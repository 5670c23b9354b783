"""Seconds per job in the copy of the subset search's answer to the host
(the ``gen_dst.to_host`` span of ``core/strategies.run_strategy``, which
waits for the search's device work), mean over the window's jobs."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "gen_dst.to_host")

"""Seconds per job in ``execute``'s strategy phase (``core/strategies.run_strategy``
-> ``core/gen_dst.py``), mean over the window's jobs."""
from pbcore.readers import phase_mean


def read(run):
    return phase_mean(run, "gen_dst")

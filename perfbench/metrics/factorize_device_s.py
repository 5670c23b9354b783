"""Seconds per job in factorize's device pass (the ``factorize.device`` span
of ``core/measures.factorize``: the sort, the quantile edges and the codes,
up to the read of ``n_bins`` that waits for them), mean over the window's
jobs.  None for a program that records no such span."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "factorize.device")

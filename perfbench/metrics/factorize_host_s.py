"""Seconds per job in factorize's host NumPy (the ``factorize.host`` span of
``core/measures.factorize``: the per-column ``np.unique``/``np.quantile``
loop), mean over the window's jobs."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "factorize.host")

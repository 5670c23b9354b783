"""Seconds per job in factorize's copies to the card (the ``factorize.copy``
span of ``core/measures.factorize``: codes, values and bin counts), mean
over the window's jobs."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "factorize.copy")

"""Seconds per job in the AutoML rungs' one host synchronise each (the
``automl.rung.wait`` span: the copy of a rung's accuracies, which waits for
its device work), mean over the window's jobs.  The batched backend's
span; the loop backend, which no cell runs, records none."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "automl.rung.wait")

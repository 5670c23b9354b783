"""Seconds per job in queueing the AutoML rungs' sub-batches (each rung's
``automl.rung.issue`` span: inits, Adam steps, validation, issued from the
host), mean over the window's jobs.  Under the loop backend, which no cell
runs, the span also holds the rung's preparation and per-trial syncs."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "automl.rung.issue")

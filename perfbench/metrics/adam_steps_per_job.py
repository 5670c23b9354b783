"""Adam steps the host issues per job: the ``adam_steps`` count of every
``automl.rung.issue`` span (each gradient sub-batch's steps), summed over a
job and averaged over the window's jobs."""
import numpy as np

from pbcore.spans import attr_per_job


def read(run):
    steps = attr_per_job(run, "adam_steps")
    return None if steps is None else float(np.mean(steps))

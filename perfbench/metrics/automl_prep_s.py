"""Seconds per job in the AutoML passes' host preparation: ``automl.init``
(the split, the label copies, the population) and each rung's
``automl.rung.prep`` (the pipeline variants in host NumPy, their stack and
copy, the sub-batch inputs), both passes, mean over the window's jobs.
The prep/issue/wait split holds for the batched backend, which every cell
runs; the loop backend prepares inside its ``automl.rung.issue`` span."""
from pbcore.spans import seconds_per_job


def read(run):
    return seconds_per_job(run, "automl.init", "automl.rung.prep")

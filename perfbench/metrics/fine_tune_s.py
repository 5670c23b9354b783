"""Seconds per job in ``execute``'s fine-tune phase (``automl/engine.py``
restricted to the winner's family, on the full table), mean over the window's
jobs."""
from pbcore.readers import phase_mean


def read(run):
    return phase_mean(run, "fine_tune")

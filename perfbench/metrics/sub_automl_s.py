"""Seconds per job in ``execute``'s sub-AutoML phase (``automl/engine.py`` on
the subset), mean over the window's jobs."""
from pbcore.readers import phase_mean


def read(run):
    return phase_mean(run, "sub_automl")

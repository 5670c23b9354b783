"""Seconds per job in ``execute``'s factorize phase (``core/measures.factorize``,
host NumPy, then the copy to the device), mean over the window's jobs."""
from pbcore.readers import phase_mean


def read(run):
    return phase_mean(run, "factorize")

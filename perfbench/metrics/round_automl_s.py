"""Seconds per round in the partitions' AutoML passes: the ``automl`` phase of
``serve_round`` (each partition's ``automl_sub_s`` and ``fine_tune_s``: a
search's init, and each rung's equal share of the dispatch that ran it, so
the shares of a merged dispatch add up to its wall time), summed over a
round's partitions, mean over the window's rounds."""
from pbcore.readers import phase_mean


def read(run):
    return phase_mean(run, "automl")

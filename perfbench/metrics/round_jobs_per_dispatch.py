"""Mean jobs per AutoML dispatch: the ``jobs`` of every ``sched.rungs`` span
(one per scheduler step that evaluates rungs) over their ``dispatches``
(merged groups plus solo rungs), over the window's rounds.  1.0 means
nothing merged.  None for a program without the span."""
from pbcore.rounds import ratio


def read(run):
    return ratio(run, "sched.rungs", "jobs", "dispatches")

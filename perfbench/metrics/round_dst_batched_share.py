"""Share of the subset searches that ran in a batched dispatch: ``batched``
over ``searches`` of every ``sched.dst`` span of the window's rounds.
Searches batch only on coded tables of one shape.  None for a program
without the span."""
from pbcore.rounds import ratio


def read(run):
    return ratio(run, "sched.dst", "batched", "searches")

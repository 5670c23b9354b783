"""Padded over useful FLOPs of the megabatches: ``padded_flops`` over
``useful_flops`` of every ``sched.rungs`` span of the window's rounds
(``obs/torchprof.pack_flops``: every trial priced at its group's largest
shape and step count, against its own).  1.0 means no padding.  None for a
program without the span."""
from pbcore.rounds import ratio


def read(run):
    return ratio(run, "sched.rungs", "padded_flops", "useful_flops")

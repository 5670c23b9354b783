"""Mean seconds of one Gen-DST generation (a ``gen_dst.generation`` span of
``core/gen_dst._gen_dst_run``: the host issuing the generation's work, which
nothing waits for), over every generation of the window's jobs."""
from pbcore.spans import mean_seconds


def read(run):
    return mean_seconds(run, "gen_dst.generation")

"""Device operations (kernels, copies, fills) of the traced stretch that
start inside a ``gen_dst.generation`` span, over the number of those spans:
the operations one Gen-DST generation issues.  An operation counts under
the generation open when it starts on the device, so the count is exact only
while the device keeps up with the host, as a short ``gen_dst_to_host_s``
shows; where that reads high, this is an estimate."""
from pbcore.spans import ops_per_span


def read(run):
    return ops_per_span(run.stretch, "gen_dst.generation")

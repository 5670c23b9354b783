"""B1's share of its roofline: one gathered masked histogram's least time at
the cell's shapes (``costs.b1_bytes`` over the card's memory rate) over
``masked_histogram_kernel``'s mean device time per launch, in percent."""
from pbcore import costs
from pbcore.readers import gen_dst_shape, kernel_roofline


def read(run):
    s = gen_dst_shape(run)
    if s is None:
        return None
    least = costs.least_seconds(costs.b1_bytes(s["P"], s["n"], s["M"], s["B"]))
    return kernel_roofline(run, "masked_histogram_kernel", least)

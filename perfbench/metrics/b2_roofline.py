"""B2's share of its roofline: one fused delta-and-fitness step's least time
at the cell's shapes (``costs.b2_bytes``, no delta applied: Gen-DST crosses
over every generation here, so each rebuilds its histograms) over
``fused_delta_fitness_kernel``'s mean device time per launch, in percent."""
from pbcore import costs
from pbcore.readers import gen_dst_shape, kernel_roofline


def read(run):
    s = gen_dst_shape(run)
    if s is None:
        return None
    least = costs.least_seconds(costs.b2_bytes(s["P"], s["M"], s["B"]))
    return kernel_roofline(run, "fused_delta_fitness_kernel", least)

"""Gen-DST's share of its roofline: the least time of the search's fitness
work (``costs.gen_dst_bytes`` over the card's memory rate, from psi, phi, n,
M and the histogram width) over the device time of every operation that ran
inside ``execute``'s strategy phase, in percent."""
from pbcore import costs
from pbcore.readers import gen_dst_shape


def read(run):
    shape = gen_dst_shape(run)
    if shape is None or run.stretch is None:
        return None
    busy = run.stretch.device_seconds_in("gen_dst")
    if busy <= 0:
        return None
    cfg = shape["cfg"]
    least = costs.least_seconds(costs.gen_dst_bytes(
        int(cfg["psi"]), int(cfg["phi"]), int(cfg["num_islands"]), shape["n"], shape["M"],
        shape["B"], int(cfg["cross_every"]), bool(cfg["incremental"])))
    return 100.0 * least * run.stretch.n_jobs / busy

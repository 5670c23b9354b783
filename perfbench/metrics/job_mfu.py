"""The whole job's share of the card's float32 peak: the useful operations of
every AutoML trial of the window's jobs (``costs.pass_flops``, per family,
from each pass's trial log, rows, features and classes) over the window's
seconds times 67 TFLOP/s, in percent.  The port keeps TF32 off, so its
products run at the float32 rate."""
import numpy as np

from pbcore import costs


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    total = 0.0
    for jb in run.jobs:
        X, y, _ = run.job_input(jb["job"])
        for res, cfg, (n_rows, d) in run.entry.passes(jb["record"], X, y):
            c = len(np.unique(y))
            total += costs.pass_flops(res.trials, cfg["rungs"], float(cfg["keep_frac"]),
                                      n_rows, d, c, float(cfg["val_frac"]))
    return 100.0 * total / (run.window_s * costs.FP32_FLOPS)

"""Helpers the per-layer metrics' readers share."""
from __future__ import annotations

from typing import Optional

import numpy as np


def phase_mean(run, phase: str) -> Optional[float]:
    """Mean seconds per job of one phase over the window's jobs; None where
    the cell's jobs have no such phase."""
    vals = [jb["phase_s"][phase] for jb in run.jobs if phase in jb["phase_s"]]
    return float(np.mean(vals)) if vals else None


def gen_dst_shape(run) -> Optional[dict]:
    """Gen-DST's search shape in this cell: population, subset rows,
    columns counting the target, histogram width; None without a Gen-DST."""
    cfg = run.config.get("gen_dst")
    if cfg is None or not hasattr(run.entry, "n"):
        return None
    M, B = run.table_bins()
    return {"P": int(cfg["phi"]) * int(cfg["num_islands"]), "n": run.entry.n, "M": M, "B": B,
            "cfg": cfg}


def kernel_roofline(run, key: str, least_s: float) -> Optional[float]:
    """Least seconds of one launch over the kernel's mean device seconds per
    launch in the traced stretch, in percent; None where it did not run."""
    if run.stretch is None:
        return None
    times = run.stretch.kernel_times(key)
    if not times:
        return None
    return 100.0 * least_s / float(np.mean(times))

"""The result line and the closing lines on standard error."""
from __future__ import annotations

import json
import math
from typing import List, Tuple


def _plain(v):
    """A number as JSON takes it: infinities and NaN as strings."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def result_line(out: dict, kind: str, count: int) -> Tuple[str, List[str]]:
    """(the last line of standard output, the closing lines of standard
    error) of a run whose ``run_cell`` result is ``out``, on ``count`` cards
    named ``kind``.  ``checked``, each number compared as [worst reading,
    limit], comes last in the line, as the lines on standard error end."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = {"platform": "gpu", "kind": kind, "count": count, **out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checked"] = {k: [_plain(v), _plain(lim)] for k, (v, lim) in out["checked"].items()}
    err = [f"correct {out['correct']}"
           + (f" (over its limit: {', '.join(out['fails'])})" if out["fails"] else "")]
    err += [f"check {k} {v} limit {lim}" for k, (v, lim) in line["checked"].items()]
    return json.dumps(line), err

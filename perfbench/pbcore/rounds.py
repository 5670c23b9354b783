"""Readers' helpers for the cells whose job is a round of served partition
jobs (``entries/serve_round.py``).

A round's record holds the collect sink's spans, the scheduler's
``sched.*`` dispatch spans among them.  Where the program records no span
of a kind, as a program older than those spans does, a reader gets None,
never an error.
"""
from __future__ import annotations

from typing import Optional

from .spans import job_spans


def ratio(run, name: str, num: str, den: str) -> Optional[float]:
    """The attr ``num`` over the attr ``den``, each summed over every span of
    the kind ``name`` of the window's rounds; None without such spans or
    with nothing in ``den``."""
    spans = [sp for jb in run.jobs for sp in job_spans(jb["record"]) if sp["name"] == name]
    total = sum(float(sp["attrs"].get(den, 0)) for sp in spans)
    if total <= 0:
        return None
    return sum(float(sp["attrs"].get(num, 0)) for sp in spans) / total

"""The per-server experience store (DESIGN.md §17.1).

A copy of the JAX package's ``meta/store.py`` (pure Python and numpy) on
the port's ``PipelineSpec``.

One record per dataset fingerprint: the meta-feature vector (noted at job
admission), the best observed validation accuracy of every trial spec at
every successive-halving rung (fed by the scheduler's rung records), and
the sub-AutoML winner spec.  Together the records form the performance
matrix the portfolio builder maximizes coverage over.

Persistence contract: ``state_dict()`` is a plain tree (strings, floats,
``PipelineSpec`` dataclasses, float32 arrays) and ``load_state(state_dict())``
reproduces the store bit-identically — accuracies compare ``==``, feature
vectors compare bytewise — so a restored store makes byte-for-byte the same
portfolio decisions as the one that took the snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..automl.engine import PipelineSpec

__all__ = ["ExperienceRecord", "ExperienceStore"]


@dataclasses.dataclass
class ExperienceRecord:
    """Everything the fleet has learned about one dataset fingerprint."""
    fingerprint: str
    # meta-feature vector (meta/features.py), set at first admission
    features: Optional[np.ndarray] = None
    # spec -> {rung index -> best observed val accuracy at that rung}
    rung_accs: Dict[PipelineSpec, Dict[int, float]] = dataclasses.field(
        default_factory=dict)
    # the sub-AutoML winner spec, once a job on this fingerprint finished
    winner: Optional[PipelineSpec] = None
    jobs: int = 0          # jobs admitted on this fingerprint

    def final_acc(self, spec: PipelineSpec) -> Optional[float]:
        """The spec's accuracy at its deepest observed rung (the number the
        portfolio objective scores — deeper rungs train longer)."""
        accs = self.rung_accs.get(spec)
        if not accs:
            return None
        return accs[max(accs)]


class ExperienceStore:
    """Fingerprint-keyed experience records with bit-identical round trips."""

    def __init__(self):
        self.records: Dict[str, ExperienceRecord] = {}

    # -- feeding ------------------------------------------------------------

    def _record(self, fingerprint: str) -> ExperienceRecord:
        rec = self.records.get(fingerprint)
        if rec is None:
            rec = self.records[fingerprint] = ExperienceRecord(fingerprint)
        return rec

    def note_meta(self, fingerprint: str, features: np.ndarray) -> None:
        """Register a dataset's meta-feature vector (idempotent — the
        vector is a pure function of the fingerprint)."""
        rec = self._record(fingerprint)
        if rec.features is None:
            rec.features = np.asarray(features, dtype=np.float32)
        rec.jobs += 1

    def note_trial(self, fingerprint: str, spec: PipelineSpec, rung_i: int,
                   acc: float) -> None:
        """Record one scored trial; keeps the best accuracy per (spec, rung)."""
        accs = self._record(fingerprint).rung_accs.setdefault(spec, {})
        prev = accs.get(int(rung_i))
        if prev is None or acc > prev:
            accs[int(rung_i)] = float(acc)

    def note_winner(self, fingerprint: str, spec: PipelineSpec) -> None:
        self._record(fingerprint).winner = spec

    # -- querying -----------------------------------------------------------

    def trained(self, exclude: Iterable[str] = ()) -> List[str]:
        """Fingerprints with a finished sub-AutoML pass (winner known) and a
        meta-feature vector, sorted — the usable history."""
        skip = set(exclude)
        return sorted(fp for fp, rec in self.records.items()
                      if rec.winner is not None and rec.features is not None
                      and fp not in skip)

    def n_trained(self, exclude: Iterable[str] = ()) -> int:
        return len(self.trained(exclude))

    def matrix(self, fingerprints: Optional[Sequence[str]] = None,
               ) -> Dict[PipelineSpec, Dict[str, float]]:
        """The performance matrix over ``fingerprints`` (default: all
        trained history): spec -> {fingerprint -> deepest-rung accuracy}."""
        fps = self.trained() if fingerprints is None else list(fingerprints)
        out: Dict[PipelineSpec, Dict[str, float]] = {}
        for fp in fps:
            rec = self.records.get(fp)
            if rec is None:
                continue
            for spec in rec.rung_accs:
                acc = rec.final_acc(spec)
                if acc is not None:
                    out.setdefault(spec, {})[fp] = acc
        return out

    # -- persistence (bit-identical) ----------------------------------------

    def state_dict(self) -> dict:
        """A snapshot of the whole store."""
        return {"records": [self.records[fp]
                            for fp in sorted(self.records)]}

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict()`` output (replaces current contents)."""
        self.records = {}
        for rec in state["records"]:
            self.records[rec.fingerprint] = ExperienceRecord(
                fingerprint=rec.fingerprint,
                features=(None if rec.features is None
                          else np.asarray(rec.features, dtype=np.float32)),
                rung_accs={spec: {int(r): float(a) for r, a in accs.items()}
                           for spec, accs in rec.rung_accs.items()},
                winner=rec.winner,
                jobs=int(rec.jobs),
            )

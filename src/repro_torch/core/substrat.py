"""SubStrat — the paper's 3-step subset-based AutoML strategy (§1.1, Fig. 1).

The port of the JAX package's ``core/substrat.py``:

  1. Find a small measure-preserving data subset d (Gen-DST or another
     registered strategy).
  2. Run the AutoML tool on d:  A(d, y) -> M'.
  3. Fine-tune: a restricted, much shorter AutoML pass on the full D, only
     over pipelines with M''s model family:  -> M_sub.

``substrat()`` is a thin client of ``core/plan.py``; the phase functions
here are the units of work ``execute`` runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..automl.engine import AutoMLConfig, AutoMLResult, get_backend
from ..device import DeviceLike
from .gen_dst import GenDSTConfig
from .measures import CodedDataset

__all__ = ["SubStratResult", "substrat", "SubStratConfig",
           "dst_feature_columns", "build_subset", "nf_test_eval"]


@dataclasses.dataclass(frozen=True)
class SubStratConfig:
    """Configuration of the full 3-step strategy (paper §1.1, DESIGN.md §5).

    - ``gen`` — Gen-DST budget and search-loop levers (paper §3.3).
    - ``n`` / ``m`` — DST shape; ``None`` means ``sqrt(N)`` rows and
      ``0.25·M`` columns (paper §4.2).
    - ``fine_tune`` — step 3 on/off; ``False`` is SubStrat-NF (paper §4.4).
    - ``sub_automl`` / ``ft_automl`` — the step-2 and step-3 budgets.
    - ``num_islands`` — overrides ``gen.num_islands`` when set.
    - ``automl_backend`` — when set, the AutoML backend of *both* the
      sub-AutoML and the fine-tune passes (``"batched"`` or ``"loop"``).
    """
    gen: GenDSTConfig = GenDSTConfig()
    n: Optional[int] = None
    m: Optional[int] = None
    fine_tune: bool = True
    sub_automl: AutoMLConfig = AutoMLConfig()
    ft_automl: AutoMLConfig = AutoMLConfig(n_trials=6, rungs=(60,))
    num_islands: Optional[int] = None
    automl_backend: Optional[str] = None

    def __post_init__(self):
        if self.automl_backend is not None:
            get_backend(self.automl_backend)   # unknown names list the registry

    def resolved_gen(self) -> GenDSTConfig:
        if self.num_islands is not None:
            return self.gen._replace(num_islands=self.num_islands)
        return self.gen

    def resolved_sub_automl(self) -> AutoMLConfig:
        if self.automl_backend is not None:
            return dataclasses.replace(self.sub_automl, backend=self.automl_backend)
        return self.sub_automl

    def resolved_ft_automl(self) -> AutoMLConfig:
        if self.automl_backend is not None:
            return dataclasses.replace(self.ft_automl, backend=self.automl_backend)
        return self.ft_automl


@dataclasses.dataclass
class SubStratResult:
    final: AutoMLResult               # M_sub (or M' if fine_tune=False)
    intermediate: AutoMLResult        # M'
    row_idx: np.ndarray
    col_idx: np.ndarray               # selected feature columns (no target)
    dst_fitness: float
    times: dict                       # per-phase seconds
    total_time_s: float
    strategy: str = "gen_dst"


def dst_feature_columns(col_mask: np.ndarray, target_col: int) -> np.ndarray:
    """Feature columns of the DST (the target column participates in the
    measure but is the label, not a feature)."""
    col_idx = np.flatnonzero(col_mask)
    col_idx = col_idx[col_idx != target_col]
    if len(col_idx) == 0:
        col_idx = np.array([0 if target_col != 0 else 1])
    return col_idx


def build_subset(
    X: np.ndarray,
    y: np.ndarray,
    row_idx: np.ndarray,
    col_idx: np.ndarray,
    generator: Optional[torch.Generator] = None,
    *,
    patch_seed: Optional[int] = None,
):
    """Materialize the DST rows/columns as the step-2 training set.

    If the rows miss whole label classes, patch the subset with rows drawn
    from each missing class (at most ``len(row_idx) // len(missing)`` and
    32 each).  The draw's numpy seed is ``patch_seed`` when given, else one
    draw from ``generator`` (else 0): the reference derives it with
    ``jax.random``, which torch cannot replay, so the tests inject it."""
    X, y = np.asarray(X), np.asarray(y)
    X_sub = X[row_idx][:, col_idx]
    y_sub = y[row_idx]
    missing = np.setdiff1d(np.unique(y), np.unique(y_sub))
    if len(missing):
        if patch_seed is not None:
            seed = int(patch_seed)
        elif generator is not None:
            seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=generator,
                                     device=generator.device)[0])
        else:
            seed = 0
        rng = np.random.default_rng(seed)
        per_class = max(1, len(row_idx) // len(missing))
        extra = np.concatenate([
            rng.choice(np.flatnonzero(y == cls),
                       size=min(32, per_class, int((y == cls).sum())),
                       replace=False)
            for cls in missing
        ])
        X_sub = np.concatenate([X_sub, X[extra][:, col_idx]])
        y_sub = np.concatenate([y_sub, y[extra]])
    return X_sub, y_sub


def nf_test_eval(intermediate: AutoMLResult, y_sub: np.ndarray, col_idx: np.ndarray,
                 X_test: np.ndarray, y_test: np.ndarray) -> AutoMLResult:
    """SubStrat-NF test evaluation: score M' on the full-width test data
    restricted to the DST's feature columns (no fine-tune pass)."""
    from ..automl.engine import apply_pipeline
    from ..automl.models import _leaves, accuracy
    dev = _leaves(intermediate.params)[0].device
    Xt = apply_pipeline(intermediate.spec, intermediate.pre_stats, intermediate.feat_idx,
                        np.asarray(X_test, np.float32)[:, col_idx], dev)
    classes = np.unique(y_sub)
    yt = torch.as_tensor(np.searchsorted(classes, np.asarray(y_test)), dtype=torch.int64,
                         device=dev)
    return dataclasses.replace(
        intermediate,
        test_acc=accuracy(intermediate.params, Xt, yt, intermediate.spec.family),
    )


def substrat(
    X: np.ndarray,
    y: np.ndarray,
    *,
    seed: int = 0,
    config: SubStratConfig = SubStratConfig(),
    coded: Optional[CodedDataset] = None,
    X_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> SubStratResult:
    """One-shot SubStrat run — a thin client of the plan API."""
    from .plan import execute, plan_from_config
    return execute(plan_from_config(config), X, y, seed=seed, coded=coded,
                   X_test=X_test, y_test=y_test, device=device)

"""The declarative plan-based pipeline API (DESIGN.md §12), in PyTorch.

The port of the JAX package's ``core/plan.py``::

    from repro_torch.core.plan import plan, execute

    p = plan("gen_dst", cfg=GenDSTConfig(psi=20),
             sub_automl=AutoMLConfig(n_trials=12))
    result = execute(p, X, y, seed=0)            # on CUDA unless device="cpu"

A ``Plan`` names a SubsetStrategy (``core/strategies.py``), the subset
shape, the two AutoML pass budgets and, optionally, the AutoML backend of
both passes.
``execute()`` runs the whole pipeline: factorize → strategy → subset →
sub-AutoML → restricted fine-tune.  ``Plan.cacheable``, ``Plan.batchable``
and ``Plan.subset_identity`` say what the service layer (``service/``) may
cache and merge; ``Plan.continuous_batching`` and ``Plan.warm_start`` opt a
served job into the scheduler's cross-rung megabatch and its portfolio warm
starts.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ..automl.engine import AutoMLConfig, automl_fit, get_backend
from ..device import DeviceLike, make_generator, resolve_device
from ..obs import trace as _trace
from .gen_dst import _resolve_nm
from .measures import CodedDataset, factorize
from .strategies import SubsetResult, get_strategy, run_strategy

__all__ = ["Plan", "plan", "execute", "plan_from_config"]


def _norm_opts(opts) -> Tuple[Tuple[str, object], ...]:
    """Normalize strategy options to sorted hashable items."""
    return tuple(sorted(dict(opts).items()))


@dataclasses.dataclass(frozen=True)
class Plan:
    """A declarative description of one SubStrat run (see the JAX
    package's ``Plan`` for each field's meaning).  ``backend``, when set,
    overrides the AutoML backend of *both* AutoML passes."""
    strategy: Union[str, Callable] = "gen_dst"
    strategy_opts: Tuple[Tuple[str, object], ...] = ()
    n: Optional[int] = None
    m: Optional[int] = None
    fine_tune: bool = True
    sub_automl: AutoMLConfig = AutoMLConfig()
    ft_automl: AutoMLConfig = AutoMLConfig(n_trials=6, rungs=(60,))
    backend: Optional[str] = None
    # opt into the scheduler's standing cross-rung megabatch (DESIGN.md §13);
    # off, the job merges only with cohorts at its exact (rung_i, epochs)
    continuous_batching: bool = True
    # opt into portfolio warm starts from the server's experience store
    # (DESIGN.md §17); off, the sub-AutoML pass seeds its full cold population
    warm_start: bool = True

    def __post_init__(self):
        if not callable(self.strategy):
            get_strategy(self.strategy)        # fail fast, listing names
        if self.backend is not None:
            get_backend(self.backend)
        object.__setattr__(self, "strategy_opts", _norm_opts(self.strategy_opts))

    def resolved_sub_automl(self) -> AutoMLConfig:
        if self.backend is not None:
            return dataclasses.replace(self.sub_automl, backend=self.backend)
        return self.sub_automl

    def resolved_ft_automl(self) -> AutoMLConfig:
        if self.backend is not None:
            return dataclasses.replace(self.ft_automl, backend=self.backend)
        return self.ft_automl

    @property
    def cacheable(self) -> bool:
        """Whether this plan's subset is DST-cache eligible: a *registered*
        strategy whose output is a pure function of (dataset, n, m, opts)."""
        return not callable(self.strategy) and get_strategy(self.strategy).cacheable

    @property
    def batchable(self) -> bool:
        """Whether the strategy can run same-shaped searches as one."""
        return not callable(self.strategy) and get_strategy(self.strategy).batch_fn is not None

    def subset_identity(self, coded: CodedDataset) -> tuple:
        """The hashable identity of this plan's subset-search problem on
        ``coded``: the resolved subset shape, the strategy and its options."""
        n, m = _resolve_nm(coded, self.n, self.m)
        return (n, m, self.strategy, self.strategy_opts)


def plan(
    strategy: Union[str, Callable] = "gen_dst",
    *,
    n: Optional[int] = None,
    m: Optional[int] = None,
    fine_tune: bool = True,
    sub_automl: Optional[AutoMLConfig] = None,
    ft_automl: Optional[AutoMLConfig] = None,
    backend: Optional[str] = None,
    continuous_batching: bool = True,
    warm_start: bool = True,
    **strategy_opts,
) -> Plan:
    """Build a ``Plan``; extra keyword arguments become strategy options."""
    kw = {}
    if sub_automl is not None:
        kw["sub_automl"] = sub_automl
    if ft_automl is not None:
        kw["ft_automl"] = ft_automl
    return Plan(strategy=strategy, strategy_opts=_norm_opts(strategy_opts),
                n=n, m=m, fine_tune=fine_tune, backend=backend,
                continuous_batching=continuous_batching, warm_start=warm_start, **kw)


def plan_from_config(config, dst_fn: Optional[Callable] = None) -> Plan:
    """Convert a ``SubStratConfig`` (and, deprecated, a bare ``dst_fn``
    strategy, which ``Scheduler.submit(dst_fn=)`` still takes) into the
    equivalent ``Plan``."""
    if dst_fn is not None:
        strategy, opts = dst_fn, ()
    else:
        strategy, opts = "gen_dst", (("cfg", config.resolved_gen()),)
    return Plan(
        strategy=strategy, strategy_opts=opts,
        n=config.n, m=config.m, fine_tune=config.fine_tune,
        sub_automl=config.resolved_sub_automl(), ft_automl=config.resolved_ft_automl(),
    )


def execute(
    p: Plan,
    X: np.ndarray,
    y: np.ndarray,
    *,
    seed: int = 0,
    coded: Optional[CodedDataset] = None,
    X_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
    trace_sink: Optional[List[dict]] = None,
    device: DeviceLike = None,
):
    """Run one plan end to end on ``device`` (default CUDA; raises without
    one unless ``device="cpu"``); returns a ``SubStratResult``.

    ``seed`` seeds the strategy's generator (on the device) and the subset
    patch draw.  The per-phase ``times`` are recorded as spans: pass
    ``trace_sink=[]`` to receive the closed span records.  Each phase ends
    with its results on the host, so its time covers its device work.

    The call is one trace of its own.  Its four phase spans (``factorize``,
    ``gen_dst``, ``sub_automl``, ``fine_tune``) are the roots; the spans
    that the layers below record go into the same sink under them
    (``obs/trace.collect``), innermost first."""
    from .substrat import SubStratResult, build_subset, dst_feature_columns, nf_test_eval
    dev = resolve_device(device)
    times = {}
    spans = [] if trace_sink is None else trace_sink

    @contextlib.contextmanager
    def _phase(name, tkey):
        with _trace.span(None, None, name, phase=name) as sp:
            yield
        times[tkey] = times.get(tkey, 0.0) + (sp["t1"] - sp["t0"])

    with _trace.collect(spans):
        with _phase("factorize", "factorize_s"):
            coded = factorize(X, y, device=dev) if coded is None else coded.to(dev)

        with _phase("gen_dst", "gen_dst_s"):
            subset: SubsetResult = run_strategy(
                p.strategy, make_generator(seed, dev), coded, p.n, p.m, p.strategy_opts)
        col_idx = dst_feature_columns(subset.col_mask, coded.target_col)

        with _phase("sub_automl", "automl_sub_s"):
            X_sub, y_sub = build_subset(X, y, subset.row_idx, col_idx,
                                        make_generator(seed ^ 0x5AB5))
            intermediate = automl_fit(X_sub, y_sub, config=p.resolved_sub_automl(), device=dev)

        if p.fine_tune:
            with _phase("fine_tune", "fine_tune_s"):
                final = automl_fit(
                    X, y,
                    config=p.resolved_ft_automl(),
                    restrict_family=intermediate.spec.family,
                    X_test=X_test, y_test=y_test, device=dev,
                )
        else:
            final = intermediate
            if X_test is not None:
                final = nf_test_eval(intermediate, y_sub, col_idx, X_test, y_test)

    return SubStratResult(
        final=final,
        intermediate=intermediate,
        row_idx=subset.row_idx,
        col_idx=col_idx,
        dst_fitness=subset.fitness,
        times=times,
        total_time_s=sum(times.values()),
        strategy=subset.strategy,
    )

"""The paper's comparison on one dataset: Full-AutoML against SubStrat and the
baseline subset strategies, each reported as time-reduction and relative
accuracy (after the JAX package's ``benchmarks/common.py``).

    from repro_torch.launch.compare import run_dataset
    full, results = run_dataset(PAPER_DATASETS["D6"], scale=1.0)   # on CUDA

Every method is a ``Plan`` executed by ``core/plan.execute``: SubStrat is
``plan("gen_dst")`` under the quick budgets, SubStrat-NF the same without the
fine-tune, and each baseline the same plan with another SubsetStrategy.

``run_dataset`` keeps the reference's protocol.  The table is split and
factorized once, and every method reuses the factorized table.
Full-AutoML runs first.  Each distinct method's subset strategy then runs
once, untimed, in the order the methods are listed (the reference iterates
a ``set``): that pays the one-time costs a deployment pays once per process
(the first kernel build, the log2 table's first fill), as the reference's
warm-up pays its jit compiles.  Each method then runs with
``seed = seed * 977 + 13`` where the reference passes
``jax.random.key(seed * 977 + 13)``.  The AutoML passes' one-time costs
(cuBLAS handles, the caching allocator) fall in Full-AutoML's timed pass,
which favours SubStrat: call ``run_dataset`` once untimed before a timed
call.

Each result also carries what the port adds: the launches of each
hand-written kernel during the method's run (differences of
``kernels.launch_counts()``, read outside the timed region) and the run's
own result object.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

from .. import kernels
from ..automl.engine import AutoMLConfig, automl_fit
from ..core.gen_dst import GenDSTConfig
from ..core.measures import factorize
from ..core.plan import Plan, execute, plan_from_config
from ..core.strategies import run_strategy
from ..core.substrat import SubStratConfig
from ..data.tabular import DatasetSpec, make_dataset, train_test_split
from ..device import DeviceLike, make_generator, resolve_device

__all__ = ["QUICK_AUTOML", "QUICK_FT", "QUICK_GEN", "BASELINE_STRATEGIES",
           "BenchResult", "method_plan", "run_dataset", "substrat_config"]

# quick-mode engine budgets, the reference's
QUICK_AUTOML = AutoMLConfig(n_trials=10, rungs=(60, 200))
QUICK_FT = AutoMLConfig(n_trials=4, rungs=(120,))
QUICK_GEN = GenDSTConfig(psi=10, phi=24)


def substrat_config(**kw) -> SubStratConfig:
    base = dict(gen=QUICK_GEN, sub_automl=QUICK_AUTOML, ft_automl=QUICK_FT)
    base.update(kw)
    return SubStratConfig(**base)


# method name -> (strategy, strategy_opts): the subset axis of each plan
BASELINE_STRATEGIES: Dict[str, Tuple[str, tuple]] = {
    "MC-100": ("mc", (("budget", 100), ("batch", 50))),
    "MC-100K": ("mc", (("budget", 4000), ("batch", 200))),
    "MAB": ("mab", (("rounds", 200),)),
    "KM": ("km", ()),
    "IG-Rand": ("ig_rand", ()),
    "IG-KM": ("ig_km", ()),
    "ASP": ("asp_proxy", ()),
}


def method_plan(method: str, sub_cfg: SubStratConfig) -> Plan:
    """The ``Plan`` of one named method under the shared engine budgets."""
    base = plan_from_config(sub_cfg)
    if method == "SubStrat":
        return base
    if method == "SubStrat-NF":
        return dataclasses.replace(base, fine_tune=False)
    strategy, opts = BASELINE_STRATEGIES[method]
    return dataclasses.replace(base, strategy=strategy, strategy_opts=opts)


@dataclasses.dataclass
class BenchResult:
    dataset: str
    method: str
    time_s: float
    test_acc: float
    time_reduction: float
    relative_accuracy: float
    # the port's additions: kernel launches during the run, and its result
    # (an AutoMLResult for Full-AutoML, else a SubStratResult)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    result: Any = None


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in kernels.launch_counts().items()}


def run_dataset(
    spec: DatasetSpec,
    *,
    scale: float = 0.05,
    seed: int = 0,
    methods: Optional[list] = None,
    sub_cfg: Optional[SubStratConfig] = None,
    full_cfg: AutoMLConfig = QUICK_AUTOML,
    device: DeviceLike = None,
):
    """Returns (full BenchResult, [method BenchResults]); runs on ``device``
    (default CUDA; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    X, y = make_dataset(spec, scale=scale)
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.2, seed=seed)
    coded = factorize(Xtr, ytr, device=dev)     # shared across methods
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    full = automl_fit(Xtr, ytr, config=full_cfg, X_test=Xte, y_test=yte, device=dev)
    t_full = time.perf_counter() - t0
    full_res = BenchResult(spec.name, "Full-AutoML", t_full, full.test_acc, 0.0, 1.0,
                           _launches_since(before), full)

    sub_cfg = sub_cfg or substrat_config()
    out = []
    methods = methods if methods is not None else (
        ["SubStrat", "SubStrat-NF"] + list(BASELINE_STRATEGIES)
    )
    # warm up each distinct method's strategy once (untimed), in list order
    for method in dict.fromkeys(methods):
        p = method_plan(method, sub_cfg)
        run_strategy(p.strategy, make_generator(0, dev), coded, p.n, p.m, p.strategy_opts)
    for method in methods:
        before = kernels.launch_counts()
        res = execute(method_plan(method, sub_cfg), Xtr, ytr, seed=seed * 977 + 13,
                      coded=coded, X_test=Xte, y_test=yte, device=dev)
        t = res.total_time_s
        acc = res.final.test_acc
        out.append(BenchResult(
            spec.name, method, t, acc,
            1.0 - t / max(t_full, 1e-9), acc / max(full.test_acc, 1e-9),
            _launches_since(before), res,
        ))
    return full_res, out

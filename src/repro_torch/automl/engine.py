"""A search-based AutoML engine ``A(D, y) -> M*`` in PyTorch.

The port of the JAX package's ``automl/engine.py``: random sampling of
pipelines (preprocessor, feature selector, model family, HPs) plus
successive halving on the ``epochs`` resource (DESIGN.md §10.1-10.2).

What carries over exactly: the spec sampling and the train/val split run
the same ``np.random.default_rng`` calls, so the sampled population and the
split are identical to the reference's for a seed; promotion is a stable
top-k (ties to the lower trial index).

What differs:
* ``_trial_generator`` replaces ``_trial_key``: a ``torch.Generator`` seeded
  from ``(seed, trial_id, rung)``, so a trial's draws do not depend on
  evaluation order.  Only the MLP init draws from it.
* Two rung evaluators share one rung loop, as in the reference
  (``AutoMLConfig.backend``, resolved through a registry):
  ``"batched"`` (default) advances a whole rung cohort at once in
  ``automl/batched.py`` (DESIGN.md §10.3); ``"loop"`` trains one trial at a
  time (``_eval_rung_loop``).  Both draw a trial's MLP init from the same
  ``_trial_generator``, so the same seed gives the same winner.
* ``init_provider`` is a seam for the tests: ``fn(spec, trial_id, rung,
  d, n_classes) -> params or None`` replaces a trial's drawn initial params.

The paper's fine-tuning step (§3.4) maps to ``restrict_family=...``.
``search_snapshot``/``search_restore(snap, device=)`` carry a search across
processes (DESIGN.md §14.4): the snapshot drops the device, its label
mirrors and ``init_provider``, and a restored search rebuilds them on the
device it resolves; the winner's params, host arrays if they crossed the
wire, go to the search's device in ``search_result``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..obs import trace as _trace
from .models import FAMILIES, accuracy, train_model

__all__ = [
    "AutoMLConfig", "AutoMLResult", "automl_fit", "PipelineSpec",
    "apply_pipeline", "sh_promote", "SearchState", "search_init",
    "search_cohort", "search_record", "search_result", "search_eval_rung",
    "TrialCohort", "search_trial_cohort", "register_backend", "get_backend",
    "available_backends", "BACKENDS", "params_to", "search_snapshot",
    "search_restore",
]

PREPROCS = ("none", "standardize", "minmax")
FEATURE_FRACS = (1.0, 0.5)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """One point of the pipeline search space (DESIGN.md §10.1)."""
    preproc: str
    feature_frac: float
    family: str
    hp: tuple           # sorted (k, v) tuple from the family's hp_grid


@dataclasses.dataclass
class AutoMLResult:
    spec: PipelineSpec
    params: Any                # dict of tensors on the run's device (loop shapes)
    val_acc: float
    test_acc: Optional[float]
    time_s: float
    n_trials: int
    feat_idx: np.ndarray
    pre_stats: Dict[str, np.ndarray]
    trials: List[tuple]        # (spec, val_acc), cohort order per rung
    rung_times: List[float] = dataclasses.field(default_factory=list)
    backend: str = "batched"
    # the search's spans (``obs/trace``), filled by ``automl_fit``
    spans: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class AutoMLConfig:
    """Budget + schedule of one ``automl_fit`` search (DESIGN.md §10.2)."""
    n_trials: int = 24
    time_budget_s: Optional[float] = None
    rungs: Sequence[int] = (20, 60, 180)
    keep_frac: float = 0.34
    val_frac: float = 0.2
    seed: int = 0
    backend: str = "batched"   # "batched" (§10.3) | "loop" (one trial at a time)


def _fit_preproc(name: str, X: np.ndarray) -> Dict[str, np.ndarray]:
    if name == "standardize":
        return {"mu": X.mean(0), "sd": X.std(0) + 1e-9}
    if name == "minmax":
        return {"lo": X.min(0), "hi": X.max(0)}
    return {}


def _apply_preproc(name: str, stats, X: np.ndarray) -> np.ndarray:
    if name == "standardize":
        return (X - stats["mu"]) / stats["sd"]
    if name == "minmax":
        rng = np.maximum(stats["hi"] - stats["lo"], 1e-9)
        return (X - stats["lo"]) / rng * 2.0 - 1.0
    return X


def _select_features(frac: float, X_train: np.ndarray, y_train: np.ndarray) -> np.ndarray:
    d = X_train.shape[1]
    k = max(1, int(round(frac * d)))
    if k >= d:
        return np.arange(d)
    var = X_train.var(axis=0)         # variance ranking (cheap, label-free)
    return np.argsort(-var)[:k]


def apply_pipeline(spec: PipelineSpec, pre_stats, feat_idx, X: np.ndarray,
                   device: DeviceLike = "cpu") -> torch.Tensor:
    """Preprocess on the host (numpy, as the reference) and move to ``device``."""
    Xp = _apply_preproc(spec.preproc, pre_stats, X)
    return torch.as_tensor(np.ascontiguousarray(Xp[:, feat_idx], dtype=np.float32),
                           device=device)


def _trial_seed(seed: int, trial_id: int, rung_i: int) -> int:
    digest = hashlib.blake2s(f"{seed}/{trial_id}/{rung_i}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _trial_generator(seed: int, trial_id: int, rung_i: int, device) -> torch.Generator:
    """Per-trial generator, independent of evaluation order."""
    return make_generator(_trial_seed(seed, trial_id, rung_i), device)


def sh_promote(val_acc, keep_frac: float) -> np.ndarray:
    """Successive-halving promotion as a top-k survivor mask.

    Keeps ``max(1, ceil(n * keep_frac))`` trials; ties go to the lower trial
    index (a stable sort), as in the reference (DESIGN.md §10.2)."""
    acc = torch.as_tensor(np.asarray(val_acc, np.float32))
    keep = max(1, int(np.ceil(acc.shape[0] * keep_frac)))
    order = torch.argsort(-acc, stable=True)
    mask = torch.zeros(acc.shape, dtype=torch.bool)
    mask[order[:keep]] = True
    return mask.numpy()


def _sample_specs(rng: np.random.Generator, n: int, families: Sequence[str]) -> List[PipelineSpec]:
    specs = []
    for _ in range(n):
        fam = families[rng.integers(len(families))]
        grid = FAMILIES[fam].hp_grid
        hp = tuple(sorted((k, v[rng.integers(len(v))]) for k, v in grid.items()))
        specs.append(
            PipelineSpec(
                preproc=PREPROCS[rng.integers(len(PREPROCS))],
                feature_frac=FEATURE_FRACS[rng.integers(len(FEATURE_FRACS))],
                family=fam,
                hp=hp,
            )
        )
    seen, out = set(), []     # dedup, keep order
    for s in specs:
        key = (s.preproc, s.feature_frac, s.family, s.hp)
        if key not in seen:
            seen.add(key)
            out.append(s)
    return out


def _eval_rung_loop(cohort, tids, rung_i, epochs, ctx, out_of_budget, collect_params=True):
    """Sequential reference: one ``train_model`` call per trial.

    Returns ``(scored, positions)``: ``scored[i]`` is
    ``(spec, val_acc, params, feat_idx, pre_stats)``.  One
    ``automl.rung.issue`` span covers the trials, each prepared, trained and
    waited for in turn, with the batched backend's counts ``adam_steps``
    and ``trial_steps`` (every Adam-trained trial issues its own steps, so
    they are equal) and ``graph_steps``, the steps ``models.adam_train``
    replayed from a CUDA graph.  So under this backend ``.issue`` also
    holds the preprocessing and the syncs that the batched backend's
    ``.prep`` and ``.wait`` spans hold."""
    dev = ctx["device"]
    scored = []
    with _trace.span(None, None, "automl.rung.issue", graph_steps=0) as sp:
        for spec, tid in zip(cohort, tids):
            if out_of_budget() and scored:
                break
            ckey = (spec.preproc, spec.feature_frac)
            if ckey not in ctx["pipe_cache"]:
                stats = _fit_preproc(spec.preproc, ctx["X_tr"])
                fidx = _select_features(spec.feature_frac, ctx["X_tr"], ctx["y_tr"])
                Xtr_p = apply_pipeline(spec, stats, fidx, ctx["X_tr"], dev)
                Xval_p = apply_pipeline(spec, stats, fidx, ctx["X_val"], dev)
                ctx["pipe_cache"][ckey] = (stats, fidx, Xtr_p, Xval_p)
            stats, fidx, Xtr_p, Xval_p = ctx["pipe_cache"][ckey]
            init = None
            if ctx["init_provider"] is not None:
                init = ctx["init_provider"](spec, tid, rung_i, Xtr_p.shape[1], ctx["n_classes"])
            params = train_model(
                _trial_generator(ctx["seed"], tid, rung_i, dev),
                Xtr_p, ctx["y_tr_t"], spec.family, ctx["n_classes"], dict(spec.hp), epochs,
                init_params=init,
            )
            vacc = accuracy(params, Xval_p, ctx["y_val_t"], spec.family)
            scored.append((spec, vacc, params, fidx, stats))
        steps = epochs * sum(FAMILIES[s.family].fit_closed is None for s, *_r in scored)
        sp["attrs"].update(adam_steps=steps, trial_steps=steps)
    return scored, list(range(len(scored)))


# ---------------------------------------------------------------------------
# SearchBackend registry: "how one rung of trials is evaluated"
# ---------------------------------------------------------------------------

# A backend is a rung evaluator:
#   (cohort, tids, rung_i, epochs, ctx, out_of_budget, collect_params)
#     -> (scored, positions)
# where ``scored[i]`` is ``(spec, val_acc, params, feat_idx, pre_stats)`` and
# ``positions[i]`` its index into ``cohort`` (DESIGN.md §12.2).
BACKENDS: Dict[str, Any] = {}


def register_backend(name: str, eval_rung, *, overwrite: bool = False):
    """Register a rung evaluator under ``name``."""
    if not overwrite and name in BACKENDS:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    BACKENDS[name] = eval_rung
    return eval_rung


def available_backends():
    return tuple(sorted(BACKENDS))


def get_backend(name: str):
    """Look up a registered backend; unknown names list what exists."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown AutoML backend {name!r}; available backends: "
            f"{', '.join(available_backends())}") from None


def _eval_rung_batched_lazy(cohort, tids, rung_i, epochs, ctx, out_of_budget,
                            collect_params=True):
    # deferred import: batched.py imports engine helpers (no cycle at load)
    from .batched import eval_rung_batched
    return eval_rung_batched(cohort, tids, rung_i, epochs, ctx, out_of_budget,
                             collect_params)


register_backend("loop", _eval_rung_loop)
register_backend("batched", _eval_rung_batched_lazy)


@dataclasses.dataclass
class SearchState:
    """Resumable state of one successive-halving search (DESIGN.md §11.3):
    ``search_cohort`` → the rung's evaluation → ``search_record``, rung by
    rung; ``search_result`` finalizes."""
    config: AutoMLConfig
    classes: np.ndarray
    ctx: dict
    specs: List[PipelineSpec]
    alive_ids: List[int]
    t_start: float
    rung_i: int = 0
    live: List[tuple] = dataclasses.field(default_factory=list)
    trials_log: List[tuple] = dataclasses.field(default_factory=list)
    rung_times: List[float] = dataclasses.field(default_factory=list)
    n_done: int = 0
    stopped: bool = False
    # per-trial rung cursors (DESIGN.md §13.2): ``trial_rung[tid]`` is the
    # rung the trial trains next; survivors advance, culled trials keep
    # their last cursor (they have left the megabatch)
    trial_rung: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.stopped or self.rung_i >= len(self.config.rungs)

    def out_of_budget(self) -> bool:
        return (
            self.config.time_budget_s is not None
            and time.perf_counter() - self.t_start > self.config.time_budget_s
        )


def search_init(
    X: np.ndarray,
    y: np.ndarray,
    *,
    config: AutoMLConfig = AutoMLConfig(),
    restrict_family: Optional[str] = None,
    seed_trials: Optional[Sequence[PipelineSpec]] = None,
    device: DeviceLike = None,
    init_provider: Optional[Callable] = None,
) -> SearchState:
    """Build the evaluation context and sample the initial population.

    ``seed_trials`` is the meta-learning warm start (DESIGN.md §17.4): when
    given, rung 0 runs only those specs.  The sampled population depends
    only on ``config.seed``, so a seed spec that matches a sampled one keeps
    its trial id, and with it the ``(seed, trial_id, rung)`` generator a
    cold run would use; seed specs outside the population append with fresh
    ids.  ``seed_trials=None`` (or empty) is the cold path."""
    get_backend(config.backend)   # unknown names raise, listing the registry
    dev = resolve_device(device)
    t_start = time.perf_counter()
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y)
    classes, y_enc = np.unique(y, return_inverse=True)
    rng = np.random.default_rng(config.seed)

    # train/val split
    N = X.shape[0]
    perm = rng.permutation(N)
    n_val = max(1, int(config.val_frac * N))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    X_tr, y_tr = X[tr_idx], y_enc[tr_idx]
    X_val, y_val = X[val_idx], y_enc[val_idx]

    families = [restrict_family] if restrict_family else list(FAMILIES)
    n_seed_trials = config.n_trials if not restrict_family else max(4, config.n_trials // 4)
    specs = _sample_specs(rng, n_seed_trials, families)
    alive_ids = list(range(len(specs)))
    if seed_trials:
        index = {s: i for i, s in enumerate(specs)}
        ids = []
        for s in seed_trials:
            i = index.get(s)
            if i is None:
                specs.append(s)
                i = index[s] = len(specs) - 1
            ids.append(i)
        alive_ids = sorted(set(ids))

    ctx = {
        "X_tr": X_tr, "y_tr": y_tr, "X_val": X_val, "y_val": y_val,
        "y_tr_t": torch.as_tensor(y_tr, dtype=torch.int64, device=dev),
        "y_val_t": torch.as_tensor(y_val, dtype=torch.int64, device=dev),
        "n_classes": len(classes), "seed": config.seed, "device": dev,
        "budget_active": config.time_budget_s is not None,
        "pipe_cache": {},      # loop backend: (preproc, frac) -> projected data
        "variant_cache": {},   # batched backend: (preproc, frac) -> full-width variant
        "init_provider": init_provider,
    }
    return SearchState(config=config, classes=classes, ctx=ctx, specs=specs,
                       alive_ids=alive_ids, t_start=t_start,
                       trial_rung={i: 0 for i in alive_ids})


def search_cohort(state: SearchState):
    """Current rung's work unit: ``(cohort, tids, epochs, collect_params)``."""
    config = state.config
    cohort = [state.specs[i] for i in state.alive_ids]
    collect = (state.rung_i == len(config.rungs) - 1
               or config.time_budget_s is not None)
    return cohort, list(state.alive_ids), int(config.rungs[state.rung_i]), collect


class TrialCohort(NamedTuple):
    """One job's current rung as a uniform, mergeable unit of trial work
    (DESIGN.md §12.3, §13): same-shaped cohorts merge exactly,
    differently-shaped ones through maximal-shape padding
    (``batched.eval_rung_cohorts``), cohorts at different rungs through
    per-trial step masks (``batched.eval_trial_megabatch``).

    ``rungs``/``steps`` carry each trial's rung cursor and epoch budget
    (from ``SearchState.trial_rung``); the scalar ``rung_i``/``epochs`` are
    the uniform-rung view."""
    specs: list            # PipelineSpec per live trial
    tids: list             # trial ids (generator derivation)
    rung_i: int
    epochs: int
    collect: bool          # params wanted (final rung / budget active)
    ctx: dict              # the SearchState evaluation context
    rungs: tuple = ()      # per-trial rung cursors (§13.2)
    steps: tuple = ()      # per-trial epoch budgets at those cursors

    @property
    def shape(self):
        """(N_tr, N_val, d, n_classes) — the merge-compatibility axes."""
        return (self.ctx["X_tr"].shape[0], self.ctx["X_val"].shape[0],
                self.ctx["X_tr"].shape[1], self.ctx["n_classes"])

    @property
    def trial_rungs(self):
        """Per-trial rungs, defaulting to the uniform ``rung_i``."""
        return self.rungs if self.rungs else (self.rung_i,) * len(self.specs)

    @property
    def trial_steps(self):
        """Per-trial step budgets, defaulting to the uniform ``epochs``."""
        return self.steps if self.steps else (self.epochs,) * len(self.specs)


def search_trial_cohort(state: SearchState) -> TrialCohort:
    """The current rung of ``state`` as a ``TrialCohort``."""
    cohort, tids, epochs, collect = search_cohort(state)
    rungs = tuple(state.trial_rung.get(t, state.rung_i) for t in tids)
    steps = tuple(int(state.config.rungs[r]) for r in rungs)
    return TrialCohort(cohort, tids, state.rung_i, epochs, collect, state.ctx,
                       rungs, steps)


def params_to(params, device):
    """``params`` with every host numpy leaf a tensor on ``device``: params
    that crossed the wire come back as numpy.  Tensors, lazy thunks and
    None pass through."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    if isinstance(params, np.ndarray):
        return torch.as_tensor(params, device=device)
    return params


def search_record(state: SearchState, scored, positions, rung_time: float) -> None:
    """Record one evaluated rung: log trials, promote survivors, advance."""
    config = state.config
    state.rung_times.append(rung_time)
    state.trials_log.extend((s, v) for (s, v, *_rest) in scored)
    state.n_done += len(scored)
    state.live = scored
    mask = sh_promote(np.asarray([v for (_s, v, *_r) in scored], np.float32),
                      config.keep_frac)
    surv = list(np.flatnonzero(mask))
    if config.time_budget_s is not None:
        surv.sort(key=lambda i: (-scored[i][1], i))
    state.alive_ids = [state.alive_ids[positions[i]] for i in surv]
    state.rung_i += 1
    for tid in state.alive_ids:        # survivors' cursors advance
        state.trial_rung[tid] = state.rung_i
    if state.out_of_budget():
        state.stopped = True


def search_result(state: SearchState, X_test: Optional[np.ndarray] = None,
                  y_test: Optional[np.ndarray] = None) -> AutoMLResult:
    """Finalize: pick the accuracy-argmax of the last evaluated rung."""
    live = state.live
    best_i = int(np.argmax([v for (_s, v, *_r) in live]))  # ties -> lower index
    best_spec, best_vacc, best_params, best_fidx, best_stats = live[best_i]
    if callable(best_params):   # the batched backend unpads params lazily
        best_params = best_params()
    # a rung evaluated in another process (or restored) brings host arrays
    dev = state.ctx["device"]
    best_params = params_to(best_params, dev)
    test_acc = None
    if X_test is not None:
        Xt = apply_pipeline(best_spec, best_stats, best_fidx,
                            np.asarray(X_test, np.float32), dev)
        yt = torch.as_tensor(np.searchsorted(state.classes, np.asarray(y_test)),
                             dtype=torch.int64, device=dev)
        test_acc = accuracy(best_params, Xt, yt, best_spec.family)
    return AutoMLResult(
        spec=best_spec, params=best_params, val_acc=float(best_vacc), test_acc=test_acc,
        time_s=time.perf_counter() - state.t_start, n_trials=state.n_done,
        feat_idx=best_fidx, pre_stats=best_stats, trials=state.trials_log,
        rung_times=state.rung_times, backend=state.config.backend,
    )


# context keys that cross process boundaries; the device, its label mirrors,
# the test seam and the per-backend caches are rebuilt on restore
_CTX_SNAPSHOT_KEYS = ("X_tr", "y_tr", "X_val", "y_val", "n_classes", "seed",
                      "budget_active")


def _materialize_scored(scored):
    """Resolve the batched backend's lazy param thunks so a scored rung can
    cross a process boundary (DESIGN.md §14.2)."""
    out = []
    for spec, vacc, params, fidx, stats in scored:
        if callable(params):
            params = params()
        out.append((spec, float(vacc), params, fidx, stats))
    return out


def search_snapshot(state: SearchState) -> dict:
    """A wire-serializable snapshot of one search (DESIGN.md §14.4).

    Captures the config, the sampled population and survivor cursors, the
    trial log and the raw evaluation data.  The device, its label mirrors
    and the pipe/variant caches are dropped and rebuilt by
    ``search_restore``; lazy param thunks in the last scored rung are
    materialized.  A search with an ``init_provider`` (the tests' seam, a
    callable) cannot be snapshotted."""
    from ..service.wire import WireError
    ctx = state.ctx
    if ctx["init_provider"] is not None:
        raise WireError("search_snapshot: a search with an init_provider (a "
                        "callable) is not wire-serializable")
    return {
        "config": state.config,
        "classes": np.asarray(state.classes),
        "specs": list(state.specs),
        "alive_ids": [int(i) for i in state.alive_ids],
        "rung_i": int(state.rung_i),
        "live": _materialize_scored(state.live),
        "trials_log": [(s, float(v)) for s, v in state.trials_log],
        "rung_times": [float(t) for t in state.rung_times],
        "n_done": int(state.n_done),
        "stopped": bool(state.stopped),
        "trial_rung": {int(k): int(v) for k, v in state.trial_rung.items()},
        "elapsed_s": time.perf_counter() - state.t_start,
        "ctx": {k: ctx[k] for k in _CTX_SNAPSHOT_KEYS},
    }


def restore_ctx(shipped: dict, device: DeviceLike = None) -> dict:
    """An evaluation context rebuilt on ``device`` (default CUDA) from its
    shipped keys (``_CTX_SNAPSHOT_KEYS``): the device, its label mirrors,
    the test seam and empty caches."""
    dev = resolve_device(device)
    ctx = dict(shipped)
    ctx["X_tr"] = np.asarray(ctx["X_tr"], np.float32)
    ctx["X_val"] = np.asarray(ctx["X_val"], np.float32)
    ctx["y_tr"] = np.asarray(ctx["y_tr"])
    ctx["y_val"] = np.asarray(ctx["y_val"])
    ctx["y_tr_t"] = torch.as_tensor(ctx["y_tr"], dtype=torch.int64, device=dev)
    ctx["y_val_t"] = torch.as_tensor(ctx["y_val"], dtype=torch.int64, device=dev)
    ctx["n_classes"] = int(ctx["n_classes"])
    ctx["seed"] = int(ctx["seed"])
    ctx["device"] = dev
    ctx["budget_active"] = bool(ctx["budget_active"])
    ctx["pipe_cache"] = {}
    ctx["variant_cache"] = {}
    ctx["init_provider"] = None
    return ctx


def search_restore(snap: dict, device: DeviceLike = None) -> SearchState:
    """Rebuild a ``SearchState`` from a ``search_snapshot`` payload on
    ``device`` (default CUDA).

    The restored search continues from the rung boundary the snapshot
    captured; finishing it gives the uninterrupted run's winner and trial
    accuracies (tested across a process boundary in
    ``tests/test_torch_wire.py``)."""
    ctx = restore_ctx(snap["ctx"], device)
    return SearchState(
        config=snap["config"],
        classes=np.asarray(snap["classes"]),
        ctx=ctx,
        specs=list(snap["specs"]),
        alive_ids=[int(i) for i in snap["alive_ids"]],
        t_start=time.perf_counter() - float(snap["elapsed_s"]),
        rung_i=int(snap["rung_i"]),
        live=[tuple(t) for t in snap["live"]],
        trials_log=[tuple(t) for t in snap["trials_log"]],
        rung_times=list(snap["rung_times"]),
        n_done=int(snap["n_done"]),
        stopped=bool(snap["stopped"]),
        trial_rung={int(k): int(v) for k, v in snap["trial_rung"].items()},
    )


def search_eval_rung(state: SearchState):
    """Evaluate the current rung in-process, through the configured
    backend, and record it.  An ``automl.rung`` span (attr ``rung``)
    covers the evaluation; its extent is the rung's time."""
    _eval_rung = get_backend(state.config.backend)
    cohort, tids, epochs, collect = search_cohort(state)
    with _trace.span(None, None, "automl.rung", rung=state.rung_i) as sp:
        scored, positions = _eval_rung(cohort, tids, state.rung_i, epochs, state.ctx,
                                       state.out_of_budget, collect)
    search_record(state, scored, positions, sp["t1"] - sp["t0"])


def automl_fit(
    X: np.ndarray,
    y: np.ndarray,
    *,
    config: AutoMLConfig = AutoMLConfig(),
    restrict_family: Optional[str] = None,
    X_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    init_provider: Optional[Callable] = None,
) -> AutoMLResult:
    """Run the AutoML search on ``device`` (default CUDA).  Returns the best
    pipeline found.  ``restrict_family`` implements the paper's restricted
    fine-tune pass; ``init_provider`` is the tests' seam (module docstring).

    The search's spans (``automl.init`` around ``search_init``, an
    ``automl.rung`` a rung with the backend's spans inside, ``automl.result``
    around ``search_result``; ``obs/trace``) go to
    ``AutoMLResult.spans`` and, when the caller collects spans, to the
    caller's sink too, under its trace; a bare call is a trace of its own."""
    spans: List[dict] = []
    with _trace.collect(spans):
        with _trace.span(None, None, "automl.init"):
            state = search_init(X, y, config=config, restrict_family=restrict_family,
                                device=device, init_provider=init_provider)
        # successive halving over epoch rungs: each rung retrains the surviving
        # cohort from scratch at the next epoch budget (DESIGN.md §10.2)
        while not state.done:
            search_eval_rung(state)
        with _trace.span(None, None, "automl.result"):
            res = search_result(state, X_test, y_test)
    res.spans = spans
    return res

"""Multi-tenant SubStrat job scheduler (DESIGN.md §11.3, §12.4).

Turns the plan-based pipeline (``core/plan.py``) into a cooperative job
queue.  Every job carries a declarative ``Plan`` — legacy
``SubStratConfig`` submissions are converted on admission — and moves
through explicit resumable phases::

    factorize  ─►  dst  ─►  sub_automl  ─►  fine_tune  ─►  done
        │  cache hit │           │              ▲
        │            └► warm_wait ──────────────┤
        │  (known winner family) ───────────────┘
        └────────────────────────────────────────

A cache hit skips ``dst``; if the entry already names the sub-AutoML winner
family, the job warm-starts straight into ``fine_tune``.  If the family is
not yet known but another in-flight job on the same cache key is about to
produce it, the repeat parks in ``warm_wait`` instead of duplicating the
sub-AutoML pass (in-flight dedup) and un-parks the moment the leader
publishes its winner — falling back to running the pass itself if every
leader disappears.

``step()`` advances every active job by exactly one unit of work — one
phase transition, or one successive-halving rung of its current AutoML
search.  Work merges across jobs at two layers:

- **dst**: concurrent cache-miss jobs whose plans name the same *batchable*
  strategy (``StrategySpec.batch_fn`` — Gen-DST and its island variant) on
  same-shaped datasets run their searches in one batched dispatch
  (``gen_dst_batch``), bit-identical per search to solo execution.
- **sub_automl / fine_tune**: ready rung cohorts pack into one standing
  **megabatch** per step — continuous rung batching (DESIGN.md §13).  A
  cohort joins the dispatch at *any* rung: each trial carries its own rung
  cursor and epoch budget into the batched engine
  (``batched.eval_trial_megabatch``), which runs shorter trials as
  step-masked passengers of the longest scan.  Admission is governed by a
  single **waste budget**: a group is packed only while its padded compute
  (every trial priced at the group-maximal rows × features × classes ×
  steps) stays within ``waste_budget``× the useful compute
  (``merge_waste``) — one policy across row, class, *and* step padding.
  Same-shaped cohorts merge exactly regardless of rung (bit-identical per
  trial — §13.3); differently-shaped ones merge through maximal-shape
  padding with row/class masks (§12.3) when ``hetero_merge`` is on.
  ``megabatch=False`` restores lockstep ``(rung_i, epochs)`` bucketing.
  Merged wall time is attributed to participants in equal shares.

The DST cache keys on the plan's subset identity —
``(fingerprint, n, m, measure, (strategy, strategy_opts))`` — so *every*
registered cacheable strategy (all the paper baselines, the ASP proxy
scorer) is cached and warm-started exactly like Gen-DST.  Jobs with a bare
callable strategy (the deprecated ``dst_fn``) bypass the cache.

Beyond the exact-fingerprint cache, the scheduler meta-learns across
tenants (DESIGN.md §17): every sub-AutoML rung feeds the
``meta.ExperienceStore`` (fingerprint × trial spec → rung accuracies), and
once enough *distinct* datasets have finished (``warm_min_history``), a new
job's sub pass is seeded with the greedy submodular portfolio built from
the k-NN meta-feature slice of that history — fewer rung-0 trials, each
bit-identical to its cold-run counterpart (the portfolio filters the
deterministically sampled population, preserving trial ids).  Cold starts
and ``Plan(warm_start=False)`` jobs run the unchanged full population.

The port of the JAX package's ``service/scheduler.py``.  One scheduler runs
every job on one device (``device=``, CUDA by default, raising without a
card); ``transport.DistributedScheduler`` ships its rung dispatches to
worker processes through the ``_eval_groups`` hook.  A job carries an int ``seed`` where the
reference carries a key: its strategy draws from ``make_generator(seed,
device)`` and its subset patch from ``make_generator(seed ^ 0x5AB5)``, as
``core/plan.execute`` draws them, so a job served alone equals ``execute``
on the same seed and device.  Each span's seconds end with its phase's
results on the host.  ``snapshot``/``load_snapshot`` carry the whole
scheduler through the wire format with ``seed`` in place of the reference's
key; a loaded snapshot's tables, searches and models go to this scheduler's
device.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..automl.engine import (
    SearchState, params_to, search_eval_rung, search_init, search_record,
    search_restore, search_result, search_snapshot, search_trial_cohort,
)
from ..core.measures import CodedDataset, factorize, host_codes
from ..core.plan import Plan, plan_from_config
from ..core.strategies import run_strategy, run_strategy_batch
from ..core.substrat import (
    SubStratConfig, SubStratResult, build_subset, dst_feature_columns,
    nf_test_eval,
)
from ..meta import (
    ExperienceStore, meta_features, portfolio_coverage, portfolio_for,
)
from ..device import DeviceLike, make_generator, resolve_device
from ..obs import torchprof, trace
from ..obs.metrics import MetricsRegistry
from .cache import DSTCache, DSTCacheEntry, dst_cache_key
from .fingerprint import dataset_fingerprint

__all__ = ["CohortMeta", "Scheduler", "SubStratJob", "PHASES",
           "merge_waste", "pack_megabatches"]

PHASES = ("factorize", "dst", "warm_wait", "sub_automl", "fine_tune",
          "done", "failed")

# times-dict key per AutoML phase (matches substrat()'s per-phase keys)
_PHASE_TIME_KEY = {"sub_automl": "automl_sub_s", "fine_tune": "fine_tune_s"}


def _plan_measure(plan: Plan) -> str:
    """The preserved measure named by a plan's strategy options (the
    ``measure`` field of a GenDSTConfig ``cfg`` option), defaulting to the
    paper's entropy measure every baseline targets."""
    for k, v in plan.strategy_opts:
        if k == "cfg" and hasattr(v, "measure"):
            return v.measure
        if k == "measure":
            return v
    return "entropy"


# ---------------------------------------------------------------------------
# megabatch packing policy (DESIGN.md §13.2) — pure, host-side, testable
# ---------------------------------------------------------------------------


class CohortMeta(NamedTuple):
    """The packing-relevant summary of one ready rung cohort."""
    shape: Tuple[int, int, int, int]   # (N_tr, N_val, d, n_classes)
    steps: Tuple[int, ...]             # per-trial epoch budgets this rung


def _padded_unit(metas: Sequence[CohortMeta]) -> float:
    """Per-trial padded cost under the group-maximal shape and scan length:
    ``(steps_max · Ntr_max + Nval_max) · d_max · c_max``.  Train cost scales
    with steps; the fused validation eval is one pass."""
    ntr = max(m.shape[0] for m in metas)
    nval = max(m.shape[1] for m in metas)
    d = max(m.shape[2] for m in metas)
    c = max(m.shape[3] for m in metas)
    smax = max(max(m.steps) for m in metas)
    return float((smax * ntr + nval) * d * c)


def merge_waste(metas: Sequence[CohortMeta]) -> float:
    """Padded-to-useful compute ratio of merging ``metas`` into one dispatch.

    Every trial in the merged dispatch costs the group-maximal padded unit;
    its useful compute is its *own* ``(steps·N_tr + N_val)·d·c``.  The ratio
    is a single waste measure across all padding axes — rows, features,
    classes, *and* scan steps — so a cohort narrow in rows but wide in
    classes (or short in steps) is priced correctly.
    A singleton uniform cohort scores exactly 1.0."""
    total = sum(len(m.steps) for m in metas) * _padded_unit(metas)
    useful = sum((st * m.shape[0] + m.shape[1]) * m.shape[2] * m.shape[3]
                 for m in metas for st in m.steps)
    return total / useful


def pack_megabatches(metas: Sequence[CohortMeta], waste_budget: float,
                     same_shape_only: bool = False) -> List[List[int]]:
    """Pack ready cohorts into megabatch groups under the waste budget.

    Deterministic first-fit-decreasing: cohorts are visited in descending
    per-cohort padded cost (stable on input order), and each joins the first
    group whose combined ``merge_waste`` stays ``<= waste_budget`` — big
    cohorts seed groups, small ones ride along only where the padding they
    would absorb is paid for by the dispatches they save.
    ``same_shape_only`` (the ``hetero_merge=False`` regime) additionally
    requires exact data-shape equality, so every group stays a bit-identical
    merge regardless of rung mix.  Returns groups of indices into ``metas``;
    every index appears in exactly one group (singletons allowed — a lone
    cohort always fits its own group)."""
    order = sorted(range(len(metas)),
                   key=lambda i: (-_padded_unit([metas[i]]), i))
    groups: List[List[int]] = []
    for i in order:
        placed = False
        for g in groups:
            if same_shape_only and metas[g[0]].shape != metas[i].shape:
                continue
            if merge_waste([metas[j] for j in g + [i]]) <= waste_budget:
                g.append(i)
                placed = True
                break
        if not placed:
            groups.append([i])
    for g in groups:
        g.sort()   # job order within a dispatch follows submission order
    return groups


@dataclasses.dataclass
class SubStratJob:
    """One submitted SubStrat run and its phase state."""
    job_id: int
    tenant: str
    X: np.ndarray
    y: np.ndarray
    seed: int
    plan: Plan
    coded: Optional[CodedDataset] = None   # on the scheduler's device once factorized
    X_test: Optional[np.ndarray] = None
    y_test: Optional[np.ndarray] = None

    phase: str = "factorize"
    times: Dict[str, float] = dataclasses.field(default_factory=dict)
    cache_hit: bool = False
    warm_family: Optional[str] = None      # cache-known winner (skips sub pass)
    fingerprint: Optional[str] = None
    cache_key: Optional[tuple] = None
    row_idx: Optional[np.ndarray] = None
    col_mask: Optional[np.ndarray] = None
    col_idx: Optional[np.ndarray] = None
    dst_fitness: Optional[float] = None
    y_sub: Optional[np.ndarray] = None     # NF test eval needs the subset labels
    search: Optional[SearchState] = None   # current AutoML pass, rung-resumable
    intermediate: Optional[object] = None  # AutoMLResult M'
    final: Optional[object] = None         # AutoMLResult M_sub
    result: Optional[SubStratResult] = None
    error: Optional[BaseException] = None
    # streamed partial results: one entry per recorded rung (DESIGN.md §14.4)
    leaderboard: List[dict] = dataclasses.field(default_factory=list)
    # observability (DESIGN.md §15.1): deterministic per-job trace id and
    # the closed span records of every phase/rung/dispatch the job touched
    trace_id: str = ""
    spans: List[dict] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.phase not in ("done", "failed")

    @property
    def cost_s(self) -> float:
        return sum(self.times.values())

    @property
    def strategy_name(self) -> str:
        s = self.plan.strategy
        return s if isinstance(s, str) else getattr(s, "__name__", "<callable>")


class Scheduler:
    """Cooperative multi-job scheduler with DST caching and rung merging,
    running every job on ``device`` (default CUDA)."""

    def __init__(self, cache: Optional[DSTCache] = None, *,
                 warm_start: bool = True, hetero_merge: bool = True,
                 megabatch: bool = True, waste_budget: float = 4.0,
                 batch_dst: bool = False,
                 experience: Optional[ExperienceStore] = None,
                 warm_min_history: int = 3, portfolio_k: int = 6,
                 portfolio_knn: int = 4, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else DSTCache()
        self.warm_start = warm_start
        # cross-tenant meta-learning (DESIGN.md §17): served-job history and
        # the portfolio warm-start policy built from it.  warm_start=False
        # disables feeding and seeding alike (the pre-§17 scheduler).
        self.experience = (experience if experience is not None
                           else ExperienceStore())
        self.warm_min_history = warm_min_history
        self.portfolio_k = portfolio_k
        self.portfolio_knn = portfolio_knn
        self.hetero_merge = hetero_merge
        # continuous rung batching (DESIGN.md §13): one standing cross-rung
        # dispatch per step instead of lockstep (rung_i, epochs) buckets
        self.megabatch = megabatch
        self.waste_budget = waste_budget
        # run same-shaped concurrent cache-miss searches as one
        # (gen_dst_batch).  Bit-identical per search; a device-utilization
        # play, opt-in as in the reference.
        self.batch_dst = batch_dst
        self.jobs: Dict[int, SubStratJob] = {}
        self._next_id = 0
        self.merged_rungs = 0   # merged dispatches issued
        self.merged_jobs = 0    # job-rungs that rode a merged dispatch
        self.hetero_rungs = 0   # merged dispatches that needed shape padding
        self.mixed_rungs = 0    # merged dispatches spanning >1 (rung, epochs)
        self.solo_rungs = 0     # rungs evaluated per-job
        self.merged_dst = 0     # subset searches that rode a batched dispatch
        self.poisoned_packs = 0  # failed packs re-run solo to isolate blame
        self.metrics = MetricsRegistry()
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Register the scheduler's metric families — get-or-create, so a
        call after ``metrics.load_state`` re-attaches the ``m_*`` handles to
        the restored families (DESIGN.md §15.3).  Subclasses extend, never
        replace."""
        m = self.metrics
        self.m_dispatches = m.counter(
            "dispatches_total", "rung dispatches by execution mode", ("mode",))
        self.m_dispatch_latency = m.histogram(
            "dispatch_latency_seconds",
            "wall seconds of one rung dispatch (merged: whole group)",
            ("mode",))
        self.m_cache_hits = m.counter(
            "cache_hits_total", "DST cache hits at job admission/re-probe")
        self.m_cache_misses = m.counter(
            "cache_misses_total", "cacheable jobs admitted without an entry")
        self.m_poisoned = m.counter(
            "poisoned_packs_total",
            "failed packed dispatches re-run solo to isolate blame")
        self.m_jobs_finished = m.counter(
            "jobs_finished_total", "jobs reaching a terminal phase",
            ("phase",))
        self.m_pack_waste = m.gauge(
            "pack_waste_ratio",
            "merge_waste (padded/useful compute) of the newest megabatch "
            "group")
        self.m_padded_flops = m.counter(
            "pack_padded_flops_total",
            "analytic FLOPs packed dispatches actually execute (padded "
            "shapes/steps)")
        self.m_useful_flops = m.counter(
            "pack_useful_flops_total",
            "analytic FLOPs the packed trials needed at their own "
            "shapes/steps")
        self.m_portfolio_hits = m.counter(
            "portfolio_hits_total",
            "sub-AutoML passes seeded from the experience-store portfolio")
        self.m_portfolio_seeded = m.counter(
            "portfolio_seeded_trials_total",
            "rung-0 trials seeded by portfolio warm-starts")
        self.m_portfolio_saved = m.counter(
            "portfolio_trials_saved_total",
            "rung-0 trials a warm-started pass skipped vs its cold "
            "population")
        self.m_portfolio_coverage = m.gauge(
            "portfolio_coverage",
            "covered-dataset best-accuracy F(P) of the newest portfolio")
        self.m_experience_datasets = m.gauge(
            "experience_datasets",
            "distinct trained fingerprints in the experience store")

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        *,
        tenant: str = "default",
        seed: int = 0,
        plan: Optional[Plan] = None,
        config: Optional[SubStratConfig] = None,
        dst_fn: Optional[Callable] = None,
        coded: Optional[CodedDataset] = None,
        X_test: Optional[np.ndarray] = None,
        y_test: Optional[np.ndarray] = None,
    ) -> int:
        """Admit a job; returns its id.  No work happens until ``step()``.

        ``plan`` is the native submission payload; ``config`` (+ the
        deprecated ``dst_fn``) is converted via ``plan_from_config`` for
        legacy call sites and produces identical execution.  ``seed`` seeds
        the job's strategy generator and subset patch, as
        ``execute(seed=)`` does."""
        if dst_fn is not None:
            warnings.warn(
                "submit(dst_fn=...) is deprecated; pass the generator as a "
                "Plan strategy (plan(my_fn, ...)) or register it via "
                "repro_torch.core.strategies.register_strategy",
                DeprecationWarning, stacklevel=2)
        if plan is None:
            plan = plan_from_config(config or SubStratConfig(), dst_fn)
        elif config is not None or dst_fn is not None:
            raise ValueError("pass either plan= or config=/dst_fn=, not both")
        job = SubStratJob(
            job_id=self._next_id, tenant=tenant, X=X, y=y, seed=int(seed),
            plan=plan, coded=coded, X_test=X_test, y_test=y_test,
            trace_id=trace.job_trace_id(self._next_id),
        )
        self.jobs[job.job_id] = job
        self._next_id += 1
        return job.job_id

    def pending(self) -> List[SubStratJob]:
        return [j for j in self.jobs.values() if j.active]

    # -- phase work ---------------------------------------------------------

    def _job_time_span(self, job: SubStratJob, name: str, key: str,
                       w0: float, seconds: float, **attrs) -> None:
        """Record one closed span on the job's trace AND fold its cost into
        ``job.times[key]`` — the span record is the phase-time bookkeeping
        (DESIGN.md §15.1), not a parallel ledger.  ``seconds`` may be an
        attributed equal share of a merged dispatch rather than the span's
        own wall extent; the span keeps both (extent in t0/t1, share in
        attrs)."""
        job.spans.append(trace.make_span(
            job.trace_id, name, w0, time.time(),
            attrs={"seconds": float(seconds), **attrs}))
        job.times[key] = job.times.get(key, 0.0) + float(seconds)

    def _fold_task_spans(self, group: Sequence[SubStratJob],
                         spans: Sequence[dict]) -> None:
        """Copy one remote dispatch's transport/worker spans onto every
        participating job's trace.  The copies are re-tagged with the job's
        trace id for single-timeline rendering; span/parent ids are stored
        explicitly in each record, so the dispatch→queue_wait→eval tree
        survives the re-tag intact."""
        for job in group:
            for sp in spans:
                cp = dict(sp)
                cp["trace_id"] = job.trace_id
                cp["attrs"] = dict(sp["attrs"])
                job.spans.append(cp)

    def _factorize(self, job: SubStratJob) -> None:
        t0 = time.perf_counter()
        w0 = time.time()
        # factorize on the scheduler's device; the fingerprint and the
        # meta-features read the codes on the host, one packed
        # device-to-host copy of them (free on the CPU)
        if job.coded is None:
            job.coded = factorize(job.X, job.y, device=self.device)
        else:
            job.coded = job.coded.to(self.device)
        codes, n_bins = host_codes(job.coded)
        host = job.coded._replace(codes=torch.from_numpy(codes),
                                  n_bins=torch.from_numpy(n_bins))
        job.fingerprint = dataset_fingerprint(host)
        if self.warm_start:
            # register the dataset's meta-feature vector (host work on the
            # same host codes)
            self.experience.note_meta(job.fingerprint, meta_features(host))
        self._job_time_span(job, "factorize", "factorize_s", w0,
                            time.perf_counter() - t0, phase="factorize")

        # the cache key is the plan's resolved subset identity — the actual
        # search problem, not the (possibly None) plan fields
        if job.plan.cacheable:
            n, m, strategy, opts = job.plan.subset_identity(job.coded)
            job.cache_key = dst_cache_key(
                job.fingerprint, n, m, _plan_measure(job.plan),
                search_cfg=(strategy, opts))

        if not self._try_cache_hit(job):
            if job.cache_key is not None:
                self.m_cache_misses.inc()
            job.phase = "dst"

    def _try_cache_hit(self, job: SubStratJob) -> bool:
        """Probe the DST cache; on a hit, install the stored subset and
        advance the job past the subset search (and, when warm-startable,
        past the sub-AutoML pass)."""
        t0 = time.perf_counter()
        w0 = time.time()
        entry = self.cache.get(job.cache_key) if job.cache_key else None
        if entry is None:
            return False
        # cache hit: the stored subset replaces the whole strategy search;
        # gen_dst_s records what the hit actually cost (the lookup)
        job.cache_hit = True
        self.m_cache_hits.inc()
        self._install_subset(job, entry.row_idx, entry.col_mask, entry.fitness)
        self._job_time_span(job, "cache_probe", "gen_dst_s", w0,
                            time.perf_counter() - t0, cache_hit=True)
        if self.warm_start and job.plan.fine_tune and entry.winner_family:
            job.warm_family = entry.winner_family
            job.phase = "fine_tune"
        elif (self.warm_start and job.plan.fine_tune
              and self._family_leader(job) is not None):
            # a concurrent job on the same cache key is already running the
            # sub-AutoML pass: wait for its winner family instead of
            # duplicating the pass (in-flight dedup; resolves in step())
            job.phase = "warm_wait"
        else:
            job.phase = "sub_automl"
        return True

    def _install_subset(self, job: SubStratJob, row_idx, col_mask,
                        fitness) -> None:
        job.row_idx, job.col_mask = row_idx, col_mask
        job.dst_fitness = fitness
        job.col_idx = dst_feature_columns(col_mask, job.coded.target_col)

    def _family_leader(self, job: SubStratJob) -> Optional[SubStratJob]:
        """An active job on the same cache key whose sub-AutoML pass will
        publish the winner family this job could warm-start from."""
        for other in self.jobs.values():
            if (other is not job and other.active
                    and other.cache_key == job.cache_key
                    and other.phase in ("dst", "sub_automl")):
                return other
        return None

    def _advance_waiters(self) -> bool:
        """Resolve warm-wait jobs: warm-start once the family is published,
        or fall back to running the sub pass if every leader is gone."""
        worked = False
        for job in self.pending():
            if job.phase != "warm_wait":
                continue
            entry = (self.cache.peek(job.cache_key)
                     if job.cache_key is not None else None)
            if entry is not None and entry.winner_family:
                job.warm_family = entry.winner_family
                job.phase = "fine_tune"
                worked = True
            elif self._family_leader(job) is None:
                job.phase = "sub_automl"   # leader failed/evicted: run it
                worked = True
        return worked

    # -- subset search: batched where the strategy allows -------------------

    def _reprobe(self, job: SubStratJob) -> bool:
        """Re-probe the cache before searching: a same-identity job earlier
        in the queue may have inserted the entry since this job's admission
        probe (concurrent duplicate submissions coalesce onto one search);
        peek first so an absent entry doesn't count a second miss."""
        return (job.cache_key is not None
                and self.cache.peek(job.cache_key) is not None
                and self._try_cache_hit(job))

    def _record_subset(self, job: SubStratJob, subset, elapsed: float) -> None:
        self._install_subset(job, subset.row_idx, subset.col_mask,
                             subset.fitness)
        # the span's extent approximates the dispatch window (batched
        # searches hand each rep its equal share, not its own wall clock)
        self._job_time_span(job, "gen_dst", "gen_dst_s",
                            time.time() - elapsed, elapsed,
                            phase="dst", strategy=job.strategy_name)
        if job.cache_key is not None:
            self.cache.put(job.cache_key, DSTCacheEntry(
                row_idx=job.row_idx, col_mask=job.col_mask,
                fitness=job.dst_fitness, cost_s=elapsed))
        job.phase = "sub_automl"

    def _dst(self, job: SubStratJob) -> bool:
        """Search one job's subset alone; False where a re-probe of the
        cache made the search unnecessary.  A failed search fails its job
        and counts as searched."""
        try:
            if self._reprobe(job):
                return False
            p = job.plan
            t0 = time.perf_counter()
            subset = run_strategy(p.strategy, make_generator(job.seed, self.device),
                                  job.coded, p.n, p.m, p.strategy_opts)
            self._record_subset(job, subset, time.perf_counter() - t0)
        except Exception as e:   # noqa: BLE001 — isolate job failures
            self._fail(job, e)
        return True

    def _dst_batch_key(self, job: SubStratJob):
        """Hashable batch-compatibility class of a job's subset search, or
        None if the search must run solo (callable strategy, no batch_fn,
        or nothing to share)."""
        p = job.plan
        if not p.batchable:
            return None
        n, m, strategy, opts = p.subset_identity(job.coded)
        return (strategy, opts, n, m, tuple(job.coded.codes.shape),
                job.coded.max_bins, job.coded.target_col)

    def _dispatch_dst(self, jobs: List[SubStratJob]) -> None:
        """Run the queue's pending subset searches: group batchable jobs by
        strategy/shape compatibility into one batched dispatch each
        (identical-cache-key duplicates coalesce onto one search slot),
        everything else solo.

        Inside an ``obs.trace.collect`` one ``sched.dst`` span covers the
        dispatch (nothing is recorded outside one): ``searches`` counts the
        subset searches it ran, ``batched`` those that ran in a batched
        dispatch (``merged_dst``'s increment)."""
        with trace.span(None, None, "sched.dst", searches=0, batched=0) as sp:
            self._dispatch_dst_groups(jobs, sp["attrs"])

    def _dispatch_dst_groups(self, jobs: List[SubStratJob], counts: dict) -> None:
        groups: Dict[object, List[SubStratJob]] = {}
        solo: List[SubStratJob] = []
        for job in jobs:
            if self._reprobe(job):
                continue
            bkey = self._dst_batch_key(job) if self.batch_dst else None
            if bkey is None:
                solo.append(job)
            else:
                groups.setdefault(bkey, []).append(job)

        for job in solo:
            counts["searches"] += self._dst(job)

        for bkey, group in groups.items():
            # duplicate submissions (same cache key) share one search slot
            reps: List[SubStratJob] = []
            seen_keys = set()
            followers: List[SubStratJob] = []
            for job in group:
                if job.cache_key is not None and job.cache_key in seen_keys:
                    followers.append(job)
                else:
                    seen_keys.add(job.cache_key)
                    reps.append(job)
            if len(reps) == 1:
                counts["searches"] += self._dst(reps[0])
            else:
                strategy, opts, n, m = bkey[0], bkey[1], bkey[2], bkey[3]
                counts["searches"] += len(reps)
                t0 = time.perf_counter()
                try:
                    subsets = run_strategy_batch(
                        strategy,
                        [make_generator(j.seed, self.device) for j in reps],
                        [j.coded for j in reps], n, m, opts)
                except Exception as e:   # noqa: BLE001
                    # fail the reps only: followers fall through to the
                    # solo retry below (a batch failure, e.g. OOM on the
                    # K-wide stacked tensors, need not doom a search that
                    # would succeed solo)
                    for job in reps:
                        self._fail(job, e)
                    subsets = []
                else:
                    self.merged_dst += len(reps)
                    counts["batched"] += len(reps)
                share = (time.perf_counter() - t0) / max(len(subsets), 1)
                for job, subset in zip(reps, subsets):
                    self._record_subset(job, subset, share)
            for job in followers:   # their rep just populated the cache;
                # a failed or uncacheable rep leaves them a solo search
                counts["searches"] += self._dst(job)

    # -- AutoML phases ------------------------------------------------------

    def _portfolio_seeds(self, job: SubStratJob):
        """The experience-store seed portfolio for a job's sub-AutoML pass,
        or None for the cold path (opted out, or not enough *other*
        datasets finished to meta-learn from)."""
        if not (self.warm_start and job.plan.warm_start
                and job.fingerprint is not None):
            return None
        store = self.experience
        exclude = {job.fingerprint}
        if store.n_trained(exclude) < self.warm_min_history:
            return None
        rec = store.records.get(job.fingerprint)
        feats = rec.features if rec is not None else None
        seeds = portfolio_for(store, feats, k=self.portfolio_k,
                              knn=self.portfolio_knn, exclude=exclude)
        if not seeds:
            return None
        self.m_portfolio_hits.inc()
        self.m_portfolio_seeded.inc(len(seeds))
        self.m_portfolio_coverage.set(
            portfolio_coverage(store.matrix(store.trained(exclude)), seeds))
        self.m_experience_datasets.set(store.n_trained())
        return seeds

    def _ensure_search(self, job: SubStratJob) -> None:
        if job.search is not None:
            return
        t0 = time.perf_counter()
        w0 = time.time()
        p = job.plan
        if job.phase == "sub_automl":
            X_sub, y_sub = build_subset(job.X, job.y, job.row_idx, job.col_idx,
                                        make_generator(job.seed ^ 0x5AB5))
            job.y_sub = y_sub
            seeds = self._portfolio_seeds(job)
            job.search = search_init(
                X_sub, y_sub, config=p.resolved_sub_automl(),
                seed_trials=seeds, device=self.device)
            if seeds:
                saved = len(job.search.specs) - len(job.search.alive_ids)
                if saved > 0:
                    self.m_portfolio_saved.inc(saved)
        else:   # fine_tune: restricted to M''s (or the cache-known) family
            family = job.warm_family or job.intermediate.spec.family
            job.search = search_init(
                job.X, job.y, config=p.resolved_ft_automl(),
                restrict_family=family, device=self.device)
        self._job_time_span(job, f"{job.phase}/init",
                            _PHASE_TIME_KEY[job.phase], w0,
                            time.perf_counter() - t0, phase=job.phase)

    def _finish_search(self, job: SubStratJob) -> None:
        if job.phase == "sub_automl":
            job.intermediate = search_result(job.search)
            job.search = None
            if job.cache_key is not None:
                self.cache.note_winner(job.cache_key,
                                       job.intermediate.spec.family)
            if self.warm_start and job.fingerprint is not None:
                # the fingerprint's history is now usable warm-start
                # material (trained() requires a winner)
                self.experience.note_winner(job.fingerprint,
                                            job.intermediate.spec)
                self.m_experience_datasets.set(self.experience.n_trained())
            if job.plan.fine_tune:
                job.phase = "fine_tune"
                return
            final = job.intermediate
            if job.X_test is not None:
                final = nf_test_eval(job.intermediate, job.y_sub, job.col_idx,
                                     job.X_test, job.y_test)
            job.final = final
        else:
            job.final = search_result(job.search, job.X_test, job.y_test)
            job.search = None
        self._complete(job)

    def _complete(self, job: SubStratJob) -> None:
        job.result = SubStratResult(
            final=job.final,
            # warm-started jobs skip the sub pass: intermediate is final
            intermediate=(job.intermediate if job.intermediate is not None
                          else job.final),
            row_idx=job.row_idx,
            col_idx=job.col_idx,
            dst_fitness=job.dst_fitness,
            times=dict(job.times),
            total_time_s=job.cost_s,
            strategy=job.strategy_name,
        )
        job.phase = "done"
        self.m_jobs_finished.inc(phase="done")
        self._release_data(job)

    def _fail(self, job: SubStratJob, error: BaseException) -> None:
        job.error, job.phase = error, "failed"
        self.m_jobs_finished.inc(phase="failed")
        self._release_data(job)

    @staticmethod
    def _release_data(job: SubStratJob) -> None:
        """Drop the finished job's dataset references, the coded table on
        the device and the search's device inputs with them: the job table
        is long-lived (poll/result/accounting) but must not pin every
        tenant's data in memory for the server's lifetime."""
        job.X = job.y = job.X_test = job.y_test = None
        job.coded = job.y_sub = job.search = None

    # -- rung dispatch: merged where compatible -----------------------------

    def _rung_key(self, job: SubStratJob):
        """Hashable ``(rung_i, epochs)`` merge bucket of a job's current
        rung, or None if the job must run solo (non-batched backend, or
        mid-rung time budget)."""
        st = job.search
        cfg = st.config
        if cfg.backend != "batched" or cfg.time_budget_s is not None:
            return None
        return (st.rung_i, int(cfg.rungs[st.rung_i]))

    def _plan_bucket(self, bucket: List[SubStratJob]):
        """Split one ``(rung_i, epochs)`` bucket into merged groups + solos
        (the lockstep ``megabatch=False`` regime).

        Same-shaped jobs merge exactly.  Differently-shaped jobs merge into
        one padded dispatch when ``hetero_merge`` is on and the bucket's
        aggregate ``merge_waste`` — one measure across row, feature, *and*
        class padding — stays within ``waste_budget``; otherwise each shape
        class merges separately."""
        cohorts = {id(job): search_trial_cohort(job.search) for job in bucket}
        by_shape: Dict[tuple, List[SubStratJob]] = {}
        for job in bucket:
            by_shape.setdefault(cohorts[id(job)].shape, []).append(job)
        if len(by_shape) > 1 and self.hetero_merge:
            metas = [CohortMeta(tc.shape, tc.trial_steps)
                     for tc in cohorts.values()]
            if merge_waste(metas) <= self.waste_budget:
                return [bucket], []
        merged, solo = [], []
        for group in by_shape.values():
            if len(group) > 1:
                merged.append(group)
            else:
                solo.append(group[0])
        return merged, solo

    def _note_rung(self, job: SubStratJob, top_k: int = 5) -> None:
        """Append a leaderboard entry for the rung just recorded — the
        streamed partial result ``poll(since=...)`` hands back rung by rung
        (DESIGN.md §14.4)."""
        st = job.search
        if st is None or not st.live:
            return
        if (job.phase == "sub_automl" and self.warm_start
                and job.fingerprint is not None):
            # feed the experience store: every scored trial of the rung just
            # recorded (rung_i already advanced past it)
            for spec, v, *_rest in st.live:
                self.experience.note_trial(job.fingerprint, spec,
                                           st.rung_i - 1, float(v))
        ranked = sorted(((float(v), i) for i, (s, v, *_) in enumerate(st.live)),
                        key=lambda t: -t[0])
        job.leaderboard.append({
            "phase": job.phase,
            "rung": st.rung_i - 1,          # rung_i already advanced past it
            "alive": len(st.alive_ids),
            "trials_done": st.n_done,
            "top": [{"family": st.live[i][0].family,
                     "preproc": st.live[i][0].preproc,
                     "feature_frac": float(st.live[i][0].feature_frac),
                     "val_acc": v}
                    for v, i in ranked[:top_k]],
        })

    def _record_group(self, group: List[SubStratJob], cohorts, outs,
                      share: float) -> None:
        """Record one successful dispatch: merge counters, per-job rung
        results, equal-share wall-time attribution, leaderboard entries."""
        if len(group) > 1:
            self.merged_rungs += 1
            self.merged_jobs += len(group)
            self.hetero_rungs += int(len({tc.shape for tc in cohorts}) > 1)
            self.mixed_rungs += int(
                len({(tc.rung_i, tc.epochs) for tc in cohorts}) > 1)
        else:
            self.solo_rungs += 1
        mode = "merged" if len(group) > 1 else "solo"
        wall = share * len(group)
        self.m_dispatches.inc(mode=mode)
        self.m_dispatch_latency.observe(wall, mode=mode)
        torchprof.dispatch_event("rung_dispatch", wall,
                               mode=mode, jobs=len(group))
        w0 = time.time() - wall   # the dispatch window just ended
        for job, (scored, positions) in zip(group, outs):
            search_record(job.search, scored, positions, share)
            rung = job.search.rung_i - 1   # search_record advanced past it
            self._job_time_span(job, f"{job.phase}/rung{rung}",
                                _PHASE_TIME_KEY[job.phase], w0, share,
                                phase=job.phase, rung=rung, mode=mode)
            self._note_rung(job)

    def _isolate_failure(self, group: List[SubStratJob], cohorts,
                         eval_fn, error: BaseException) -> None:
        """A failed packed dispatch must not doom its innocent co-riders:
        re-run each member solo so only the job(s) that actually fail alone
        are marked failed (the rest lose one dispatch, not their search)."""
        if len(group) == 1:
            self._fail(group[0], error)
            return
        self.poisoned_packs += 1
        self.m_poisoned.inc()
        for job, tc in zip(group, cohorts):
            self._run_merged([job], [tc], eval_fn)

    def _run_merged(self, group: List[SubStratJob], cohorts, eval_fn) -> None:
        """Dispatch one packed group through ``eval_fn`` and record every
        job's rung; merged wall time is shared equally by participants."""
        t0 = time.perf_counter()
        try:
            outs = eval_fn(cohorts)
        except Exception as e:   # noqa: BLE001 — isolate job failures
            self._isolate_failure(group, cohorts, eval_fn, e)
            return
        self._record_group(group, cohorts, outs,
                           (time.perf_counter() - t0) / len(group))

    def _eval_groups(self, packed, eval_fn) -> None:
        """Execute packed rung groups synchronously, in process.

        ``packed`` is ``[(jobs, cohorts), ...]``."""
        for group, cohorts in packed:
            self._run_merged(group, cohorts, eval_fn)

    def _dispatch_rungs(self, ready: List[SubStratJob]) -> None:
        """Evaluate the ready jobs' current rungs: megabatches, lockstep
        merges and solo rungs.

        Inside an ``obs.trace.collect`` one ``sched.rungs`` span covers the
        dispatch (nothing is recorded outside one): ``jobs``, the ready
        jobs; ``dispatches``, the dispatches planned for them (merged groups
        plus solo rungs; a failed pack's solo re-runs are not counted);
        ``padded_flops`` and ``useful_flops``, its megabatches' analytic
        FLOPs (``torchprof.pack_flops``)."""
        with trace.span(None, None, "sched.rungs", jobs=len(ready), dispatches=0,
                        padded_flops=0.0, useful_flops=0.0) as sp:
            self._dispatch_rung_groups(ready, sp["attrs"])

    def _dispatch_rung_groups(self, ready: List[SubStratJob], counts: dict) -> None:
        from ..automl.batched import eval_rung_cohorts, eval_trial_megabatch

        mega: List[SubStratJob] = []
        buckets: Dict[object, List[SubStratJob]] = {}
        solo: List[SubStratJob] = []
        for job in ready:
            rkey = self._rung_key(job)
            if rkey is None:
                solo.append(job)
            elif self.megabatch and job.plan.continuous_batching:
                mega.append(job)
            else:
                buckets.setdefault(rkey, []).append(job)
        merged = []
        for bucket in buckets.values():
            if len(bucket) == 1:
                solo.append(bucket[0])
                continue
            groups, singles = self._plan_bucket(bucket)
            merged.extend(groups)
            solo.extend(singles)
        counts["dispatches"] += len(solo) + len(merged)

        for job in solo:
            t0 = time.perf_counter()
            w0 = time.time()
            try:
                search_eval_rung(job.search)
            except Exception as e:   # noqa: BLE001 — isolate job failures
                self._fail(job, e)
                continue
            dt = time.perf_counter() - t0
            self.solo_rungs += 1
            self.m_dispatches.inc(mode="solo")
            self.m_dispatch_latency.observe(dt, mode="solo")
            rung = job.search.rung_i - 1
            self._job_time_span(job, f"{job.phase}/rung{rung}",
                                _PHASE_TIME_KEY[job.phase], w0, dt,
                                phase=job.phase, rung=rung, mode="solo")
            self._note_rung(job)

        if mega:
            # the standing megabatch (§13): every ready cohort, any rung,
            # packed under the waste budget; hetero_merge=False restricts
            # groups to exact shapes so every merge stays bit-identical
            cohorts = [search_trial_cohort(j.search) for j in mega]
            metas = [CohortMeta(tc.shape, tc.trial_steps) for tc in cohorts]
            groups = pack_megabatches(metas, self.waste_budget,
                                      same_shape_only=not self.hetero_merge)
            counts["dispatches"] += len(groups)
            for gidx in groups:
                gmetas = [metas[i] for i in gidx]
                self.m_pack_waste.set(merge_waste(gmetas))
                padded, useful = torchprof.pack_flops(gmetas)
                self.m_padded_flops.inc(padded)
                self.m_useful_flops.inc(useful)
                counts["padded_flops"] += padded
                counts["useful_flops"] += useful
            self._eval_groups(
                [([mega[i] for i in gidx], [cohorts[i] for i in gidx])
                 for gidx in groups],
                eval_trial_megabatch)

        if merged:
            self._eval_groups(
                [(group, [search_trial_cohort(j.search) for j in group])
                 for group in merged],
                eval_rung_cohorts)

    # -- the cooperative loop ----------------------------------------------

    def step(self) -> bool:
        """Advance every active job one phase unit.  Returns True iff any
        work was done (False means nothing is pending)."""
        worked = False
        dst_ready: List[SubStratJob] = []
        for job in sorted(self.pending(), key=lambda j: j.job_id):
            try:
                if job.phase == "factorize":
                    self._factorize(job)
                    worked = True
            except Exception as e:   # noqa: BLE001 — isolate job failures
                self._fail(job, e)
                worked = True
            if job.phase == "dst":
                dst_ready.append(job)
        if dst_ready:
            self._dispatch_dst(dst_ready)
            worked = True

        ready: List[SubStratJob] = []
        for job in sorted(self.pending(), key=lambda j: j.job_id):
            if job.phase not in ("sub_automl", "fine_tune"):
                continue
            try:
                self._ensure_search(job)
            except Exception as e:   # noqa: BLE001
                self._fail(job, e)
                worked = True
                continue
            ready.append(job)
        if ready:
            self._dispatch_rungs(ready)
            worked = True
            for job in ready:
                if job.active and job.search is not None and job.search.done:
                    try:
                        self._finish_search(job)
                    except Exception as e:   # noqa: BLE001
                        self._fail(job, e)
        # release warm-waiters last, so the step that publishes a winner
        # family also un-parks the jobs waiting on it
        if self._advance_waiters():
            worked = True
        return worked

    def run(self) -> None:
        """Drive all pending jobs to completion."""
        while self.pending():
            if not self.step():   # pragma: no cover — step always works
                raise RuntimeError("scheduler stalled with pending jobs")

    def stats(self) -> dict:
        phases: Dict[str, int] = {}
        for job in self.jobs.values():
            phases[job.phase] = phases.get(job.phase, 0) + 1
        return {
            "jobs": phases,
            "cache": self.cache.stats(),
            "merged_rungs": self.merged_rungs,
            "merged_jobs": self.merged_jobs,
            "hetero_rungs": self.hetero_rungs,
            "mixed_rungs": self.mixed_rungs,
            "solo_rungs": self.solo_rungs,
            "merged_dst": self.merged_dst,
            "poisoned_packs": self.poisoned_packs,
            "metrics": self.metrics.to_dict(),
        }

    # -- checkpoint / restore (DESIGN.md §14.5) ------------------------------

    _COUNTER_FIELDS = ("merged_rungs", "merged_jobs", "hetero_rungs",
                       "mixed_rungs", "solo_rungs", "merged_dst",
                       "poisoned_packs")
    _JOB_PLAIN_FIELDS = ("job_id", "tenant", "X", "y", "X_test", "y_test",
                         "phase", "cache_hit", "warm_family", "fingerprint",
                         "cache_key", "row_idx", "col_mask", "col_idx",
                         "dst_fitness", "y_sub", "intermediate", "final",
                         "result", "trace_id")

    def snapshot(self) -> bytes:
        """Serialize the whole scheduler — every job (including mid-search
        ``SearchState``s), the DST cache, the merge counters, the metrics
        and the experience store — to one versioned wire payload.  A fresh
        scheduler that ``load_snapshot``s it resumes in-progress jobs
        bit-identically (rung-boundary granularity: ``step()`` snapshots
        land between rungs)."""
        from . import wire
        jobs = []
        for job in self.jobs.values():
            d = {f: getattr(job, f) for f in self._JOB_PLAIN_FIELDS}
            d["seed"] = job.seed
            d["plan"] = job.plan
            d["coded"] = job.coded
            d["times"] = dict(job.times)
            d["leaderboard"] = list(job.leaderboard)
            d["spans"] = list(job.spans)
            d["search"] = (search_snapshot(job.search)
                           if job.search is not None else None)
            d["error"] = None if job.error is None else repr(job.error)
            jobs.append(d)
        payload = {
            "jobs": jobs,
            "next_id": self._next_id,
            "counters": {k: getattr(self, k) for k in self._COUNTER_FIELDS},
            "cache": self.cache.items(),
            "metrics": self.metrics.state_dict(),
            # the experience store rides every snapshot (wire version 3) so
            # a restored server warm-starts exactly like the one that died
            "experience": self.experience.state_dict(),
        }
        return wire.dumps(payload, kind="scheduler")

    def _on_device(self, result):
        """An ``AutoMLResult`` (or a ``SubStratResult`` of two) read from
        the wire, with its model params on this scheduler's device."""
        if result is None:
            return None
        if isinstance(result, SubStratResult):
            return dataclasses.replace(
                result, final=self._on_device(result.final),
                intermediate=self._on_device(result.intermediate))
        return dataclasses.replace(result,
                                   params=params_to(result.params, self.device))

    def load_snapshot(self, data: bytes) -> None:
        """Restore state captured by ``snapshot`` (replaces current state).
        Each job's coded table, search and models go to this scheduler's
        device."""
        from . import wire
        payload = wire.loads(data)
        self.jobs.clear()
        for d in payload["jobs"]:
            coded = d["coded"]
            if coded is not None:   # host arrays off the wire
                coded = coded._replace(
                    codes=torch.as_tensor(coded.codes),
                    values=torch.as_tensor(coded.values),
                    n_bins=torch.as_tensor(coded.n_bins)).to(self.device)
            job = SubStratJob(
                job_id=d["job_id"], tenant=d["tenant"], X=d["X"], y=d["y"],
                seed=int(d["seed"]), plan=d["plan"], coded=coded,
                X_test=d["X_test"], y_test=d["y_test"])
            for f in self._JOB_PLAIN_FIELDS:
                setattr(job, f, d[f])
            job.intermediate = self._on_device(job.intermediate)
            job.final = self._on_device(job.final)
            job.result = self._on_device(job.result)
            job.times = dict(d["times"])
            job.leaderboard = list(d["leaderboard"])
            job.spans = list(d.get("spans", []))
            job.search = (search_restore(d["search"], self.device)
                          if d["search"] is not None else None)
            # the original exception class is gone; keep its repr visible
            job.error = (None if d["error"] is None
                         else RuntimeError(d["error"]))
            self.jobs[job.job_id] = job
        self._next_id = payload["next_id"]
        for k, v in payload["counters"].items():
            setattr(self, k, v)
        for key, entry in payload["cache"]:
            self.cache.put(key, entry)
        # restore first, then re-register: get-or-create re-attaches the
        # m_* handles to the restored families (bit-identical round trip)
        self.metrics.load_state(payload["metrics"])
        self._register_metrics()
        self.experience.load_state(payload["experience"])

    def save_checkpoint_to(self, ckpt_dir, step: int, *, keep: int = 3) -> None:
        """Write ``snapshot()`` as an atomic on-disk checkpoint
        (``distributed/checkpoint.py`` manifest + COMMIT protocol)."""
        from ..distributed.checkpoint import save_checkpoint
        blob = np.frombuffer(self.snapshot(), dtype=np.uint8)
        save_checkpoint(ckpt_dir, step, {"wire": blob}, keep=keep)

    def restore_checkpoint(self, ckpt_dir) -> Optional[int]:
        """Restore the newest complete checkpoint under ``ckpt_dir``;
        returns its step, or None if no commit exists."""
        from ..distributed.checkpoint import restore_latest_untyped
        found = restore_latest_untyped(ckpt_dir)
        if found is None:
            return None
        leaves, step = found
        self.load_snapshot(leaves[0].tobytes())
        return step

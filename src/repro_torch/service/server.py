"""In-process SubStrat serving front end (DESIGN.md §11.5).

``SubStratServer`` wraps the scheduler with the three-call serving surface —
``submit`` / ``poll`` / ``result`` — plus per-tenant budget accounting:
every job's phase costs (measured wall seconds; merged rungs charge each
participant its equal share) accrue to the submitting tenant, and a tenant
over its budget gets ``BudgetExceeded`` at the next ``submit``.  Already
admitted jobs always run to completion — admission control, not preemption.

Admission is also *rate*-limited per tenant: each tenant draws from a
token bucket (``rate`` jobs/second refill, ``burst`` capacity) and an
empty bucket gets ``RateLimited`` — carrying ``retry_after_s`` — which the
HTTP transport maps to ``429`` with a ``Retry-After`` header.  Buckets use
an injectable clock so the policy is deterministic under test.

Nothing here assumes more than the scheduler's cooperative ``step()``
loop: the same server fronts the in-process ``Scheduler`` or a
``transport.DistributedScheduler`` whose rungs run in worker processes, and
``transport.SubStratHTTPServer`` puts HTTP in front of it.

The port of the JAX package's ``service/server.py``: jobs take an int
``seed`` where the reference takes a key, and the server's scheduler runs
them on ``device`` (CUDA by default, raising without a card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..core.measures import CodedDataset
from ..core.plan import Plan
from ..core.substrat import SubStratConfig, SubStratResult
from ..device import DeviceLike
from ..obs import torchprof
from .cache import DSTCache
from .scheduler import Scheduler

__all__ = ["BudgetExceeded", "JobStatus", "RateLimited", "SubStratServer",
           "TenantAccount", "TokenBucket"]


class BudgetExceeded(RuntimeError):
    """Raised by ``submit`` when the tenant has spent its budget."""


class RateLimited(RuntimeError):
    """Raised by ``submit`` when the tenant's token bucket is empty.

    ``retry_after_s`` is the seconds until the bucket refills one token —
    the HTTP layer surfaces it as the ``Retry-After`` header of a 429."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} is rate limited; retry in "
            f"{retry_after_s:.2f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class TokenBucket:
    """A standard token bucket: ``rate`` tokens/second refill up to
    ``burst`` capacity; each admission costs one token.  The clock is
    injectable (tests drive a fake monotonic clock)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t_last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t_last) * self.rate)
        self._t_last = now

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens

    def try_acquire(self) -> float:
        """Take one token.  Returns 0.0 on success, else the seconds until
        one token is available (nothing is consumed on failure)."""
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return 0.0
        return (1.0 - self._tokens) / self.rate


@dataclasses.dataclass
class TenantAccount:
    budget_s: Optional[float] = None   # None = unlimited
    spent_s: float = 0.0               # accrued phase seconds (all jobs)
    jobs_submitted: int = 0


@dataclasses.dataclass(frozen=True)
class JobStatus:
    """Snapshot returned by ``poll``."""
    job_id: int
    tenant: str
    phase: str                 # scheduler.PHASES: factorize | dst | warm_wait
                               #   | sub_automl | fine_tune | done | failed
    cache_hit: bool
    warm_started: bool         # cache knew the winner family: sub pass skipped
    times: Dict[str, float]    # per-phase seconds so far (raw ledger keys)
    # the canonical per-phase breakdown (DESIGN.md §15.1): always all four
    # pipeline phases, zero where a phase has not run (or was skipped)
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    error: Optional[str] = None
    # streamed partial results (DESIGN.md §14.4): the rung-by-rung
    # leaderboard entries recorded since the caller's cursor, plus the
    # total count to use as the next ``poll(since=...)`` cursor
    leaderboard: tuple = ()
    leaderboard_total: int = 0

    @property
    def done(self) -> bool:
        return self.phase == "done"


# JobStatus.phase_times key <- job.times ledger key
_PHASE_TIME_KEYS = (("factorize", "factorize_s"), ("gen_dst", "gen_dst_s"),
                    ("sub_automl", "automl_sub_s"),
                    ("fine_tune", "fine_tune_s"))


class SubStratServer:
    """submit/poll/result over the multi-tenant scheduler."""

    def __init__(
        self,
        *,
        cache_capacity: int = 128,
        cache_byte_budget: Optional[int] = None,
        cache_policy: str = "lru",
        warm_start: bool = True,
        hetero_merge: bool = True,
        megabatch: bool = True,
        waste_budget: float = 4.0,
        batch_dst: bool = False,
        tenant_budgets: Optional[Dict[str, float]] = None,
        scheduler: Optional[Scheduler] = None,
        tenant_rate_limits: Optional[Dict[str, Tuple[float, float]]] = None,
        default_rate_limit: Optional[Tuple[float, float]] = None,
        rate_clock: Callable[[], float] = time.monotonic,
        device: DeviceLike = None,
    ):
        # an injected scheduler wins; the cache/merge/device kwargs then
        # belong to its constructor, not ours
        self.scheduler = scheduler if scheduler is not None else Scheduler(
            DSTCache(cache_capacity, byte_budget=cache_byte_budget,
                     policy=cache_policy),
            warm_start=warm_start, hetero_merge=hetero_merge,
            megabatch=megabatch, waste_budget=waste_budget,
            batch_dst=batch_dst, device=device)
        self.tenants: Dict[str, TenantAccount] = {}
        for tenant, budget in (tenant_budgets or {}).items():
            self.tenants[tenant] = TenantAccount(budget_s=budget)
        # per-tenant admission rate limits: tenant -> (rate/s, burst).
        # ``default_rate_limit`` applies to tenants without an explicit
        # entry; None (the default) leaves those tenants unlimited.
        self._rate_limits = dict(tenant_rate_limits or {})
        self._default_rate_limit = default_rate_limit
        self._rate_clock = rate_clock
        self._buckets: Dict[str, TokenBucket] = {}

    # -- tenancy ------------------------------------------------------------

    def _account(self, tenant: str) -> TenantAccount:
        if tenant not in self.tenants:
            self.tenants[tenant] = TenantAccount()
        return self.tenants[tenant]

    def set_budget(self, tenant: str, budget_s: Optional[float]) -> None:
        self._account(tenant).budget_s = budget_s

    def set_rate_limit(self, tenant: str,
                       limit: Optional[Tuple[float, float]]) -> None:
        """(Re)set a tenant's ``(rate/s, burst)`` admission limit; None
        removes it (the tenant falls back to the default limit, if any)."""
        self._buckets.pop(tenant, None)
        if limit is None:
            self._rate_limits.pop(tenant, None)
        else:
            self._rate_limits[tenant] = limit

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            limit = self._rate_limits.get(tenant, self._default_rate_limit)
            if limit is None:
                return None
            rate, burst = limit
            bucket = TokenBucket(rate, burst, clock=self._rate_clock)
            self._buckets[tenant] = bucket
        return bucket

    def _check_rate(self, tenant: str) -> None:
        bucket = self._bucket(tenant)
        if bucket is None:
            return
        m = self.scheduler.metrics
        retry_after = bucket.try_acquire()
        m.gauge("rate_limit_tokens",
                "admission tokens remaining in the tenant's bucket",
                ("tenant",)).set(bucket.tokens, tenant=tenant)
        if retry_after > 0.0:
            m.counter("rate_limited_total",
                      "submissions rejected by the tenant rate limiter",
                      ("tenant",)).inc(tenant=tenant)
            raise RateLimited(tenant, retry_after)

    def _refresh_spend(self) -> None:
        for account in self.tenants.values():
            account.spent_s = 0.0
        for job in self.scheduler.jobs.values():
            self._account(job.tenant).spent_s += job.cost_s

    # -- serving surface ----------------------------------------------------

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
        """Admit a job for ``tenant``; returns a job id for poll/result.

        ``plan`` is the native payload (DESIGN.md §12); ``config`` (+ the
        deprecated ``dst_fn``) is converted on admission."""
        self._check_rate(tenant)
        account = self._account(tenant)
        self._refresh_spend()
        if account.budget_s is not None and account.spent_s >= account.budget_s:
            raise BudgetExceeded(
                f"tenant {tenant!r} spent {account.spent_s:.2f}s of its "
                f"{account.budget_s:.2f}s budget")
        account.jobs_submitted += 1
        return self.scheduler.submit(
            X, y, tenant=tenant, seed=seed, plan=plan, config=config,
            dst_fn=dst_fn, coded=coded, X_test=X_test, y_test=y_test)

    def poll(self, job_id: int, since: int = 0) -> JobStatus:
        """Job status snapshot.  ``since`` is a leaderboard cursor: only
        entries recorded at index >= ``since`` are returned, so a client
        polling with ``since=last.leaderboard_total`` streams each rung's
        standings exactly once instead of poll-until-done."""
        job = self.scheduler.jobs[job_id]
        return JobStatus(
            job_id=job.job_id,
            tenant=job.tenant,
            phase=job.phase,
            cache_hit=job.cache_hit,
            warm_started=job.warm_family is not None,
            times=dict(job.times),
            phase_times={name: float(job.times.get(key, 0.0))
                         for name, key in _PHASE_TIME_KEYS},
            error=None if job.error is None else repr(job.error),
            leaderboard=tuple(job.leaderboard[since:]),
            leaderboard_total=len(job.leaderboard),
        )

    def run(self) -> None:
        """Drive every pending job to completion (cooperative loop)."""
        self.scheduler.run()
        self._refresh_spend()

    def result(self, job_id: int) -> SubStratResult:
        """Block (cooperatively) until ``job_id`` finishes; return its result.

        Other pending jobs advance too — the scheduler has no way to run one
        job's rung without stepping the queue, and stepping the queue is the
        point (merged rungs)."""
        job = self.scheduler.jobs[job_id]
        while job.active:
            self.scheduler.step()
        self._refresh_spend()
        if job.phase == "failed":
            raise RuntimeError(f"job {job_id} failed") from job.error
        return job.result

    def stats(self) -> dict:
        self._refresh_spend()
        out = self.scheduler.stats()
        out["tenants"] = {
            tenant: {"spent_s": acc.spent_s, "budget_s": acc.budget_s,
                     "jobs_submitted": acc.jobs_submitted}
            for tenant, acc in self.tenants.items()
        }
        out["rate_limits"] = {
            tenant: {"rate": limit[0], "burst": limit[1],
                     "tokens": (self._buckets[tenant].tokens
                                if tenant in self._buckets else limit[1])}
            for tenant, limit in sorted(self._rate_limits.items())
        }
        if self._default_rate_limit is not None:
            out["default_rate_limit"] = {
                "rate": self._default_rate_limit[0],
                "burst": self._default_rate_limit[1],
            }
        return out

    # -- observability (DESIGN.md §15) ---------------------------------------

    def metrics_text(self) -> str:
        """Prometheus text exposition: the scheduler's registry plus the
        process-global kernel build and launch counters."""
        return self.scheduler.metrics.render() + torchprof.render_prometheus()

    def trace(self, job_id: int) -> Optional[dict]:
        """One job's recorded spans (JSON-safe), or None for unknown ids."""
        job = self.scheduler.jobs.get(job_id)
        if job is None:
            return None
        return {"job_id": job.job_id, "trace_id": job.trace_id,
                "spans": list(job.spans)}

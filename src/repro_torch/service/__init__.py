"""SubStrat service layer (DESIGN.md §11, §14): a multi-tenant job server
over the plan pipeline, in one process or across worker processes.

The port of the JAX package's ``service/``:

- ``fingerprint`` — stable content hash of a factorized dataset (the same
                    hex string as the reference's).
- ``cache``       — LRU/GDSF DST cache keyed by (fingerprint, n, m,
                    measure, search config), so repeat submissions skip the
                    subset search and warm-start the restricted fine-tune.
- ``scheduler``   — cooperative job queue running jobs through explicit
                    resumable phases, merging concurrent subset searches
                    (``gen_dst_batch``) and rung cohorts from different jobs
                    into one batched-engine dispatch; whole-scheduler
                    snapshots and checkpoints.
- ``server``      — in-process submit/poll/result front end with per-tenant
                    budget accounting, token-bucket admission rate limits,
                    and streamed rung leaderboards.
- ``wire``        — the versioned binary format every cross-process payload
                    travels in (the reference's bytes; ``repro_torch.*``
                    types only; tensors as host arrays).
- ``worker``      — the worker-process loop: rung cohorts evaluated on the
                    worker's device.
- ``transport``   — worker pools (``ProcessWorkerPool``, the deterministic
                    ``SimWorkerPool``), the crash-recovering
                    ``DistributedScheduler`` and the HTTP front end and
                    client.  The subset search and its kernels stay in the
                    front end; workers evaluate AutoML rungs.
"""
from .cache import DSTCache, DSTCacheEntry
from .fingerprint import dataset_fingerprint
from .scheduler import Scheduler, SubStratJob
from .server import (
    BudgetExceeded, JobStatus, RateLimited, SubStratServer, TokenBucket,
)
from .transport import (
    DistributedScheduler, ProcessWorkerPool, SimWorkerPool, SubStratHTTPClient,
    SubStratHTTPServer,
)
from .wire import WireError, WireVersionError

__all__ = [
    "DSTCache", "DSTCacheEntry", "dataset_fingerprint",
    "Scheduler", "SubStratJob",
    "BudgetExceeded", "JobStatus", "RateLimited", "SubStratServer",
    "TokenBucket",
    "DistributedScheduler", "ProcessWorkerPool", "SimWorkerPool",
    "SubStratHTTPClient", "SubStratHTTPServer", "WireError", "WireVersionError",
]

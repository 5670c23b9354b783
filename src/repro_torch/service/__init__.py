"""SubStrat service layer (DESIGN.md §11, §14): a multi-tenant job server
over the plan pipeline, in one process on one device.

The port of the JAX package's ``service/`` (its in-process half; the wire
format, worker processes and the HTTP transport are not ported yet):

- ``fingerprint`` — stable content hash of a factorized dataset (the same
                    hex string as the reference's).
- ``cache``       — LRU/GDSF DST cache keyed by (fingerprint, n, m,
                    measure, search config), so repeat submissions skip the
                    subset search and warm-start the restricted fine-tune.
- ``scheduler``   — cooperative job queue running jobs through explicit
                    resumable phases, merging concurrent subset searches
                    (``gen_dst_batch``) and rung cohorts from different jobs
                    into one batched-engine dispatch.
- ``server``      — in-process submit/poll/result front end with per-tenant
                    budget accounting, token-bucket admission rate limits,
                    and streamed rung leaderboards.
"""
from .cache import DSTCache, DSTCacheEntry
from .fingerprint import dataset_fingerprint
from .scheduler import Scheduler, SubStratJob
from .server import (
    BudgetExceeded, JobStatus, RateLimited, SubStratServer, TokenBucket,
)

__all__ = [
    "DSTCache", "DSTCacheEntry", "dataset_fingerprint",
    "Scheduler", "SubStratJob",
    "BudgetExceeded", "JobStatus", "RateLimited", "SubStratServer",
    "TokenBucket",
]

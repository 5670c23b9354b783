"""DST cache with LRU and cost-aware GDSF eviction (DESIGN.md §11.2, §12.5).

Keyed by ``(fingerprint, n, m, measure, search_cfg)`` — the full identity
of a subset-search problem: the factorized dataset content, the requested
subset shape, the preserved measure, and the resolved strategy + options
(subsets found by weaker searches must not satisfy stronger requests; with
the plan API, ``search_cfg`` is the plan's ``(strategy, strategy_opts)``
identity, so *every* registered cacheable strategy shares this cache, not
just Gen-DST).  An entry stores the search's *output*
(``row_idx``/``col_mask``/fitness), its *production cost* in wall seconds,
and, once a job's sub-AutoML pass has finished, the winning model family,
so a repeat submission can skip the subset search entirely and warm-start
the restricted fine-tune (scheduler, §11.3).

Entries are immutable snapshots of host numpy arrays; the cache never holds
device buffers (the port of the JAX package's ``service/cache.py``, pure
Python and numpy).  Two eviction policies:

- ``policy="lru"`` (default): plain recency order (`get` refreshes).
- ``policy="gdsf"``: Greedy-Dual-Size-Frequency — each entry carries the
  priority ``clock + frequency * cost_s / size_bytes``, refreshed on every
  hit; eviction removes the lowest-priority entry and advances the clock to
  its priority (aging).  A cheap-to-recompute, rarely-hit, byte-heavy
  subset is evicted long before an expensive Gen-DST result of the same
  age — entry production costs span ~4 orders of magnitude between a
  k-means baseline and a paper-strength genetic search.

Both policies enforce the entry-count ``capacity`` and, when set, a
``byte_budget`` over the summed entry payload sizes.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["DSTCache", "DSTCacheEntry", "dst_cache_key"]


def dst_cache_key(fingerprint: str, n: int, m: int, measure: str,
                  search_cfg: Optional[Tuple] = None) -> Tuple:
    """The cache key of one subset-search problem.

    ``(fingerprint, n, m, measure)`` identifies *what* subset is sought;
    ``search_cfg`` (any hashable — the resolved ``GenDSTConfig``, or the
    plan API's ``(strategy, strategy_opts)`` pair) identifies *how* it was
    searched for — without it, a subset found by a 2-generation toy search
    would satisfy a later paper-strength request for the same dataset."""
    return (fingerprint, int(n), int(m), measure, search_cfg)


@dataclasses.dataclass
class DSTCacheEntry:
    row_idx: np.ndarray            # (n,) host int
    col_mask: np.ndarray           # (M,) host bool
    fitness: float                 # -|F(d) - F(D)| at insert time
    winner_family: Optional[str] = None   # sub-AutoML winner from a prior job
    hits: int = 0
    cost_s: float = 0.0            # production cost (strategy wall seconds)

    @property
    def nbytes(self) -> int:
        """Payload size — the GDSF size term and the byte-budget unit."""
        return int(self.row_idx.nbytes) + int(self.col_mask.nbytes)


class DSTCache:
    """Map from DST search problems to their solved subsets.

    ``capacity`` bounds the entry count; ``byte_budget`` (optional) bounds
    the summed payload bytes; ``policy`` picks the victim: ``"lru"``
    recency order or ``"gdsf"`` cost-aware priority (module docstring)."""

    def __init__(self, capacity: int = 128, *,
                 byte_budget: Optional[int] = None, policy: str = "lru"):
        if capacity < 1:
            raise ValueError("DSTCache capacity must be >= 1")
        if policy not in ("lru", "gdsf"):
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             "available policies: gdsf, lru")
        if byte_budget is not None and byte_budget < 1:
            raise ValueError("byte_budget must be >= 1 (or None)")
        self.capacity = capacity
        self.byte_budget = byte_budget
        self.policy = policy
        self._entries: "OrderedDict[Tuple, DSTCacheEntry]" = OrderedDict()
        self._pri: dict = {}           # gdsf: key -> priority
        self._clock = 0.0              # gdsf aging clock
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _priority(self, entry: DSTCacheEntry) -> float:
        # GDSF: clock + frequency * cost / size.  hits+1 counts the insert
        # itself as one use; the size floor guards empty payloads.
        return self._clock + (entry.hits + 1) * entry.cost_s / max(entry.nbytes, 1)

    def _touch(self, key, entry: DSTCacheEntry) -> None:
        self._entries.move_to_end(key)
        if self.policy == "gdsf":
            self._pri[key] = self._priority(entry)

    def _evict_until_fits(self) -> None:
        while (len(self._entries) > self.capacity
               or (self.byte_budget is not None
                   and self.total_bytes > self.byte_budget
                   and len(self._entries) > 1)):
            if self.policy == "gdsf":
                victim = min(self._pri, key=self._pri.get)
                # aging: future inserts compete against the evicted value
                self._clock = self._pri.pop(victim)
                del self._entries[victim]
            else:
                victim, _ = self._entries.popitem(last=False)
            self.evictions += 1

    def items(self) -> List[Tuple[tuple, DSTCacheEntry]]:
        """Entries in recency order, oldest first (re-``put``ting them in
        this order reproduces the LRU order)."""
        return list(self._entries.items())

    def peek(self, key) -> Optional[DSTCacheEntry]:
        """Look up without touching recency/priority or hit/miss stats (used
        by the scheduler's warm-wait polling, which is not a cache *use*)."""
        return self._entries.get(key)

    def get(self, key) -> Optional[DSTCacheEntry]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        entry.hits += 1
        self._touch(key, entry)
        return entry

    def put(self, key, entry: DSTCacheEntry) -> DSTCacheEntry:
        self._entries[key] = entry
        self._touch(key, entry)
        self._evict_until_fits()
        return entry

    def note_winner(self, key, family: str) -> None:
        """Record the sub-AutoML winner family for warm-started repeats.

        No-op if the entry was evicted meanwhile; does not refresh recency
        (recording a result is not a use of the entry)."""
        entry = self._entries.get(key)
        if entry is not None:
            entry.winner_family = family

    def stats(self) -> dict:
        return {
            "size": len(self._entries),
            "capacity": self.capacity,
            "bytes": self.total_bytes,
            "byte_budget": self.byte_budget,
            "policy": self.policy,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

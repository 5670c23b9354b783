"""Shard placement and heartbeats for the serving tier's fault handling.

A copy of ``assign_shards`` and ``Heartbeat`` from the JAX package's
``distributed/fault.py`` (pure Python and numpy):

* ``assign_shards``: deterministic shard -> host assignment that
  rebalances when hosts die or straggle (surviving hosts keep their
  shards; orphaned shards go to the least-loaded survivor).  Every host
  computes the same assignment from the same alive set — no coordinator.
* ``Heartbeat``: per-host progress timestamps; hosts slower than the
  median by ``straggler_factor`` are stragglers.

The checkpointed training loop (``FaultTolerantLoop``) comes with training.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["assign_shards", "Heartbeat"]


def assign_shards(n_shards: int, alive_hosts: Sequence[int], all_hosts: int):
    """shard -> host map; stable for surviving hosts, orphans least-loaded.

    Surviving hosts always keep their home shards (``s % all_hosts``); each
    orphaned shard goes to the alive host with the fewest shards so far
    (ties broken by host id — fully deterministic), which keeps the load
    within one shard of balanced instead of piling orphans onto ``alive[0]``.
    """
    alive = sorted(set(alive_hosts))
    if not alive:
        raise ValueError("no alive hosts")
    assignment = {}
    orphans = []
    for s in range(n_shards):
        home = s % all_hosts
        if home in alive:
            assignment[s] = home
        else:
            orphans.append(s)
    loads = {h: 0 for h in alive}
    for h in assignment.values():
        loads[h] += 1
    for s in orphans:
        h = min(alive, key=lambda x: (loads[x], x))
        assignment[s] = h
        loads[h] += 1
    return assignment


@dataclasses.dataclass
class Heartbeat:
    n_hosts: int
    straggler_factor: float = 3.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)
    step_time: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, step_duration: float):
        self.last_seen[host] = time.monotonic()
        self.step_time[host] = step_duration

    def stragglers(self) -> List[int]:
        if len(self.step_time) < 2:
            return []
        med = float(np.median(list(self.step_time.values())))
        return [h for h, t in self.step_time.items()
                if t > self.straggler_factor * max(med, 1e-9)]

    def dead(self, timeout_s: float = 60.0) -> List[int]:
        now = time.monotonic()
        return [h for h, t in self.last_seen.items() if now - t > timeout_s]

"""Fault tolerance and straggler mitigation, after the JAX package's
``distributed/fault.py`` (``assign_shards`` and ``Heartbeat`` are copies,
pure Python and numpy):

* ``assign_shards``: deterministic shard -> host assignment that
  rebalances when hosts die or straggle (surviving hosts keep their
  shards; orphaned shards go to the least-loaded survivor).  Every host
  computes the same assignment from the same alive set — no coordinator.
* ``Heartbeat``: per-host progress timestamps; hosts slower than the
  median by ``straggler_factor`` are stragglers.
* ``FaultTolerantLoop``: a train loop with periodic checkpoints and
  restart-from-latest semantics; ``simulate_failure_at`` is the test hook.
  The port's train step updates its state in place, so the loop keeps a
  host copy of the initial state for a restart that finds no checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .checkpoint import _flatten, _to_host, restore_latest, save_checkpoint

__all__ = ["assign_shards", "Heartbeat", "FaultTolerantLoop"]


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


class FaultTolerantLoop:
    """Checkpointed train loop with restart-from-latest semantics.

    ``step_fn(state, batch) -> (state, metrics)`` must be deterministic given
    (state, batch): a restart then reproduces the uninterrupted run.  A
    restart restores the newest checkpoint typed by ``init_state`` and runs
    the steps after it.

    A restart that finds no checkpoint starts from the initial values even
    when ``step_fn`` updated ``init_state`` in place (the port's train step
    does): the first ``run`` that finds no checkpoint keeps a host copy of
    ``init_state`` (``checkpoint._to_host``), and a later ``run`` handed the
    same object, again without a checkpoint, copies it back into the state
    in place before step 0.  The copy costs host memory the size of the
    state, 29 GB (27 GiB) for zamba2-2.7b's float32 params and AdamW state,
    and no device memory: a second device copy would not fit beside its
    training peak.  It is dropped once a checkpoint is written."""

    def __init__(self, step_fn: Callable, batch_fn: Callable, ckpt_dir,
                 ckpt_every: int = 10, keep: int = 3):
        self.step_fn = step_fn
        self.batch_fn = batch_fn            # step -> batch (deterministic)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self._initial = None                # (init_state, its host copy)

    def _start_from(self, init_state):
        """``init_state`` holding its initial values: snapshot it on the first
        start, restore the snapshot into it on a later one."""
        if self._initial is None or self._initial[0] is not init_state:
            self._initial = (init_state, _to_host(init_state))
            return init_state
        live: List = []
        saved: List = []
        _flatten(init_state, live)
        _flatten(self._initial[1], saved)
        with torch.no_grad():
            for dst, src in zip(live, saved):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
                elif isinstance(dst, np.ndarray):
                    np.copyto(dst, src)
        return init_state

    def run(self, init_state, n_steps: int,
            simulate_failure_at: Optional[int] = None):
        restored = restore_latest(self.ckpt_dir, init_state)
        if restored is not None:
            state, start = restored
            start += 1
        else:
            state, start = self._start_from(init_state), 0
        metrics = None
        for step in range(start, n_steps):
            if simulate_failure_at is not None and step == simulate_failure_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = self.batch_fn(step)
            state, metrics = self.step_fn(state, batch)
            if (step + 1) % self.ckpt_every == 0 or step == n_steps - 1:
                save_checkpoint(self.ckpt_dir, step, state, keep=self.keep)
                self._initial = None
        return state, metrics

"""Worker-process loop of the cross-process serving tier (DESIGN.md §14.3).

The port of the JAX package's ``service/worker.py``.  A worker is one
process pinned to one device: it pulls packed rung tasks from its queue,
evaluates them through the same batched engine the in-process scheduler
uses (``eval_trial_megabatch`` / ``eval_rung_cohorts``), and pushes
wire-encoded scored results back on the shared result queue.  The
evaluation entry points are pure functions of the cohort payloads, so a
task re-dispatched to another worker after a crash gives the same results —
the whole recovery story rests on that.  Workers evaluate AutoML rungs
only; the subset search (and with it every hand-written kernel) stays in
the front end.

Message protocol (queue values are small tuples; large payloads are wire
bytes — see ``service/wire.py``):

  front end -> worker
      ("eval", task_id, wire_bytes, attempt)   evaluate one packed group
      ("stop",)                                drain and exit

  worker -> front end
      ("hello", worker_id, t, device)      ready (torch imported, device
                                           resolved, loop live)
      ("beat", worker_id, t)               heartbeat: task accepted
      ("done", task_id, worker_id, wire_bytes, dt, spans)
      ("error", task_id, worker_id, repr, traceback, dt, spans)

``hello`` ends with the device the worker resolved (``str(torch.device)``),
which the reference's does not: the pool checks it against the device it
asked for, so a worker cannot quietly compute elsewhere.  The ``attempt``
number rides the queue message rather than the wire payload on purpose: a
re-dispatch reuses the encoded payload bytes verbatim.  ``spans`` is a list
of plain span dicts (``obs/trace``) covering the worker's
deserialize/eval/serialize legs; the worker derives its parent dispatch-span
id from the wire header's trace context plus the attempt number.

Fault injection: ``worker_main`` takes ``fault_events`` — a tuple of
``(worker_id, task_index, action, seconds)`` primitives (what the tests'
``harness/faultsim.FaultPlan`` compiles to).  When this worker dequeues its
``task_index``-th task it applies the action first:

- ``"kill"``  — ``os._exit`` before any reply: exactly what a crashed or
  OOM-killed process looks like to the front end;
- ``"stall"`` — sleep ``seconds`` *before* the heartbeat, so the front end
  sees a dispatched task with no beat (the straggler signature);
- ``"delay"`` — sleep ``seconds`` and then run normally (a slow worker,
  not a lost one).
"""
from __future__ import annotations

import contextlib
import os
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..automl.engine import TrialCohort, _materialize_scored, restore_ctx
from ..device import DeviceLike, resolve_device
from ..obs import trace
from . import wire

__all__ = ["cohort_payload", "cohort_restore", "eval_task", "handle_eval",
           "worker_main", "KILLED_EXIT_CODE"]

KILLED_EXIT_CODE = 17     # distinguishes injected kills from real crashes


# ---------------------------------------------------------------------------
# cohort <-> wire payload
# ---------------------------------------------------------------------------

# the evaluation-context keys a worker needs; the rest is rebuilt on the
# worker (engine.restore_ctx)
_CTX_KEYS = ("X_tr", "y_tr", "X_val", "y_val", "n_classes", "seed")


def cohort_payload(tc: TrialCohort) -> dict:
    """The wire-encodable projection of one ``TrialCohort``: the raw
    evaluation data and the per-trial cursors."""
    if tc.ctx["init_provider"] is not None:
        raise wire.WireError("cohort_payload: a cohort with an init_provider "
                             "(a callable) is not wire-serializable")
    return {
        "specs": list(tc.specs),
        "tids": [int(t) for t in tc.tids],
        "rung_i": int(tc.rung_i),
        "epochs": int(tc.epochs),
        "collect": bool(tc.collect),
        "rungs": tuple(int(r) for r in tc.trial_rungs),
        "steps": tuple(int(s) for s in tc.trial_steps),
        "ctx": {k: tc.ctx[k] for k in _CTX_KEYS},
    }


def cohort_restore(payload: dict, device: DeviceLike = None) -> TrialCohort:
    """Rebuild an evaluable ``TrialCohort`` on ``device`` (default CUDA)
    from its wire projection."""
    # merged dispatches are never time-budgeted
    ctx = restore_ctx({**payload["ctx"], "budget_active": False}, device)
    return TrialCohort(
        specs=list(payload["specs"]),
        tids=[int(t) for t in payload["tids"]],
        rung_i=int(payload["rung_i"]),
        epochs=int(payload["epochs"]),
        collect=bool(payload["collect"]),
        ctx=ctx,
        rungs=tuple(payload["rungs"]),
        steps=tuple(payload["steps"]),
    )


def eval_task(payload: dict, device: DeviceLike = None) -> list:
    """Evaluate one packed task ``{"kind", "cohorts"}`` on ``device`` ->
    per-job ``(scored, positions)`` with lazy params materialized (device
    tensors, wire-safe)."""
    from ..automl.batched import eval_rung_cohorts, eval_trial_megabatch
    cohorts = [cohort_restore(c, device) for c in payload["cohorts"]]
    fn = eval_rung_cohorts if payload["kind"] == "rung" else eval_trial_megabatch
    outs = fn(cohorts)
    return [(_materialize_scored(scored), list(positions))
            for scored, positions in outs]


# ---------------------------------------------------------------------------
# the worker loop
# ---------------------------------------------------------------------------


def _my_faults(worker_id: int,
               fault_events: Sequence[Tuple[int, int, str, float]],
               ) -> Dict[int, Tuple[str, float]]:
    return {int(t): (str(action), float(seconds))
            for (w, t, action, seconds) in fault_events
            if int(w) == int(worker_id)}


def apply_fault(action: Optional[Tuple[str, float]]) -> None:
    """Execute one fault action at the dequeue point (see module doc)."""
    if action is None:
        return
    what, seconds = action
    if what == "kill":
        os._exit(KILLED_EXIT_CODE)
    elif what in ("stall", "delay"):
        time.sleep(seconds)
    else:
        raise ValueError(f"unknown fault action {what!r}")


def handle_eval(task_id, worker_id: int, payload_bytes: bytes,
                attempt: int = 0, device: DeviceLike = None) -> tuple:
    """Evaluate one queued task on ``device`` and build its full reply tuple.

    Shared by the real worker loop and the deterministic in-process twin
    (``transport.SimWorkerPool``), so both produce identical reply shapes
    and identical worker-side spans.  The parent dispatch-span id is
    re-derived from the wire header's trace context and the queue
    message's attempt number (``obs/trace.span_id`` is a pure hash)."""
    try:
        tctx = wire.trace_of(payload_bytes)
    except wire.WireError:
        tctx = None
    sink: list = []
    trace_id = parent = None
    if tctx:
        trace_id = tctx["trace_id"]
        parent = trace.span_id(trace_id, tctx["parent"], attempt)

    def _leg(name):
        if trace_id is None:
            return contextlib.nullcontext({})
        return trace.span(sink, trace_id, name, attempt=attempt,
                          parent_id=parent, worker=int(worker_id))

    t0 = time.perf_counter()
    try:
        with _leg("deserialize"):
            payload = wire.loads(payload_bytes)
        with _leg("eval"):
            outs = eval_task(payload, device)
        with _leg("serialize"):
            blob = wire.dumps(outs)
        return ("done", task_id, worker_id, blob,
                time.perf_counter() - t0, sink)
    except Exception as e:   # noqa: BLE001 — report, keep serving
        return ("error", task_id, worker_id, repr(e),
                traceback.format_exc(), time.perf_counter() - t0, sink)


def worker_main(worker_id: int, task_q, result_q,
                fault_events: Sequence[Tuple[int, int, str, float]] = (),
                device: DeviceLike = None):
    """Entry point of one worker process (see module docstring).  Resolves
    ``device`` first (raising without a card, as every entry point does) and
    makes its context, then says hello with the device it resolved."""
    dev = resolve_device(device)
    torch.zeros(1, device=dev)     # the device context, before the hello
    faults = _my_faults(worker_id, fault_events)
    result_q.put(("hello", worker_id, time.monotonic(), str(dev)))
    n_dequeued = 0
    while True:
        msg = task_q.get()
        if msg is None or msg[0] == "stop":
            break
        _op, task_id, payload_bytes = msg[0], msg[1], msg[2]
        attempt = int(msg[3]) if len(msg) > 3 else 0
        fault = faults.get(n_dequeued)
        n_dequeued += 1
        if fault is not None and fault[0] in ("kill", "stall"):
            apply_fault(fault)   # kill exits; stall sleeps pre-heartbeat
        result_q.put(("beat", worker_id, time.monotonic()))
        if fault is not None and fault[0] == "delay":
            apply_fault(fault)
        result_q.put(handle_eval(task_id, worker_id, payload_bytes, attempt, dev))

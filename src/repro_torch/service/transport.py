"""Cross-process serving transport (DESIGN.md §14).

The port of the JAX package's ``service/transport.py``.  Three layers turn
the in-process scheduler into a served, crash-tolerant tier, all
stdlib-only around torch:

1. **Worker pools.**  ``ProcessWorkerPool`` spawns one ``worker.worker_main``
   subprocess per worker (``multiprocessing`` "spawn": CUDA state must never
   cross a fork, so ``"fork"`` on a CUDA device raises), each with its own
   task queue and one shared result queue, all on ``device`` (default CUDA;
   several workers share one card by time-slicing it).  Each worker names
   the device it resolved in its hello and the pool refuses any other.
   ``SimWorkerPool`` is a drop-in in-process stand-in with the same
   five-call surface whose "workers" evaluate tasks synchronously through
   the *same* ``worker.handle_eval`` code path on the front end's device,
   applying ``fault_events`` at the same dequeue points — so every recovery
   path is exercised deterministically, with no subprocess and (for kills)
   no timers.  ``tests/harness/faultsim.py`` builds the fault plans.

2. **Distributed scheduling.**  ``DistributedScheduler`` overrides the
   scheduler's ``_eval_groups`` transport hook: packed rung groups are
   wire-encoded (``service/wire.py``), spread over the pool with the
   deterministic ``distributed/fault.assign_shards`` placement, and the
   results folded back through ``_record_group`` — so everything above the
   hook (phases, Gen-DST and its kernels, caching, merging, budgets) is the
   in-process scheduler verbatim, in the front end.  Recovery (§14.5):

   - a worker is declared **lost** when its process is dead, or a task has
     sat on it past ``stall_timeout_s`` with no heartbeat since dispatch
     (workers beat at task pickup, so long evaluations don't false-positive);
   - a lost worker's pending tasks re-dispatch to the survivors via
     ``assign_shards`` on the reduced alive set — deterministic given the
     fault point, so recovery runs are reproducible;
   - duplicate results (a straggler finishing after re-dispatch) resolve
     first-result-wins; evaluation is deterministic per task;
   - with **no** survivors the front end evaluates the remainder itself, on
     the scheduler's device — it is the worker of last resort.

   ``ckpt_dir`` arms per-step checkpointing: scheduler snapshots (a wire
   blob in a ``distributed/checkpoint.py`` manifest+COMMIT directory) that
   a restarted front end ``resume()``s at rung granularity.

3. **HTTP front end.**  ``SubStratHTTPServer`` puts ``http.server`` in front
   of a ``SubStratServer``: wire-encoded submissions (an int ``seed`` where
   the reference takes a key), JSON polling with streamed rung-by-rung
   leaderboards (``since`` cursor), wire-encoded results, and a single
   stepping thread that advances the scheduler under a lock.
   ``SubStratHTTPClient`` is the stdlib-``urllib`` counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import math
import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..distributed.fault import Heartbeat, assign_shards
from ..obs import torchprof, trace
from . import wire
from .scheduler import Scheduler
from .server import RateLimited, SubStratServer
from .worker import cohort_payload, eval_task, handle_eval, worker_main

__all__ = ["DistributedScheduler", "ProcessWorkerPool", "RemoteEvalError",
           "SimWorkerPool", "SubStratHTTPClient", "SubStratHTTPServer"]


class RemoteEvalError(RuntimeError):
    """A worker reported an evaluation exception for a shipped task."""


# ---------------------------------------------------------------------------
# worker pools
# ---------------------------------------------------------------------------


class ProcessWorkerPool:
    """``n_workers`` subprocesses running ``worker.worker_main`` on
    ``device`` (default CUDA).

    One task queue per worker plus one shared result queue; ``__init__``
    blocks until every worker says hello from the asked device, so
    interpreter, torch and CUDA-context boot time is never mistaken for a
    stall by the scheduler's timeout (``boot_s`` keeps each worker's).  On
    a CUDA device the front end builds the kernel library before it spawns,
    so no worker ever compiles."""

    def __init__(self, n_workers: int, *, device: DeviceLike = None,
                 fault_events: Sequence[Tuple[int, int, str, float]] = (),
                 start_method: str = "spawn",
                 ready_timeout_s: float = 300.0):
        import multiprocessing as mp
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if start_method == "fork":
                raise ValueError("start_method='fork' cannot serve a CUDA "
                                 "device: CUDA state does not survive a fork")
            from ..kernels import _build
            _build.library()
        ctx = mp.get_context(start_method)
        self.n_workers = n_workers
        self.result_q = ctx.Queue()
        self._task_qs = {}
        self._procs = {}
        self._dead = set()
        self.boot_s: Dict[int, float] = {}
        t0 = time.monotonic()
        for w in range(n_workers):
            q = ctx.Queue()
            p = ctx.Process(target=worker_main,
                            args=(w, q, self.result_q, tuple(fault_events),
                                  str(self.device)),
                            daemon=True)
            p.start()
            self._task_qs[w] = q
            self._procs[w] = p
        deadline = t0 + ready_timeout_s
        while len(self.boot_s) < n_workers:
            missing = sorted(set(range(n_workers)) - set(self.boot_s))
            dead = [w for w in missing if not self._procs[w].is_alive()]
            if dead or time.monotonic() > deadline:
                self.close()
                raise RuntimeError(
                    f"workers {dead or missing} "
                    f"{'died at boot' if dead else 'not ready'} "
                    f"(waited {ready_timeout_s}s max)")
            try:
                msg = self.result_q.get(timeout=0.5)
            except queue.Empty:
                continue
            if msg[0] == "hello":
                if msg[-1] != str(self.device):
                    self.close()
                    raise RuntimeError(
                        f"worker {msg[1]} resolved device {msg[-1]!r}, not "
                        f"{str(self.device)!r}")
                self.boot_s[msg[1]] = time.monotonic() - t0

    def send(self, worker_id: int, msg) -> None:
        self._task_qs[worker_id].put(msg)

    def recv(self, timeout_s: float):
        """Next worker message, or None after ``timeout_s``."""
        try:
            return self.result_q.get(timeout=max(timeout_s, 1e-3))
        except queue.Empty:
            return None

    def alive_workers(self) -> List[int]:
        return sorted(w for w, p in self._procs.items()
                      if w not in self._dead and p.is_alive())

    def kill(self, worker_id: int) -> None:
        """Mark a worker lost and make it so (idempotent)."""
        self._dead.add(worker_id)
        p = self._procs[worker_id]
        if p.is_alive():
            p.terminate()
        p.join(timeout=5)

    def close(self) -> None:
        for w in self.alive_workers():
            try:
                self._task_qs[w].put(("stop",))
            except (OSError, ValueError):   # pragma: no cover — closing race
                pass
        for w, p in self._procs.items():
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in (*self._task_qs.values(), self.result_q):
            q.cancel_join_thread()
            q.close()


class SimWorkerPool:
    """Deterministic in-process stand-in for ``ProcessWorkerPool``.

    Same five-call surface, but workers are virtual: ``recv`` evaluates the
    oldest queued task of the lowest-id live worker synchronously through
    ``worker.handle_eval`` — the exact code a real worker runs — on the
    device of the ``DistributedScheduler`` that adopts it, and returns its
    messages one at a time.  Fault events fire at the same
    dequeue point as in ``worker.worker_main``:

    - ``kill``  — the worker dies mid-task: the task is swallowed with no
      reply and the worker drops out of ``alive_workers()`` (no clock);
    - ``stall`` — the worker stays *in* ``alive_workers()`` but never beats
      or replies again, so only the scheduler's no-beat timeout can catch
      it (use a small ``stall_timeout_s`` in tests);
    - ``delay`` — no-op in sim time: the task just runs.
    """

    def __init__(self, n_workers: int, *,
                 fault_events: Sequence[Tuple[int, int, str, float]] = ()):
        self.n_workers = n_workers
        self.device = None      # set by the DistributedScheduler that adopts it
        self._inbox: Dict[int, list] = {w: [] for w in range(n_workers)}
        self._out: list = []
        self._dead = set()
        self._stalled = set()
        self._n_dequeued = {w: 0 for w in range(n_workers)}
        self._faults = {(int(w), int(t)): (str(a), float(s))
                        for (w, t, a, s) in fault_events}
        self.tasks_evaluated = 0

    def send(self, worker_id: int, msg) -> None:
        if worker_id in self._dead:
            return          # queueing to a corpse: silently lost, like mp
        self._inbox[worker_id].append(msg)

    def recv(self, timeout_s: float = 0.0):
        if self._out:
            return self._out.pop(0)
        for w in sorted(self._inbox):
            if w in self._dead or w in self._stalled or not self._inbox[w]:
                continue
            msg = self._inbox[w].pop(0)
            if msg is None or msg[0] == "stop":
                continue
            _op, task_id, payload_bytes = msg[0], msg[1], msg[2]
            attempt = int(msg[3]) if len(msg) > 3 else 0
            fault = self._faults.get((w, self._n_dequeued[w]))
            self._n_dequeued[w] += 1
            if fault is not None:
                action = fault[0]
                if action == "kill":
                    self._dead.add(w)       # task swallowed, no reply
                    return None
                if action == "stall":
                    self._stalled.add(w)    # alive but silent forever
                    return None
            self._out.append(("beat", w, time.monotonic()))
            # handle_eval builds the real worker's replies — same tuple
            # shape, same worker-side spans, same blame-isolation semantics
            self._out.append(handle_eval(task_id, w, payload_bytes, attempt,
                                         self.device))
            self.tasks_evaluated += 1
            return self._out.pop(0)
        return None

    def alive_workers(self) -> List[int]:
        # stalled workers LOOK alive — that is the failure mode under test
        return sorted(w for w in self._inbox if w not in self._dead)

    def kill(self, worker_id: int) -> None:
        self._dead.add(worker_id)
        self._stalled.discard(worker_id)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# the distributed scheduler
# ---------------------------------------------------------------------------


class DistributedScheduler(Scheduler):
    """Scheduler whose packed rung dispatches run on a worker pool.

    Only the ``_eval_groups`` transport hook changes; every layer above it
    (phases, the subset search and its kernels, the DST cache, megabatch
    packing, budget accounting) is the in-process ``Scheduler`` verbatim,
    and per-task evaluation is a pure function of the shipped cohorts —
    which is why re-dispatching a dead worker's tasks to survivors
    reproduces the fault-free results exactly.  A pool without a device of
    its own (``SimWorkerPool``) evaluates on this scheduler's.

    Each dispatch span records the task's wire ``bytes`` and the front
    end's ``encode_s``; a completed one also the reply's ``reply_bytes``
    and ``decode_s``.
    """

    def __init__(self, pool, *, stall_timeout_s: float = 60.0,
                 poll_s: float = 0.02, ckpt_dir=None, ckpt_every: int = 1,
                 ckpt_keep: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.pool = pool
        if pool.device is None:
            pool.device = self.device
        self.heartbeat = Heartbeat(pool.n_workers)
        self.stall_timeout_s = stall_timeout_s
        self.poll_s = poll_s
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        self._step_no = 0
        self._task_seq = 0    # dispatch sequence: deterministic task traces
        # transport counters (surface in stats())
        self.remote_tasks = 0
        self.redispatched_tasks = 0
        self.worker_failures = 0
        self.local_fallbacks = 0
        self.dup_results = 0

    def _register_metrics(self) -> None:
        super()._register_metrics()
        m = self.metrics
        self.m_remote_tasks = m.counter(
            "remote_tasks_total", "packed tasks shipped to the worker pool")
        self.m_redispatched = m.counter(
            "redispatched_tasks_total",
            "tasks re-dispatched after their owner was declared lost")
        self.m_heartbeat_misses = m.counter(
            "heartbeat_misses_total",
            "owners declared lost (dead process, or dispatched with no "
            "heartbeat inside stall_timeout_s)")
        self.m_worker_failures = m.counter(
            "worker_failures_total", "workers removed from the alive set")
        self.m_local_fallbacks = m.counter(
            "local_fallbacks_total",
            "tasks the front end evaluated itself (no surviving workers)")
        self.m_dup_results = m.counter(
            "dup_results_total",
            "straggler results arriving after their task was re-dispatched")

    # -- transport hook ------------------------------------------------------

    def _eval_groups(self, packed, eval_fn) -> None:
        if not packed:
            return
        kind = ("rung" if getattr(eval_fn, "__name__", "")
                == "eval_rung_cohorts" else "mega")
        task_traces: Dict[int, str] = {}
        payloads: Dict[int, bytes] = {}
        encode_s: Dict[int, float] = {}
        for tid, (group, cohorts) in enumerate(packed):
            # deterministic per-dispatch trace; the wire header carries just
            # enough for the worker to re-derive its parent span id
            ttrace = trace.span_id("substrat-tasks", str(self._task_seq))
            self._task_seq += 1
            task_traces[tid] = ttrace
            t0 = time.perf_counter()
            payloads[tid] = wire.dumps(
                {"kind": kind,
                 "cohorts": [cohort_payload(tc) for tc in cohorts]},
                kind="task", trace=trace.child_ctx(ttrace, "dispatch"))
            encode_s[tid] = time.perf_counter() - t0
        results = self._run_remote(payloads,
                                   {tid: len(g) for tid, (g, _) in
                                    enumerate(packed)},
                                   task_traces, encode_s)
        for tid, (group, cohorts) in enumerate(packed):
            status, val, share, spans = results[tid]
            self._fold_task_spans(group, spans)
            if status == "ok":
                self._record_group(group, cohorts, val, share)
            else:
                # remote failure: same blame isolation as in-process (a
                # poison job must not doom its co-riders); the solo retries
                # run locally through eval_fn
                self._isolate_failure(group, cohorts, eval_fn, val)

    def _eval_local(self, payload_bytes: bytes, group_size: int):
        """Evaluate one task in the front end, on the scheduler's device."""
        t0 = time.perf_counter()
        try:
            outs = eval_task(wire.loads(payload_bytes), self.device)
        except Exception as e:   # noqa: BLE001 — blame isolation upstream
            return ("exc", e, 0.0)
        return ("ok", outs, (time.perf_counter() - t0) / group_size)

    def _run_remote(self, payloads: Dict[int, bytes],
                    group_sizes: Dict[int, int],
                    task_traces: Optional[Dict[int, str]] = None,
                    encode_s: Optional[Dict[int, float]] = None,
                    ) -> Dict[int, tuple]:
        """Dispatch wire payloads across the pool; collect with recovery.

        Returns ``{task_id: ("ok", outs, share, spans) |
        ("exc", error, 0.0, spans)}``.  ``spans`` is the task's stitched
        timeline: one dispatch span per attempt (a re-dispatch after a lost
        owner appears as a distinct retry span), each with a front-end
        queue_wait child and — for the attempt that completed — the
        worker-attached deserialize/eval/serialize children (DESIGN.md
        §15.2)."""
        task_traces = task_traces or {}
        encode_s = encode_s or {}
        n_tasks = len(payloads)
        results: Dict[int, tuple] = {}
        spans: Dict[int, list] = {tid: [] for tid in payloads}
        attempts: Dict[int, int] = {tid: 0 for tid in payloads}
        open_d: Dict[int, dict] = {}   # tid -> open dispatch span
        open_q: Dict[int, dict] = {}   # tid -> open queue_wait child
        pending = set(payloads)
        owner: Dict[int, int] = {}
        dispatched_at: Dict[int, float] = {}
        last_beat: Dict[int, float] = {}
        self.remote_tasks += n_tasks
        self.m_remote_tasks.inc(n_tasks)

        def _open_dispatch(tid, w):
            tt = task_traces.get(tid)
            if tt is None:
                return
            now_w = time.time()
            a = attempts[tid]
            d = trace.make_span(tt, "dispatch", now_w, now_w, attempt=a,
                                attrs={"worker": int(w),
                                       "bytes": len(payloads[tid]),
                                       "encode_s": encode_s.get(tid, 0.0)})
            q = trace.make_span(tt, "queue_wait", now_w, now_w, attempt=a,
                                parent_id=d["span_id"],
                                attrs={"worker": int(w)})
            open_d[tid], open_q[tid] = d, q

        def _note_beat(w):
            # a beat fires at task pickup: close the queue_wait of the
            # earliest-dispatched task still waiting on this worker
            waiting = [tid for tid in pending
                       if owner.get(tid) == w and tid in open_q]
            if waiting:
                tid = min(waiting, key=lambda t: dispatched_at[t])
                q = open_q.pop(tid)
                q["t1"] = time.time()
                spans[tid].append(q)

        def _close_dispatch(tid, outcome) -> Optional[dict]:
            now_w = time.time()
            q = open_q.pop(tid, None)
            if q is not None:       # never picked up: waited the whole time
                q["t1"] = now_w
                q["attrs"]["outcome"] = outcome
                spans[tid].append(q)
            d = open_d.pop(tid, None)
            if d is not None:
                d["t1"] = now_w
                d["attrs"]["outcome"] = outcome
                spans[tid].append(d)
            return d

        def _dispatch(tids, alive):
            amap = assign_shards(n_tasks, list(alive), self.pool.n_workers)
            now = time.monotonic()
            for tid in sorted(tids):
                w = amap[tid]
                owner[tid] = w
                dispatched_at[tid] = now
                self.pool.send(w, ("eval", tid, payloads[tid], attempts[tid]))
                _open_dispatch(tid, w)

        def _fall_back_locally(tids):
            self.local_fallbacks += len(tids)
            self.m_local_fallbacks.inc(len(tids))
            for tid in sorted(tids):
                _close_dispatch(tid, "lost")
                w0 = time.time()
                status, val, share = self._eval_local(payloads[tid],
                                                      group_sizes[tid])
                tt = task_traces.get(tid)
                if tt is not None:
                    spans[tid].append(trace.make_span(
                        tt, "local_fallback", w0, time.time(),
                        attempt=attempts[tid], attrs={"outcome": status}))
                results[tid] = (status, val, share)
                pending.discard(tid)

        alive = self.pool.alive_workers()
        if not alive:
            _fall_back_locally(set(pending))
            return {tid: (*r, spans[tid]) for tid, r in results.items()}
        _dispatch(pending, alive)

        while pending:
            msg = self.pool.recv(self.poll_s)
            if msg is not None:
                op = msg[0]
                if op in ("hello", "beat"):
                    w = msg[1]
                    last_beat[w] = time.monotonic()
                    self.heartbeat.last_seen[w] = last_beat[w]
                    if op == "beat":
                        _note_beat(w)
                elif op in ("done", "error"):
                    # explicit per-op indices: replies end with the worker's
                    # span list
                    if op == "done":
                        tid, w, dt = msg[1], msg[2], msg[4]
                        wspans = msg[5] if len(msg) > 5 else []
                    else:
                        tid, w, dt = msg[1], msg[2], msg[5]
                        wspans = msg[6] if len(msg) > 6 else []
                    self.heartbeat.beat(w, dt)
                    last_beat[w] = time.monotonic()
                    if tid not in pending:
                        self.dup_results += 1   # straggler after re-dispatch
                        self.m_dup_results.inc()
                        continue
                    spans[tid].extend(wspans)
                    d = _close_dispatch(tid, "ok" if op == "done" else "error")
                    self.m_dispatches.inc(mode="remote")
                    self.m_dispatch_latency.observe(dt, mode="remote")
                    torchprof.dispatch_event("remote_dispatch", dt,
                                             worker=int(w),
                                             attempt=attempts[tid])
                    if op == "done":
                        t0 = time.perf_counter()
                        outs = wire.loads(msg[3])
                        if d is not None:
                            d["attrs"]["reply_bytes"] = len(msg[3])
                            d["attrs"]["decode_s"] = time.perf_counter() - t0
                        results[tid] = ("ok", outs, dt / group_sizes[tid])
                    else:
                        results[tid] = ("exc", RemoteEvalError(
                            f"worker {w}: {msg[3]}\n{msg[4]}"), 0.0)
                    pending.discard(tid)
                continue   # drain the queue before running failure checks

            # no message this tick: look for dead or stalled owners
            now = time.monotonic()
            alive_now = set(self.pool.alive_workers())
            lost = set()
            for tid in pending:
                w = owner[tid]
                if w not in alive_now:
                    lost.add(w)
                elif (now - dispatched_at[tid] > self.stall_timeout_s
                      and last_beat.get(w, -1.0) < dispatched_at[tid]):
                    lost.add(w)   # dispatched, never beat: stalled
            if not lost:
                continue
            for w in lost:
                self.pool.kill(w)
            self.worker_failures += len(lost)
            self.m_worker_failures.inc(len(lost))
            self.m_heartbeat_misses.inc(len(lost))
            orphans = {tid for tid in pending if owner[tid] in lost}
            for tid in sorted(orphans):
                _close_dispatch(tid, "lost")
                attempts[tid] += 1   # the next dispatch is a visible retry
            survivors = self.pool.alive_workers()
            if survivors:
                self.redispatched_tasks += len(orphans)
                self.m_redispatched.inc(len(orphans))
                _dispatch(orphans, survivors)
            else:
                _fall_back_locally(orphans)
        return {tid: (*r, spans[tid]) for tid, r in results.items()}

    # -- checkpointed stepping ----------------------------------------------

    def step(self) -> bool:
        worked = super().step()
        self._step_no += 1
        if (worked and self.ckpt_dir is not None
                and self._step_no % self.ckpt_every == 0):
            self.save_checkpoint_to(self.ckpt_dir, self._step_no,
                                    keep=self.ckpt_keep)
        return worked

    def resume(self) -> Optional[int]:
        """Restore the newest complete checkpoint from ``ckpt_dir`` (a
        restarted front end picks up mid-flight jobs at the last recorded
        rung boundary).  Returns the restored step, or None."""
        if self.ckpt_dir is None:
            return None
        step = self.restore_checkpoint(self.ckpt_dir)
        if step is not None:
            self._step_no = step
        return step

    def close(self) -> None:
        self.pool.close()

    def stats(self) -> dict:
        out = super().stats()
        out["transport"] = {
            "workers_alive": len(self.pool.alive_workers()),
            "workers_total": self.pool.n_workers,
            "remote_tasks": self.remote_tasks,
            "redispatched_tasks": self.redispatched_tasks,
            "worker_failures": self.worker_failures,
            "local_fallbacks": self.local_fallbacks,
            "dup_results": self.dup_results,
        }
        return out


# ---------------------------------------------------------------------------
# HTTP front end (stdlib http.server / urllib)
# ---------------------------------------------------------------------------


def _send_json(handler, code: int, obj,
               headers: Optional[Dict[str, str]] = None) -> None:
    body = json.dumps(obj).encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for name, value in (headers or {}).items():
        handler.send_header(name, value)
    handler.end_headers()
    handler.wfile.write(body)


def _send_wire(handler, code: int, blob: bytes) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", "application/x-substrat-wire")
    handler.send_header("Content-Length", str(len(blob)))
    handler.end_headers()
    handler.wfile.write(blob)


def _send_text(handler, code: int, text: str, content_type: str) -> None:
    body = text.encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class SubStratHTTPServer:
    """HTTP transport in front of a ``SubStratServer`` (DESIGN.md §14.6).

    Endpoints (all state touched under one lock; a single stepping thread
    advances the scheduler whenever jobs are pending):

    - ``POST /v1/submit`` — wire payload ``{"X", "y", "tenant", "seed",
      "plan", "X_test", "y_test"}`` → ``{"job_id": N}``; ``429`` with a
      ``Retry-After`` header when the tenant's token bucket is empty
    - ``GET /v1/poll?job_id=N&since=K`` — JSON ``JobStatus`` including the
      leaderboard entries from index ``K`` (streamed partial results)
    - ``GET /v1/result?job_id=N`` — wire ``SubStratResult``; ``202`` while
      the job is still running, ``500`` with the error if it failed
    - ``GET /v1/stats`` — JSON scheduler + tenant statistics
    - ``GET /v1/metrics`` — Prometheus text exposition (scheduler registry
      + process-global kernel build and launch counters; DESIGN.md §15.3)
    - ``GET /v1/trace?job_id=N`` — JSON span records of one job's timeline
    """

    def __init__(self, server: SubStratServer, host: str = "127.0.0.1",
                 port: int = 0, admission_grace_s: float = 0.25):
        self.server = server
        # one scheduler step can be long (a remote dispatch), and it runs
        # under this lock — the grace window lets a client land its whole
        # batch of submissions before the stepping thread starts, so
        # co-submitted jobs merge instead of queueing behind the first step
        self.admission_grace_s = admission_grace_s
        self._last_submit = 0.0
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):   # noqa: D102 — quiet by design
                pass

            def do_GET(self):
                outer._route(self, "GET")

            def do_POST(self):
                outer._route(self, "POST")

        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._threads: List[threading.Thread] = []

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "SubStratHTTPServer":
        for target in (self.httpd.serve_forever, self._drive):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _drive(self) -> None:
        while not self._stop.is_set():
            if time.monotonic() - self._last_submit < self.admission_grace_s:
                time.sleep(self.admission_grace_s / 5)
                continue
            with self._lock:
                worked = (self.server.scheduler.step()
                          if self.server.scheduler.pending() else False)
            if not worked:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    # -- routing -------------------------------------------------------------

    def _route(self, handler, method: str) -> None:
        try:
            parsed = urllib.parse.urlsplit(handler.path)
            qs = dict(urllib.parse.parse_qsl(parsed.query))
            route = (method, parsed.path)
            if route == ("POST", "/v1/submit"):
                length = int(handler.headers.get("Content-Length", 0))
                req = wire.loads(handler.rfile.read(length))
                self._last_submit = time.monotonic()
                try:
                    with self._lock:
                        job_id = self.server.submit(
                            req["X"], req["y"],
                            tenant=req.get("tenant") or "default",
                            seed=int(req.get("seed") or 0), plan=req.get("plan"),
                            X_test=req.get("X_test"), y_test=req.get("y_test"))
                except RateLimited as e:
                    _send_json(
                        handler, 429,
                        {"error": str(e), "retry_after_s": e.retry_after_s},
                        headers={"Retry-After":
                                 str(max(1, math.ceil(e.retry_after_s)))})
                    return
                self._last_submit = time.monotonic()
                self._wake.set()
                _send_json(handler, 200, {"job_id": job_id})
            elif route == ("GET", "/v1/poll"):
                job_id = int(qs["job_id"])
                since = int(qs.get("since", 0))
                with self._lock:
                    status = self.server.poll(job_id, since=since)
                _send_json(handler, 200, dataclasses.asdict(status))
            elif route == ("GET", "/v1/result"):
                job_id = int(qs["job_id"])
                with self._lock:
                    job = self.server.scheduler.jobs.get(job_id)
                    if job is None:
                        _send_json(handler, 404,
                                   {"error": f"unknown job {job_id}"})
                    elif job.phase == "failed":
                        _send_json(handler, 500, {"error": repr(job.error)})
                    elif job.active:
                        _send_json(handler, 202, {"phase": job.phase})
                    else:
                        _send_wire(handler, 200,
                                   wire.dumps(job.result, kind="result"))
            elif route == ("GET", "/v1/stats"):
                with self._lock:
                    stats = self.server.stats()
                _send_json(handler, 200, stats)
            elif route == ("GET", "/v1/metrics"):
                with self._lock:
                    text = self.server.metrics_text()
                _send_text(handler, 200, text,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif route == ("GET", "/v1/trace"):
                job_id = int(qs["job_id"])
                with self._lock:
                    payload = self.server.trace(job_id)
                if payload is None:
                    _send_json(handler, 404,
                               {"error": f"unknown job {job_id}"})
                else:
                    _send_json(handler, 200, payload)
            else:
                _send_json(handler, 404,
                           {"error": f"no route {method} {parsed.path}"})
        except wire.WireVersionError as e:
            _send_json(handler, 426, {"error": str(e)})   # upgrade required
        except (BrokenPipeError, ConnectionResetError):   # pragma: no cover
            pass
        except Exception as e:   # noqa: BLE001 — surface, don't crash serve
            try:
                _send_json(handler, 500, {"error": repr(e)})
            except (BrokenPipeError, ConnectionResetError):  # pragma: no cover
                pass


class SubStratHTTPClient:
    """Stdlib (urllib) client for ``SubStratHTTPServer``."""

    def __init__(self, url: str, timeout_s: float = 600.0):
        # generous default: any request can queue behind one full scheduler
        # step before it is served
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _request(self, path: str, data: Optional[bytes] = None):
        req = urllib.request.Request(
            self.url + path, data=data,
            headers=({"Content-Type": "application/x-substrat-wire"}
                     if data is not None else {}))
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    @staticmethod
    def _json(body: bytes) -> dict:
        return json.loads(body.decode("utf-8"))

    def submit(self, X, y, *, tenant: str = "default", seed: int = 0, plan=None,
               X_test=None, y_test=None) -> int:
        payload = wire.dumps({
            "X": np.asarray(X), "y": np.asarray(y), "tenant": tenant,
            "seed": int(seed), "plan": plan,
            "X_test": None if X_test is None else np.asarray(X_test),
            "y_test": None if y_test is None else np.asarray(y_test),
        }, kind="submit")
        status, body = self._request("/v1/submit", data=payload)
        if status != 200:
            raise RuntimeError(f"submit failed ({status}): {body!r}")
        return self._json(body)["job_id"]

    def poll(self, job_id: int, since: int = 0) -> dict:
        status, body = self._request(
            f"/v1/poll?job_id={job_id}&since={since}")
        if status != 200:
            raise RuntimeError(f"poll failed ({status}): {body!r}")
        return self._json(body)

    def stream_leaderboard(self, job_id: int, poll_s: float = 0.05,
                           timeout_s: float = 600.0):
        """Yield each rung's leaderboard entry exactly once, until the job
        finishes (streamed partial results over plain polling)."""
        since = 0
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            st = self.poll(job_id, since=since)
            for entry in st["leaderboard"]:
                yield entry
            since = st["leaderboard_total"]
            if st["phase"] in ("done", "failed"):
                return
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still active after {timeout_s}s")

    def result(self, job_id: int, timeout_s: float = 600.0,
               poll_s: float = 0.05):
        """Block until ``job_id`` finishes; returns its ``SubStratResult``
        (model params as host numpy arrays)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status, body = self._request(f"/v1/result?job_id={job_id}")
            if status == 200:
                return wire.loads(body)
            if status == 202:
                time.sleep(poll_s)
                continue
            raise RuntimeError(f"result failed ({status}): {body!r}")
        raise TimeoutError(f"job {job_id} still active after {timeout_s}s")

    def stats(self) -> dict:
        status, body = self._request("/v1/stats")
        if status != 200:
            raise RuntimeError(f"stats failed ({status}): {body!r}")
        return self._json(body)

    def metrics(self) -> str:
        """The server's Prometheus text exposition (``/v1/metrics``)."""
        status, body = self._request("/v1/metrics")
        if status != 200:
            raise RuntimeError(f"metrics failed ({status}): {body!r}")
        return body.decode("utf-8")

    def trace(self, job_id: int) -> dict:
        """One job's span records: ``{"job_id", "trace_id", "spans"}`` —
        feed ``spans`` to ``obs.trace.render_timeline`` for the ASCII view."""
        status, body = self._request(f"/v1/trace?job_id={job_id}")
        if status != 200:
            raise RuntimeError(f"trace failed ({status}): {body!r}")
        return self._json(body)

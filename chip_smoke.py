#!/usr/bin/env python3
"""Run the PyTorch port of SubStrat, and its LM serving slice, on one CUDA
card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the build of the CUDA kernels from ``src/repro_torch/csrc``, and a probe of
   the machine (host loop speed, wall time per small launch, device copy rate,
   clocks) so that runs on different machines can be told apart.  Then
   ``factorize`` of D1's training table on the card against the same
   function on the CPU and against the per-column NumPy loop
   (``np.unique``, ``np.quantile``): exact; the card's median time over 5
   calls.
2. The masked-histogram kernel against its plain version, through both of
   its entries.  The gathered entry, which the main path calls, at paper
   dataset D1 (100 candidates of 322 rows x 23 columns gathered from the
   103,904-row table, B = 256) and at edge shapes (ragged P, M and B no
   multiple of 4, tiles across candidates, padding bins, large B): exact.
   A row index outside the table must stop the kernel with an error, in a
   process of its own (its CUDA context is unusable after).
   The unindexed entry on the same fold (322, 2300) and the padding edges:
   exact with uniform weights, fractional weights within rtol = atol = 1e-5.
   Timed beside its plain version, one ``torch.bincount`` call and its bound,
   with its device time and its host time per call.
3. The fused Gen-DST kernel against its plain version at (100, 23, 256) and
   at ragged P, with one F(D) for all candidates and with one per candidate
   (as ``gen_dst_batch`` passes it), and at edge shapes
   (fractional counts and delta, 100 and 600 columns, more than a CTA's 32
   warps, slabs of a size or at an address no multiple of 16 bytes, one
   column, B no multiple of 4): counts bit-equal, fitness within 1e-6.  Timed the same
   way.
4. The small-input check: Gen-DST on the card (kernels) and on the CPU (plain
   versions) from the same draws must find the same subset.  Then a full-size
   search under ``torch.cuda.set_sync_debug_mode("error")``: no operation in
   the generation loop may wait for the host.
5. The main path: ``execute(plan("gen_dst"), ...)`` on D1 at full scale with
   the paper's defaults, both AutoML passes on the batched default backend.
   Both kernels' launch counters are zeroed just before and read just after,
   and must have risen.  The reported DST fitness must
   match a plain recomputation within 1e-6, and the test accuracy must be a
   finite number in [0, 1].
6. Where the time goes: the Gen-DST phase alone and the whole ``execute``
   again under ``torch.profiler``: the device-busy share of the wall time and
   the kernels with the most device time; for Gen-DST also its device
   operations per generation and B1's and B2's share of its device time.
7. The flash-attention kernel against its plain version at zamba2's prefill
   shape (B 4, S 1024, 32 heads, hd 80, bf16, causal) and at edge shapes
   (GQA, MQA with hd 256, ragged S, float32, non-causal; for the bf16 wgmma
   body also hd 80 with Sq no multiple of its 128-row tile, Skv > Sq
   non-causal, ragged hd 256 MQA, and hd 20, which the wrapper pads), and at
   phase 14's shapes (the qwen2-moe, phi-3-vision (hd 96) and kimi-k2 (GQA
   64/8, hd 112) prefills, whisper's non-causal encoder over 1500 frames and
   its cross-attention of 4 queries over them, float32 at hd 96 and 4 x
   1500): bf16 within 2e-2, float32 within 2e-5.  Timed beside its plain
   version, ``scaled_dot_product_attention`` and its bound, with its
   achieved TFLOP/s and share of the bound, at the zamba2, qwen2-moe,
   phi-3-vision and kimi-k2 prefill shapes.
8. The SSD-scan kernel against its plain version at zamba2's shape (B 4,
   S 1024, 80 heads, P = N = 64, bf16: the chunked body, chunks of 128) and
   at edge shapes (G > 1 with a partial chunk, small Q, float32, N 128, and
   for the chunked body S < chunk and N 128): y within 5e-2 (bf16) and 1e-3
   (float32) of the plain version run in float32 on the same values, the
   final state within 1e-3 relative.  Timed the same way, with the device
   time of each of the chunked body's three kernels by name.
9. The LM serving path: the hybrid smoke config in float32 on the card and
   the CPU (logits within 1e-4, greedy tokens equal); then
   ``launch.serve.main`` for zamba2-2.7b at full width (batch 4, prompt 1024,
   32 tokens, bf16, seeded weights), with both kernels' launch counters
   zeroed before and read after (9 and 54 per prefill), finite logits; warm
   prefill and decode times and the profile of each; decode steps under
   ``torch.cuda.set_sync_debug_mode("error")`` (no step may wait for the
   host); and the serving invariant (decode step t = forward at t within
   1e-2) at full width and 12 layers in float32.
10. The AutoML backends on the card: rung 0 of D1's sub-AutoML (the 24
   sampled specs on phase 5's subset) through the batched and the loop
   backend, every trial's validation accuracy within 2/N_val of the other's
   (and how many differ at all); the batched rung under
   ``torch.cuda.set_sync_debug_mode("error")`` from its inputs on the card to
   its one copy back; a hetero-shape ``eval_rung_cohorts`` and a mixed-step
   ``eval_trial_megabatch`` against each cohort run solo, within the same
   tolerance; a ``time_budget_s`` run that stops between sub-batches; then
   ``execute`` timed with each backend (loop, batched, batched, loop), and
   the sub-AutoML phase of each under ``torch.profiler``: its device
   operations per rung and its device-busy share.
11. The other subset strategies.  (a) At a small size, each of the 8
   baselines and ``asp_proxy`` on the card (mc through both kernels) and
   on the CPU (plain versions) from the same draws: the same subset, or at
   a fitness near-tie a subset whose fitness is within 1e-6.  (b) On D1 at
   full scale with the reference's default options (mc budget 100, batch
   50; mab 200 rounds; greedy pools of 64): each through ``run_strategy``
   (first call and warm), with B1/B2 launches per search (mc must launch
   both), the reported fitness against a plain recomputation (1e-6), the
   device-busy share and device operations of a search under
   ``torch.profiler``, and the search under
   ``torch.cuda.set_sync_debug_mode("error")`` (every one but
   ``asp_proxy``, host numpy by design); then every registered strategy
   through ``execute`` end to end (phase seconds, test accuracy in [0, 1]).
   (c) ``gen_dst_batch`` on D1 and 3 copies of its spec with other seeds:
   each result bit-equal to its solo run, B1 and B2 launched once per
   generation for the 4, no host wait, timed beside the 4 solo runs
   (solo, batch, batch, solo) and profiled.
12. The service (``service/``): a ``SubStratServer(batch_dst=True)`` on the
   card serves five jobs of four tenants at full width (the paper's
   defaults, batched AutoML backend), all submitted before the first step:
   D1, two copies of its spec with dataset seeds 11 and 12 (their searches
   merge into one ``gen_dst_batch``), D1 again (a cache hit that waits for
   the leader's winner family and fine-tunes it), and D7 (another shape,
   searched solo).  Checks: every job done with a test accuracy in [0, 1];
   B1 and B2 launched once per generation for the merged group and once per
   generation for D7; each merged job's subset equal to its solo run from
   the same seed; each DST fitness against a plain recomputation (1e-6);
   one cache hit, three merged searches, a megabatch dispatch spanning
   jobs; each table coded on the card hashes to its job's fingerprint; the
   metrics text parses and holds every family the scheduler registers; no
   kernel built during the run.  Then a sixth job (D1's spec,
   seed 13) must start from the portfolio with fewer rung-0 trials than a
   cold job.  Prints each job's phase seconds and spans, the five jobs
   through ``execute`` one after another against the server's wall time
   (solo, served, served, solo), a profiled served run (busy share, device
   operations, B1 + B2's share) and the host waits of each ``step`` of one
   D1 job under ``torch.cuda.set_sync_debug_mode("warn")``.
13. The multi-process tier (``service/transport.py``, ``worker.py``,
   ``wire.py``, ``distributed/checkpoint.py``): a
   ``DistributedScheduler(batch_dst=True)`` behind ``SubStratHTTPServer``,
   with a ``ProcessWorkerPool`` of two worker processes on the card (each
   hello must name ``cuda``) and worker 0 killed at its first task, serves
   three jobs submitted through ``SubStratHTTPClient`` at full width: D1,
   D1's spec with dataset seed 11 (its search merges with D1's) and D7.
   Checks: every job done with a test accuracy in [0, 1]; one worker
   failure and at least one re-dispatch; each job's subset, DST fitness,
   winner specs and trial accuracies equal to the same jobs on an
   in-process ``Scheduler`` in the same call (bit-equal, else within
   2/N_val with the differing parts named); B1 and B2 launched 62 times
   each in the front end (the merged D1 pair's generations and D7's);
   a streamed leaderboard of at least 2 entries; ``/v1/metrics`` parses and
   holds the transport's families; the killed task's job shows a retry
   dispatch with the worker's deserialize, eval and serialize children.
   Then a checkpointed front end stops after step 2 and a fresh one on a
   new pool resumes it to the in-process results.  Prints the workers' boot
   seconds, each remote dispatch's bytes and codec times against the
   worker's eval seconds and the front end's dispatch span, the served wall
   against in-process (in-process, HTTP, HTTP, in-process) and the host
   waits of each front-end step of one D1 job (sync-debug "warn").  The
   two workers and the front end share the one card.

14. The moe, vlm and encdec families.  (a) The qwen2-moe, kimi-k2,
   phi-3-vision and whisper-base smoke configs in float32, the same weights
   and inputs on the card and the CPU: logits within 1e-4, 8 greedy tokens
   equal.  (b) At full width in bf16 with seeded weights, batch 4:
   qwen2-moe-a2.7b through ``launch.serve.main`` (all 24 layers, prompt
   1024, 32 tokens), phi-3-vision-4.2b (32 layers, 256 patch embeddings +
   768 text tokens, 32 tokens) and whisper-base (6 + 6 layers, 1500 frames,
   a 4-token prompt, 64 tokens) through their model entry points, kimi-k2
   cut to one layer (prompt 1024, 16 tokens) through ``serve.generate``.
   B3's launch counters are zeroed before each prefill and read after it
   and after decode: 24, 32, 18 and 1 per prefill, none in decode; finite
   logits, ids in range; cold and warm prefill, decode ms/token, tokens/s,
   peak memory, qwen2-moe's useful TFLOP/s (``launch/flops``), its prefill
   and decode profiled (B3's share of the prefill's device time) and the
   device operations of one MoE block at a decode step.  (c) Decode steps of
   qwen2-moe, phi-3-vision and whisper under sync-debug "error".  (d) The
   serving invariant in float32 (decode = forward within 1e-2): qwen2-moe
   at full width and 4 layers with capacity factor E / k (forward drops no
   token), phi-3-vision at full width and 8 layers with patch embeddings,
   whisper-base whole.

15. Training (``train/``, ``data/pipeline.py``, the training half of
   ``distributed/``, ``launch/train.py``).  (a) The zamba2-2.7b and
   granite-3-2b smoke configs in float32: three steps of two microbatches
   from the same params on the card and the CPU, loss and grad norm within
   1e-4 relative, params within 2 lr per step; B3 and B4 launched 2 x 3 x
   their count per forward.  (b) ``launch.train.main`` for zamba2-2.7b at
   full width (54 layers, bf16 compute, float32 params, AdamW; 4 x 512
   positions a step in 2 microbatches; a 2048-sequence corpus cut to 256 by
   Gen-DST; a checkpoint every 4 steps, one of the 29 GB state) for 4
   steps, launch counters zeroed
   before and read after: B1 and B2 in the subset selection, B3 18 and B4
   108 per step, no call of any kernel's plain version; finite loss and
   grad norm; peak memory.  Then the same with 6 steps must resume at step
   4 from the checkpoint: its first loss is the checkpointed state's on the
   loader's step-4 batch (the loader's state restored).  (c) Warm steps: ms/step, tokens/s and MFU
   (``launch/flops`` over 989 TFLOP/s, a reading) and peak memory, with
   remat (the config's default, as the reference's launcher trains) and
   then without it; one step under the profiler (busy share, top kernels,
   B3's and B4's shares and those of ``_sdpa``'s and ``_ssd_chunked``'s
   recomputation in the backward); the host waits inside one step
   (sync-debug "warn").  Phases (a)-(c) run with remat: B3 and B4 run in
   each forward and again in its recomputation (2 x 2 x 3 x their count per
   forward in (a); 36 and 216 per step in (b)).  (d) The reference's
   ``train_4k`` length: zamba2-2.7b's published config, uncut, on 2 x 4096
   positions a step in 2 microbatches of 1 x 4096 (the reference's global
   batch of 256 and grad_accum 8 cut for one card's time), remat, AdamW,
   no checkpoint: one untimed and 3 timed steps (ms/step, tokens/s, MFU,
   peak memory), B3 36 and B4 216 launches per step, finite loss and grad
   norm, one profiled step; and whether B3 and B4 give bit-equal outputs
   on a second call with the same inputs at that shape (what a recomputed
   forward saves for the backward).

16. The mesh layer (``launch/mesh.py``, ``distributed/sharding.py``,
   ``distributed/compression.py``, ``models/pmm.py``, ``restore_resharded``)
   on one card: a world-size-1 NCCL process group and a (1, 1) (data,
   model) CUDA mesh; zamba2-2.7b's param, AdamW and Adafactor state and
   cache specs in every mode, all None; ``compressed_psum`` equal to the
   int8 round trip; ``pmm`` with DTensor operands at zamba2's MLP up and q
   projections in bf16 and float32 against ``torch.einsum`` autograd
   (within 1e-2 and 1e-5 of the largest magnitude), dW in its spec's
   placements; a small training checkpoint restored onto the mesh, every
   global value the saved one.

17. The dry-run (``launch/dryrun.py``, ``launch/costs.py``) on the card:
   a world-size-1 NCCL group and a (1, 1) CUDA mesh; zamba2-2.7b's
   published config at two one-card cells, train_4k_card (2 x 4096 in 2
   microbatches of 1 x 4096, AdamW, remat) and prefill_card (4 x 1024).
   Each is first estimated by ``dryrun.run_cell`` on fake CUDA tensors, then
   built for real from the same ``build_cell`` (seeded) and its step run
   once under the same FLOP counter: B3 36 and B4 216 launches (train), 9
   and 54 (prefill), no plain version called, finite loss and grad norm or
   logits; the estimated peak within 15 % of ``max_memory_allocated``, the
   FLOPs within 1e-6; the roofline terms, model FLOPs and the useful ratio
   printed.  Then zamba2-2.7b train_4k traced on the (16, 16) production
   mesh over a fake process group, in a subprocess.

18. The entry points of the JAX package's ``examples/`` through their port
   modules (``launch/quickstart.py``, ``compare.py``, ``automl_tabular.py``'s
   ``run_dataset``, the four gates, ``serve_lm.py``, ``train_lm.py``).  (a)
   The quickstart at its defaults (D3 at scale 0.5, 10 trials, batched,
   Gen-DST), then with the loop backend and with ``ig_km`` at the CI's
   scale 0.1 and 4 trials.  (b) ``compare.run_dataset`` at the paper
   datasets' full size: D6 (17,415 rows x 8) with all nine methods and D1
   (129,880 x 22) with SubStrat and SubStrat-NF; for each, one untimed call
   at scale 0.1, then two timed calls back to back between two machine
   probes, printing per method its seconds, time-reduction, test accuracy,
   relative accuracy, phase seconds and B1/B2 launches.  Every accuracy
   must be finite in [0, 1], each Gen-DST method's DST fitness within 1e-6
   of a plain recomputation, B1 and B2 launched in SubStrat and
   SubStrat-NF and neither in Full-AutoML.  (c) The four gates return 0:
   warm start, metrics (B1/B2 launches in the exposition), recompile budget
   (no kernel built in the steady state), and chaos parity between
   ``serve_tabular --json`` in process and with two workers, worker 0
   killed.  (d) ``serve_lm`` (qwen3-8b's smoke config; B3 launches) and
   ``train_lm --steps 2`` (mamba2-130m's; B4 launches) in a temporary
   working directory.

Then it prints the ``{"kernels": [...]}`` line (B3's entry also carries its
times at the other prefill shapes and its launches per prefill of each
served model; every entry its launches in the training run, per training
step and per ``train_4k`` step, in each phase-17 cell and in each run of
phase 18), each phase's
seconds, the ``nvidia-smi`` line and, last, ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published memory rate
BF16_OPS_PER_S = 989e12        # H100 SXM published bf16 dense tensor-core rate
FP32_OPS_PER_S = 67e12         # H100 SXM published float32 rate (no tensor cores)
FP64_OPS_PER_S = 34e12         # H100 SXM published float64 rate (no tensor cores)
HIST_TOL = 1e-5                # fractional-weight histogram: rtol = atol
FIT_TOL = 1e-6                 # fused kernel fitness, and DST fitness recomputation
# flash attention against its plain version, max-abs (tests/test_kernels.py:145)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# ||o - o_plain|| / ||o_plain||: scaled to the output, which the absolute
# limit is not where a non-causal row averages ~S/e keys (|o| ~ 0.04 at 1500)
FA_REL_TOL = 1e-2
# SSD scan y against its plain version, max-abs (tests/test_ssd_kernel.py:35);
# its final state within SSD_STATE_RTOL of the state's largest magnitude
SSD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
SSD_STATE_RTOL = 1e-3
# the gathered histogram with a row index outside the table, in a process of
# its own: prints "raised" if the error surfaced and "unusable" if the CUDA
# context stayed broken after it
BAD_ROW_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels.entropy.ops import population_histogram_rows
codes = torch.zeros((10, 3), dtype=torch.int32, device="cuda")
rows = torch.tensor([[0, 10]], dtype=torch.int32, device="cuda")
try:
    population_histogram_rows(codes, rows, 4)
    torch.cuda.synchronize()
except RuntimeError:
    print("raised")
try:
    torch.ones(1, device="cuda").sum().item()
except RuntimeError:
    print("unusable")
"""


def plain_fitness(torch, coded, row_idx, cols) -> float:
    """-|H(d) - H(D)| of a subset of the factorized table ``coded``,
    recomputed with the plain entropy: rows ``row_idx``, columns ``cols``
    (indices or a boolean mask) with the target column added."""
    from repro_torch.core.measures import full_column_entropy, subset_entropy
    B, dev = coded.max_bins, coded.codes.device
    mask = torch.zeros(coded.codes.shape[1], dtype=torch.bool, device=dev)
    mask[torch.as_tensor(cols, device=dev)] = True
    mask[coded.target_col] = True
    rows = torch.as_tensor(row_idx, device=dev)
    return -abs(subset_entropy(coded.codes, rows, mask, B).item()
                - full_column_entropy(coded.codes, B).mean().item())


def phase_seconds(n: int, t0: float) -> float:
    """Print phase ``n``'s seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"phase {n}: {now - t0:.1f} s")
    return now


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def smi_state() -> str:
    """The card's clocks, temperature, power draw and active clock-event
    reasons, to tell one machine's state from another's; never fatal."""
    for reasons in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
             f"power.draw,{reasons}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            return out.stdout.strip().splitlines()[0]
    return "not available"


def machine_probe(torch) -> None:
    """Three yardsticks of the machine, printed beside the results: the host's
    Python speed, the wall time per small launch (what bounds the main path),
    and the device's copy rate."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i
    host_s = time.perf_counter() - t0
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5000):
        x.add_(1)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 5000 * 1e6
    a = torch.empty(1 << 28, device="cuda")                 # 1 GiB
    b = torch.empty_like(a)
    b.copy_(a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        b.copy_(a)
    end.record()
    end.synchronize()
    copy_tbs = 2 * a.numel() * 4 * 10 / (start.elapsed_time(end) / 1e3) / 1e12
    del a, b
    print(f"machine: host loop of 2e6 adds {host_s:.4f} s, {launch_us:.3f} us per small "
          f"launch, device copy {copy_tbs:.3f} TB/s (read + write)")
    print(f"  clocks: {smi_state()}")


def time_ms(torch, fn, label: str, iters: int = 100, repeats: int = 5, warmup: int = 10) -> float:
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls, ``repeats`` times; prints the spread and returns the median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    print(f"  {label}: median {times[len(times) // 2]:.5f} ms, min {times[0]:.5f}, "
          f"max {times[-1]:.5f} ({repeats} x {iters} calls)")
    return times[len(times) // 2]


def host_us(torch, fn, iters: int = 100, repeats: int = 5) -> float:
    """Host time per call in microseconds: the host clock around ``iters``
    back-to-back calls, read before the device is waited for (the launch
    queue holds them all), so the device's time is left out; the median of
    ``repeats`` such runs."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[repeats // 2]


def dev_us(e) -> float:
    """Device microseconds of a profiler event (the attribute's name changed
    across torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernel_device_ms(torch, fn, kernel: str, calls: int = 50):
    """Device time per launch of the CUDA kernel named ``kernel`` over
    ``calls`` calls of ``fn``, from torch.profiler; None if none was seen.
    Unlike ``time_ms`` it leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    return sum(dev_us(e) for e in events) / count / 1e3 if count else None


def profile_share(torch, run, top: int = 8) -> tuple:
    """Run ``run()`` under torch.profiler; print the device-busy share of the
    wall time and the ``top`` kernels that took the most device time.  Returns the
    profiler's device events (kernels and copies, summed by name: ``key``,
    ``count`` and their device time, which ``dev_us`` reads) and the busy
    share (None where no device time was recorded).  The device events are
    read from the profiler's raw results: building its per-operator table
    (``key_averages``) took over a minute for a served fleet's run."""
    import types
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        agg = by_name.setdefault(e.name(), types.SimpleNamespace(
            key=e.name(), count=0, self_device_time_total=0.0))
        agg.count += 1
        agg.self_device_time_total += e.duration_ns() / 1e3
    events = list(by_name.values())
    busy_us = sum(dev_us(e) for e in events)
    if busy_us <= 0:
        print("  profile: no device time recorded (device busy share not measured)")
        return events, None
    print(f"  profile: wall {wall:.3f} s (profiler on), device busy {busy_us / 1e6:.4f} s, "
          f"busy share {busy_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:top]:
        print(f"    {dev_us(e) / 1e3:10.3f} ms  {e.count:7d} x  {e.key[:90]}")
    return events, busy_us / 1e6 / wall


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(out, ref) -> float:
    """||out - ref|| / ||ref||, in float32."""
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# prefill shapes B3 is timed at beside SDPA and its bound: (label, B, S, H, Kh, hd)
FA_TIMED = (("zamba2-2.7b", 4, 1024, 32, 32, 80),
            ("qwen2-moe-a2.7b", 4, 1024, 16, 16, 128),
            ("phi-3-vision-4.2b", 4, 1024, 32, 32, 96),       # 128-column tile, 1/4 padding
            ("kimi-k2-1t-a32b", 4, 1024, 64, 8, 112))         # 128-column tile, 1/8 padding


def numpy_factorize(X, y, max_bins: int = 256, categorical_threshold: int = 64):
    """The per-column NumPy loop ``factorize`` replaces (``np.unique``,
    ``np.quantile``, ``np.searchsorted``): ``(codes, n_bins)``."""
    import numpy as np
    cols = [X[:, j] for j in range(X.shape[1])] + [y]
    codes = np.empty((X.shape[0], len(cols)), np.int32)
    n_bins = np.empty(len(cols), np.int32)
    for j, col in enumerate(cols):
        colf = np.asarray(col, np.float64)
        uniq, inv = np.unique(colf, return_inverse=True)
        if len(uniq) <= max(categorical_threshold, 2) or j == len(cols) - 1:
            codes[:, j], n_bins[j] = inv, len(uniq)
        else:
            qs = np.quantile(colf, np.linspace(0.0, 1.0, max_bins + 1)[1:-1])
            ub, ib = np.unique(np.searchsorted(qs, colf, side="right"), return_inverse=True)
            codes[:, j], n_bins[j] = ib, len(ub)
    return codes, n_bins


def check_factorize(torch, dev, factorize, X, y) -> float:
    """``factorize`` of one table on the card against the same function on
    the CPU and against the NumPy loop, exact; returns the card's median ms
    over 5 calls (each ends with its one read of ``n_bins``)."""
    import numpy as np
    card, cpu = factorize(X, y, device=dev), factorize(X, y, device="cpu")
    ref_codes, ref_bins = numpy_factorize(X, y)
    for name, a, b in (("codes", card.codes, cpu.codes), ("values", card.values, cpu.values),
                       ("n_bins", card.n_bins, cpu.n_bins)):
        if not torch.equal(a.cpu(), b):
            fail(f"factorize: card {name} differ from the CPU's")
    if not (np.array_equal(card.codes.cpu().numpy(), ref_codes)
            and np.array_equal(card.n_bins.cpu().numpy(), ref_bins)):
        fail("factorize: card codes differ from the NumPy loop's")
    if (card.max_bins, card.target_col) != (max(int(ref_bins.max()), 2), X.shape[1]):
        fail("factorize: max_bins or target_col differ from the NumPy loop's")
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        factorize(X, y, device=dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def phase7_flash_attention(torch, dev) -> dict:
    """B3 against its plain version on the card, timed beside its plain
    version, ``scaled_dot_product_attention`` and its bound at each prefill
    shape of ``FA_TIMED``; the first (zamba2) is the kernels line's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, Sq, Skv, H, Kh, hd, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn((B, S, h, hd), generator=gen, device=dev).to(dtype)
                     for S, h in ((Sq, H), (Skv, Kh), (Skv, Kh)))

    main_shape = (4, 1024, 1024, 32, 32, 80, bf16, True)     # zamba2 prefill
    shapes = [
        main_shape,
        (2, 512, 512, 32, 8, 128, bf16, True),     # GQA 32/8, hd 128 (qwen3, llama3)
        (2, 256, 256, 8, 1, 256, bf16, True),      # MQA 8/1, hd 256 (gemma)
        (2, 512, 512, 32, 8, 64, bf16, True),      # hd 64 (granite)
        (2, 300, 300, 32, 32, 80, bf16, True),     # ragged S
        (1, 200, 333, 4, 2, 64, f32, True),        # ragged, Sq != Skv, float32
        (2, 256, 256, 32, 32, 80, f32, True),      # float32 at zamba2's heads
        (2, 256, 192, 8, 2, 128, bf16, False),     # non-causal
        (2, 130, 130, 4, 2, 16, f32, False),       # smoke widths
        (2, 128, 128, 4, 1, 32, f32, True),
        (3, 200, 200, 32, 32, 80, bf16, True),     # hd 80, Sq no multiple of 128
        (2, 200, 333, 8, 2, 80, bf16, False),      # Skv > Sq, non-causal
        (2, 333, 333, 8, 1, 256, bf16, True),      # MQA, hd 256, ragged
        (2, 70, 70, 4, 2, 20, bf16, True),         # hd 20: padded to 24 by the wrapper
        (4, 1024, 1024, 16, 16, 128, bf16, True),  # qwen2-moe prefill
        (4, 1024, 1024, 32, 32, 96, bf16, True),   # phi-3-vision prefill: hd 96
        (4, 1024, 1024, 64, 8, 112, bf16, True),   # kimi-k2 prefill: GQA 64/8, hd 112
        (4, 1500, 1500, 8, 8, 64, bf16, False),    # whisper encoder, 1500 frames
        (4, 4, 1500, 8, 8, 64, bf16, False),       # whisper cross-attention at prefill
        (2, 300, 300, 32, 32, 96, f32, True),      # float32 at hd 96 (phase 14's invariant)
        (2, 4, 1500, 8, 8, 64, f32, False),        # float32 cross-attention, Sq 4
    ]
    main_err = None
    for i, (B, Sq, Skv, H, Kh, hd, dtype, causal) in enumerate(shapes):
        q, k, v = inputs(B, Sq, Skv, H, Kh, hd, dtype, seed=100 + i)
        o_k = flash_attention_cuda(q, k, v, causal=causal)
        o_r = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (o_k.float() - o_r.float()).abs().max().item()
        rel = rel_err(o_k, o_r)
        tol = FA_TOL[_dtype_name(dtype)]
        where = f"{(B, Sq, Skv, H, Kh, hd)} {_dtype_name(dtype)} causal={causal}"
        if not err <= tol:
            fail(f"flash_attention: max_abs_err {err} > {tol} at {where}")
        if not rel <= FA_REL_TOL:
            fail(f"flash_attention: relative error {rel} > {FA_REL_TOL} at {where}")
        print(f"flash_attention B={B} Sq={Sq} Skv={Skv} H={H} Kh={Kh} hd={hd} "
              f"{_dtype_name(dtype)} causal={causal}: max_abs_err {err:.3e}, max|o| "
              f"{o_r.float().abs().max().item():.3e}, relative error {rel:.3e}")
        # faults the relative check must see: the 128-key tile's partial
        # remainder dropped (whisper's 1500 keys), the softmax scale taken
        # from the 128-column tile that hd 96 and 112 are padded to
        planted = []
        if not causal and Skv >= 1024 and Skv % 128:
            cut = Skv % 128
            planted.append((f"last {cut} keys dropped",
                             attention_ref(q, k[:, :-cut], v[:, :-cut], causal=False)))
        if hd in (96, 112):
            planted.append(("softmax scale of the 128-column tile",
                            attention_ref(q.float() * (hd / 128) ** 0.5, k, v, causal=causal)))
        for what, o_f in planted:
            r = rel_err(o_f, o_r)
            print(f"  planted fault ({what}): relative error {r:.3e}")
            if not r > FA_REL_TOL:
                fail(f"flash_attention: the relative check misses a planted fault ({what}) "
                     f"at {where}: {r} <= {FA_REL_TOL}")
        if i == 0:
            main_err = err

    timed = []
    for j, (label, B, S, H, Kh, hd) in enumerate(FA_TIMED):
        q, k, v = inputs(B, S, S, H, Kh, hd, bf16, seed=100 + j)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))   # SDPA's layout
        print(f"flash_attention at {label}'s prefill (B={B}, S={S}, H={H}, Kh={Kh}, hd={hd}, "
              f"bf16, causal):")
        ms_k = time_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True), "kernel",
                       iters=20)
        ms_p = time_ms(torch, lambda: attention_ref(q, k, v, causal=True), "plain", iters=3,
                       repeats=3, warmup=1)
        ms_l = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != Kh), "scaled_dot_product_attention",
            iters=20)
        # q, k, v read once and o written once; 2 * hd multiply-adds per kept
        # (query, key) pair in QK^T and again in PV, S(S+1)/2 pairs per head
        n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
        n_ops = 4 * B * H * hd * S * (S + 1) // 2
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        dev_ms = kernel_device_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True),
                                  "flash_attention_wgmma_kernel", calls=20)
        tile = 128 if 80 < hd <= 128 else hd
        print(f"  kernel {ms_k:.4f} ms, device {dev_ms} ms, plain {ms_p:.4f} ms, sdpa "
              f"{ms_l:.4f} ms, bound {b_ms:.5f} ms ({b_by}); achieved "
              f"{n_ops / (ms_k * 1e-3) / 1e12:.1f} TFLOP/s (causal operations), "
              f"{b_ms / ms_k:.3f} of the bound; kernel / sdpa {ms_k / ms_l:.3f}; "
              f"tile {tile} columns for hd {hd}  [{smi_line()}]")
        timed.append({"shape": label, "B": B, "S": S, "H": H, "Kh": Kh, "hd": hd, "ms": ms_k,
                      "device_ms": dev_ms, "plain_ms": ms_p, "library_ms": ms_l,
                      "bound_ms": b_ms, "bound_by": b_by})
    main = timed[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
            "launches": None, "max_abs_err": main_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed_shapes": timed}


def phase8_ssd_scan(torch, dev) -> dict:
    """B4 against its plain version on the card, y and final state, timed
    beside its plain version and its bound (no one PyTorch call computes it)."""
    from repro_torch.kernels.ssd_scan.kernel import chunk_for, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_model_ref

    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, S, H, P, G, N, dtype, seed):
        """x, B and C as views into one (B, S, H*P + 2*G*N) tensor, as the
        model slices them from its conv output; B and C scaled so that C.B
        has the spread it has at N = 16 in the reference's tests."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        xbc = torch.randn((B, S, H * P + 2 * G * N), generator=gen, device=dev)
        xbc[..., H * P:] *= (16 / N) ** 0.25
        xbc = xbc.to(dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=gen, device=dev)
        a = -(0.5 + 3.5 * torch.rand((H,), generator=gen, device=dev))
        return x, dt, a, bm, cm

    main_shape = (4, 1024, 80, 64, 1, 64, 128, bf16)         # zamba2 prefill
    shapes = [
        main_shape,
        (4, 1024, 80, 64, 1, 64, 128, f32),        # float32 at zamba2's shape
        (2, 300, 16, 32, 4, 32, 64, bf16),         # G = 4, partial last chunk
        (2, 64, 8, 16, 2, 16, 8, f32),             # small Q (smoke chunk)
        (1, 16, 4, 8, 1, 8, 4, f32),               # serving-test widths
        (2, 512, 24, 64, 1, 128, 256, f32),        # mamba2-130m: N 128, Q 256 halved
        (2, 50, 80, 64, 1, 64, 128, bf16),         # S < chunk: one partial chunk
        (2, 512, 24, 64, 1, 128, 256, bf16),       # N 128: chunks of 64 fit
        (2, 64, 8, 16, 2, 16, 8, bf16),            # smoke widths, G = 2
    ]
    main_err = None
    for i, (B, S, H, P, G, N, Q, dtype) in enumerate(shapes):
        x, dt, a, bm, cm = inputs(B, S, H, P, G, N, dtype, seed=200 + i)
        y_k, h_k = ssd_scan_cuda(x, dt, a, bm, cm, block_q=Q)
        # the plain version in float32 on the same values: the kernel rounds
        # its float32 result once, and a second rounding of the plain
        # version's result could flip a last bit against it
        y_r, h_r = ssd_scan_model_ref(x.float(), dt, a, bm.float(), cm.float())
        torch.cuda.synchronize()
        err = (y_k.float() - y_r.float()).abs().max().item()
        h_err = ((h_k - h_r).abs().max() / h_r.abs().max()).item()
        tol = SSD_TOL[_dtype_name(dtype)]
        if not (err <= tol and h_err <= SSD_STATE_RTOL):
            fail(f"ssd_scan: y max_abs_err {err} (limit {tol}), state rel err {h_err} "
                 f"(limit {SSD_STATE_RTOL}) at {(B, S, H, P, G, N, Q)} {_dtype_name(dtype)}")
        print(f"ssd_scan B={B} S={S} H={H} P={P} G={G} N={N} Q={Q} {_dtype_name(dtype)}: "
              f"y max_abs_err {err:.3e}, state rel err {h_err:.3e}")
        if i == 0:
            main_err = err

    B, S, H, P, G, N, Q, dtype = main_shape
    x, dt, a, bm, cm = inputs(B, S, H, P, G, N, dtype, seed=200)
    ms_k = time_ms(torch, lambda: ssd_scan_cuda(x, dt, a, bm, cm, block_q=Q), "kernel",
                   iters=20)
    ms_p = time_ms(torch, lambda: ssd_scan_model_ref(x, dt, a, bm, cm), "plain", iters=2,
                   repeats=3, warmup=1)
    # x, dt, a, B and C read once, y and the final state written once; per
    # chunk the kernel walks (Qk), the C B^T and PV products over the full
    # Qk x Qk tile and the two (Qk, P, N) state products
    Qk = chunk_for(Q, S, P, N, bf16=dtype == bf16)
    es = x.element_size()
    n_bytes = (2 * B * S * H * P * es + B * S * H * 4 + H * 4 + 2 * B * S * G * N * es
               + B * H * P * N * 4)
    n_ops = B * H * math.ceil(S / Qk) * 2 * (Qk * Qk * N + Qk * Qk * P + 2 * Qk * P * N)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    parts = {name: kernel_device_ms(torch, lambda: ssd_scan_cuda(x, dt, a, bm, cm, block_q=Q),
                                    name, calls=20)
             for name in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                          "ssd_chunk_scan_kernel")}
    dev_ms = sum(parts.values()) if all(parts.values()) else None
    print(f"ssd_scan (B={B}, S={S}, H={H}, P={P}, N={N}, block_q={Q}, kernel chunk {Qk}, "
          f"bf16): kernel {ms_k:.4f} ms, device {dev_ms} ms, plain {ms_p:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by})")
    print("  device ms per launch: " + ", ".join(f"{k} {v}" for k, v in parts.items()))
    print(f"  achieved {n_ops / (ms_k * 1e-3) / 1e12:.1f} TFLOP/s (chunk products), "
          f"{b_ms / ms_k:.3f} of the bound")
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:62",
            "launches": None, "max_abs_err": main_err, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
SERVE_ARGV = ["--arch", "zamba2-2.7b", "--preset", "full", "--batch", str(SERVE_BATCH),
              "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN), "--device", "cuda",
              "--seed", "0"]
SERVE_CARD_CPU_TOL = 1e-4      # float32 logits, card (kernels) vs CPU (plain versions)
SERVE_INVARIANT_TOL = 1e-2     # decode step t vs forward at t (tests/test_serve.py)
# per-trial validation accuracy, batched against loop and merged against
# solo: within this many validation rows (tests/test_torch_automl.py)
AUTOML_TOL_ROWS = 2


def phase9_serving(torch, dev, K) -> dict:
    """The LM serving path: the hybrid smoke config on the card and on the
    CPU; ``serve.main`` for zamba2-2.7b at full width with both kernels'
    launches counted; the serving invariant at full width and 12 layers in
    float32; the profile of a prefill and of the decode loop.  Returns the
    main path's launch counts."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.launch import serve
    from repro_torch.models import lm

    arch = get_arch("zamba2-2.7b")
    # (a) small input: the same weights on the card (kernels) and the CPU
    cfg = dataclasses.replace(arch.smoke, dtype=torch.float32)
    params_cpu = lm.init_params(make_generator(0), cfg)
    params_dev = copy.deepcopy(params_cpu).to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=make_generator(1))
    logits_cpu = lm.forward(params_cpu, {"tokens": toks}, cfg)
    logits_dev = lm.forward(params_dev, {"tokens": toks.to(dev)}, cfg)
    err = (logits_dev.cpu() - logits_cpu).abs().max().item()
    ids_cpu = serve.generate(params_cpu, toks[:, :32], cfg, 8).ids
    ids_dev = serve.generate(params_dev, toks[:, :32].to(dev), cfg, 8).ids
    if not err <= SERVE_CARD_CPU_TOL:
        fail(f"serving smoke: card and CPU logits differ by {err} > {SERVE_CARD_CPU_TOL}")
    if not torch.equal(ids_cpu, ids_dev):
        fail(f"serving smoke: greedy tokens differ, card {ids_dev.tolist()} vs CPU "
             f"{ids_cpu.tolist()}")
    print(f"serving smoke ({cfg.name}, float32, S=40): card = CPU, logits max_abs_err "
          f"{err:.3e}, greedy tokens equal")

    # (b) the main path: serve.main at full width, launches counted
    full = arch.config
    torch.cuda.reset_peak_memory_stats()
    print(f"  clocks before serving: {smi_state()}")
    K.reset_launch_counts()
    res = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"  clocks after serving: {smi_state()}")
    n_attn = full.n_layers // full.shared_attn_every
    print(f"main path serve.main({' '.join(SERVE_ARGV)}): launches {launches}; cold "
          f"prefill {res.prefill_ms:.3f} ms, decode {res.decode_ms_per_token:.3f} ms/token; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if launches["flash_attention"] != n_attn or launches["ssd_scan"] != full.n_layers:
        fail(f"one prefill should launch flash_attention {n_attn} and ssd_scan "
             f"{full.n_layers} times, got {launches}")
    if not (torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.last_logits).all()):
        fail("serving: logits are not finite")
    if res.ids.shape != (SERVE_BATCH, SERVE_GEN) or not (0 <= int(res.ids.min()) and
                                        int(res.ids.max()) < full.vocab_size):
        fail(f"serving: generated ids {tuple(res.ids.shape)} out of shape or range")

    # warm timings and the profile, on weights and prompts made as serve.main makes them
    batch, prompt_len, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    params = lm.init_params(make_generator(0, dev), full)
    prompts = torch.randint(0, full.vocab_size, (batch, prompt_len),
                            generator=make_generator(1, dev), device=dev)
    warm = serve.generate(params, prompts, full, gen)
    print(f"serving zamba2-2.7b (full width, {full.n_layers} layers, bf16, batch {batch}, prompt "
          f"{prompt_len}, {gen} tokens), warm: prefill {warm.prefill_ms:.3f} ms, decode "
          f"{warm.decode_ms_per_token:.3f} ms/token, {batch * 1e3 / warm.decode_ms_per_token:.1f} "
          f"tokens/s  [{smi_line()}]")
    print(f"  warm run's tokens equal serve.main's (same seeds): "
          f"{torch.equal(warm.ids, res.ids)}")
    print("profiled prefill, then the decode loop:")
    profile_share(torch, lambda: lm.prefill(params, {"tokens": prompts}, full,
                                            max_len=prompt_len + gen))
    _, cache = lm.prefill(params, {"tokens": prompts}, full, max_len=prompt_len + gen)
    tok = warm.ids[:, :1].to(dev)

    def decode_loop():
        t = tok
        for i in range(gen - 1):
            logits, _ = lm.decode(params, cache, t, prompt_len + i, full)
            t = logits[:, -1].argmax(dim=-1, keepdim=True)
    profile_share(torch, decode_loop)
    # the decode loop stays on the device: steps under sync-debug "error"
    # raise at the first operation that waits for the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_loop()
    except RuntimeError as exc:
        fail(f"decode synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  decode loop: no host sync inside the steps")
    del params, cache

    # (c) the serving invariant at full width, 12 layers, float32
    cfg12 = dataclasses.replace(full, n_layers=12, dtype=torch.float32)
    params12 = lm.init_params(make_generator(3, dev), cfg12)
    S, prompt = 144, 128
    toks = torch.randint(0, cfg12.vocab_size, (2, S), generator=make_generator(4, dev),
                         device=dev)
    ref = lm.forward(params12, {"tokens": toks}, cfg12)[:, prompt - 1:]
    logits, cache = lm.prefill(params12, {"tokens": toks[:, :prompt]}, cfg12, max_len=S)
    outs = [logits[:, 0]]
    for t in range(prompt, S):
        lg, cache = lm.decode(params12, cache, toks[:, t:t + 1], t, cfg12)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    excess = ((dec - ref).abs() - SERVE_INVARIANT_TOL * (1 + ref.abs())).max().item()
    err = (dec - ref).abs().max().item()
    if not excess <= 0:
        fail(f"serving invariant: decode differs from forward by {err} (atol = rtol = "
             f"{SERVE_INVARIANT_TOL})")
    print(f"serving invariant (zamba2 width, 12 layers, float32, S={S}, prompt {prompt}): "
          f"decode = forward within {SERVE_INVARIANT_TOL}, max_abs_err {err:.3e}")
    return launches


def phase10_automl_backends(torch, dev, X_tr, y_tr, X_te, y_te, result) -> None:
    """The AutoML backends on the card: rung 0 of D1's sub-AutoML through the
    batched and the loop backend (every trial within 2/N_val), the batched
    rung under sync-debug "error", a hetero-shape and a mixed-step merge
    against solo runs, a time budget that stops between sub-batches, and
    ``execute`` timed with each backend (loop, batched, batched, loop) with
    the sub-AutoML phase profiled for each."""
    from repro_torch.automl import batched as B
    from repro_torch.automl.engine import (
        AutoMLConfig, _eval_rung_loop, automl_fit, search_cohort, search_eval_rung,
        search_init, search_result, search_trial_cohort,
    )
    from repro_torch.core.plan import execute, plan
    from repro_torch.core.substrat import build_subset
    from repro_torch.device import make_generator
    import dataclasses
    import numpy as np

    def worst(label, got, ref, n_val):
        """Largest per-trial accuracy difference of two rung outputs, and how
        many trials differ; fails past 2/N_val or on unequal positions."""
        (scored_g, pos_g), (scored_r, pos_r) = got, ref
        if pos_g != pos_r or [s[0] for s in scored_g] != [s[0] for s in scored_r]:
            fail(f"AutoML {label}: trials or positions differ ({pos_g} vs {pos_r})")
        diffs = [abs(a[1] - b[1]) for a, b in zip(scored_g, scored_r)]
        if not max(diffs) <= AUTOML_TOL_ROWS / n_val + 1e-9:
            fail(f"AutoML {label}: a trial's accuracy differs by {max(diffs)} > "
                 f"{AUTOML_TOL_ROWS}/{n_val}")
        return max(diffs), sum(d > 0 for d in diffs)

    # the sub-AutoML's input exactly as execute(seed=0) built it in phase 5
    X_sub, y_sub = build_subset(X_tr, y_tr, result.row_idx, result.col_idx,
                                make_generator(0 ^ 0x5AB5))
    st = search_init(X_sub, y_sub, config=AutoMLConfig(), device=dev)
    cohort, tids, epochs, _ = search_cohort(st)
    n_val, d, c = len(st.ctx["y_val"]), st.ctx["X_tr"].shape[1], st.ctx["n_classes"]
    print(f"AutoML backends: D1's sub-AutoML input {X_sub.shape}, train {st.ctx['X_tr'].shape[0]} "
          f"rows (class counts {np.bincount(st.ctx['y_tr']).tolist()}), N_val {n_val}, "
          f"{len(cohort)} trials at rung 0 ({epochs} epochs)")

    # (a) rung 0, batched against loop, on the card
    t0 = time.perf_counter()
    bat = B.eval_rung_batched(cohort, tids, 0, epochs, st.ctx, st.out_of_budget, True)
    t_bat = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = _eval_rung_loop(cohort, tids, 0, epochs, st.ctx, st.out_of_budget, True)
    t_loop = time.perf_counter() - t0
    err, n_diff = worst("rung 0 batched vs loop", bat, loop, n_val)
    print(f"  (a) rung 0: batched {t_bat:.4f} s, loop {t_loop:.4f} s (first calls); "
          f"{n_diff} of {len(cohort)} trials differ at all, largest {err:.6f} "
          f"(limit {AUTOML_TOL_ROWS}/{n_val})")

    # (b) the same rung from its inputs on the card to its one sync: no
    # operation may wait for the host
    trials, variants, subbatches, common = B._rung_inputs(cohort, tids, 0, epochs, st.ctx)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        evaluated = B._run_subbatches(subbatches, common, c, d, epochs)
    except RuntimeError as exc:
        fail(f"the batched rung synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = B._unpack_results(evaluated, trials, variants, False)
    same = all(again[i][0] == bat[0][i][1] for i in range(len(cohort)))
    print(f"  (b) batched rung: no host sync before its one copy back; {len(subbatches)} "
          f"sub-batches; accuracies equal to (a)'s: {same}")

    # (c) a hetero-shape merge and a mixed-step megabatch against solo runs:
    # job B takes 601 rows of all 22 features, another seed
    stB = search_init(X_tr[:601], y_tr[:601], config=AutoMLConfig(seed=1), device=dev)
    nB = len(stB.ctx["y_val"])
    cohortB, tidsB, _, _ = search_cohort(stB)
    soloB = B.eval_rung_batched(cohortB, tidsB, 0, epochs, stB.ctx, stB.out_of_budget, False)
    mA, mB = B.eval_rung_cohorts([search_trial_cohort(st), search_trial_cohort(stB)])
    ea, _ = worst("hetero merge, job A", mA, bat, n_val)
    eb, _ = worst("hetero merge, job B", mB, soloB, nB)
    search_eval_rung(st)                               # job A one rung ahead
    tcA, tcB = search_trial_cohort(st), search_trial_cohort(stB)
    soloA1 = B.eval_rung_batched(tcA.specs, tcA.tids, tcA.rung_i, tcA.epochs, st.ctx,
                                 st.out_of_budget, False)
    gA, gB = B.eval_trial_megabatch([tcA, tcB])
    ga, _ = worst("megabatch, job A", gA, soloA1, n_val)
    gb, _ = worst("megabatch, job B", gB, soloB, nB)
    print(f"  (c) hetero merge ({st.ctx['X_tr'].shape} with {stB.ctx['X_tr'].shape}): largest "
          f"difference from solo {max(ea, eb):.6f}; megabatch (job A at rung 1, "
          f"{tcA.epochs} steps, with job B at rung 0, {tcB.epochs}): {max(ga, gb):.6f}")

    # (d) a time budget spent at once stops rung 0 after its first sub-batch
    stD = search_init(X_sub, y_sub, config=AutoMLConfig(time_budget_s=1e-9), device=dev)
    search_eval_rung(stD)
    resD = search_result(stD)
    if not (stD.stopped and 1 <= resD.n_trials == len(subbatches[0][0]) < len(cohort)):
        fail(f"time budget: {resD.n_trials} trials scored, stopped {stD.stopped}; expected "
             f"the first sub-batch's {len(subbatches[0][0])} of {len(cohort)}")
    print(f"  (d) time budget: stopped after the first sub-batch, {resD.n_trials} of "
          f"{len(cohort)} trials scored, winner {resD.spec.family}")

    # (e) execute with each backend, loop, batched, batched, loop (after one
    # unrecorded run: phases 7-9 ran in between), then the sub-AutoML of each
    # rung by rung, and under the profiler
    execute(plan("gen_dst"), X_tr, y_tr, seed=0, device=dev)
    for backend in ("loop", "batched", "batched", "loop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = execute(plan("gen_dst", backend=backend), X_tr, y_tr, X_test=X_te, y_test=y_te,
                    seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"  (e) execute, backend {backend}: {wall:.4f} s; " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.times.items())
            + f"; final {r.final.spec.family} test_acc {r.final.test_acc:.4f}  [{smi_line()}]")
    # Adam steps issued by the host: both backends call models.adam_train,
    # the batched module through its own name; counted here only
    from repro_torch.automl import models as M
    issued = [0]

    def counting_adam(loss_fn, params0, lr, epochs, n_steps=None):
        fixed = n_steps is None or isinstance(n_steps, torch.Tensor)
        issued[0] += epochs if fixed else min(epochs, int(n_steps))
        return adam_train(loss_fn, params0, lr, epochs, n_steps)
    adam_train = M.adam_train
    M.adam_train = B.adam_train = counting_adam
    try:
        for backend in ("loop", "batched", "batched", "loop"):
            stR = search_init(X_sub, y_sub, config=AutoMLConfig(backend=backend), device=dev)
            parts = []
            while not stR.done:
                n_trials, before = len(stR.alive_ids), issued[0]
                search_eval_rung(stR)
                parts.append(f"rung {stR.rung_i - 1}: {n_trials} trials, "
                             f"{issued[0] - before} Adam steps, {stR.rung_times[-1]:.4f} s")
            print(f"  sub-AutoML by rung, backend {backend}: " + "; ".join(parts)
                  + f"; winner {search_result(stR).spec.family}")
    finally:
        M.adam_train = B.adam_train = adam_train
    for backend in ("loop", "batched"):
        print(f"  profiled sub-AutoML, backend {backend}, whole phase:")
        profile_share(torch, lambda: automl_fit(
            X_sub, y_sub, config=AutoMLConfig(backend=backend), device=dev))
        print(f"  rung by rung, backend {backend}:")
        stP = search_init(X_sub, y_sub, config=AutoMLConfig(backend=backend), device=dev)
        per_rung = []
        while not stP.done:
            events, _ = profile_share(torch, lambda: search_eval_rung(stP), top=0)
            per_rung.append(sum(e.count for e in events))
            print(f"    rung {stP.rung_i - 1}: {per_rung[-1]} device operations")
        print(f"  sub-AutoML {backend}: {sum(per_rung)} device operations in {len(per_rung)} "
              f"rungs, {sum(per_rung) / len(per_rung):.1f} per rung")
    ft = plan("gen_dst").ft_automl
    for backend in ("loop", "batched"):
        print(f"  profiled fine-tune ({result.intermediate.spec.family}, {len(y_tr)} rows), "
              f"backend {backend}:")
        events, _ = profile_share(torch, lambda: automl_fit(
            X_tr, y_tr, config=dataclasses.replace(ft, backend=backend),
            restrict_family=result.intermediate.spec.family, device=dev))
        print(f"  fine-tune {backend}: {sum(e.count for e in events)} device operations")


# the strategies this phase adds to the card: the paper's baselines and asp_proxy
NEW_STRATEGIES = ("mc", "mab", "greedy_seq", "greedy_mult", "km", "ig_rand", "ig_km",
                  "asp_proxy")


def phase11_strategies(torch, dev, K, coded, X_tr, y_tr, X_te, y_te) -> None:
    """Every other subset strategy on the card: card against CPU at a small
    size, each at D1 through ``run_strategy`` and ``execute`` with its
    launches, profile and a run under sync-debug "error", then
    ``gen_dst_batch`` on 4 D1-sized tables against the 4 solo runs."""
    import dataclasses
    import numpy as np
    from repro_torch.core import baselines as BL
    from repro_torch.core.gen_dst import GenDSTConfig, TorchDraws, gen_dst, gen_dst_batch
    from repro_torch.core.measures import factorize
    from repro_torch.core.plan import execute, plan
    from repro_torch.core.strategies import (
        asp_proxy_dst, available_strategies, get_strategy, run_strategy,
    )
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    from repro_torch.device import make_generator
    t_phase = time.perf_counter()

    # (a) small size: the card (kernels) against the CPU (plain versions),
    # from the same CPU draws
    rng = np.random.default_rng(0)
    Xs = np.column_stack([rng.integers(0, k, 800) for k in (3, 5, 17, 2, 40, 7)]).astype(float)
    ys = rng.integers(0, 2, 800).astype(float)
    small = {
        "mc": lambda c, d, g: BL.mc_dst(None, c, 20, 3, budget=60, batch=20, device=d, draws=g),
        "mab": lambda c, d, g: BL.mab_dst(None, c, 20, 3, rounds=30, device=d, draws=g),
        "greedy_seq": lambda c, d, g: BL.greedy_seq_dst(None, c, 20, 3, pool=16, device=d,
                                                        draws=g),
        "greedy_mult": lambda c, d, g: BL.greedy_mult_dst(None, c, 20, 3, pool=16, device=d,
                                                          draws=g),
        "km": lambda c, d, g: BL.km_dst(None, c, 20, 3, device=d, draws=g),
        "ig_rand": lambda c, d, g: BL.ig_rand_dst(None, c, 20, 3, device=d, draws=g),
        "ig_km": lambda c, d, g: BL.ig_km_dst(None, c, 20, 3, device=d, draws=g),
        "asp_proxy": lambda c, d, g: asp_proxy_dst(None, c, 20, 3, device=d, draws=g),
    }
    for name, fn in small.items():
        res = {}
        for key, d in (("card", dev), ("cpu", "cpu")):
            r = fn(factorize(Xs, ys, device=d), d, TorchDraws(make_generator(7), d))
            res[key] = (r.row_idx.cpu(), r.col_mask.cpu(), float(r.fitness))
        same = torch.equal(res["card"][0], res["cpu"][0]) and torch.equal(res["card"][1],
                                                                          res["cpu"][1])
        err = abs(res["card"][2] - res["cpu"][2])
        if not err <= FIT_TOL:
            fail(f"small {name}: card and CPU fitness differ by {err} (subsets equal: {same})")
        print(f"small {name}: card {'= CPU' if same else 'and CPU differ at a fitness near-tie'}"
              f" (fitness {res['card'][2]:.7f}, difference {err:.2e})")

    # (b) D1 at full scale, the reference's default options
    table = []
    for name in NEW_STRATEGIES:
        fn = get_strategy(name).fn

        def search():
            return fn(make_generator(0, dev), coded, None, None)
        t0 = time.perf_counter()
        run_strategy(name, make_generator(0, dev), coded, None, None)
        first_s = time.perf_counter() - t0
        K.reset_launch_counts()
        t0 = time.perf_counter()
        sub = run_strategy(name, make_generator(0, dev), coded, None, None)
        warm_s = time.perf_counter() - t0
        launches = K.launch_counts()
        f_plain = plain_fitness(torch, coded, sub.row_idx, sub.col_mask)
        if not (math.isfinite(sub.fitness) and abs(sub.fitness - f_plain) <= FIT_TOL):
            fail(f"{name} at D1: fitness {sub.fitness} against its plain recomputation {f_plain}")
        if name == "mc" and not (launches["masked_histogram"] > 0
                                 and launches["fused_delta_fitness"] > 0):
            fail(f"mc did not launch both Gen-DST kernels: {launches}")
        print(f"{name} at D1 (n {len(sub.row_idx)}, m {int(sub.col_mask.sum())}): first call "
              f"{first_s:.4f} s, warm {warm_s:.4f} s; B1 {launches['masked_histogram']}, B2 "
              f"{launches['fused_delta_fitness']} launches per search; fitness "
              f"{sub.fitness:.8f}, plain recomputation {f_plain:.8f}")
        events, busy = profile_share(torch, search, top=3)
        ops = sum(e.count for e in events)
        if name != "asp_proxy":          # host numpy by design, as in the reference
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                search()
            except RuntimeError as exc:
                fail(f"{name} synchronised with the host: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        table.append((name, warm_s, busy, ops, launches))
    print("  no host sync inside any search but asp_proxy's")
    for name in available_strategies():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = execute(plan(name), X_tr, y_tr, X_test=X_te, y_test=y_te, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = r.final.test_acc
        if not (acc is not None and math.isfinite(acc) and 0.0 <= acc <= 1.0):
            fail(f"execute(plan({name!r})): test accuracy {acc} is not a finite number in [0, 1]")
        if name != "random":
            f_plain = plain_fitness(torch, coded, r.row_idx, r.col_idx)
            if not abs(r.dst_fitness - f_plain) <= FIT_TOL:
                fail(f"execute(plan({name!r})): DST fitness {r.dst_fitness} against {f_plain}")
        print(f"execute(plan({name!r})) on D1: {wall:.4f} s; " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.times.items())
            + f"; final {r.final.spec.family} test_acc {acc:.4f}  [{smi_line()}]")
    print("strategies at D1 (warm run_strategy s, device-busy share of a search, device "
          "operations per search, B1 / B2 launches per search):")
    for name, warm_s, busy, ops, launches in table:
        print(f"  {name:12s} {warm_s:.4f} s, busy {busy if busy is None else round(busy, 4)}, "
              f"{ops} operations, B1 {launches['masked_histogram']}, B2 "
              f"{launches['fused_delta_fitness']}")

    # (c) gen_dst_batch: D1 and 3 copies of its spec with other seeds
    specs = [PAPER_DATASETS["D1"]] + [dataclasses.replace(PAPER_DATASETS["D1"], seed=s)
                                      for s in (11, 12, 13)]
    codeds = [coded]
    for spec in specs[1:]:
        Xd, yd = make_dataset(spec, scale=1.0)
        codeds.append(factorize(*train_test_split(Xd, yd)[:2], device=dev))
    if len({(c.codes.shape, c.max_bins, c.target_col) for c in codeds}) != 1:
        fail("gen_dst_batch: the D1-sized tables differ in shape, max_bins or target: "
             f"{[(tuple(c.codes.shape), c.max_bins, c.target_col) for c in codeds]}")
    cfg = GenDSTConfig()
    seeds = (0, 1, 2, 3)

    def solo_runs():
        return [gen_dst(make_generator(s, dev), c, cfg=cfg, device=dev)
                for s, c in zip(seeds, codeds)]

    def batch_run():
        return gen_dst_batch([make_generator(s, dev) for s in seeds], codeds, cfg=cfg,
                             device=dev)
    K.reset_launch_counts()
    solos = solo_runs()
    torch.cuda.synchronize()
    solo_launches = K.launch_counts()
    K.reset_launch_counts()
    batch = batch_run()
    torch.cuda.synchronize()
    batch_launches = K.launch_counts()
    for d, (a, b) in enumerate(zip(solos, batch)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"gen_dst_batch: dataset {d}'s result differs from its solo run")
    want = cfg.psi + 1                    # the initial population and each generation
    if not (batch_launches["masked_histogram"] == batch_launches["fused_delta_fitness"] == want):
        fail(f"gen_dst_batch launched {batch_launches}, not B1 and B2 {want} times each")
    print(f"gen_dst_batch (D = 4 D1-sized tables, {cfg.psi} generations): each result = its "
          f"solo run; launches batch {batch_launches}, 4 solo runs {solo_launches}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch_run()
    except RuntimeError as exc:
        fail(f"gen_dst_batch synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  gen_dst_batch: no host sync inside the search")
    times = []
    for label, run in (("4 solo", solo_runs), ("batch", batch_run), ("batch", batch_run),
                       ("4 solo", solo_runs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        [r.row_idx.cpu() for r in out]
        times.append(f"{label} {time.perf_counter() - t0:.4f} s")
    print(f"  timed (the results on the host): {', '.join(times)}  [{smi_line()}]")
    for label, run in (("4 solo runs", solo_runs), ("batch", batch_run)):
        print(f"  profiled {label}:")
        events, _ = profile_share(torch, run, top=4)
        print(f"  {label}: {sum(e.count for e in events)} device operations")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


# phase 12's fleet: (tenant, job seed) of each of the five jobs, in the order
# of the tables ``service_tables`` returns
SERVICE_JOBS = (("alpha", 0), ("beta", 1), ("gamma", 2), ("alpha", 3), ("delta", 4))


def service_tables(X_tr, y_tr, X_te, y_te) -> list:
    """Phase 12's tables at full scale, each (X_train, y_train, X_test,
    y_test): D1 (the main path's split), two copies of D1's spec with
    dataset seeds 11 and 12, D1 again, D7; then D1's spec with seed 13 for
    the warm-started job."""
    import dataclasses
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split

    def table(name, seed=None):
        spec = PAPER_DATASETS[name]
        if seed is not None:
            spec = dataclasses.replace(spec, seed=seed)
        return train_test_split(*make_dataset(spec, scale=1.0))
    d1 = (X_tr, y_tr, X_te, y_te)
    return [d1, table("D1", 11), table("D1", 12), d1, table("D7"), table("D1", 13)]


# one line of the Prometheus text exposition: a sample, or a HELP/TYPE comment
SAMPLE_LINE = r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (-?[0-9.]+(e[+-]?[0-9]+)?|[+-]Inf|NaN)"
COMMENT_LINE = r"# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*"


def phase12_service(torch, dev, K, tables, pl) -> None:
    """The service on the card: five jobs of four tenants through one
    ``SubStratServer`` (merged Gen-DST searches, a cache hit that waits for
    its leader, megabatched rungs), checked against solo runs, plain
    recomputations and the metrics; then a portfolio warm start, the same
    jobs through ``execute`` timed against the server, a profiled served run
    and the host waits of each step of one job."""
    import collections
    import re
    import warnings
    import numpy as np
    from repro_torch.core.gen_dst import GenDSTConfig
    from repro_torch.core.measures import factorize
    from repro_torch.core.plan import execute
    from repro_torch.obs import torchprof
    from repro_torch.service import Scheduler, SubStratServer, dataset_fingerprint
    t_phase = time.perf_counter()
    jobs, warm_table = tables[:5], tables[5]
    psi = dict(pl.strategy_opts).get("cfg", GenDSTConfig()).psi

    def new_server():
        return SubStratServer(device=dev, batch_dst=True)

    def serve(server):
        """Submit the five jobs, then wait for each result; the wall time
        from the first submit to the last result."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [server.submit(X, y, tenant=tenant, seed=seed, plan=pl, X_test=Xt, y_test=yt)
               for (tenant, seed), (X, y, Xt, yt) in zip(SERVICE_JOBS, jobs)]
        results = [server.result(i) for i in ids]
        torch.cuda.synchronize()
        return ids, results, time.perf_counter() - t0

    def solo():
        """The same five jobs through ``execute``, one after another."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [execute(pl, X, y, seed=seed, X_test=Xt, y_test=yt, device=dev)
                   for (_t, seed), (X, y, Xt, yt) in zip(SERVICE_JOBS, jobs)]
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0

    walls = []
    solo_results, wall = solo()
    walls.append(f"solo {wall:.4f} s")
    for (tenant, seed), res in zip(SERVICE_JOBS, solo_results):
        print(f"  execute, {tenant}'s job (seed {seed}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.times.items()))

    # the checked run: launch counters zeroed just before, read just after
    snap = torchprof.tracing_snapshot()
    server = new_server()
    K.reset_launch_counts()
    ids, results, wall = serve(server)
    launches = K.launch_counts()
    walls.append(f"served {wall:.4f} s")
    stats = server.stats()
    metrics = stats["metrics"]
    print(f"service: {len(ids)} jobs of {len({t for t, _s in SERVICE_JOBS})} tenants served in "
          f"{wall:.4f} s (first submit to last result); launches {launches}; merged_dst "
          f"{stats['merged_dst']}, merged rungs {stats['merged_rungs']} ({stats['merged_jobs']} "
          f"job-rungs, {stats['hetero_rungs']} padded, {stats['mixed_rungs']} mixed), solo "
          f"rungs {stats['solo_rungs']}; cache {stats['cache']}")
    for jid, ((tenant, seed), res) in zip(ids, zip(SERVICE_JOBS, results)):
        st = server.poll(jid)
        job = server.scheduler.jobs[jid]
        acc = res.final.test_acc
        if not (st.phase == "done" and acc is not None and math.isfinite(acc)
                and 0.0 <= acc <= 1.0):
            fail(f"service job {jid}: phase {st.phase}, test accuracy {acc}")
        print(f"  job {jid} ({tenant}, seed {seed}): cache_hit {st.cache_hit}, warm_started "
              f"{st.warm_started}; " + ", ".join(f"{k} {v:.4f}" for k, v in st.phase_times.items())
              + f"; final {res.final.spec.family} test_acc {acc:.4f}")
        print("    spans: " + ", ".join(f"{s['name']} {s['attrs']['seconds']:.4f}"
                                         for s in job.spans))
    want = 2 * (psi + 1)        # the merged group's generations and D7's
    if not (launches["masked_histogram"] == launches["fused_delta_fitness"] == want):
        fail(f"service: B1/B2 launched {launches}, not {want} times each (once per generation "
             f"for the merged group and for D7)")
    for j in range(3):
        got, ref = results[j], solo_results[j]
        if not (np.array_equal(got.row_idx, ref.row_idx) and np.array_equal(got.col_idx,
                                                                             ref.col_idx)
                and got.dst_fitness == ref.dst_fitness):
            fail(f"service: merged job {ids[j]}'s subset differs from its solo run")
    st3 = server.poll(ids[3])
    if not (st3.cache_hit and st3.warm_started
            and np.array_equal(results[3].row_idx, results[0].row_idx)
            and results[3].final.spec.family == results[0].intermediate.spec.family):
        fail("service: the repeat of D1 did not take the cache hit and the leader's family")
    if not (metrics["cache_hits_total"]["value"] == 1 and stats["merged_dst"] == 3):
        fail(f"service: cache hits {metrics['cache_hits_total']['value']}, merged_dst "
             f"{stats['merged_dst']}; expected 1 and 3")
    if not metrics["dispatches_total"]["values"].get("merged", 0) >= 1:
        fail(f"service: no megabatch dispatch spanned two jobs: {metrics['dispatches_total']}")
    coded = {}
    for j, (X, y, _xt, _yt) in enumerate(jobs):
        key = id(X)
        if key not in coded:
            coded[key] = factorize(X, y, device=dev)
        c = coded[key]
        # the job hashed its host codes; the table coded on the card hashes the same
        if dataset_fingerprint(c) != server.scheduler.jobs[ids[j]].fingerprint:
            fail(f"service job {ids[j]}: the card-coded table's fingerprint differs")
        f_plain = plain_fitness(torch, c, results[j].row_idx, results[j].col_idx)
        if not abs(results[j].dst_fitness - f_plain) <= FIT_TOL:
            fail(f"service job {ids[j]}: DST fitness {results[j].dst_fitness} against its plain "
                 f"recomputation {f_plain}")
    print("  merged subsets = solo runs; every DST fitness within "
          f"{FIT_TOL} of its plain recomputation; fingerprints of the tables coded on the "
          "card = the jobs'")
    text = server.metrics_text()
    for line in text.splitlines():
        if not (re.fullmatch(SAMPLE_LINE, line) or re.fullmatch(COMMENT_LINE, line)):
            fail(f"service: metrics line does not parse: {line!r}")
    typed = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    families = set(Scheduler(device=dev).metrics.to_dict()) | {
        "torch_kernel_builds_total", "kernel_launches_total"}
    if not families <= typed:
        fail(f"service: metrics text lacks {sorted(families - typed)}")
    built = torchprof.new_tracings_since(snap)
    if built:
        fail(f"service: kernels built during the served run: {built}")
    print(f"  metrics: {len(text.splitlines())} lines parse, {len(families)} families present; "
          f"no kernel built during the run  ({time.perf_counter() - t_phase:.1f} s into phase 12)")

    # a sixth job once four fingerprints have trained: seeded from the portfolio
    X, y, Xt, yt = warm_table
    wid = server.submit(X, y, tenant="beta", seed=5, plan=pl, X_test=Xt, y_test=yt)
    wres = server.result(wid)
    m = server.scheduler.metrics.to_dict()
    warm0 = server.poll(wid).leaderboard[0]["trials_done"]
    cold0 = server.poll(ids[0]).leaderboard[0]["trials_done"]
    if not (m["portfolio_hits_total"]["value"] == 1 and warm0 < cold0
            and 0.0 <= wres.final.test_acc <= 1.0):
        fail(f"service: the warm job took {m['portfolio_hits_total']['value']} portfolios and "
             f"{warm0} rung-0 trials (cold {cold0})")
    print(f"  warm start: portfolio of {m['portfolio_seeded_trials_total']['value']:.0f} specs "
          f"(coverage {m['portfolio_coverage']['value']:.4f}) from "
          f"{m['experience_datasets']['value']:.0f} datasets; rung 0 {warm0} trials against "
          f"{cold0} cold; " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in server.poll(wid).phase_times.items())
          + f"; final {wres.final.spec.family} test_acc {wres.final.test_acc:.4f}")

    # timed: solo, served (above), served, solo
    _ids, _res, wall = serve(new_server())
    walls.append(f"served {wall:.4f} s")
    _res, wall = solo()
    walls.append(f"solo {wall:.4f} s")
    print(f"  five jobs (results on the host): {', '.join(walls)}  [{smi_line()}]  "
          f"({time.perf_counter() - t_phase:.1f} s into phase 12)")

    print("  profiled served run:")
    events, _ = profile_share(torch, lambda: serve(new_server()), top=6)
    ops = sum(e.count for e in events)
    total_us = sum(dev_us(e) for e in events)
    ours_us = sum(dev_us(e) for e in events
                  if "masked_histogram_kernel" in e.key or "fused_delta_fitness_kernel" in e.key)
    print(f"  served run: {ops} device operations ({ops / len(jobs):.0f} per job); B1 + B2 "
          f"{ours_us / 1e3:.4f} ms of {total_us / 1e3:.4f} ms device time "
          f"({ours_us / total_us if total_us else float('nan'):.4f})  "
          f"({time.perf_counter() - t_phase:.1f} s into phase 12)")

    # host waits of each step of one D1 job, under sync-debug "warn"
    server = new_server()
    X, y, Xt, yt = jobs[0]
    jid = server.submit(X, y, seed=0, plan=pl, X_test=Xt, y_test=yt)
    job = server.scheduler.jobs[jid]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    steps = []
    try:
        while job.active:
            before = job.phase
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                server.scheduler.step()
            waits = [w for w in caught if "synchroniz" in str(w.message)]
            where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in waits)
            steps.append((before, job.phase, len(waits), where))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if job.phase != "done":
        fail(f"service: the sync-debug job ended {job.phase}: {job.error!r}")
    print(f"  host waits per step of one D1 job ({len(steps)} steps, "
          f"{sum(s[2] for s in steps)} in all):")
    for i, (before, after, n_waits, where) in enumerate(steps):
        print(f"    step {i} ({before} -> {after}): {n_waits}: "
              + ", ".join(f"{k} x{v}" for k, v in where.most_common()))
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# phase 13's jobs: D1 (the main path's split), D1's spec with dataset seed 11
# (its search merges with D1's) and D7, as (tenant, seed); D1's and seed 11's
# are phase 12's first two
TRANSPORT_JOBS = (("alpha", 0), ("beta", 1), ("delta", 4))
# the multi-process tier's families in its metrics text (DESIGN.md §14.5)
TRANSPORT_FAMILIES = ("remote_tasks_total", "redispatched_tasks_total",
                      "heartbeat_misses_total", "worker_failures_total")


def _same_results(got, want) -> list:
    """The parts of two ``SubStratResult``s that differ: subset, fitness,
    winner specs and trial accuracies (empty if all are bit-equal)."""
    import numpy as np
    diff = []
    if not (np.array_equal(got.row_idx, want.row_idx)
            and np.array_equal(got.col_idx, want.col_idx)):
        diff.append("subset")
    if got.dst_fitness != want.dst_fitness:
        diff.append("dst_fitness")
    for name in ("intermediate", "final"):
        g, w = getattr(got, name), getattr(want, name)
        if g.spec != w.spec:
            diff.append(f"{name} spec")
        if [v for _, v in g.trials] != [v for _, v in w.trials]:
            diff.append(f"{name} trial accuracies")
        if g.test_acc != w.test_acc:
            diff.append(f"{name} test_acc")
    return diff


def _trial_gap(got, want, n_train: int) -> float:
    """The largest trial-accuracy gap of two results' AutoML passes, in units
    of 2/N_val of each pass (a gap <= 1 is within tolerance); inf if the two
    ran other trials.  The sub pass's N_val is taken from the subset's rows,
    the fine-tune's from the ``n_train`` rows of the table."""
    gap = 0.0
    for name, n_rows in (("intermediate", len(want.row_idx)), ("final", n_train)):
        g, w = getattr(got, name), getattr(want, name)
        if [s for s, _ in g.trials] != [s for s, _ in w.trials]:
            return float("inf")
        n_val = max(1, int(0.2 * n_rows))
        for (_s, a), (_t, b) in zip(g.trials, w.trials):
            gap = max(gap, abs(a - b) / (2.0 / n_val))
    return gap


def phase13_transport(torch, dev, K, jobs, pl) -> None:
    """The multi-process tier on the card: three jobs through a
    ``DistributedScheduler`` behind the HTTP front end, with two worker
    processes on the card and worker 0 killed at its first task; checked
    against the in-process scheduler, then a checkpointed front end resumed
    by a fresh one with a new pool; prints boot seconds, wire bytes and
    codec times per task, worker eval against dispatch spans, the served
    wall against in-process (in-process, HTTP, HTTP, in-process) and the
    host waits per front-end step."""
    import collections
    import re
    import shutil
    import warnings
    from repro_torch.core.gen_dst import GenDSTConfig
    from repro_torch.service import (
        DistributedScheduler, ProcessWorkerPool, Scheduler, SubStratHTTPClient,
        SubStratHTTPServer, SubStratServer,
    )
    t_phase = time.perf_counter()
    psi = dict(pl.strategy_opts).get("cfg", GenDSTConfig()).psi
    kill = ((0, 0, "kill", 0.0),)          # worker 0 exits at its first task

    def submit_all(submit):
        return [submit(X, y, tenant=tenant, seed=seed, plan=pl, X_test=Xt, y_test=yt)
                for (tenant, seed), (X, y, Xt, yt) in zip(TRANSPORT_JOBS, jobs)]

    def in_process():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched = Scheduler(batch_dst=True, device=dev)
        ids = submit_all(sched.submit)
        sched.run()
        torch.cuda.synchronize()
        return [sched.jobs[i].result for i in ids], time.perf_counter() - t0

    def over_http(pool):
        """The three jobs through a fresh front end on ``pool``, over HTTP:
        the wall from the first submit to the last result.  The caller
        closes the returned HTTP server."""
        sched = DistributedScheduler(pool, batch_dst=True, stall_timeout_s=120.0, device=dev)
        http = SubStratHTTPServer(SubStratServer(scheduler=sched)).start()
        client = SubStratHTTPClient(http.url)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = submit_all(client.submit)
        board = list(client.stream_leaderboard(ids[0]))
        results = [client.result(i) for i in ids]
        wall = time.perf_counter() - t0
        return http, sched, client, ids, board, results, wall

    def check_against(label, results, want):
        for (tenant, seed), got, ref, table in zip(TRANSPORT_JOBS, results, want, jobs):
            acc = got.final.test_acc
            if not (acc is not None and math.isfinite(acc) and 0.0 <= acc <= 1.0):
                fail(f"transport ({label}): {tenant}'s job test accuracy {acc}")
            diff = _same_results(got, ref)
            if diff:
                # not bit-equal: held within 2/N_val, and said so
                gap = _trial_gap(got, ref, len(table[1]))
                print(f"  {label}: {tenant}'s job NOT bit-equal to in-process ({diff}); "
                      f"largest trial gap {gap:.3f} x 2/N_val")
                if "subset" in diff or "dst_fitness" in diff or not gap <= 1.0:
                    fail(f"transport ({label}): {tenant}'s job differs from in-process: {diff}")
        print(f"  {label}: every job done, test accuracy in [0, 1]; subsets, fitness, winner "
              f"specs and trial accuracies checked against in-process")

    walls = []
    want, wall = in_process()
    walls.append(f"in-process {wall:.4f} s")

    # --- the checked run: two workers, worker 0 killed, over HTTP -------------
    t0 = time.perf_counter()
    pool_a = ProcessWorkerPool(2, device=dev, fault_events=kill)
    boot = time.perf_counter() - t0
    if pool_a.device.type != "cuda" or sorted(pool_a.boot_s) != [0, 1]:
        fail(f"transport: pool on {pool_a.device}, hellos from {sorted(pool_a.boot_s)}")
    print(f"  pool of 2 workers on {pool_a.device} (each hello names it): boot "
          + ", ".join(f"worker {w} {s:.3f} s" for w, s in sorted(pool_a.boot_s.items()))
          + f" (spawn, import torch, CUDA context); {boot:.3f} s in all  [{smi_line()}]")
    K.reset_launch_counts()
    http, sched, client, ids, board, results, wall = over_http(pool_a)
    launches = K.launch_counts()
    walls.append(f"HTTP, worker 0 killed {wall:.4f} s")
    check_against("HTTP, worker 0 killed", results, want)
    stats = client.stats()
    tr = stats["transport"]
    print(f"  transport {tr}; launches in the front end {launches}")
    if not (tr["worker_failures"] == 1 and tr["redispatched_tasks"] >= 1):
        fail(f"transport: the kill was not recovered as one failure and a re-dispatch: {tr}")
    want_launches = 2 * (psi + 1)     # the merged D1 pair's generations and D7's
    if not (launches["masked_histogram"] == launches["fused_delta_fitness"] == want_launches):
        fail(f"transport: B1/B2 launched {launches} in the front end, not {want_launches} each")
    if len(board) < 2:
        fail(f"transport: the streamed leaderboard had {len(board)} entries")
    text = client.metrics()
    for line in text.splitlines():
        if not (re.fullmatch(SAMPLE_LINE, line) or re.fullmatch(COMMENT_LINE, line)):
            fail(f"transport: metrics line does not parse: {line!r}")
    typed = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    if not set(TRANSPORT_FAMILIES) <= typed:
        fail(f"transport: metrics text lacks {sorted(set(TRANSPORT_FAMILIES) - typed)}")
    retried = None
    for jid in ids:
        spans = client.trace(jid)["spans"]
        retry = [s for s in spans if s["name"] == "dispatch" and s["attempt"] >= 1]
        if retry:
            kids = {s["name"] for s in spans if s.get("parent_id") == retry[0]["span_id"]}
            if not {"deserialize", "eval", "serialize"} <= kids:
                fail(f"transport: job {jid}'s retry dispatch has children {sorted(kids)}")
            retried = jid
    if retried is None:
        fail("transport: no job's trace shows a retry dispatch")
    print(f"  leaderboard of job {ids[0]}: {len(board)} streamed entries; metrics parse "
          f"and hold {', '.join(TRANSPORT_FAMILIES)}; job {retried}'s trace has a retry "
          f"dispatch with deserialize, eval and serialize children")
    http.close()
    # per dispatch (each task once, though its spans are on every job it carried)
    seen = {}
    for jid in ids:
        for s in sched.jobs[jid].spans:
            if s["name"] in ("dispatch", "deserialize", "eval", "serialize"):
                seen.setdefault(s["span_id"], s)
    children = collections.defaultdict(dict)
    for s in seen.values():
        if s["name"] != "dispatch":
            children[s["parent_id"]][s["name"]] = s["t1"] - s["t0"]
    print("  remote dispatches (task bytes, front-end encode ms; worker decode ms, eval s, "
          "encode ms; reply bytes, front-end decode ms; front-end dispatch span s):")
    for s in sorted(seen.values(), key=lambda s: s["t0"]):
        if s["name"] != "dispatch":
            continue
        a, c = s["attrs"], children.get(s["span_id"], {})
        print(f"    worker {a['worker']} attempt {s['attempt']} {a['outcome']}: "
              f"{a['bytes']} B, {a['encode_s'] * 1e3:.3f} ms; "
              + (f"{c['deserialize'] * 1e3:.3f} ms, {c['eval']:.4f} s, "
                 f"{c['serialize'] * 1e3:.3f} ms; {a['reply_bytes']} B, "
                 f"{a['decode_s'] * 1e3:.3f} ms; " if "eval" in c else "lost; ")
              + f"{s['t1'] - s['t0']:.4f} s")

    # --- checkpoint and resume: stop after step 2, resume on a new pool -------
    ckpt = ROOT / "build" / "phase13_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    first = DistributedScheduler(pool_a, batch_dst=True, ckpt_dir=ckpt, device=dev)
    submit_all(first.submit)
    first.step()
    first.step()
    pool_a.close()          # the front end and its workers go down together
    del first
    pool_b = ProcessWorkerPool(2, device=dev)
    resumed = DistributedScheduler(pool_b, batch_dst=True, ckpt_dir=ckpt, device=dev)
    step = resumed.resume()
    if step != 2:
        fail(f"transport: resumed at step {step}, not 2")
    resumed.run()
    check_against("checkpointed at step 2, resumed on a new pool",
                  [resumed.jobs[i].result for i in sorted(resumed.jobs)], want)
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  new pool boot " + ", ".join(f"worker {w} {s:.3f} s"
                                           for w, s in sorted(pool_b.boot_s.items()))
          + f"  ({time.perf_counter() - t_phase:.1f} s into phase 13)")

    # --- timed: in-process (above), HTTP (above), HTTP, in-process ------------
    http, *_rest, wall = over_http(pool_b)
    http.close()
    walls.append(f"HTTP {wall:.4f} s")
    _r, wall = in_process()
    walls.append(f"in-process {wall:.4f} s")
    print(f"  three jobs, first submit to last result: {', '.join(walls)}  [{smi_line()}]")

    # host waits of each front-end step of one D1 job, under sync-debug "warn"
    sched = DistributedScheduler(pool_b, batch_dst=True, device=dev)
    (tenant, seed), (X, y, Xt, yt) = TRANSPORT_JOBS[0], jobs[0]
    job = sched.jobs[sched.submit(X, y, tenant=tenant, seed=seed, plan=pl, X_test=Xt,
                                  y_test=yt)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    steps = []
    try:
        while job.active:
            before = job.phase
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sched.step()
            waits = [w for w in caught if "synchroniz" in str(w.message)]
            where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in waits)
            steps.append((before, job.phase, len(waits), where))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        pool_b.close()
    if job.phase != "done":
        fail(f"transport: the sync-debug job ended {job.phase}: {job.error!r}")
    print(f"  host waits per front-end step of one D1 job ({len(steps)} steps, "
          f"{sum(s[2] for s in steps)} in all):")
    for i, (before, after, n_waits, where) in enumerate(steps):
        print(f"    step {i} ({before} -> {after}): {n_waits}: "
              + ", ".join(f"{k} x{v}" for k, v in where.most_common()))
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# phase 14: the moe, vlm and encdec families.  Full width: batch, prompt
# positions and generated tokens of each run
FAM_BATCH, FAM_PROMPT, FAM_GEN = 4, 1024, 32
MOE_ARGV = ["--arch", "qwen2-moe-a2.7b", "--preset", "full", "--batch", str(FAM_BATCH),
            "--prompt-len", str(FAM_PROMPT), "--gen", str(FAM_GEN), "--device", "cuda",
            "--seed", "0"]
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_GEN = 1500, 4, 64   # 30 s of audio after the stem
KIMI_LAYERS, KIMI_GEN = 1, 16


def _generate(torch, prefill, decode, pos0: int, gen: int, K=None) -> dict:
    """Greedy generation on the card: ``prefill()`` -> (logits, cache), then
    ``gen - 1`` steps ``decode(cache, token, pos)`` from position ``pos0``.
    With ``K``, the kernels' launch counts are zeroed before the prefill and
    read after it and after the decode loop.  Returns the ids (on the CPU),
    the first and last logits, prefill ms and decode ms per step."""
    if K is not None:
        K.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "prefill_logits": logits}
    if K is not None:
        out["prefill_launches"] = K.launch_counts()
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    ids = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(cache, tok, pos0 + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        ids.append(tok)
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / max(gen - 1, 1)
    if K is not None:
        out["launches"] = K.launch_counts()
    out.update(ids=torch.cat(ids, dim=1).cpu(), last_logits=logits, cache=cache)
    return out


def _prefill_median_ms(torch, prefill, n: int = 5) -> float:
    """Median wall ms of ``n`` prefill calls, each waited for, on a prefill
    the runs before it have warmed."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    return sorted(times)[n // 2]


def _check_full(name: str, torch, run: dict, vocab: int, n_b3: int, B: int, gen: int) -> None:
    """B3 launched ``n_b3`` times by the prefill and never by decode; logits
    finite; ``gen`` ids per sequence, in range."""
    got = (run["prefill_launches"]["flash_attention"], run["launches"]["flash_attention"])
    if got != (n_b3, n_b3):
        fail(f"{name}: flash_attention launches after prefill and after decode {got}, "
             f"expected {n_b3} by the prefill and none by decode")
    if not (torch.isfinite(run["prefill_logits"]).all() and
            torch.isfinite(run["last_logits"]).all()):
        fail(f"{name}: logits are not finite")
    ids = run["ids"]
    if ids.shape != (B, gen) or not (0 <= int(ids.min()) and int(ids.max()) < vocab):
        fail(f"{name}: generated ids {tuple(ids.shape)} out of shape or range")


def _no_host_sync(torch, name: str, loop) -> None:
    """Run ``loop()`` under sync-debug "error": any operation that waits for
    the host raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop()
    except RuntimeError as exc:
        fail(f"{name}: decode synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  {name} decode loop: no host sync inside the steps")


def _invariant(torch, name: str, dec, ref) -> None:
    excess = ((dec - ref).abs() - SERVE_INVARIANT_TOL * (1 + ref.abs())).max().item()
    err = (dec - ref).abs().max().item()
    if not excess <= 0:
        fail(f"{name} serving invariant: decode differs from forward by {err} (atol = rtol = "
             f"{SERVE_INVARIANT_TOL})")
    print(f"serving invariant ({name}, float32): decode = forward within "
          f"{SERVE_INVARIANT_TOL}, max_abs_err {err:.3e}")


def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase14_families(torch, dev, K) -> dict:
    """The moe, vlm and encdec families on the card: (a) each new smoke config
    on the card against the CPU; (b) qwen2-moe-a2.7b through ``serve.main``,
    phi-3-vision-4.2b and whisper-base through their model entry points and
    kimi-k2 cut to one layer through ``serve.generate``, at full width in
    bf16, with B3's launches per prefill; the qwen2-moe prefill and decode
    profiled; (c) their decode loops under sync-debug "error"; (d) the
    serving invariant in float32.  Returns B3's launches per prefill."""
    import copy
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.launch import serve
    from repro_torch.launch.flops import model_flops
    from repro_torch.models import encdec, lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.moe import moe_block

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, seed, device=dev, dtype=f32):
        return torch.randn(shape, generator=make_generator(seed, device), device=device,
                           dtype=dtype)

    def randint(high, shape, seed, device=dev):
        return torch.randint(0, high, shape, generator=make_generator(seed, device),
                             device=device)

    # (a) the smoke configs in float32: the same weights and inputs on the card
    # (B3) and on the CPU (plain versions)
    def smoke_run(cfg, p, inputs):
        """Forward logits (on the CPU) and 8 greedy tokens."""
        if cfg.family == "encdec":
            logits = encdec.forward(p, inputs, cfg)
            ids = _generate(torch, lambda: encdec.prefill(
                p, {**inputs, "tokens": inputs["tokens"][:, :8]}, cfg, max_dec_len=16),
                lambda c, t, pos: encdec.decode(p, c, t, pos, cfg), 8, 8)["ids"]
        elif cfg.family == "vlm":
            n_img = cfg.n_img_tokens
            logits = lm.forward(p, inputs, cfg)
            ids = _generate(torch, lambda: lm.prefill(
                p, {**inputs, "tokens": inputs["tokens"][:, :32]}, cfg, max_len=n_img + 40),
                lambda c, t, pos: lm.decode(p, c, t, pos, cfg), n_img + 32, 8)["ids"]
        else:
            logits = lm.forward(p, inputs, cfg)
            ids = serve.generate(p, inputs["tokens"][:, :32], cfg, 8).ids
        return logits.cpu(), ids

    cpu = torch.device("cpu")
    for arch_id in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b", "whisper-base"):
        cfg = dataclasses.replace(get_arch(arch_id).smoke, dtype=f32)
        if cfg.family == "encdec":
            p_cpu = encdec.init_params(make_generator(0), cfg)
            inputs = {"frames": randn((2, 64, cfg.d_model), 1, cpu),
                      "tokens": randint(cfg.vocab_size, (2, 16), 2, cpu)}
        else:
            p_cpu = lm.init_params(make_generator(0), cfg)
            inputs = {"tokens": randint(cfg.vocab_size, (2, 40), 1, cpu)}
            if cfg.family == "vlm":
                inputs["patch_embeds"] = randn((2, cfg.n_img_tokens, cfg.d_model), 2, cpu)
        logits_cpu, ids_cpu = smoke_run(cfg, p_cpu, inputs)
        logits_dev, ids_dev = smoke_run(cfg, copy.deepcopy(p_cpu).to(dev),
                                        {k: v.to(dev) for k, v in inputs.items()})
        err = (logits_dev - logits_cpu).abs().max().item()
        if not err <= SERVE_CARD_CPU_TOL:
            fail(f"{cfg.name}: card and CPU logits differ by {err} > {SERVE_CARD_CPU_TOL}")
        if not torch.equal(ids_dev, ids_cpu):
            fail(f"{cfg.name}: greedy tokens differ, card {ids_dev.tolist()} vs CPU "
                 f"{ids_cpu.tolist()}")
        print(f"families smoke ({cfg.name}, {cfg.family}, float32): card = CPU, logits "
              f"max_abs_err {err:.3e}, greedy tokens equal")
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 14)")

    per_prefill = {}
    B, S, G = FAM_BATCH, FAM_PROMPT, FAM_GEN

    def report(name, cold, warm, prefill_ms, n_b3, tokens_per_seq):
        per_prefill[name] = n_b3
        print(f"serving {name} (bf16, batch {B}, {tokens_per_seq}): cold prefill "
              f"{cold['prefill_ms']:.3f} ms, warm prefill {prefill_ms:.3f} ms (median of 5; "
              f"the warm run's one {warm['prefill_ms']:.3f} ms), decode "
              f"{warm['decode_ms']:.3f} ms/token, {B * 1e3 / warm['decode_ms']:.1f} tokens/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; B3 "
              f"{n_b3} launches per prefill, none in decode  [{smi_line()}]")

    # (b) qwen2-moe-a2.7b: the launcher at full width, then warm runs
    arch = get_arch("qwen2-moe-a2.7b")
    full = arch.config
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = serve.main(MOE_ARGV)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"serve.main({' '.join(MOE_ARGV)}): launches {launches}")
    cold = {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms_per_token,
            "prefill_launches": launches, "launches": launches, "ids": res.ids,
            "prefill_logits": res.prefill_logits, "last_logits": res.last_logits}
    _check_full("qwen2-moe-a2.7b", torch, cold, full.vocab_size, full.n_layers, B, G)
    del res
    params = lm.init_params(make_generator(0, dev), full)
    prompts = torch.randint(0, full.vocab_size, (B, S), generator=make_generator(1, dev),
                            device=dev)
    prefill = lambda: lm.prefill(params, {"tokens": prompts}, full, max_len=S + G)
    decode = lambda c, t, pos: lm.decode(params, c, t, pos, full)
    warm = _generate(torch, prefill, decode, S, G, K)
    _check_full("qwen2-moe-a2.7b", torch, warm, full.vocab_size, full.n_layers, B, G)
    if not torch.equal(warm["ids"], cold["ids"]):
        fail("qwen2-moe-a2.7b: the warm run's tokens differ from serve.main's (same seeds)")
    prefill_ms = _prefill_median_ms(torch, prefill)
    report("qwen2-moe-a2.7b", cold, warm, prefill_ms, full.n_layers,
           f"prompt {S}, {G} tokens, all {full.n_layers} layers")
    flops = model_flops(full, ShapeSpec("prefill", S, B, "prefill"))
    tflops = flops / (prefill_ms * 1e-3) / 1e12
    print(f"  useful prefill work {flops / 1e12:.3f} TFLOP (launch/flops.model_flops): "
          f"{tflops:.1f} TFLOP/s at the median warm prefill, "
          f"{tflops * 1e12 / BF16_OPS_PER_S:.4f} of 989 TFLOP/s")
    print("profiled qwen2-moe prefill, then its decode loop:")
    events, _ = profile_share(torch, prefill)
    total_us = sum(dev_us(e) for e in events)
    fa_us = sum(dev_us(e) for e in events if "flash_attention" in e.key)
    print(f"  prefill: {sum(e.count for e in events)} device operations; B3 "
          f"{fa_us / 1e3:.4f} ms of {total_us / 1e3:.4f} ms device time "
          f"({fa_us / total_us if total_us else float('nan'):.4f})")
    cache = warm.pop("cache")
    tok = warm["ids"][:, :1].to(dev)

    def moe_decode_loop(steps=G - 1):
        t = tok
        for i in range(steps):
            logits, _ = lm.decode(params, cache, t, S + i, full)
            t = logits[:, -1].argmax(dim=-1, keepdim=True)
    events, _ = profile_share(torch, moe_decode_loop)
    print(f"  decode: {sum(e.count for e in events) / (G - 1):.1f} device operations and "
          f"{sum(dev_us(e) for e in events) / 1e3 / (G - 1):.4f} ms device time per step")
    x1 = randn((B, 1, full.d_model), 5, dtype=bf16)
    with torch.inference_mode():
        events, _ = profile_share(torch, lambda: moe_block(params["layers"][0]["moe"], x1,
                                                           full), top=12)
    print(f"  one MoE block at a decode step (T = {B} tokens): "
          f"{sum(e.count for e in events)} device operations, "
          f"{sum(dev_us(e) for e in events) / 1e3:.4f} ms device time")
    _no_host_sync(torch, "qwen2-moe-a2.7b", lambda: moe_decode_loop(4))
    del params, cache, warm, cold, prefill, decode
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 14)")

    # (b) phi-3-vision-4.2b: 256 patch embeddings and 768 text tokens
    full = get_arch("phi-3-vision-4.2b").config
    n_img = full.n_img_tokens
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(make_generator(0, dev), full)
    batch = {"tokens": randint(full.vocab_size, (B, S - n_img), 1),
             "patch_embeds": randn((B, n_img, full.d_model), 2, dtype=bf16)}
    prefill = lambda: lm.prefill(params, batch, full, max_len=S + G)
    decode = lambda c, t, pos: lm.decode(params, c, t, pos, full)
    cold = _generate(torch, prefill, decode, S, G, K)
    warm = _generate(torch, prefill, decode, S, G, K)
    for run in (cold, warm):
        _check_full("phi-3-vision-4.2b", torch, run, full.vocab_size, full.n_layers, B, G)
    report("phi-3-vision-4.2b", cold, warm, _prefill_median_ms(torch, prefill), full.n_layers,
           f"{n_img} patches + {S - n_img} text tokens, {G} tokens, all {full.n_layers} layers")
    cache, tok = warm.pop("cache"), warm["ids"][:, :1].to(dev)

    def vlm_loop():
        t = tok
        for i in range(4):
            logits, _ = lm.decode(params, cache, t, S + i, full)
            t = logits[:, -1].argmax(dim=-1, keepdim=True)
    _no_host_sync(torch, "phi-3-vision-4.2b", vlm_loop)
    del params, cache, cold, warm, prefill, decode, batch

    # (b) whisper-base: 1500 frames, a 4-token decoder prompt, 64 tokens
    full = get_arch("whisper-base").config
    P, GW = WHISPER_PROMPT, WHISPER_GEN
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = encdec.init_params(make_generator(0, dev), full)
    batch = {"frames": randn((B, WHISPER_FRAMES, full.d_model), 1, dtype=bf16),
             "tokens": randint(full.vocab_size, (B, P), 2)}
    prefill = lambda: encdec.prefill(params, batch, full, max_dec_len=P + GW)
    decode = lambda c, t, pos: encdec.decode(params, c, t, pos, full)
    cold = _generate(torch, prefill, decode, P, GW, K)
    warm = _generate(torch, prefill, decode, P, GW, K)
    n_b3 = full.n_enc_layers + 2 * full.n_layers
    for run in (cold, warm):
        _check_full("whisper-base", torch, run, full.vocab_size, n_b3, B, GW)
    report("whisper-base", cold, warm, _prefill_median_ms(torch, prefill), n_b3,
           f"{WHISPER_FRAMES} frames, prompt {P}, {GW} tokens, {full.n_enc_layers} + "
           f"{full.n_layers} layers")
    cache, tok = warm.pop("cache"), warm["ids"][:, :1].to(dev)

    def whisper_loop():
        t = tok
        for i in range(4):
            logits, _ = encdec.decode(params, cache, t, P + i, full)
            t = logits[:, -1].argmax(dim=-1, keepdim=True)
    _no_host_sync(torch, "whisper-base", whisper_loop)
    del params, cache, cold, warm, prefill, decode, batch

    # (b) kimi-k2 at full width, cut to one layer (one layer's experts are 34 GB)
    arch = get_arch("kimi-k2-1t-a32b")
    full = dataclasses.replace(arch.config, n_layers=KIMI_LAYERS)
    print(f"kimi-k2-1t-a32b reduced: n_layers {arch.config.n_layers} -> {KIMI_LAYERS} "
          f"(full width, {full.param_dtype} params)")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(make_generator(0, dev), full)
    n_params = sum(p.numel() for p in params.parameters())
    prompts = randint(full.vocab_size, (B, S), 1)
    runs = []
    for _ in range(2):
        K.reset_launch_counts()
        res = serve.generate(params, prompts, full, KIMI_GEN)
        launches = K.launch_counts()
        runs.append({"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms_per_token,
                     "prefill_launches": launches, "launches": launches, "ids": res.ids,
                     "prefill_logits": res.prefill_logits, "last_logits": res.last_logits})
        _check_full("kimi-k2-1t-a32b", torch, runs[-1], full.vocab_size, KIMI_LAYERS, B,
                    KIMI_GEN)
    prefill_ms = _prefill_median_ms(
        torch, lambda: lm.prefill(params, {"tokens": prompts}, full, max_len=S + KIMI_GEN))
    report("kimi-k2-1t-a32b", runs[0], runs[1], prefill_ms, KIMI_LAYERS,
           f"prompt {S}, {KIMI_GEN} tokens, {n_params / 1e9:.2f} B params, 1 layer")
    del params, runs, res
    _free(torch)
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 14)")

    # (d) the serving invariant in float32: decode step t = forward at t,
    # the prompt's tokens fed to decode (teacher forcing)
    def invariant(name, ref, prefill, decode, positions):
        logits, cache = prefill()
        outs = [logits[:, 0]]
        for pos in positions:
            logits, cache = decode(cache, pos)
            outs.append(logits[:, 0])
        _invariant(torch, name, torch.stack(outs, dim=1), ref)

    arch = get_arch("qwen2-moe-a2.7b").config
    # forward over B * S tokens must drop none that decode keeps
    cfg = dataclasses.replace(arch, n_layers=4, dtype=f32,
                              capacity_factor=arch.n_experts / arch.moe_top_k)
    params = lm.init_params(make_generator(3, dev), cfg)
    S2, prompt = 144, 128
    toks = randint(cfg.vocab_size, (2, S2), 4)
    invariant(f"qwen2-moe width, 4 layers, capacity factor {cfg.capacity_factor}, S={S2}, "
              f"prompt {prompt}",
              lm.forward(params, {"tokens": toks}, cfg)[:, prompt - 1:],
              lambda: lm.prefill(params, {"tokens": toks[:, :prompt]}, cfg, max_len=S2),
              lambda c, pos: lm.decode(params, c, toks[:, pos:pos + 1], pos, cfg),
              range(prompt, S2))
    del params
    _free(torch)

    cfg = dataclasses.replace(get_arch("phi-3-vision-4.2b").config, n_layers=8, dtype=f32)
    params = lm.init_params(make_generator(3, dev), cfg)
    n_img = cfg.n_img_tokens
    toks = randint(cfg.vocab_size, (2, S2), 4)
    patches = randn((2, n_img, cfg.d_model), 5)
    invariant(f"phi-3-vision width, 8 layers, {n_img} patches, S={S2}, prompt {prompt}",
              lm.forward(params, {"tokens": toks, "patch_embeds": patches}, cfg)[:, prompt - 1:],
              lambda: lm.prefill(params, {"tokens": toks[:, :prompt], "patch_embeds": patches},
                                 cfg, max_len=n_img + S2),
              lambda c, pos: lm.decode(params, c, toks[:, pos:pos + 1], n_img + pos, cfg),
              range(prompt, S2))
    del params
    _free(torch)

    cfg = dataclasses.replace(get_arch("whisper-base").config, dtype=f32)
    params = encdec.init_params(make_generator(3, dev), cfg)
    S2, prompt = 48, 32
    frames = randn((2, WHISPER_FRAMES, cfg.d_model), 4)
    toks = randint(cfg.vocab_size, (2, S2), 5)
    invariant(f"whisper-base, {WHISPER_FRAMES} frames, S={S2}, prompt {prompt}",
              encdec.forward(params, {"frames": frames, "tokens": toks}, cfg)[:, prompt - 1:],
              lambda: encdec.prefill(params, {"frames": frames, "tokens": toks[:, :prompt]},
                                     cfg, max_dec_len=S2),
              lambda c, pos: encdec.decode(params, c, toks[:, pos:pos + 1], pos, cfg),
              range(prompt, S2))
    del params
    _free(torch)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return per_prefill


# phase 15: training.  The launcher's arguments at full width (zamba2-2.7b,
# all 54 layers, bf16 compute, float32 params and AdamW): 4 sequences of 512
# positions a step in 2 microbatches, a 2048-sequence corpus cut to 256 by
# Gen-DST, a checkpoint every 4 steps: the state is 29 GB (params, m, v in
# float32), and a run that writes more than 45 GiB of checkpoints may not
# fit the machine's disk, so the run writes one checkpoint (after step 3),
# which the second run resumes from
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_RESUME_STEPS = 4, 512, 2, 4, 6
TRAIN_CORPUS, TRAIN_SUBSET = 2048, 256
TRAIN_ARGV = ["--arch", "zamba2-2.7b", "--preset", "full", "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--accum", str(TRAIN_ACCUM), "--corpus-seqs",
              str(TRAIN_CORPUS), "--substrat-subset", str(TRAIN_SUBSET), "--ckpt-every", "4",
              "--log-every", "1", "--device", "cuda", "--seed", "0"]
# small size, card (kernels) against CPU (plain versions), float32: loss and
# grad norm within this relative difference; params within 2 lr per step,
# the most an Adam step can move a parameter whose near-zero gradient takes
# another sign on the other device (C3)
TRAIN_CARD_CPU_RTOL = 1e-4
TRAIN_SMALL_LR, TRAIN_SMALL_STEPS = 1e-3, 3
# warm steps timed at 4 x 512, with remat and then without
TRAIN_WARM_STEPS = 5
# the resumed run's first logged loss (4 decimals) against the checkpointed
# state's loss on the same batch, recomputed in the same call
TRAIN_RESUME_TOL = 1e-3
# each kernel's plain version (kernels/*/ref.py), watched during training
PLAIN_VERSIONS = {
    "repro_torch.kernels.entropy.ref": ("masked_histogram_ref",),
    "repro_torch.kernels.gen_dst.ref": ("fused_delta_fitness_ref",),
    "repro_torch.kernels.flash_attention.ref": ("attention_ref",),
    "repro_torch.kernels.ssd_scan.ref": ("ssd_scan_ref", "ssd_scan_model_ref",
                                         "ssd_scan_chunked_ref"),
}


class plain_versions_counted:
    """Within the block, every kernel's plain version, wherever a
    ``repro_torch`` module holds it, counts its calls into ``self.calls``."""

    def __enter__(self):
        import importlib
        self.calls, self._patched = {}, []
        for mod_name, names in PLAIN_VERSIONS.items():
            ref = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(ref, name)

                def counted(*args, _fn=fn, _name=name, **kw):
                    self.calls[_name] = self.calls.get(_name, 0) + 1
                    return _fn(*args, **kw)
                holders = [(m, attr) for m in list(sys.modules.values())
                           if getattr(m, "__name__", "").startswith("repro_torch")
                           for attr, val in list(vars(m).items()) if val is fn]
                for m, attr in holders:
                    setattr(m, attr, counted)
                    self._patched.append((m, attr, fn))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self._patched:
            setattr(m, attr, fn)
        return False


def _run_logged(fn, argv):
    """``fn(argv)`` with its standard output echoed and kept; returns the
    result, the output and the wall seconds (ending in a synchronise)."""
    import contextlib
    import io
    import torch

    class Tee(io.StringIO):
        def write(self, s):
            sys.__stdout__.write(s)
            return super().write(s)

    buf = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    torch.cuda.synchronize()
    return out, buf.getvalue(), time.perf_counter() - t0


def _step_lines(text: str) -> list:
    """(step, loss, grad norm) of each ``step N loss L gnorm G T ms/step`` line."""
    out = []
    for line in text.splitlines():
        f = line.split()
        if len(f) == 8 and f[0] == "step" and f[2] == "loss" and f[4] == "gnorm":
            out.append((int(f[1]), float(f[3]), float(f[5])))
    return out


def phase15_training(torch, dev, K) -> dict:
    """Training on the card: (a) the zamba2-2.7b and granite-3-2b smoke
    configs, three steps on the card against the CPU from the same float32
    params; (b) ``launch.train.main`` for zamba2-2.7b at full width (subset
    selection through B1/B2, B3/B4 in every forward, checkpoints), then
    resumed from its checkpoint; (c) warm steps timed, one profiled and one
    under sync-debug "warn".  Returns each kernel's launches in the
    training run."""
    import copy
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (
        LoaderState, ShardedLoader, SyntheticCorpus, select_corpus_subset,
    )
    from repro_torch.device import make_generator
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train.optimizer import adamw, leaf_groups
    from repro_torch.train.train_step import TrainState, make_train_step, xent_loss

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    # (a) small size: the same float32 params and batches on the card and the CPU
    for arch_id in ("zamba2-2.7b", "granite-3-2b"):
        cfg = dataclasses.replace(get_arch(arch_id).smoke, dtype=torch.float32)
        base = lm.init_params(make_generator(0), cfg, for_training=True)
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_SMALL_STEPS, 4, 33),
                             generator=make_generator(1))
        opt = adamw(lambda s: TRAIN_SMALL_LR)
        runs = []
        for d in (cpu, dev):
            params = copy.deepcopy(base).to(d)
            state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
            step = make_train_step(cfg, opt, accum_steps=2)
            K.reset_launch_counts()
            metrics = []
            for s in range(TRAIN_SMALL_STEPS):
                batch = {"tokens": toks[s, :, :-1].to(d), "labels": toks[s, :, 1:].to(d)}
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((metrics, K.launch_counts(), leaf_groups(state.params)))
        (m_cpu, _, g_cpu), (m_dev, launches, g_dev) = runs
        loss_err = max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(m_dev, m_cpu))
        gn_err = max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(m_dev, m_cpu))
        p_err = max((a.value().cpu() - b.value()).abs().max().item()
                    for a, b in zip(g_dev, g_cpu))
        p_tol = 2 * TRAIN_SMALL_LR * TRAIN_SMALL_STEPS
        n_attn = (cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid"
                  else cfg.n_layers)
        n_ssd = cfg.n_layers if cfg.family == "hybrid" else 0
        # 2 microbatches a step; under remat each forward runs again in the backward
        per = 2 * TRAIN_SMALL_STEPS * (2 if cfg.remat else 1)
        print(f"training smoke ({cfg.name}, float32, remat {cfg.remat}, {TRAIN_SMALL_STEPS} "
              f"steps of 2 microbatches): loss rel diff {loss_err:.3e}, grad norm rel diff {gn_err:.3e}, "
              f"params max abs diff {p_err:.3e}; launches {launches}")
        if not (loss_err <= TRAIN_CARD_CPU_RTOL and gn_err <= TRAIN_CARD_CPU_RTOL
                and p_err <= p_tol):
            fail(f"training smoke {cfg.name}: card and CPU differ (loss {loss_err}, grad norm "
                 f"{gn_err}, limit {TRAIN_CARD_CPU_RTOL} relative; params {p_err}, limit "
                 f"{p_tol})")
        if (launches["flash_attention"], launches["ssd_scan"]) != (per * n_attn, per * n_ssd):
            fail(f"training smoke {cfg.name}: launches {launches}, expected flash_attention "
                 f"{per * n_attn} and ssd_scan {per * n_ssd}")
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 15)")

    # (b) the launcher at full width, then resumed from its checkpoint
    arch = get_arch("zamba2-2.7b")
    full = arch.config
    n_attn = full.n_layers // full.shared_attn_every
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        argv = TRAIN_ARGV + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt_dir]
        print(f"  clocks before training: {smi_state()}")
        with plain_versions_counted() as plain:
            state, text, wall = _run_logged(train.main, argv)
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  clocks after training: {smi_state()}")
        steps = _step_lines(text)
        print(f"main path launch.train.main({' '.join(argv)}), remat {full.remat}: {wall:.3f} "
              f"s; launches {launches}; peak memory {peak:.2f} GiB; plain versions called "
              f"{plain.calls}")
        if plain.calls:
            fail(f"training on the card called kernels' plain versions: {plain.calls}")
        if [s for s, _, _ in steps] != list(range(TRAIN_STEPS)):
            fail(f"training: logged steps {steps}, expected 0..{TRAIN_STEPS - 1}")
        if not all(math.isfinite(l) and math.isfinite(g) for _, l, g in steps):
            fail(f"training: loss or grad norm not finite: {steps}")
        if int(state.step) != TRAIN_STEPS:
            fail(f"training: final state at step {int(state.step)}, expected {TRAIN_STEPS}")
        # each microbatch's forward, and again its recomputed forward under remat
        fwd = TRAIN_ACCUM * (2 if full.remat else 1)
        want = {"flash_attention": fwd * n_attn * TRAIN_STEPS,
                "ssd_scan": fwd * full.n_layers * TRAIN_STEPS}
        if {k: launches[k] for k in want} != want:
            fail(f"training: launches {launches}, expected {want} "
                 f"({fwd * n_attn} and {fwd * full.n_layers} per step)")
        if launches["masked_histogram"] <= 0 or launches["fused_delta_fitness"] <= 0:
            fail(f"training: the subset selection launched no Gen-DST kernel: {launches}")
        for s, loss, gn in steps:
            print(f"  step {s}: loss {loss:.4f}, grad norm {gn:.4f}")
        per_step = {k: launches[k] // TRAIN_STEPS for k in want}
        print(f"  per step: flash_attention {per_step['flash_attention']}, ssd_scan "
              f"{per_step['ssd_scan']}; subset selection: masked_histogram "
              f"{launches['masked_histogram']}, fused_delta_fitness "
              f"{launches['fused_delta_fitness']}  ({time.perf_counter() - t_phase:.1f} s "
              f"into phase 15)")
        # the loss the resumed run must log first: the checkpointed state (this
        # one) on the batch the loader gives at step TRAIN_STEPS, from the
        # corpus and subset the launcher makes
        corpus = SyntheticCorpus(TRAIN_CORPUS, TRAIN_SEQ + 1, full.vocab_size, seed=0)
        subset = select_corpus_subset(corpus, TRAIN_SUBSET, generator=make_generator(0, dev),
                                      sample_rows=min(TRAIN_CORPUS, 4096), device=dev)
        loader = ShardedLoader(corpus, TRAIN_BATCH, seed=0, subset=subset)
        loader.restore(LoaderState(TRAIN_STEPS))
        nxt = {k: torch.as_tensor(v, device=dev).chunk(TRAIN_ACCUM)
               for k, v in loader.next().items()}
        with torch.no_grad():
            want = sum(float(xent_loss(lm.forward(state.params, {"tokens": t}, full), lab))
                       for t, lab in zip(nxt["tokens"], nxt["labels"])) / TRAIN_ACCUM
        del state, nxt
        _free(torch)

        argv = TRAIN_ARGV + ["--steps", str(TRAIN_RESUME_STEPS), "--ckpt-dir", ckpt_dir]
        K.reset_launch_counts()
        state, text, wall = _run_logged(train.main, argv)
        resumed = _step_lines(text)
        print(f"resumed launch.train.main(... --steps {TRAIN_RESUME_STEPS}): {wall:.3f} s; "
              f"launches {K.launch_counts()}")
        if (f"[ckpt] resumed from step {TRAIN_STEPS - 1}" not in text
                or [s for s, _, _ in resumed] != list(range(TRAIN_STEPS, TRAIN_RESUME_STEPS))
                or int(state.step) != TRAIN_RESUME_STEPS):
            fail(f"training: the second run did not resume at step {TRAIN_STEPS}: "
                 f"steps {resumed}, final step {int(state.step)}")
        if not all(math.isfinite(l) and math.isfinite(g) for _, l, g in resumed):
            fail(f"training: resumed loss or grad norm not finite: {resumed}")
        # the log prints 4 decimals
        print(f"  resumed step {TRAIN_STEPS} loss {resumed[0][1]:.4f}; the checkpointed "
              f"state on the loader's step-{TRAIN_STEPS} batch {want:.6f}")
        if not abs(resumed[0][1] - want) <= TRAIN_RESUME_TOL:
            fail(f"training: the resumed run's first loss {resumed[0][1]} is not the "
                 f"checkpointed state's {want} on the loader's step-{TRAIN_STEPS} batch")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 15)")

    # (c) warm steps on the resumed state: timed with and without remat,
    # profiled, host waits
    state = _train_warm(torch, dev, state, peak)
    print(f"  ({time.perf_counter() - t_phase:.1f} s into phase 15)")

    # (d) the reference's train_4k length, on the same state
    per_step_4k = _train_4k(torch, dev, K, state)
    del state
    _free(torch)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "per_step": per_step, "per_step_4k": per_step_4k}


TRAIN_RECOMPUTE = ("_sdpa recompute", "_ssd_chunked recompute")
B4_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")


def _train_warm(torch, dev, state, peak: float) -> None:
    """Warm full-width zamba2-2.7b steps on ``state``: ``TRAIN_WARM_STEPS``
    timed (ms/step, tokens/s, MFU, peak memory), then as many without remat
    after one untimed, one with the largest log-decay span its SSD backward
    meets (ROADMAP C4), one under the profiler (busy share, top kernels, B3's and
    B4's shares of the device time and those of the backward's
    recomputations through ``_sdpa`` and ``_ssd_chunked``, each labelled by a
    ``record_function`` range around the autograd Function's backward), one
    under sync-debug "warn" (the host waits inside a step)."""
    import bisect
    import collections
    import dataclasses
    import warnings
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.launch.flops import model_flops
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models import ssm
    from repro_torch.models.layers import _FlashAttention
    from repro_torch.models.ssm import _SSDScan
    from repro_torch.train.optimizer import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import make_train_step

    arch = get_arch("zamba2-2.7b")
    full = arch.config
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.peak_lr, warmup=20, total=100))
    step_fn = make_train_step(full, opt, accum_steps=TRAIN_ACCUM)
    toks = torch.randint(0, full.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=make_generator(5, dev), device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    flops = model_flops(full, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # remat (the config's default), then without it, in the same call
    for remat in (True, False):
        fn = step_fn if remat else make_train_step(dataclasses.replace(full, remat=False), opt,
                                                   accum_steps=TRAIN_ACCUM)
        if not remat:
            state, _ = fn(state, batch)         # its first step, untimed
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        state, _, ms, times = _timed_steps(torch, fn, state, batch, TRAIN_WARM_STEPS)
        window_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"training zamba2-2.7b (full width, {full.n_layers} layers, bf16 compute, "
              f"float32 params, AdamW, batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} "
              f"microbatches, remat {remat}), warm: {ms:.3f} ms/step (median of "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), {tokens * 1e3 / ms:.1f} "
              f"tokens/s, {flops / 1e12:.3f} TFLOP per step (launch/flops), MFU "
              f"{flops / (ms * 1e-3) / BF16_OPS_PER_S:.4f} of {BF16_OPS_PER_S / 1e12:.0f} "
              f"TFLOP/s (a reading, no claim); peak memory of these steps {window_peak:.2f} "
              f"GiB" + (f", of the launcher's run {peak:.2f} GiB" if remat else "")
              + f"  [{smi_line()}]")

    originals = (_FlashAttention.backward, _SSDScan.backward)

    # the largest log-decay span inside a chunk that the backward meets:
    # past 88.7 the reference's _ssd_chunked overflows exp (ROADMAP C4).  Read
    # from the arguments of the backward's _ssd_chunked: under remat a saved
    # tensor may be unpacked only once, by the backward itself.
    spans_seen = []
    chunked = ssm._ssd_chunked

    def span_recorded(x, dt, a, *args, **kw):
        Q = min(full.ssm_chunk, x.shape[1])
        la = torch.cumsum((dt * a).reshape(dt.shape[0], -1, Q, dt.shape[2]), dim=2)
        spans_seen.append((la[:, :, 0] - la[:, :, -1]).max().detach())
        return chunked(x, dt, a, *args, **kw)
    ssm._ssd_chunked = span_recorded
    try:
        state, m = step_fn(state, batch)
    finally:
        ssm._ssd_chunked = chunked
    span = torch.stack(spans_seen).max().item()
    print(f"  largest log-decay span in a chunk over one step's {len(spans_seen)} SSD "
          f"backward calls: {span:.2f} (exp overflows float32 past 88.7); grad norm "
          f"{float(m['grad_norm']):.4f}")
    if not math.isfinite(float(m["grad_norm"])):
        fail(f"training: a warm step's grad norm is not finite (largest span {span})")

    def labelled(label, fn):
        def backward(ctx, *grads):
            with record_function(label):
                return fn(ctx, *grads)
        return staticmethod(backward)
    _FlashAttention.backward = labelled(TRAIN_RECOMPUTE[0], originals[0])
    _SSDScan.backward = labelled(TRAIN_RECOMPUTE[1], originals[1])
    try:
        print("profiled warm training step:")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        _FlashAttention.backward, _SSDScan.backward = (staticmethod(f) for f in originals)
    # device events: the ranges' spans on the device timeline, and the kernels
    # and copies (one stream: a kernel inside a range's span is the range's)
    spans = collections.defaultdict(list)
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        start, dur = e.start_ns(), e.duration_ns()
        if e.name() in TRAIN_RECOMPUTE:
            spans[e.name()].append((start, start + dur))
        else:
            ops.append((e.name(), start, start + dur, dur / 1e3))
    busy = sum(us for *_, us in ops)
    if busy <= 0:
        fail("training: the profiler recorded no device time for a step")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, _, _, us in ops:
        by_name[name][0] += 1
        by_name[name][1] += us
    print(f"  wall {wall:.3f} s (profiler on), device busy {busy / 1e6:.4f} s, busy share "
          f"{busy / 1e6 / wall:.4f}; {len(ops)} device operations")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us / 1e3:10.3f} ms  {n:6d} x  {name[:90]}")
    shares = {"B3 (flash_attention)": sum(us for name, _, _, us in ops
                                          if "flash_attention" in name),
              "B4 (ssd_scan)": sum(us for name, _, _, us in ops
                                   if any(k in name for k in B4_KERNELS))}
    for label in TRAIN_RECOMPUTE:
        iv = sorted(spans[label])
        starts = [a for a, _ in iv]
        inside = 0.0
        for _, a, b, us in ops:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= iv[i][1]:
                inside += us
        shares[f"{label} ({len(iv)} ranges)"] = inside
    print("  shares of the step's device time: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms ({us / busy:.4f})" for k, us in shares.items()))
    if not all(us > 0 for us in shares.values()):
        fail(f"training: the profiled step is missing a kernel or a recomputation: {shares}")

    # host waits inside one step
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, m = step_fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in waits)
    print(f"  host waits inside one training step: {len(waits)}"
          + (": " + ", ".join(f"{k} x{v}" for k, v in where.most_common()) if waits else ""))
    return state


# phase 15 (d): zamba2-2.7b's published config, uncut, at the reference's
# train_4k length (src/repro/models/config.py:102: 4096 positions); the global
# batch cut from 256 (grad_accum 8) to 2 sequences in 2 microbatches of 1 x
# 4096, for one card's time.  One untimed step, TRAIN_4K_STEPS timed, one
# profiled; no checkpoint (the state is 29 GB).
TRAIN_4K_SEQ, TRAIN_4K_BATCH, TRAIN_4K_ACCUM, TRAIN_4K_STEPS = 4096, 2, 2, 3


def _train_4k(torch, dev, K, state) -> dict:
    """Phase 15 (d): ``state`` trained on 2 x 4096 positions a step with remat
    (B3 and B4 in each forward and its recomputation).  Prints warm ms/step,
    tokens/s, MFU, peak memory, launches per step and one profiled step;
    checks loss and grad norm finite.  Then B3 and B4 called twice on the
    same inputs at this shape: whether a recomputed forward reproduces them
    bit for bit.  Returns each kernel's launches per step."""
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch.flops import model_flops
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.optimizer import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    arch = get_arch("zamba2-2.7b")
    full = arch.config
    if not full.remat:
        fail("train_4k: the zamba2-2.7b config does not default to remat")
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.peak_lr, warmup=20, total=100))
    step_fn = make_train_step(full, opt, accum_steps=TRAIN_4K_ACCUM)
    toks = torch.randint(0, full.vocab_size, (TRAIN_4K_BATCH, TRAIN_4K_SEQ + 1),
                         generator=make_generator(6, dev), device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, m = step_fn(state, batch)
    first = (float(m["loss"]), float(m["grad_norm"]))
    state, m, ms, times = _timed_steps(torch, step_fn, state, batch, TRAIN_4K_STEPS)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = 1 + TRAIN_4K_STEPS
    n_attn = full.n_layers // full.shared_attn_every
    fwd = TRAIN_4K_ACCUM * 2                  # each forward and its recomputation
    want = {"flash_attention": fwd * n_attn, "ssd_scan": fwd * full.n_layers}
    per_step = {k: launches[k] // n_steps for k in want}
    flops = model_flops(full, ShapeSpec("train_4k", TRAIN_4K_SEQ, TRAIN_4K_BATCH, "train"))
    tokens = TRAIN_4K_BATCH * TRAIN_4K_SEQ
    last = (float(m["loss"]), float(m["grad_norm"]))
    print(f"train_4k: zamba2-2.7b (published config, {full.n_layers} layers, bf16 compute, "
          f"float32 params, AdamW, remat), {TRAIN_4K_BATCH} x {TRAIN_4K_SEQ} positions a step "
          f"in {TRAIN_4K_ACCUM} microbatches of 1 x {TRAIN_4K_SEQ}; warm {ms:.3f} ms/step "
          f"(median of {', '.join(f'{t * 1e3:.3f}' for t in times)}), "
          f"{tokens * 1e3 / ms:.1f} tokens/s, {flops / 1e12:.3f} TFLOP per step "
          f"(launch/flops), MFU {flops / (ms * 1e-3) / BF16_OPS_PER_S:.4f} of "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s (a reading, no claim); peak memory "
          f"{peak:.2f} GiB  [{smi_line()}]")
    print(f"  launches in {n_steps} steps: {launches}; per step flash_attention "
          f"{launches['flash_attention'] / n_steps:g}, ssd_scan {launches['ssd_scan'] / n_steps:g}"
          f" (expected {want['flash_attention']} and {want['ssd_scan']}); loss "
          f"{first[0]:.4f} -> {last[0]:.4f}, grad norm {first[1]:.4f} -> {last[1]:.4f}")
    if not all(math.isfinite(v) for v in first + last):
        fail(f"train_4k: loss or grad norm not finite: {first}, {last}")
    if any(launches[k] != n_steps * want[k] for k in want):
        fail(f"train_4k: launches {launches} over {n_steps} steps, expected {want} per step")
    print("  profiled train_4k step:")
    profile_share(torch, lambda: step_fn(state, batch))

    # does a recomputed forward reproduce each kernel's output bit for bit?
    g = make_generator(7, dev)
    H, hd = full.n_heads, full.head_dim
    q, k, v = (torch.randn(1, TRAIN_4K_SEQ, H, hd, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    Hs, P, N = full.ssm_heads, full.ssm_head_dim, full.ssm_state
    x = torch.randn(1, TRAIN_4K_SEQ, Hs, P, generator=g, device=dev, dtype=torch.bfloat16)
    dt = torch.rand(1, TRAIN_4K_SEQ, Hs, generator=g, device=dev) * 0.1
    a = -torch.rand(Hs, generator=g, device=dev)
    bm, cm = (torch.randn(1, TRAIN_4K_SEQ, full.ssm_groups, N, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    same = {"B3 (flash_attention)": torch.equal(flash_attention(q, k, v, causal=True),
                                                flash_attention(q, k, v, causal=True))}
    y1, h1 = ssd_scan(x, dt, a, bm, cm, block_q=full.ssm_chunk)
    y2, h2 = ssd_scan(x, dt, a, bm, cm, block_q=full.ssm_chunk)
    same["B4 (ssd_scan)"] = torch.equal(y1, y2) and torch.equal(h1, h2)
    print("  a second call on the same inputs at the train_4k shape, bit-equal (deterministic: "
          "a recomputed forward saves the same tensors): " + ", ".join(
              f"{k} {'yes' if v else 'no (nondeterministic: the recomputed forward shifts the gradient)'}"
              for k, v in same.items()))
    print(f"  (train_4k: {time.perf_counter() - t0:.1f} s)")
    return per_step


def _timed_steps(torch, step_fn, state, batch, n: int):
    """``n`` steps, each timed on the host clock to its loss on the host;
    returns the state, the last step's metrics, the median ms and each
    step's seconds."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    return state, m, sorted(times)[n // 2] * 1e3, times


# phase 16: the mesh layer on one card.  pmm at zamba2-2.7b's MLP up
# projection (4096 tokens, 2560 -> 10240) and its q projection (2560 -> 32 x
# 80 heads); against torch.einsum autograd, relative to the largest magnitude
PMM_SHAPES = (("bsd,df->bsf", (1, 4096, 2560), (2560, 10240), ("data", "model")),
              ("bsd,dhk->bshk", (1, 4096, 2560), (2560, 32, 80), ("data", "model", None)))
PMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def phase16_mesh(torch, dev) -> None:
    """The mesh layer on one card: a world-size-1 NCCL process group and a
    (1, 1) (data, model) CUDA mesh; zamba2-2.7b's param and optimizer-state
    specs on it (all None: ``_sanitize`` drops size-1 axes); ``compressed_psum``
    against the int8 round trip; ``pmm`` with DTensor operands at zamba2
    projection shapes in bf16 and float32 against ``torch.einsum`` autograd;
    ``restore_resharded`` of a small checkpoint onto the mesh.  The process
    group is destroyed at the end."""
    import dataclasses
    import shutil
    import socket
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.compression import (
        compressed_psum, dequantize_int8, quantize_int8,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.pmm import matmul
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.train_step import TrainState, init_train_state

    class MetaGenerator(torch.Generator):
        """Reports the meta device: ``init_params`` then builds shapes only."""

        @property
        def device(self):
            return torch.device("meta")

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        print(f"mesh: {mesh.device_type} {tuple(mesh.shape)} {mesh.mesh_dim_names} on a "
              f"world-size-1 {dist.get_backend()} process group")

        # (a) zamba2-2.7b's specs on the one-card mesh: all None
        full = get_arch("zamba2-2.7b").config
        params = lm.init_params(MetaGenerator(), full, for_training=True)
        n_specs = 0
        for mode in ("train", "prefill", "decode"):
            rules = sh.rules_for(full, mesh, mode)
            pspecs = sh.param_specs(params, full, mesh, rules)
            trees = [pspecs]
            for opt in (adamw(lambda s: 1e-3), adafactor(lambda s: 1e-3)):
                trees.append(sh.opt_state_specs(opt.init(params), pspecs, params, mesh))
            trees.append(sh.cache_specs(lm.init_cache(full, 4, 4096, device="meta"), full,
                                        mesh, rules))
            specs = []
            for tree in trees:
                sh._map_specs(tree, specs.append)
            bad = [sp for sp in specs if any(e is not None for e in sp)]
            if bad:
                fail(f"mesh: {len(bad)} specs on the (1, 1) mesh name an axis ({mode}): "
                     f"{bad[:3]}")
            n_specs += len(specs)
        print(f"  zamba2-2.7b specs (params, AdamW and Adafactor state, cache; train, prefill, "
              f"decode): {n_specs}, all None")

        # (b) compressed_psum over the one-rank group: the int8 round trip, twice
        x = torch.randn(1 << 20, generator=make_generator(8, dev), device=dev)
        got = compressed_psum(x)
        q, sc = quantize_int8(x.reshape(1, -1))
        q2, s2 = quantize_int8((q.float() * sc).sum(0))
        want = dequantize_int8(q2, s2)
        rel = float((got - x).abs().max() / x.abs().max())
        print(f"  compressed_psum (1 rank, {x.numel()} floats): equal to the int8 round trip "
              f"{torch.equal(got, want)}; max error {rel:.3e} of the largest magnitude")
        if not torch.equal(got, want) or not rel < 0.05:
            fail(f"mesh: compressed_psum differs from the int8 round trip (error {rel})")

        # (c) pmm with DTensor operands on the mesh, bf16 and float32
        for subs, xs, ws, spec in PMM_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                gen = make_generator(9, dev)
                xv = torch.randn(xs, generator=gen, device=dev).to(dtype)
                wv = (torch.randn(ws, generator=gen, device=dev) * xs[-1] ** -0.5).to(dtype)
                xd = distribute_tensor(xv, mesh, sh.spec_placements(("data",), mesh))
                wd = distribute_tensor(wv, mesh, sh.spec_placements(spec, mesh))
                xd.requires_grad_()
                wd.requires_grad_()
                y = matmul(xd, wd, subs, (spec, 1, 1, None))
                gy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
                y.backward(distribute_tensor(gy, mesh, list(y.placements)))
                xr, wr = xv.clone().requires_grad_(), wv.clone().requires_grad_()
                yr = torch.einsum(subs, xr, wr)
                yr.backward(gy)
                errs = {name: float((a.detach().full_tensor().float() - b.detach().float())
                                    .abs().max() / b.detach().float().abs().max())
                        for name, a, b in (("y", y, yr), ("dx", xd.grad, xr.grad),
                                           ("dw", wd.grad, wr.grad))}
                tol = PMM_TOL[str(dtype).split(".")[-1]]
                placed = tuple(wd.grad.placements) == sh.spec_placements(spec, mesh)
                print(f"  pmm {subs} {xs} x {ws} {str(dtype).split('.')[-1]}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                      + f" of the largest magnitude (limit {tol}); dW placements "
                      f"{tuple(wd.grad.placements)}")
                if not (all(v <= tol for v in errs.values()) and placed
                        and isinstance(wd.grad, DTensor)):
                    fail(f"mesh: pmm {subs} {dtype} differs from einsum autograd: {errs}, "
                         f"dW placements {wd.grad.placements}")
                del xd, wd, y, xr, wr, yr

        # (d) restore_resharded of a small training checkpoint onto the mesh
        smoke = dataclasses.replace(get_arch("zamba2-2.7b").smoke, dtype=torch.float32)
        state = init_train_state(make_generator(0), smoke, adamw(lambda s: 1e-3))
        ckpt.save_checkpoint(tmp, 3, state)
        rules = sh.rules_for(smoke, mesh, "train")
        pspecs = sh.param_specs(state.params, smoke, mesh, rules)
        specs = TrainState(sh.PartitionSpec(), pspecs,
                           sh.opt_state_specs(state.opt_state, pspecs, state.params, mesh))
        restored, step = ckpt.restore_resharded(tmp, state, sh.tree_shardings(specs, mesh))
        saved, got = [], []
        ckpt._flatten(state, saved)
        ckpt._flatten(restored, got)
        ok = (step == 3 and len(saved) == len(got)
              and all(isinstance(g, DTensor) and g.device.type == "cuda"
                      and torch.equal(g.full_tensor().cpu(), s) for s, g in zip(saved, got)))
        print(f"  restore_resharded: {len(got)} leaves of zamba2's smoke training state onto "
              f"the CUDA mesh, step {step}, every global value the saved one: {ok}")
        if not ok:
            fail("mesh: restore_resharded did not restore the saved values onto the mesh")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


# phase 17: the dry-run held on the card.  Its two one-card cells: zamba2-2.7b
# train_4k at 2 x 4096 (the reference's accum rule gives min(8, 2) = 2
# microbatches of 1 x 4096, phase 15's train_4k) and phase 9's prefill
DRYRUN_CELLS = (("train_4k_card", 4096, 2, "train"), ("prefill_card", 1024, 4, "prefill"))
DRYRUN_LAUNCHES = {"train_4k_card": {"flash_attention": 36, "ssd_scan": 216},
                   "prefill_card": {"flash_attention": 9, "ssd_scan": 54}}
DRYRUN_PEAK_RTOL = 0.15        # estimated peak against max_memory_allocated
DRYRUN_FLOPS_RTOL = 1e-6       # fake-traced FLOPs against the real step's, same counter


def phase17_dryrun(torch, dev, K) -> dict:
    """The dry-run (``launch/dryrun.py``, ``launch/costs.py``) on the card: a
    world-size-1 NCCL group and a (1, 1) CUDA mesh.  For each of
    ``DRYRUN_CELLS``: (1) ``dryrun.run_cell``'s estimate on fake CUDA
    tensors; (2) the same cell for real: ``build_cell``'s operands
    materialised on the card (params from seed 0, inputs from seed 17), its
    step run once under the same FLOP counter, with both kernels' launches
    and every plain version's calls counted; (3) estimate against the run:
    peak bytes within ``DRYRUN_PEAK_RTOL`` of ``max_memory_allocated``,
    FLOPs within ``DRYRUN_FLOPS_RTOL``, the launches ``DRYRUN_LAUNCHES``,
    no plain version, finite outputs; the roofline terms and the useful
    FLOPs printed beside them.  (4) One production-mesh cell traced on this
    machine: zamba2-2.7b train_4k at (16, 16) on a fake process group in a
    subprocess.  Returns each kernel's launches per cell."""
    import socket
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import CostCounter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeSpec

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    launches = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        for name, seq, batch, kind in DRYRUN_CELLS:
            shape = ShapeSpec(name, seq, batch, kind)
            _free(torch)
            rec = dryrun.run_cell("zamba2-2.7b", shape, mesh=mesh, verbose=False)
            if rec.get("status") != "ok":
                fail(f"dry-run: {name} was not traced: {rec}")
            est_peak = rec["memory"]["peak_bytes"]
            est_flops = rec["roofline"]["hlo_flops_per_dev"]
            r = rec["roofline"]
            print(f"dry-run estimate, zamba2-2.7b {name} ({batch} x {seq}, {kind}, accum "
                  f"{rec['accum']}) on the (1, 1) mesh: trace {rec['trace_s']} s over "
                  f"(layers, microbatches) {rec['traced']}; peak {est_peak / 2 ** 30:.3f} GiB "
                  f"(operands {rec['memory']['argument_bytes'] / 2 ** 30:.3f}), "
                  f"{est_flops / 1e12:.3f} TFLOP, {r['hlo_bytes_per_dev'] / 1e9:.1f} GB moved "
                  f"(no fusion), {r['collective_bytes_per_dev']:.0f} collective bytes; roofline "
                  f"compute {r['compute_s'] * 1e3:.3f} ms / memory {r['memory_s'] * 1e3:.3f} ms / "
                  f"collective {r['collective_s'] * 1e3:.3f} ms -> {r['dominant']}")

            _free(torch)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cell = dryrun.build_cell("zamba2-2.7b", shape, mesh, seed=0, device="cuda")
            dryrun.fill_inputs_(cell, seed=17)
            K.reset_launch_counts()
            with plain_versions_counted() as plain, implicit_replication():
                with CostCounter() as cc:
                    out = cell.step(*cell.args)
                torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches[name] = {k: v for k, v in K.launch_counts().items()
                              if k in DRYRUN_LAUNCHES[name]}
            peak = torch.cuda.max_memory_allocated() - base
            whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731
            if kind == "train":
                m = out[1]
                vals = torch.stack([whole(m["loss"]).float(), whole(m["grad_norm"]).float()])
                what = f"loss {float(vals[0]):.4f}, grad norm {float(vals[1]):.4f}"
            else:
                vals = whole(out[0]).float()
                what = f"logits {tuple(vals.shape)}"
                if vals.shape != (batch, 1, cell.cfg.vocab_size):
                    fail(f"dry-run: {name} logits {tuple(vals.shape)}")
            peak_err = abs(est_peak - peak) / peak
            flops_err = abs(est_flops - cc.flops) / cc.flops
            mflops = r["model_flops_global"]
            print(f"  the same cell run on the card ({run_s:.1f} s with its build): {what}; "
                  f"peak {peak / 2 ** 30:.3f} GiB (max_memory_allocated above the "
                  f"{base / 2 ** 30:.3f} GiB held before), estimate off by {peak_err:.4f} "
                  f"(limit {DRYRUN_PEAK_RTOL}); FLOPs {cc.flops / 1e12:.6f} T counted, "
                  f"estimate off by {flops_err:.2e} (limit {DRYRUN_FLOPS_RTOL}); model FLOPs "
                  f"{mflops / 1e12:.3f} T (launch/flops), useful ratio {mflops / cc.flops:.4f}; "
                  f"launches {launches[name]} (expected {DRYRUN_LAUNCHES[name]}); plain "
                  f"versions called {plain.calls or 'none'}  [{smi_line()}]")
            if not bool(torch.isfinite(vals).all()):
                fail(f"dry-run: {name} gave non-finite outputs ({what})")
            if launches[name] != DRYRUN_LAUNCHES[name] or plain.calls:
                fail(f"dry-run: {name} launches {launches[name]}, plain calls {plain.calls}")
            if not peak_err <= DRYRUN_PEAK_RTOL:
                fail(f"dry-run: {name} peak estimate {est_peak} against {peak}")
            if not flops_err <= DRYRUN_FLOPS_RTOL:
                fail(f"dry-run: {name} FLOPs estimate {est_flops} against {cc.flops}")
            del cell, out, vals
    finally:
        dist.destroy_process_group()
    _free(torch)

    # (4) a production-mesh cell traced on this machine, in a process of its own
    out_json = ROOT / "build" / "phase17_dryrun.json"
    out_json.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "zamba2-2.7b", "--shape", "train_4k", "--mesh", "single", "--force",
                           "--out", str(out_json)], capture_output=True, text=True,
                          timeout=900, cwd=ROOT, env={**__import__("os").environ,
                                                      "PYTHONPATH": str(ROOT / "src")})
    cellrec = (json.loads(out_json.read_text()).get("zamba2-2.7b|train_4k|single", {})
               if out_json.exists() else {})
    if proc.returncode != 0 or cellrec.get("status") != "ok":
        fail(f"dry-run: the (16, 16) trace failed ({proc.returncode}): {cellrec} "
             f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    r = cellrec["roofline"]
    print(f"dry-run, zamba2-2.7b train_4k on the (16, 16) production mesh (fake process "
          f"group, {time.perf_counter() - t0:.1f} s in its process, trace {cellrec['trace_s']} "
          f"s): peak {cellrec['memory']['peak_per_device_gb']:.2f} GB a device, fits 80 GB "
          f"{cellrec['fits_80gb']}; {r['hlo_flops_per_dev'] / 1e12:.3f} TFLOP a device; "
          f"compute {r['compute_s'] * 1e3:.2f} ms / memory {r['memory_s'] * 1e3:.2f} ms / "
          f"collective {r['collective_s'] * 1e3:.2f} ms -> {r['dominant']}")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 18's comparisons: dataset -> the methods run (None: all nine)
COMPARE_RUNS = (("D6", None), ("D1", ["SubStrat", "SubStrat-NF"]))
# the untimed call's scale: D6 keeps 2,786 training rows there, above the
# 2,048 at which an AutoML pass multiplies trial by trial
# (automl/models.STACKED_MATMUL_MAX_ROWS), so the warm-up runs the path that
# the full-size Full-AutoML takes
WARM_SCALE = 0.2


def _finite_acc(acc) -> bool:
    return acc is not None and math.isfinite(acc) and 0.0 <= acc <= 1.0


def phase18_examples(torch, dev, K) -> dict:
    """The entry points of ``examples/`` through their port modules, on the
    card.  (a) ``launch.quickstart`` at its defaults, then with ``--backend
    loop`` and with ``--strategy ig_km`` at ``--scale 0.1 --trials 4``.  (b)
    ``launch.compare.run_dataset`` at full size for each of
    ``COMPARE_RUNS``: one untimed call at ``WARM_SCALE``, then two timed calls
    back to back between two machine probes; per call and method its
    seconds, time-reduction, test accuracy, relative accuracy, phase seconds
    and B1/B2 launches.  Fails unless every accuracy is finite in [0, 1],
    each Gen-DST method's DST fitness is within ``FIT_TOL`` of a plain
    recomputation, B1 and B2 launch in SubStrat and SubStrat-NF and neither
    in Full-AutoML.  (c) The four gates, each returning 0: the warm-start,
    metrics and recompile-budget gates, and ``serve_tabular --json`` in
    process and with two workers and worker 0 killed, diffed by
    ``check_chaos_parity``.  (d) ``launch.serve_lm`` (qwen3-8b's smoke
    config; B3 must launch) and ``launch.train_lm --steps 2`` at both its
    presets (mamba2-130m's smoke config and its published config; B4 must
    launch, the parameters stay finite) in a temporary working directory.
    Returns each run's launches per kernel, zeroed before the run and read
    after it."""
    import collections
    import os
    import tempfile
    from repro_torch.core.measures import factorize
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    from repro_torch.launch import (
        check_chaos_parity, check_metrics, check_recompile_budget, check_warm_start, compare,
        quickstart, serve_lm, serve_tabular, train_lm,
    )

    t_phase = time.perf_counter()
    launches = {}

    def counted(label, fn):
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = K.launch_counts()
        return out

    # (a) the paper's headline comparison on D3
    for label, argv in (("quickstart", []),
                        ("quickstart --backend loop",
                         ["--backend", "loop", "--scale", "0.1", "--trials", "4"]),
                        ("quickstart --strategy ig_km",
                         ["--strategy", "ig_km", "--scale", "0.1", "--trials", "4"])):
        print(f"--- {label}")
        q = counted(label, lambda: quickstart.main(argv))
        if not (_finite_acc(q["full"].test_acc) and _finite_acc(q["substrat"].final.test_acc)):
            fail(f"{label}: test accuracy {q['full'].test_acc} / "
                 f"{q['substrat'].final.test_acc} not finite in [0, 1]")
        print(f"  launches {launches[label]}")

    # (b) the Table-4 comparison at the paper datasets' full size
    for name, methods in COMPARE_RUNS:
        spec = PAPER_DATASETS[name]
        X, y = make_dataset(spec, scale=1.0)
        Xtr, ytr, _, _ = train_test_split(X, y, 0.2, seed=0)
        coded = factorize(Xtr, ytr, device=dev)
        t0 = time.perf_counter()
        compare.run_dataset(spec, scale=WARM_SCALE, methods=methods, device=dev)
        print(f"compare {name}: untimed call at scale {WARM_SCALE} in "
              f"{time.perf_counter() - t0:.1f} s")
        machine_probe(torch)
        for call in (1, 2):
            label = f"compare {name} call {call}"
            t0 = time.perf_counter()
            full, results = counted(label, lambda: compare.run_dataset(
                spec, scale=1.0, methods=methods, device=dev))
            print(f"{label} ({len(ytr)} train rows, {time.perf_counter() - t0:.1f} s with "
                  f"warm-ups): method, time_s, time_reduction, test_acc, relative_accuracy, "
                  f"B1/B2 launches, winner family, phase (or rung) seconds  [{smi_line()}]")
            for r in [full] + results:
                b12 = [r.launches[k] for k in K.GEN_DST_KERNELS]
                if r.method == "Full-AutoML":
                    family = r.result.spec.family
                    times = "rungs " + ", ".join(f"{t:.4f}" for t in r.result.rung_times)
                else:
                    family = r.result.final.spec.family
                    times = ", ".join(f"{k} {v:.4f}" for k, v in r.result.times.items())
                print(f"  {r.method:12s} {r.time_s:.4f} {r.time_reduction:+.4f} "
                      f"{r.test_acc:.4f} {r.relative_accuracy:.4f} {b12[0]}/{b12[1]} "
                      f"{family}  {times}")
                if not _finite_acc(r.test_acc):
                    fail(f"{label}: {r.method} test accuracy {r.test_acc}")
            if any(full.launches[k] for k in K.GEN_DST_KERNELS):
                fail(f"{label}: B1/B2 launched during Full-AutoML: {full.launches}")
            for r in results:
                if r.method in ("SubStrat", "SubStrat-NF"):
                    if not all(r.launches[k] > 0 for k in K.GEN_DST_KERNELS):
                        fail(f"{label}: {r.method} launched {r.launches}")
                    f_plain = plain_fitness(torch, coded, r.result.row_idx, r.result.col_idx)
                    err = abs(r.result.dst_fitness - f_plain)
                    sub = r.result.intermediate
                    families = sorted(collections.Counter(
                        sp.family for sp, _ in sub.trials).items())
                    print(f"  {r.method} dst_fitness {r.result.dst_fitness:.8f}, plain "
                          f"recomputation {f_plain:.8f}; subset {len(r.result.row_idx)} x "
                          f"{len(r.result.col_idx)}; sub-AutoML rungs "
                          f"{', '.join(f'{t:.4f}' for t in sub.rung_times)} s over trials "
                          f"{dict(families)}")
                    if not err <= FIT_TOL:
                        fail(f"{label}: {r.method} DST fitness off its plain "
                             f"recomputation by {err}")
        machine_probe(torch)
        del coded

    # (c) the four gates
    def gate(label, fn):
        print(f"--- {label}")
        try:
            rc = counted(label, fn)
        except AssertionError as exc:
            fail(f"{label}: {exc}")
        if rc not in (0, None):
            fail(f"{label} returned {rc}")

    gate("check_warm_start", lambda: check_warm_start.main([]))
    gate("check_metrics", lambda: check_metrics.main(
        ["--jobs", "2", "--scale", "0.1", "--trials", "4"]))
    gate("check_recompile_budget", lambda: check_recompile_budget.main(
        ["--rounds", "2", "--jobs", "2", "--scale", "0.1", "--trials", "4"]))
    with tempfile.TemporaryDirectory(prefix="repro_torch_chaos_") as tmp:
        smoke = ["--jobs", "2", "--scale", "0.1", "--trials", "4", "--json"]
        for label, extra in (("serve_tabular", ["base.json"]),
                             ("serve_tabular --workers 2 --kill-worker 0",
                              ["chaos.json", "--workers", "2", "--kill-worker", "0"])):
            print(f"--- {label}")
            argv = smoke + [f"{tmp}/{extra[0]}"] + extra[1:]
            payload = counted(label, lambda: serve_tabular.main(argv))
            accs = [job["test_acc"] for job in payload["jobs"]]
            if len(accs) != 2 or not all(_finite_acc(a) for a in accs):
                fail(f"{label}: test accuracies {accs}")
        gate("check_chaos_parity", lambda: check_chaos_parity.main(
            [f"{tmp}/base.json", f"{tmp}/chaos.json"]))

    # (d) the LM wrappers at their own presets
    print("--- serve_lm")
    res = counted("serve_lm", lambda: serve_lm.main([]))
    if not bool(torch.isfinite(res.last_logits).all()) or launches["serve_lm"][
            "flash_attention"] <= 0:
        fail(f"serve_lm: launches {launches['serve_lm']}, finite logits "
             f"{bool(torch.isfinite(res.last_logits).all())}")
    print(f"  launches {launches['serve_lm']}")
    cwd = os.getcwd()
    for label, argv in (("train_lm", ["--steps", "2"]),
                        ("train_lm --preset full", ["--preset", "full", "--steps", "2"])):
        print(f"--- {label} --steps 2")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_") as tmp:
            os.chdir(tmp)
            try:
                states = counted(label, lambda: train_lm.main(argv))
            finally:
                os.chdir(cwd)
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(p.float()).all()) for s in states
                     for p in s.params.parameters())
        if not finite or launches[label]["ssd_scan"] <= 0:
            fail(f"{label}: launches {launches[label]}, finite params {finite}")
        n_params = sum(p.numel() for p in states[0].params.parameters())
        print(f"  {n_params / 1e6:.1f} M parameters; two runs of 2 steps in {wall:.1f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {launches[label]}  [{smi_line()}]")
        del states
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels as K
        from repro_torch.core.gen_dst import GenDSTConfig, TorchDraws, gen_dst
        from repro_torch.core.measures import factorize, full_column_entropy
        from repro_torch.core.plan import execute, plan
        from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
        from repro_torch.device import make_generator, resolve_device
        from repro_torch.kernels import _build
        from repro_torch.kernels.entropy.kernel import (
            masked_histogram_cuda, population_histogram_rows_cuda,
        )
        from repro_torch.kernels.entropy.ref import masked_histogram_ref
        from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
        from repro_torch.kernels.gen_dst.ref import fused_delta_fitness_ref
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")
    import numpy as np

    # --- 1. the card and the build -------------------------------------------
    t_sec = time.perf_counter()
    smi = smi_line()
    dev = resolve_device("cuda")
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    try:
        _build.library()
    except RuntimeError as exc:
        fail(f"kernel build: {exc}")
    print(f"build_s {time.perf_counter() - t0:.3f}")
    machine_probe(torch)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    # the main path's data: D1 at full scale, train split, factorized
    X, y = make_dataset(PAPER_DATASETS["D1"], scale=1.0)
    X_tr, y_tr, X_te, y_te = train_test_split(X, y)
    coded = factorize(X_tr, y_tr, device=dev)
    N, M = coded.codes.shape
    fz_ms = check_factorize(torch, dev, factorize, X_tr, y_tr)
    print(f"factorize D1 {X_tr.shape}: card = CPU = NumPy loop, exact; "
          f"card median {fz_ms:.3f} ms over 5 calls")
    B = coded.max_bins
    cfg = GenDSTConfig()
    n, m = round(N ** 0.5), round(0.25 * M)
    P = cfg.phi
    print(f"D1: train rows {N}, columns {M} (target incl.), B {B}, n {n}, m {m}, P {P}")
    gen = make_generator(1234, dev)
    rows = torch.randint(0, N, (P, n), generator=gen, device=dev)
    rows32 = rows.to(torch.int32)                                 # as Gen-DST holds them
    sub = coded.codes[rows]                                       # (P, n, M)
    flat = sub.permute(1, 0, 2).reshape(n, P * M).contiguous()    # (n, P*M)
    kernels = []

    def gathered_plain(codes_, rows_, bins):
        """The gathered entry's plain version, ``population_histogram(codes[rows])``
        with the plain histogram: the gather, the fold (P, n, M) -> (n, P*M)
        and the scatter."""
        Pg, ng = rows_.shape
        f = codes_[rows_.long()].permute(1, 0, 2).reshape(ng, Pg * codes_.shape[1])
        return masked_histogram_ref(f, torch.ones(ng, device=codes_.device), bins).reshape(
            Pg, codes_.shape[1], bins)

    t_sec = phase_seconds(1, t_sec)
    # --- 2. masked histogram -------------------------------------------------
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    h_k = masked_histogram_cuda(flat, ones, B)
    h_g = population_histogram_rows_cuda(coded.codes, rows32, B)
    h_r = masked_histogram_ref(flat, ones, B)
    torch.cuda.synchronize()
    if not torch.equal(h_k, h_r):
        fail(f"masked_histogram: not exact at the main shape, max err "
             f"{(h_k - h_r).abs().max().item()}")
    if not torch.equal(h_g, h_r.reshape(P, M, B)):
        fail(f"masked_histogram: gathered entry not exact at the main shape, max err "
             f"{(h_g - h_r.reshape(P, M, B)).abs().max().item()}")
    hist_err = (h_g - h_r.reshape(P, M, B)).abs().max().item()
    print(f"masked_histogram gathered   D1 (P={P}, n={n}, M={M}, B={B}): exact")
    edge_shapes = [(5, 3, 8, None), (300, 13, 16, None), (200, 4, 64, 11), (7, 9, 32, 5),
                   (n, P * M, B, None)]
    for Ne, Me, Be, code_max in edge_shapes:
        rng = np.random.default_rng(Ne * 7 + Me)
        codes_e = torch.as_tensor(rng.integers(0, code_max or Be, (Ne, Me)),
                                  dtype=torch.int32, device=dev)
        for kind in ("uniform", "fractional"):
            w = (torch.ones(Ne, device=dev) if kind == "uniform" else
                 torch.as_tensor(rng.random(Ne), dtype=torch.float32, device=dev))
            hk, hr = masked_histogram_cuda(codes_e, w, Be), masked_histogram_ref(codes_e, w, Be)
            torch.cuda.synchronize()
            if kind == "uniform" and not torch.equal(hk, hr):
                fail(f"masked_histogram: not exact at {(Ne, Me, Be)}")
            if not torch.allclose(hk, hr, rtol=HIST_TOL, atol=HIST_TOL):
                fail(f"masked_histogram: {kind} weights off at {(Ne, Me, Be)}: "
                     f"{(hk - hr).abs().max().item()}")
            if code_max is not None and hk[:, code_max:].any():
                fail(f"masked_histogram: padding bins not zero at {(Ne, Me, Be)}")
            print(f"masked_histogram {kind:10s} N={Ne} M={Me} B={Be}: "
                  f"max_abs_err {(hk - hr).abs().max().item():.3e}")
    # the gathered entry at edge shapes: ragged P, M and B no multiple of 4, a
    # tile across candidates, padding bins, B large enough to shrink the tile
    # and, at 20000, to take the shared-memory opt-in with one column per block
    gathered_edges = [(37, n, N, M, B, None), (7, 9, 50, 3, 8, None), (13, 20, 100, 5, 30, 11),
                      (3, 40, 64, 33, 7, None), (1, 1, 1, 1, 1, None),
                      (5, 50, 400, 6, 5000, None), (2, 10, 20, 4, 20000, 300)]
    for Pe, ne, Ne, Me, Be, code_max in gathered_edges:
        rng = np.random.default_rng(Pe * 31 + Me)
        if Ne == N:
            codes_e = coded.codes
        else:
            codes_e = torch.as_tensor(rng.integers(0, code_max or Be, (Ne, Me)),
                                      dtype=torch.int32, device=dev)
        rows_e = torch.as_tensor(rng.integers(0, Ne, (Pe, ne)), dtype=torch.int32, device=dev)
        hk, hr = population_histogram_rows_cuda(codes_e, rows_e, Be), gathered_plain(
            codes_e, rows_e, Be)
        torch.cuda.synchronize()
        if not torch.equal(hk, hr):
            fail(f"masked_histogram: gathered entry not exact at (P, n, N, M, B) = "
                 f"{(Pe, ne, Ne, Me, Be)}")
        if code_max is not None and hk[..., code_max:].any():
            fail(f"masked_histogram: gathered padding bins not zero at {(Pe, ne, Ne, Me, Be)}")
        print(f"masked_histogram gathered   P={Pe} n={ne} N={Ne} M={Me} B={Be}: exact")
    bad = subprocess.run([sys.executable, "-c", BAD_ROW_SCRIPT, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=300).stdout.split()
    if bad != ["raised", "unusable"]:
        fail(f"masked_histogram: a row index outside the table gave {bad}, not an error")
    print("masked_histogram gathered   a row outside the table: an error at the synchronise")
    col_off = (torch.arange(P * M, device=dev) * B)[None, :]
    flat_idx = (flat.long() + col_off).reshape(-1)
    w_rep = ones[:, None].expand(n, P * M).reshape(-1).contiguous()
    run_g = lambda: population_histogram_rows_cuda(coded.codes, rows32, B)  # noqa: E731
    run_u = lambda: masked_histogram_cuda(flat, ones, B)                    # noqa: E731
    ms_k = time_ms(torch, run_g, "kernel, gathered entry")
    ms_u = time_ms(torch, run_u, "kernel, unindexed entry on the fold")
    ms_p = time_ms(torch, lambda: gathered_plain(coded.codes, rows, B),
                   "plain (gather, fold, scatter)")
    ms_l = time_ms(torch, lambda: torch.bincount(flat_idx, weights=w_rep, minlength=P * M * B),
                   "bincount (of the fold's flat index)")
    host_g, host_u = host_us(torch, run_g), host_us(torch, run_u)
    # gathered codes and the row index read once, counts written once; one
    # float32 add per cell
    b_ms, b_by = bound_ms(n * P * M * 4 + P * n * 4 + P * M * B * 4, n * P * M, FP32_OPS_PER_S)
    dev_g = kernel_device_ms(torch, run_g, "masked_histogram_kernel")
    dev_u = kernel_device_ms(torch, run_u, "masked_histogram_kernel")
    print(f"masked_histogram (P={P}, n={n}, M={M}, B={B}), gathered entry: kernel {ms_k:.5f} ms, "
          f"device {dev_g} ms, host {host_g:.2f} us per call; plain {ms_p:.5f} ms, bincount "
          f"{ms_l:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
    print(f"  unindexed entry on the fold (n={n}, P*M={P * M}): kernel {ms_u:.5f} ms, device "
          f"{dev_u} ms, host {host_u:.2f} us per call")
    kernels.append({"name": "masked_histogram", "route": "cuda",
                    "source": "src/repro_torch/csrc/masked_histogram.cu",
                    "replaces": "src/repro/kernels/entropy/kernel.py:45",
                    "launches": None, "max_abs_err": hist_err, "ms": ms_k, "plain_ms": ms_p,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": ms_l})

    t_sec = phase_seconds(2, t_sec)
    # --- 3. fused delta + fitness --------------------------------------------
    counts_main = h_r.reshape(P, M, B)
    f_ref = full_column_entropy(coded.codes, B).mean().reshape(1)
    fit_err = 0.0

    def copy_at(t):
        """A copy of ``t`` at the same address modulo 16 bytes."""
        off = (t.data_ptr() % 16) // t.element_size()
        out = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].view(t.shape)
        return out.copy_(t)

    def check_fused(label, counts, old, new, applied, cm, f=f_ref):
        """The kernel against the plain version on copies of ``counts`` (the
        kernel's at the same address modulo 16 bytes): counts bit-equal,
        fitness within FIT_TOL; returns the fitness error.  ``f`` is one F(D)
        or one per candidate."""
        cr, fr = fused_delta_fitness_ref(counts.clone(), old, new, applied, cm, f)
        ck, fk = fused_delta_fitness_cuda(copy_at(counts), old, new, applied, cm, f)
        torch.cuda.synchronize()
        if not torch.equal(ck, cr):
            fail(f"fused_delta_fitness: counts not bit-equal at {label}")
        err = (fk - fr).abs().max().item()
        if not err <= FIT_TOL:
            fail(f"fused_delta_fitness: fitness off by {err} at {label}")
        print(f"fused_delta_fitness {label}: counts bit-equal, fitness max_abs_err {err:.3e}")
        return err

    for Pe in (P, 37, 1):
        rng = np.random.default_rng(Pe)
        counts = counts_main[:Pe].contiguous()
        old = sub[:Pe, 0, :].contiguous()                  # evict a real member row
        new = coded.codes[torch.as_tensor(rng.integers(0, N, Pe), device=dev)].contiguous()
        cm = torch.as_tensor(rng.random((Pe, M)) < m / M, device=dev)
        cm[:, coded.target_col] = True
        for applied_kind in ("mutation", "zero"):
            applied = (torch.as_tensor(rng.random(Pe) < 0.5, device=dev).float()
                       if applied_kind == "mutation" else torch.zeros(Pe, device=dev))
            err = check_fused(f"P={Pe} M={M} B={B} {applied_kind}", counts, old, new, applied, cm)
            if Pe == P:
                fit_err = max(fit_err, err)
        # one F(D) per candidate, as gen_dst_batch passes it (stride 1)
        f_each = torch.as_tensor(rng.random(Pe) * 3.0, dtype=torch.float32, device=dev)
        applied = torch.as_tensor(rng.random(Pe) < 0.5, device=dev).float()
        check_fused(f"P={Pe} M={M} B={B} mutation, an f_ref per candidate", counts, old, new,
                    applied, cm, f_each)
    # edge shapes: fractional counts and delta; 100 and 600 columns, more than
    # a CTA's 32 warps; slabs of a size, or at an address, no multiple of 16
    # bytes (scalar loads); one column; B no multiple of 4
    for label, Pe, Me, Be, frac, view in (
            ("fractional counts and delta", 50, M, B, True, None),
            ("slab over 48 KB", 6, 100, 256, False, None),
            ("slab over 227 KB", 3, 600, 256, False, None),
            ("slabs of a size no multiple of 16 bytes, a counts[1:] view", 9, 5, 13, True,
             "slab"),
            ("slabs one float off 16-byte alignment", 8, M, B, False, "float"),
            ("one column", 5, 1, 8, False, None),
            ("B no multiple of 4", 7, 9, 30, False, None)):
        rng = np.random.default_rng(Pe * 13 + Me)
        shape = (Pe + (view == "slab"), Me, Be)
        if frac:
            base = rng.random(shape) * 4 * (rng.random(shape) < 0.6)
        else:
            base = rng.integers(0, 40, shape) * (rng.random(shape) < 0.3)
        base = torch.as_tensor(base, dtype=torch.float32, device=dev)
        if view == "slab":
            counts = base[1:]
        elif view == "float":
            buf = torch.empty(base.numel() + 1, device=dev)
            counts = buf[1:].view(shape)
            counts.copy_(base)
        else:
            counts = base
        old = torch.as_tensor(rng.integers(0, Be, (Pe, Me)), dtype=torch.int32, device=dev)
        new = torch.as_tensor(rng.integers(0, Be, (Pe, Me)), dtype=torch.int32, device=dev)
        cm = torch.as_tensor(rng.random((Pe, Me)) < 0.5, device=dev)
        cm[:, 0] = True
        applied = torch.as_tensor(rng.random(Pe) if frac else (rng.random(Pe) < 0.6),
                                  dtype=torch.float32, device=dev)
        check_fused(f"{label} (P={Pe} M={Me} B={Be})", counts, old, new, applied, cm)
    # the main path passes a zero delta on every generation (cross_every = 1)
    counts_t = counts_main.contiguous().clone()
    old, new = sub[:, 0, :].contiguous(), sub[:, 1, :].contiguous()
    cm = torch.zeros((P, M), dtype=torch.bool, device=dev)
    cm[:, :m] = True
    zero = torch.zeros(P, device=dev)
    run_f = lambda: fused_delta_fitness_cuda(counts_t, old, new, zero, cm, f_ref)  # noqa: E731
    ms_k = time_ms(torch, run_f, "kernel")
    ms_p = time_ms(torch, lambda: fused_delta_fitness_ref(counts_t, old, new, zero, cm, f_ref),
                   "plain")
    host_f = host_us(torch, run_f)
    # the counts read once; the codes, delta, mask and f_ref read once; the
    # fitness written once; two bins stored per column of each candidate whose
    # delta is applied (none here).  Per bin a float64 add to the column total,
    # and per nonzero bin a divide, a log2, a multiply and an add.
    n_applied = int((zero != 0).sum())
    nonzero_bins = int((counts_t > 0).sum())
    b_ms, b_by = bound_ms(P * M * B * 4 + 2 * P * M * 4 + P * 4 + P * M + 4 + P * 4
                          + 2 * n_applied * M * 4,
                          P * M * B + 4 * nonzero_bins, FP64_OPS_PER_S)
    dev_ms = kernel_device_ms(torch, run_f, "fused_delta_fitness_kernel")
    print(f"fused_delta_fitness (P={P}, M={M}, B={B}): kernel {ms_k:.5f} ms, "
          f"device {dev_ms} ms, host {host_f:.2f} us per call; plain {ms_p:.5f} ms, bound "
          f"{b_ms:.5f} ms ({b_by})")
    kernels.append({"name": "fused_delta_fitness", "route": "cuda",
                    "source": "src/repro_torch/csrc/fused_delta_fitness.cu",
                    "replaces": "src/repro/kernels/gen_dst/kernel.py:77",
                    "launches": None, "max_abs_err": fit_err, "ms": ms_k, "plain_ms": ms_p,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    t_sec = phase_seconds(3, t_sec)
    # --- 4. small input: kernels on the card = plain versions on the CPU -----
    rng = np.random.default_rng(0)
    Xs = np.column_stack([rng.integers(0, k, 800) for k in (3, 5, 17, 2, 40, 7)]).astype(float)
    ys = rng.integers(0, 2, 800).astype(float)
    small_cfg = GenDSTConfig(psi=6, phi=16)
    res = {}
    for d in ("cuda", "cpu"):
        cs = factorize(Xs, ys, device=d)
        draws = TorchDraws(make_generator(7), d)       # the same CPU draws for both
        r = gen_dst(None, cs, 28, 3, small_cfg, device=d, draws=draws)
        res[d] = (r.row_idx.cpu(), r.col_mask.cpu(), float(r.fitness))
    if not (torch.equal(res["cuda"][0], res["cpu"][0])
            and torch.equal(res["cuda"][1], res["cpu"][1])
            and abs(res["cuda"][2] - res["cpu"][2]) <= FIT_TOL):
        fail(f"small Gen-DST: card and CPU disagree (fitness {res['cuda'][2]} vs "
             f"{res['cpu'][2]})")
    print(f"small Gen-DST: card = CPU (fitness {res['cuda'][2]:.7f})")

    # the generation loop stays on the device: a full-size search under
    # sync-debug "error" raises at the first operation that waits for the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen_dst(make_generator(3, dev), coded, device=dev)
    except RuntimeError as exc:
        fail(f"Gen-DST synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("full-size Gen-DST: no host sync inside the search")

    t_sec = phase_seconds(4, t_sec)
    # --- 5. the main path ------------------------------------------------------
    print(f"  clocks before the main path: {smi_state()}")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    result = execute(plan("gen_dst"), X_tr, y_tr, X_test=X_te, y_test=y_te, seed=0,
                     device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    print(f"  clocks after the main path: {smi_state()}")
    print(f"main path: execute(plan('gen_dst')) on D1 ({len(y_tr)} train rows): "
          f"{wall:.3f} s")
    for k, v in result.times.items():
        print(f"  {k} {v:.4f}")
    print(f"  launches {launches}")
    if not result.intermediate.backend == result.final.backend == "batched":
        fail(f"the main path ran the {result.intermediate.backend}/{result.final.backend} "
             f"AutoML backends, not the batched default")
    print(f"  intermediate {result.intermediate.spec.family} val_acc "
          f"{result.intermediate.val_acc:.4f}; final {result.final.spec} "
          f"val_acc {result.final.val_acc:.4f} test_acc {result.final.test_acc}")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        if entry["launches"] <= 0:
            fail(f"{entry['name']} was not launched on the main path")
    f_plain = plain_fitness(torch, coded, result.row_idx, result.col_idx)
    print(f"  dst_fitness {result.dst_fitness:.8f}, plain recomputation {f_plain:.8f}")
    if not (math.isfinite(result.dst_fitness)
            and abs(result.dst_fitness - f_plain) <= FIT_TOL):
        fail("DST fitness does not match its plain recomputation")
    acc = result.final.test_acc
    if not (acc is not None and math.isfinite(acc) and 0.0 <= acc <= 1.0):
        fail(f"test accuracy {acc} is not a finite number in [0, 1]")
    n_cols = len({int(c) for c in result.col_idx} | {int(coded.target_col)})
    if len(result.row_idx) != n or n_cols != m:
        fail(f"subset shape {len(result.row_idx)} x {n_cols}, expected {n} x {m}")

    t_sec = phase_seconds(5, t_sec)
    # --- 6. where the main path's time goes (a second run, profiled) ---------
    print("profiled main path (Gen-DST phase alone, then the whole execute):")
    events, _ = profile_share(torch, lambda: gen_dst(make_generator(0, dev), coded, device=dev))
    # device operations (kernels and copies) per generation, the initial
    # population counted as one; B1's and B2's share of the device time
    ops = sum(e.count for e in events)
    total_us = sum(dev_us(e) for e in events)
    ours_us = sum(dev_us(e) for e in events
                  if "masked_histogram_kernel" in e.key or "fused_delta_fitness_kernel" in e.key)
    print(f"  Gen-DST: {ops} device operations in {cfg.psi} generations and the initial "
          f"population, {ops / (cfg.psi + 1):.1f} per generation; B1 + B2 {ours_us / 1e3:.4f} "
          f"ms of {total_us / 1e3:.4f} ms device time "
          f"({ours_us / total_us if total_us else float('nan'):.4f})")
    profile_share(torch, lambda: execute(plan("gen_dst"), X_tr, y_tr, seed=0, device="cuda"))

    t_sec = phase_seconds(6, t_sec)
    # --- 7-9. the LM serving slice: B3, B4 and zamba2-2.7b at full width -----
    kernels.append(phase7_flash_attention(torch, dev))
    t_sec = phase_seconds(7, t_sec)
    kernels.append(phase8_ssd_scan(torch, dev))
    t_sec = phase_seconds(8, t_sec)
    launches = phase9_serving(torch, dev, K)
    t_sec = phase_seconds(9, t_sec)
    for entry in kernels:
        if entry["launches"] is None:
            entry["launches"] = launches[entry["name"]]

    # --- 10. the AutoML backends on the card -----------------------------------
    phase10_automl_backends(torch, dev, X_tr, y_tr, X_te, y_te, result)
    phase_seconds(10, t_sec)

    # --- 11. the other subset strategies and batched Gen-DST ---------------------
    phase11_strategies(torch, dev, K, coded, X_tr, y_tr, X_te, y_te)

    # --- 12. the service: five jobs of four tenants through one server ----------
    tables = service_tables(X_tr, y_tr, X_te, y_te)
    phase12_service(torch, dev, K, tables, plan("gen_dst"))

    # --- 13. the multi-process tier: workers, a kill, HTTP, a resume ------------
    phase13_transport(torch, dev, K, [tables[0], tables[1], tables[4]], plan("gen_dst"))

    # --- 14. the moe, vlm and encdec families ------------------------------------
    per_prefill = phase14_families(torch, dev, K)
    fa = next(e for e in kernels if e["name"] == "flash_attention")
    fa["launches_per_prefill"] = {"zamba2-2.7b": fa["launches"], **per_prefill}

    # --- 15. training: zamba2-2.7b at full width, checkpointed and resumed ---------
    training = phase15_training(torch, dev, K)
    for entry in kernels:
        entry["launches_training_run"] = training["launches"][entry["name"]]
        entry["launches_per_train_step"] = training["per_step"].get(entry["name"], 0)
        entry["launches_per_train_4k_step"] = training["per_step_4k"].get(entry["name"], 0)
        if entry["launches_training_run"] <= 0:
            fail(f"{entry['name']} was not launched by the training run")

    # --- 16. the mesh layer on one card --------------------------------------------
    phase16_mesh(torch, dev)

    # --- 17. the dry-run held on the card ---------------------------------------------
    dry = phase17_dryrun(torch, dev, K)
    for entry in kernels:
        entry["launches_phase17"] = {cell: counts.get(entry["name"], 0)
                                     for cell, counts in dry.items()}

    # --- 18. the entry points of examples/ through their port modules --------------
    examples = phase18_examples(torch, dev, K)
    for entry in kernels:
        entry["launches_phase18"] = {run: counts[entry["name"]]
                                     for run, counts in examples.items()}
        if not any(entry["launches_phase18"].values()):
            fail(f"{entry['name']} was not launched by the entry points of phase 18")

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the port's four CUDA kernels on one card at the kernel table's shapes
(``PERF.md`` §6) and print one JSON row per kernel and shape:

    python3 chip_kernels.py

Shapes: B1 (``masked_histogram``, gathered entry) at D1's (P 100, n 322,
M 23, B 256), on D1's training table factorized on the card; B2
(``fused_delta_fitness``) at (100, 23, 256) with the main path's zero delta;
B3 (``flash_attention``) at the zamba2-2.7b, qwen2-moe-a2.7b,
phi-3-vision-4.2b and kimi-k2 prefills (batch 4, 1024 positions, bf16,
causal); B4 (``ssd_scan``) at zamba2-2.7b's prefill (batch 4, 1024
positions, 80 heads, P = N = 64, bf16, chunks of 128).

Each row: ``kernel_ms`` (CUDA events around 5 x N back-to-back wrapper
calls, the median: the larger of host and device time), ``device_ms`` (the
kernel's own time per launch, ``torch.profiler``), ``host_us`` (the host
clock per call before the device is waited for), ``plain_ms`` (the plain
PyTorch version in ``kernels/*/ref.py``), ``library_ms`` (one PyTorch call
computing the same, where there is one), ``bound_ms`` and ``bound_by``: the
least time, bytes over 3.35 TB/s or operations over the peak rate of their
type, whichever is larger (H100 SXM data sheet).  B1's and B2's bytes are
``perfbench/pbcore/costs.py``'s.  Every row names the card and its power
limit.  Correctness is the card test files' (``tests/test_torch_*_card.py``).
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.pbcore.costs import HBM_BYTES_PER_S, b1_bytes, b2_bytes  # noqa: E402

BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate (no tensor cores)
FP64_OPS_PER_S = 34e12         # H100 SXM float64 rate (no tensor cores)
# prefill shapes B3 is timed at: (label, B, S, H, Kh, hd)
FA_SHAPES = (("zamba2-2.7b", 4, 1024, 32, 32, 80),
             ("qwen2-moe-a2.7b", 4, 1024, 16, 16, 128),
             ("phi-3-vision-4.2b", 4, 1024, 32, 32, 96),
             ("kimi-k2-1t-a32b", 4, 1024, 64, 8, 112))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters=100, repeats=5, warmup=10) -> float:
    """Median over ``repeats`` of CUDA events around ``iters`` calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[repeats // 2]


def host_us(torch, fn, iters=100, repeats=5) -> float:
    """Host microseconds per call, read before the device is waited for."""
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


def device_ms(torch, fn, names, calls=50):
    """Device milliseconds per call of the CUDA kernels whose names contain
    one of ``names`` (summed over them), from torch.profiler; None if none
    ran.  Name the kernels, not the op: an op's entry sums its kernels'
    time again."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if any(n in e.key for n in names))
    return us / calls / 1e3 if us else None


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row(torch, name, shape, fn, kernel_names, plain, library, n_bytes, n_ops, ops_per_s,
        iters=100, plain_iters=10, smi=""):
    b_ms, b_by = bound(n_bytes, n_ops, ops_per_s)
    return {"kernel": name, "shape": shape,
            "kernel_ms": event_ms(torch, fn, iters=iters),
            "device_ms": device_ms(torch, fn, kernel_names, calls=min(iters, 50)),
            "host_us": host_us(torch, fn, iters=iters),
            "plain_ms": event_ms(torch, plain, iters=plain_iters, repeats=3, warmup=1),
            "library_ms": (None if library is None else
                           event_ms(torch, library, iters=iters)),
            "bound_ms": b_ms, "bound_by": b_by, "card": smi}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_kernels.py: no CUDA card")
    import torch.nn.functional as F
    from repro_torch.core.gen_dst import GenDSTConfig
    from repro_torch.core.measures import factorize, full_column_entropy
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    from repro_torch.kernels import _build
    from repro_torch.kernels.entropy.kernel import population_histogram_rows_cuda
    from repro_torch.kernels.entropy.ref import masked_histogram_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
    from repro_torch.kernels.gen_dst.ref import fused_delta_fitness_ref
    from repro_torch.kernels.ssd_scan.kernel import chunk_for, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_model_ref

    _build.library()
    smi, dev = card(), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    # B1 and B2 on D1's table, the main path's candidate shape
    X_tr, y_tr, _, _ = train_test_split(*make_dataset(PAPER_DATASETS["D1"], scale=1.0))
    coded = factorize(X_tr, y_tr, device=dev)
    N, M = coded.codes.shape
    B, P, n, m = coded.max_bins, GenDSTConfig().phi, round(N ** 0.5), round(0.25 * M)
    rows = torch.randint(0, N, (P, n), generator=gen, device=dev, dtype=torch.int32)
    flat = coded.codes[rows.long()].permute(1, 0, 2).reshape(n, P * M).contiguous()
    ones = torch.ones(n, device=dev)

    def b1_plain():
        f = coded.codes[rows.long()].permute(1, 0, 2).reshape(n, P * M)
        return masked_histogram_ref(f, ones, B)
    flat_idx = (flat.long() + (torch.arange(P * M, device=dev) * B)[None, :]).reshape(-1)
    w_rep = ones[:, None].expand(n, P * M).reshape(-1).contiguous()
    # one float32 add per gathered cell
    out = [row(torch, "masked_histogram", [P, n, M, B],
               lambda: population_histogram_rows_cuda(coded.codes, rows, B),
               ["masked_histogram_kernel"], b1_plain,
               lambda: torch.bincount(flat_idx, weights=w_rep, minlength=P * M * B),
               b1_bytes(P, n, M, B), n * P * M, FP32_OPS_PER_S, smi=smi)]

    counts = masked_histogram_ref(flat, ones, B).reshape(P, M, B).contiguous()
    old = coded.codes[rows[:, 0].long()].contiguous()
    new = coded.codes[rows[:, 1].long()].contiguous()
    cm = torch.zeros((P, M), dtype=torch.bool, device=dev)
    cm[:, :m] = True
    zero = torch.zeros(P, device=dev)
    f_ref = full_column_entropy(coded.codes, B).mean().reshape(1)
    # per bin a float64 add to the column total; per nonzero bin a divide, a
    # log2, a multiply and an add
    ops = P * M * B + 4 * int((counts > 0).sum())
    out.append(row(torch, "fused_delta_fitness", [P, M, B],
                   lambda: fused_delta_fitness_cuda(counts, old, new, zero, cm, f_ref),
                   ["fused_delta_fitness_kernel"],
                   lambda: fused_delta_fitness_ref(counts, old, new, zero, cm, f_ref), None,
                   b2_bytes(P, M, B), ops, FP64_OPS_PER_S, smi=smi))

    # B3 at the served models' prefills, beside scaled_dot_product_attention
    for label, Bq, S, H, Kh, hd in FA_SHAPES:
        q, k, v = (torch.randn((Bq, S, h, hd), generator=gen, device=dev).to(torch.bfloat16)
                   for h in (H, Kh, Kh))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # q, k, v read once and o written once; 2 hd multiply-adds per kept
        # (query, key) pair in QK^T and again in PV, S(S+1)/2 pairs a head
        out.append(row(torch, "flash_attention", [label, Bq, S, H, Kh, hd],
                       lambda: flash_attention_cuda(q, k, v, causal=True),
                       ["flash_attention_wgmma_kernel"],
                       lambda: attention_ref(q, k, v, causal=True),
                       lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=H != Kh),
                       2 * (q.numel() + k.numel()) * q.element_size(),
                       4 * Bq * H * hd * S * (S + 1) // 2, BF16_OPS_PER_S, iters=20,
                       plain_iters=3, smi=smi))

    # B4 at zamba2-2.7b's prefill: x, B and C views of one conv output
    Bs, S, H, Ph, G, Ns, Q = 4, 1024, 80, 64, 1, 64, 128
    xbc = torch.randn((Bs, S, H * Ph + 2 * G * Ns), generator=gen, device=dev)
    xbc[..., H * Ph:] *= (16 / Ns) ** 0.25
    xbc = xbc.to(torch.bfloat16)
    x = xbc[..., :H * Ph].reshape(Bs, S, H, Ph)
    bm = xbc[..., H * Ph:H * Ph + G * Ns].reshape(Bs, S, G, Ns)
    cmat = xbc[..., H * Ph + G * Ns:].reshape(Bs, S, G, Ns)
    dt = 0.01 + 0.19 * torch.rand((Bs, S, H), generator=gen, device=dev)
    a = -(0.5 + 3.5 * torch.rand((H,), generator=gen, device=dev))
    # inputs read once, y and the final state written once; per chunk the
    # (Qk x Qk) products C B^T and PV and the two (Qk, P, N) state products
    Qk = chunk_for(Q, S, Ph, Ns, bf16=True)
    es = x.element_size()
    n_bytes = (2 * Bs * S * H * Ph * es + Bs * S * H * 4 + H * 4 + 2 * Bs * S * G * Ns * es
               + Bs * H * Ph * Ns * 4)
    ops = Bs * H * math.ceil(S / Qk) * 2 * (Qk * Qk * Ns + Qk * Qk * Ph + 2 * Qk * Ph * Ns)
    out.append(row(torch, "ssd_scan", [Bs, S, H, Ph, G, Ns, Q],
                   lambda: ssd_scan_cuda(x, dt, a, bm, cmat, block_q=Q),
                   ["ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel"],
                   lambda: ssd_scan_model_ref(x, dt, a, bm, cmat), None, n_bytes, ops,
                   BF16_OPS_PER_S, iters=20, plain_iters=2, smi=smi))
    for r in out:
        print(json.dumps(r))


if __name__ == "__main__":
    main()

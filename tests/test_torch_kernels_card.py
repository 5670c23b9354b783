"""The port's four CUDA kernels on a card against their plain versions.

B1 (``masked_histogram``: both entries), B2 (``fused_delta_fitness``), B3
(``flash_attention``) and B4 (``ssd_scan``) at the CPU parity tests' shapes,
at the main path's (D1's table, zamba2's prefill) and at the LM families'
(hd 96 and 112, whisper's 1500 frames), and at the edges of each kernel's
tiling.  Every case is marked ``cuda`` and skips without a card.  No JAX, so
it runs on the card machine:

    python -m pytest -q -m cuda tests/test_torch_kernels_card.py

Tolerances: B1 exact with 0/1 weights, rtol = atol = 1e-5 with fractional
ones (float32 sums in another order); B2 counts bit-equal, fitness within
1e-6 (the entropy summed in float64); B3 max-abs 2e-5 (float32) and 2e-2
(bfloat16), and ||o - o_plain|| / ||o_plain|| within 1e-2 (scaled to the
output, which the absolute limit is not where a non-causal row averages
~S/e keys); B4 y max-abs 1e-3 (float32) and 5e-2 (bfloat16) of the plain
version run in float32 on the same values, the final state within 1e-3 of
its largest magnitude.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _card import requires_cuda, skip_without_cuda, t
from _port_cases import (FA_CASES, FA_TOL, FUSED_CASES, GATHERED_SHAPES, PADDING_EDGE_SHAPES,
                         SSD_TOL, fa_inputs, fused_args, fused_case, fused_edge_case,
                         gathered_case, hist_case, run_every_op, ssd_model_inputs, strided)
from repro_torch import kernels
from repro_torch.kernels.entropy.ops import masked_histogram, population_histogram_rows
from repro_torch.kernels.entropy.ref import masked_histogram_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
from repro_torch.kernels.gen_dst.ops import fused_delta_fitness
from repro_torch.kernels.gen_dst.ref import fused_delta_fitness_ref
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_model_ref

pytestmark = requires_cuda

FA_REL_TOL = 1e-2
SSD_STATE_RTOL = 1e-3


@pytest.fixture(scope="module")
def d1():
    """D1's training table at full scale, factorized on the card, with the
    main path's candidate shape: P = phi, n = sqrt(N), m = 0.25 M."""
    skip_without_cuda()
    from repro_torch.core.gen_dst import GenDSTConfig
    from repro_torch.core.measures import factorize
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    X_tr, y_tr, _, _ = train_test_split(*make_dataset(PAPER_DATASETS["D1"], scale=1.0))
    coded = factorize(X_tr, y_tr, device="cuda")
    N, M = coded.codes.shape
    return coded, GenDSTConfig().phi, round(N ** 0.5), round(0.25 * M)


def _gathered_plain(codes, rows, bins):
    """The gathered entry's plain version: the gather, the fold (P, n, M) ->
    (n, P*M) and the plain histogram."""
    P, n = rows.shape
    flat = codes[rows.long()].permute(1, 0, 2).reshape(n, P * codes.shape[1])
    return masked_histogram_ref(flat, torch.ones(n, device=codes.device), bins).reshape(
        P, codes.shape[1], bins)


# ---------------------------------------------------------------------------
# B1, masked histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,M,B,code_max", PADDING_EDGE_SHAPES + [(322, 2300, 256, None)])
def test_cuda_histogram_matches_plain(N, M, B, code_max):
    skip_without_cuda()
    codes, w_frac, w_01 = hist_case(N, M, B, code_max, seed=N + M)
    c = t(codes, device="cuda")
    for w in (w_01, np.ones(N, np.float32)):
        wt = t(w, device="cuda")
        assert torch.equal(masked_histogram(c, wt, B), masked_histogram_ref(c, wt, B))
    wt = t(w_frac, device="cuda")
    torch.testing.assert_close(masked_histogram(c, wt, B), masked_histogram_ref(c, wt, B),
                               rtol=1e-5, atol=1e-5)


def test_gathered_histogram_takes_int64_and_strided_inputs():
    """The op takes on the card what its plain version takes on the CPU:
    int64 rows, and codes and rows that are strided views."""
    skip_without_cuda()
    codes, rows = gathered_case(6, 10, 25, 4, 8, None, seed=8)
    c, r = t(codes, device="cuda"), t(rows, device="cuda")
    want = population_histogram_rows(c, r, 8)
    for c_in, r_in in ((c, r.long()), (strided(c), r), (c, strided(r)),
                       (strided(c), strided(r.long()))):
        assert torch.equal(population_histogram_rows(c_in, r_in, 8), want)


# run in a process of its own: the kernel's trap leaves that process's CUDA
# context unusable
_BAD_ROW_SCRIPT = """
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
    print("context unusable")
"""


def test_cuda_gathered_histogram_traps_on_a_row_outside_the_table():
    """The documented behaviour of a bad index on the card: an error at the
    next synchronise, and a CUDA context that stays unusable."""
    skip_without_cuda()
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", _BAD_ROW_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600).stdout.split()
    assert "raised" in out and "unusable" in out


@pytest.mark.parametrize("P,n,N,M,B,code_max",
                         GATHERED_SHAPES + [(100, 322, 2000, 23, 256, None),
                                            (37, 322, 2000, 23, 256, 40),
                                            (5, 50, 400, 6, 5000, None),
                                            (2, 10, 20, 4, 20000, 300)])
def test_cuda_gathered_histogram_matches_plain(P, n, N, M, B, code_max):
    """Ragged P, M and B no multiple of 4, padding bins, one row, one column,
    and B large enough to shrink the tile and, at 20000, to take the
    shared-memory opt-in with one column per block."""
    skip_without_cuda()
    codes, rows = gathered_case(P, n, N, M, B, code_max, seed=P + n)
    c, r = t(codes, device="cuda"), t(rows, device="cuda")
    h = population_histogram_rows(c, r, B)
    assert torch.equal(h, _gathered_plain(c, r, B))
    if code_max is not None:
        assert not h[..., code_max:].any(), "bins no code reaches must stay empty"


@pytest.mark.parametrize("P", [100, 37])
def test_cuda_gathered_histogram_matches_plain_on_d1(d1, P):
    """The main path's call: P candidates of n rows gathered from D1's
    103,904-row table (P = 100 at the paper's defaults), exact; and the
    unindexed entry on the same fold (n, P*M)."""
    skip_without_cuda()
    coded, _, n, _ = d1
    N, M = coded.codes.shape
    B = coded.max_bins
    g = torch.Generator(device="cuda").manual_seed(1234 + P)
    rows = torch.randint(0, N, (P, n), generator=g, device="cuda", dtype=torch.int32)
    plain = _gathered_plain(coded.codes, rows, B)
    assert torch.equal(population_histogram_rows(coded.codes, rows, B), plain)
    flat = coded.codes[rows.long()].permute(1, 0, 2).reshape(n, P * M).contiguous()
    ones = torch.ones(n, device="cuda")
    assert torch.equal(masked_histogram(flat, ones, B).reshape(P, M, B), plain)


# ---------------------------------------------------------------------------
# B2, fused delta + fitness
# ---------------------------------------------------------------------------


def _aligned_copy(x, like):
    """A copy of ``x`` at the address of ``like`` modulo 16 bytes."""
    off = (like.data_ptr() % 16) // like.element_size()
    out = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[off:].view(x.shape)
    return out.copy_(x)


def _assert_fused_matches_plain(counts, old, new, applied, cm, f_ref):
    """The kernel on a copy of ``counts`` at its address modulo 16 bytes
    against the plain version on another copy: counts bit-equal, fitness
    within 1e-6."""
    c_r, f_r = fused_delta_fitness_ref(counts.clone(), old, new, applied, cm, f_ref)
    c_k, f_k = fused_delta_fitness_cuda(_aligned_copy(counts, counts), old, new, applied, cm,
                                        f_ref)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_r)
    assert (f_k - f_r).abs().max().item() <= 1e-6


@pytest.mark.parametrize("P,M,B,code_max", FUSED_CASES + [(100, 23, 256, None)])
def test_cuda_fused_matches_plain(P, M, B, code_max):
    skip_without_cuda()
    args = fused_case((P,), M, B, seed=P + M, code_max=code_max)
    c_k, f_k = fused_delta_fitness(*fused_args(args, "cuda"))
    c_r, f_r = fused_delta_fitness_ref(*fused_args(args, "cuda"))
    assert torch.equal(c_k, c_r)
    assert (f_k - f_r).abs().max().item() <= 1e-6


def test_fused_op_takes_strided_inputs():
    """Codes, a bool delta and a column mask given as strided views: the same
    counts and fitness on the card as from contiguous inputs."""
    skip_without_cuda()
    counts, old, new, applied, cm, f_ref = fused_args(fused_case((7,), 5, 16, seed=3), "cuda")
    c_1, f_1 = fused_delta_fitness(counts.clone(), old, new, applied, cm, f_ref)
    strided_ = [strided(x) for x in (old, new, applied, cm)]
    assert not any(x.is_contiguous() for x in strided_)
    c_2, f_2 = fused_delta_fitness(counts.clone(), *strided_, f_ref)
    assert torch.equal(c_1, c_2) and torch.equal(f_1, f_2)


# (label, P, M, B, fractional, view): fractional counts and delta; slabs of
# 100 and 600 columns, more than a CTA's 32 warps; slabs of a size, or at an
# address, no multiple of 16 bytes (scalar loads); one column; B no multiple
# of 4
CUDA_EDGES = [
    ("fractional", 50, 23, 256, True, None),
    ("slab over 48 KB", 6, 100, 256, False, None),
    ("slab over 227 KB", 3, 600, 256, False, None),
    ("counts[1:] view", 9, 5, 13, True, "slab"),
    ("one float off alignment", 8, 23, 256, False, "float"),
    ("one column", 5, 1, 8, False, None),
    ("B no multiple of 4", 7, 9, 30, False, None),
]


@pytest.mark.parametrize("label,P,M,B,fractional,view", CUDA_EDGES,
                         ids=[e[0] for e in CUDA_EDGES])
def test_cuda_fused_edges_match_plain(label, P, M, B, fractional, view):
    skip_without_cuda()
    counts, old, new, applied, cm, f_ref = fused_args(
        fused_edge_case(P + (view == "slab"), M, B, seed=P * B, fractional=fractional), "cuda")
    if view == "slab":
        counts, old, new, applied, cm = counts[1:], old[1:], new[1:], applied[1:], cm[1:]
    elif view == "float":
        buf = torch.empty(counts.numel() + 1, device="cuda")
        counts = buf[1:].view(counts.shape).copy_(counts)
    _assert_fused_matches_plain(counts, old, new, applied, cm, f_ref.reshape(1))


def test_fused_f_ref_per_candidate():
    """One F(D) per candidate, in the candidates' leading shape (as several
    datasets' searches pass it): the kernel against the plain version with
    the candidates flattened.  Counts bit-equal, fitness within 1e-6."""
    skip_without_cuda()
    counts, old, new, applied, cm, _ = fused_case((3, 4), 5, 16, seed=12)
    f_ref = (np.random.default_rng(12).random((3, 4)) * 3.0).astype(np.float32)
    args = fused_args((counts, old, new, applied, cm, f_ref), "cuda")
    c_t, f_t = fused_delta_fitness(*args)
    assert f_t.shape == (3, 4)
    c_r, f_r = fused_delta_fitness_ref(*(a.reshape((12,) + a.shape[2:]) for a in
                                         fused_args((counts, old, new, applied, cm, f_ref),
                                                    "cuda")))
    assert torch.equal(c_t.reshape(c_r.shape), c_r)
    assert (f_t.reshape(-1) - f_r).abs().max().item() <= 1e-6
    with pytest.raises(ValueError, match="f_ref"):
        fused_delta_fitness_cuda(args[0], args[1], args[2], args[3].float(), args[4],
                                 args[5][:2].contiguous())


@pytest.mark.parametrize("P,M,B", [(100, 23, 256), (6, 100, 256), (3, 600, 256)])
def test_cuda_fused_f_ref_per_candidate_at_width(P, M, B):
    """One F(D) per candidate (stride 1, as ``gen_dst_batch`` passes it) at
    D1's shape and with more columns than a CTA's 32 warps."""
    skip_without_cuda()
    counts, old, new, applied, cm, _ = fused_args(
        fused_edge_case(P, M, B, seed=P * M, fractional=False), "cuda")
    f_each = torch.rand(P, generator=torch.Generator(device="cuda").manual_seed(P),
                        device="cuda") * 3.0
    _assert_fused_matches_plain(counts, old, new, applied, cm, f_each)


@pytest.mark.parametrize("P", [100, 37, 1])
@pytest.mark.parametrize("applied_kind", ["mutation", "zero", "per candidate"])
def test_cuda_fused_matches_plain_on_d1(d1, P, applied_kind):
    """The main path's step on D1's real counts: P candidates' histograms,
    each evicting a member row for a random row of the table, a delta on
    about half the candidates or on none (the main path's zero delta), and
    with one F(D) per candidate."""
    skip_without_cuda()
    coded, _, n, m = d1
    N, M = coded.codes.shape
    B = coded.max_bins
    rng = np.random.default_rng(P)
    rows = torch.as_tensor(rng.integers(0, N, (P, n)), dtype=torch.int32, device="cuda")
    counts = _gathered_plain(coded.codes, rows, B).contiguous()
    old = coded.codes[rows[:, 0].long()].contiguous()
    new = coded.codes[torch.as_tensor(rng.integers(0, N, P), device="cuda")].contiguous()
    cm = torch.as_tensor(rng.random((P, M)) < m / M, device="cuda")
    cm[:, coded.target_col] = True
    from repro_torch.core.measures import full_column_entropy
    f_ref = full_column_entropy(coded.codes, B).mean().reshape(1)
    if applied_kind == "zero":
        applied = torch.zeros(P, device="cuda")
    else:
        applied = torch.as_tensor(rng.random(P) < 0.5, device="cuda").float()
    if applied_kind == "per candidate":
        f_ref = torch.as_tensor(rng.random(P) * 3.0, dtype=torch.float32, device="cuda")
    _assert_fused_matches_plain(counts, old, new, applied, cm, f_ref)


# ---------------------------------------------------------------------------
# B3, flash attention
# ---------------------------------------------------------------------------


def _assert_attention_matches_plain(q, k, v, causal, dtype):
    o_k = flash_attention_cuda(q, k, v, causal=causal)
    o_r = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (o_k.float() - o_r.float()).abs().max().item() <= FA_TOL[dtype]
    assert _rel_err(o_k, o_r) <= FA_REL_TOL
    return o_r


def _rel_err(out, ref) -> float:
    """||out - ref|| / ||ref||, in float32."""
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd,causal,dtype", FA_CASES + [
    (2, 300, 300, 32, 32, 80, True, "bfloat16"),
    (1, 200, 333, 8, 1, 256, True, "float32"),
    (2, 128, 128, 32, 8, 128, False, "bfloat16"),
    (3, 200, 200, 32, 32, 80, True, "bfloat16"),    # hd 80, Sq no multiple of 128
    (2, 200, 333, 8, 2, 80, False, "bfloat16"),     # Skv > Sq, non-causal
    (2, 333, 333, 8, 1, 256, True, "bfloat16"),     # MQA, hd 256, ragged
    (2, 70, 70, 4, 2, 20, True, "bfloat16"),        # hd 20: the wrapper pads it
])
def test_flash_attention_cuda_matches_plain(B, Sq, Skv, H, Kh, hd, causal, dtype):
    skip_without_cuda()
    q, k, v = (torch.as_tensor(a, device="cuda").to(getattr(torch, dtype))
               for a in fa_inputs(B, Sq, Skv, H, Kh, hd, seed=1))
    _assert_attention_matches_plain(q, k, v, causal, dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd,causal,dtype", [
    (4, 1024, 1024, 32, 32, 80, True, "bfloat16"),    # zamba2 prefill
    (2, 512, 512, 32, 8, 128, True, "bfloat16"),      # GQA 32/8, hd 128 (qwen3, llama3)
    (2, 256, 256, 8, 1, 256, True, "bfloat16"),       # MQA 8/1, hd 256 (gemma)
    (2, 512, 512, 32, 8, 64, True, "bfloat16"),       # hd 64 (granite)
    (2, 256, 256, 32, 32, 80, True, "float32"),       # float32 at zamba2's heads
    (2, 256, 192, 8, 2, 128, False, "bfloat16"),      # non-causal
    (2, 130, 130, 4, 2, 16, False, "float32"),        # smoke widths
    (2, 128, 128, 4, 1, 32, True, "float32"),
    (4, 1024, 1024, 16, 16, 128, True, "bfloat16"),   # qwen2-moe prefill
    (4, 1024, 1024, 32, 32, 96, True, "bfloat16"),    # phi-3-vision prefill: hd 96
    (4, 1024, 1024, 64, 8, 112, True, "bfloat16"),    # kimi-k2 prefill: GQA 64/8, hd 112
    (4, 1500, 1500, 8, 8, 64, False, "bfloat16"),     # whisper encoder, 1500 frames
    (4, 4, 1500, 8, 8, 64, False, "bfloat16"),        # whisper cross-attention at prefill
    (2, 300, 300, 32, 32, 96, True, "float32"),       # float32 at hd 96 (the invariant's)
    (2, 4, 1500, 8, 8, 64, False, "float32"),         # float32 cross-attention, Sq 4
])
def test_flash_attention_cuda_matches_plain_at_model_widths(B, Sq, Skv, H, Kh, hd, causal,
                                                            dtype):
    """The served models' prefill shapes.  The relative check must see the
    faults these shapes invite: the 128-key tile's partial remainder dropped
    (whisper's 1500 keys), the softmax scale taken from the 128-column tile
    that hd 96 and 112 are padded to."""
    skip_without_cuda()
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv + H + hd)
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device="cuda").to(getattr(torch, dtype))
               for S, h in ((Sq, H), (Skv, Kh), (Skv, Kh)))
    o_r = _assert_attention_matches_plain(q, k, v, causal, dtype)
    planted = []
    if not causal and Skv >= 1024 and Skv % 128:
        cut = Skv % 128
        planted.append(attention_ref(q, k[:, :-cut], v[:, :-cut], causal=False))
    if hd in (96, 112):
        planted.append(attention_ref(q.float() * (hd / 128) ** 0.5, k, v, causal=causal))
    for o_f in planted:
        assert _rel_err(o_f, o_r) > FA_REL_TOL


# ---------------------------------------------------------------------------
# B4, SSD scan
# ---------------------------------------------------------------------------


def _assert_scan_matches_plain(x, dt, a, bm, cm, Q, dtype):
    """The kernel against the plain version in float32 on the same values:
    the kernel rounds its float32 result once, and a second rounding of the
    plain version's could flip a last bit against it."""
    y_k, h_k = ssd_scan_cuda(x, dt, a, bm, cm, block_q=Q)
    y_r, h_r = ssd_scan_model_ref(x.float(), dt, a, bm.float(), cm.float())
    torch.cuda.synchronize()
    assert (y_k.float() - y_r.float()).abs().max().item() <= SSD_TOL[dtype]
    assert ((h_k - h_r).abs().max() / h_r.abs().max()).item() <= SSD_STATE_RTOL


@pytest.mark.parametrize("B,S,H,P,G,N,Q,dtype", [
    (2, 64, 4, 8, 1, 16, 8, "float32"),
    (2, 300, 16, 32, 4, 32, 64, "bfloat16"),
    (2, 256, 80, 64, 1, 64, 128, "bfloat16"),      # zamba2's widths, chunk 128
    (2, 50, 8, 64, 1, 64, 128, "bfloat16"),        # S < chunk
    (2, 256, 24, 64, 1, 128, 256, "bfloat16"),     # N 128: chunks of 64
    (2, 64, 8, 16, 2, 16, 8, "bfloat16"),          # smoke widths, G = 2
])
def test_ssd_scan_cuda_matches_plain(B, S, H, P, G, N, Q, dtype):
    skip_without_cuda()
    x, dt, a, bm, cm = (torch.as_tensor(v, device="cuda")
                        for v in ssd_model_inputs(B, S, H, P, G, N, seed=5))
    td = getattr(torch, dtype)
    _assert_scan_matches_plain(x.to(td), dt, a, bm.to(td), cm.to(td), Q, dtype)


@pytest.mark.parametrize("B,S,H,P,G,N,Q,dtype", [
    (4, 1024, 80, 64, 1, 64, 128, "bfloat16"),     # zamba2 prefill
    (4, 1024, 80, 64, 1, 64, 128, "float32"),      # float32 at zamba2's shape
    (2, 300, 16, 32, 4, 32, 64, "float32"),        # G = 4, partial last chunk, float32
    (2, 64, 8, 16, 2, 16, 8, "float32"),           # small Q (smoke chunk), G = 2
    (1, 16, 4, 8, 1, 8, 4, "float32"),             # serving-test widths
    (2, 512, 24, 64, 1, 128, 256, "float32"),      # mamba2-130m: N 128
    (2, 512, 24, 64, 1, 128, 256, "bfloat16"),     # N 128: chunks of 64 fit
    (2, 50, 80, 64, 1, 64, 128, "bfloat16"),       # S < chunk at zamba2's heads
])
def test_ssd_scan_cuda_matches_plain_at_model_widths(B, S, H, P, G, N, Q, dtype):
    """x, B and C as views into one (B, S, H*P + 2*G*N) tensor, as the model
    slices them from its conv output; B and C scaled so that C.B has the
    spread it has at N = 16 in the reference's tests."""
    skip_without_cuda()
    g = torch.Generator(device="cuda").manual_seed(B * S + H + N)
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=g, device="cuda")
    xbc[..., H * P:] *= (16 / N) ** 0.25
    xbc = xbc.to(getattr(torch, dtype))
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=g, device="cuda")
    a = -(0.5 + 3.5 * torch.rand((H,), generator=g, device="cuda"))
    _assert_scan_matches_plain(x, dt, a, bm, cm, Q, dtype)


# ---------------------------------------------------------------------------
# all four
# ---------------------------------------------------------------------------


def test_cuda_kernels_launch_and_count():
    skip_without_cuda()
    kernels.reset_launch_counts()
    run_every_op("cuda")
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"masked_histogram": 1, "fused_delta_fitness": 1,
                                       "flash_attention": 1, "ssd_scan": 1}

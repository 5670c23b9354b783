"""Inputs that the port's CPU parity tests (which import the JAX reference)
and its card tests (which must not) share: the four kernels' case tables and
their numpy input builders, and the LM inputs and serving loop.  Imports
nothing of JAX or of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from _card import np_, t

# ---------------------------------------------------------------------------
# B1, masked histogram (kernels/entropy)
# ---------------------------------------------------------------------------

# the reference's padding edges (tests/test_kernels.py): rows shorter than a
# tile, a ragged column tile, and bins beyond every code
PADDING_EDGE_SHAPES = [
    (5, 3, 8, None),
    (300, 13, 16, None),
    (200, 4, 64, 11),
    (7, 9, 32, 5),
]

# (P, n, N, M, B, code_max): ragged P, M and B no multiple of 4, padding bins,
# one row, one column
GATHERED_SHAPES = [
    (4, 9, 30, 3, 8, None),
    (7, 20, 50, 5, 30, 11),
    (13, 6, 10, 23, 7, None),
    (1, 1, 1, 1, 1, None),
    (3, 40, 64, 33, 13, 5),
]


def hist_case(N, M, B, code_max, seed):
    """Codes (N, M) below ``code_max`` (default B), fractional weights and 0/1
    weights."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B if code_max is None else code_max, (N, M)).astype(np.int32)
    return codes, rng.random(N).astype(np.float32), (rng.random(N) < 0.5).astype(np.float32)


def gathered_case(P, n, N, M, B, code_max, seed):
    """A code table (N, M) and the rows (P, n) of P candidates."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B if code_max is None else code_max, (N, M)).astype(np.int32)
    return codes, rng.integers(0, N, (P, n)).astype(np.int32)


def strided(x):
    """``x`` as a view that is not contiguous, holding the same values."""
    return torch.stack([x, x], dim=-1)[..., 0]


# ---------------------------------------------------------------------------
# B2, fused delta + fitness (kernels/gen_dst)
# ---------------------------------------------------------------------------

# the reference's cases (tests/test_gen_dst_fused.py): P below, above and at
# the Pallas tile, and padding bins
FUSED_CASES = [
    (3, 4, 8, None),
    (10, 5, 16, None),
    (16, 3, 32, 17),
    (8, 7, 8, None),
    (25, 2, 64, 40),
]


def fused_case(lead, M, B, seed, code_max=None):
    """Random inputs with leading shape ``lead``; ``code_max`` < B leaves
    padding bins."""
    rng = np.random.default_rng(seed)
    hi = B if code_max is None else code_max
    base = rng.integers(0, hi, lead + (12, M))
    counts = np.zeros(lead + (M, B), np.float32)
    for idx in np.ndindex(*lead):
        for j in range(M):
            np.add.at(counts[idx + (j,)], base[idx + (slice(None), j)], 1.0)
    old = base[..., 0, :].astype(np.int32)
    new = rng.integers(0, hi, lead + (M,)).astype(np.int32)
    applied = rng.random(lead) < 0.6
    col_mask = rng.random(lead + (M,)) < 0.5
    col_mask[..., 0] = True
    return counts, old, new, applied, col_mask, np.float32(rng.random() * 3.0)


def fused_edge_case(P, M, B, seed, fractional):
    """Counts and delta, integer-valued or fractional (with empty bins)."""
    rng = np.random.default_rng(seed)
    if fractional:
        counts = rng.random((P, M, B)) * 4 * (rng.random((P, M, B)) < 0.6)
        applied = rng.random(P)
    else:
        counts = rng.integers(0, 40, (P, M, B)) * (rng.random((P, M, B)) < 0.3)
        applied = rng.random(P) < 0.6
    old = rng.integers(0, B, (P, M)).astype(np.int32)
    new = rng.integers(0, B, (P, M)).astype(np.int32)
    col_mask = rng.random((P, M)) < 0.5
    col_mask[:, 0] = True
    return (counts.astype(np.float32), old, new, applied.astype(np.float32), col_mask,
            np.float32(rng.random() * 3.0))


def fused_args(args, device="cpu"):
    """A fused case's six numpy arrays as tensors on ``device``."""
    return tuple(t(a, device=device) for a in args)


# ---------------------------------------------------------------------------
# B3, flash attention (kernels/flash_attention)
# ---------------------------------------------------------------------------

# max-abs, as tests/test_kernels.py:145: float32 2e-5; bfloat16 2e-2 (one
# bf16 rounding of outputs of magnitude ~1)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, H, Kh, hd, causal, dtype): GQA, MQA, MHA; hd 16, 20, 32
FA_CASES = [
    (2, 64, 64, 4, 2, 16, True, "float32"),
    (1, 64, 64, 4, 1, 32, True, "float32"),
    (2, 64, 64, 4, 4, 20, True, "float32"),
    (2, 64, 64, 4, 2, 32, False, "float32"),
    (1, 64, 64, 8, 1, 20, False, "float32"),
    (2, 64, 64, 4, 2, 16, True, "bfloat16"),
    (1, 64, 64, 4, 1, 32, False, "bfloat16"),
]


def fa_inputs(B, Sq, Skv, H, Kh, hd, seed):
    """q (B, Sq, H, hd), k and v (B, Skv, Kh, hd), float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Kh, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Kh, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# B4, SSD scan (kernels/ssd_scan)
# ---------------------------------------------------------------------------

# max-abs, as tests/test_ssd_kernel.py:35: y 1e-3 in float32, 5e-2 in
# bfloat16; the final state 1e-3 of its largest magnitude
SSD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


def ssd_model_inputs(B, S, H, P, G, N, seed):
    """x (B, S, H, P), dt (B, S, H), a (H,), B and C (B, S, G, N), float32
    numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (H,)).astype(np.float32),
            rng.normal(0, 1, (B, S, G, N)).astype(np.float32),
            rng.normal(0, 1, (B, S, G, N)).astype(np.float32))


# ---------------------------------------------------------------------------
# the batched AutoML backend
# ---------------------------------------------------------------------------

AUTOML_SEED = 25          # 8 trials: all five families, MLP widths 128, 32, 128
AUTOML_CFG = dict(n_trials=8, rungs=(4, 8), seed=AUTOML_SEED)


def automl_table():
    """(X_train, y_train, X_test, y_test): 300 training rows of five
    features, three classes."""
    rng = np.random.default_rng(0)
    N, n_train = 360, 300
    y = rng.integers(0, 3, N)
    X = np.column_stack([
        y * 1.2 + rng.normal(0, 1.0, N),
        -y * 0.8 + rng.normal(0, 1.0, N),
        rng.normal(0, 1, N) * 3.0,
        rng.integers(0, 4, N),
        y * 0.3 + rng.normal(0, 2.0, N),
    ]).astype(np.float32)
    return X[:n_train], y[:n_train], X[n_train:], y[n_train:]


def fleet_tables():
    """A served fleet at a small size, each (X_train, y_train, X_test,
    y_test): a table A (D3 at scale 0.1), two more of its spec with other
    dataset seeds (their searches merge), A again (a cache hit), a table of
    another shape (D7); then a fifth of A's spec for a warm start."""
    import dataclasses

    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split

    def table(name, seed, scale):
        spec = dataclasses.replace(PAPER_DATASETS[name], seed=seed)
        return train_test_split(*make_dataset(spec, scale=scale))
    A = table("D3", 3, 0.1)
    return [A, table("D3", 11, 0.1), table("D3", 12, 0.1), A, table("D7", 7, 0.02),
            table("D3", 13, 0.1)]


# ---------------------------------------------------------------------------
# the four kernels' public ops
# ---------------------------------------------------------------------------

def run_every_op(device):
    """One call of each kernel's public op on ``device``."""
    from repro_torch.kernels.entropy.ops import population_histogram
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gen_dst.ops import fused_delta_fitness
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    sub = torch.randint(0, 8, (3, 5, 2), dtype=torch.int32, device=device)
    counts = population_histogram(sub, 8)
    z = torch.zeros((3, 2), dtype=torch.int32, device=device)
    fused_delta_fitness(counts, z, z, torch.zeros(3, device=device),
                        torch.ones((3, 2), dtype=torch.bool, device=device), 0.5)
    q = torch.randn((1, 4, 2, 8), device=device)
    flash_attention(q, q, q)
    bm = torch.randn((1, 4, 1, 8), device=device)
    ssd_scan(q, torch.rand((1, 4, 2), device=device), -torch.rand(2, device=device), bm, bm)


# ---------------------------------------------------------------------------
# the LM slice
# ---------------------------------------------------------------------------

# dense, ssm, hybrid; moe, vlm; the other dense archs
SMOKE_ARCHS = ["qwen3-8b", "mamba2-130m", "zamba2-2.7b",
               "qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b",
               "gemma-2b", "granite-3-2b", "llama3-405b"]


def lm_tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def n_img_of(cfg):
    """Patch embeddings a config's batch carries (vlm only)."""
    return cfg.n_img_tokens if cfg.family == "vlm" else 0


def lm_batch(cfg, B, S, seed=1):
    """S positions of numpy inputs: tokens, and for vlm ``n_img_tokens``
    patch embeddings (float32) before S - n_img text tokens."""
    n_img = n_img_of(cfg)
    batch = {"tokens": lm_tokens(B, S - n_img, cfg.vocab_size, seed)}
    if n_img:
        batch["patch_embeds"] = np.random.default_rng(seed + 1).normal(
            0, 1, (B, n_img, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def batch_n_img(batch):
    return batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0


def serve_port(params, cfg, batch, prompt, device="cpu"):
    """The port's ``prefill`` of the first ``prompt`` tokens (after the
    patches, for vlm), then ``decode`` of the rest one by one (teacher
    forcing): every step's logits as numpy (B, S - prompt + 1, V), and the
    cache."""
    from repro_torch.models import lm
    batch = torch_batch(batch, device)
    toks, n_img = batch["tokens"], batch_n_img(batch)
    logits, cache = lm.prefill(params, {**batch, "tokens": toks[:, :prompt]}, cfg,
                               max_len=toks.shape[1] + n_img)
    outs = [logits[:, 0]]
    for i in range(prompt, toks.shape[1]):
        lg, cache = lm.decode(params, cache, toks[:, i:i + 1], i + n_img, cfg)
        outs.append(lg[:, 0])
    return np_(torch.stack(outs, dim=1)), cache

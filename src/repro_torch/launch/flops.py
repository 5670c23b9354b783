"""Analytic MODEL_FLOPS per (arch, shape): the "useful" FLOPs yardstick.

Train: 6 * N_active * tokens  (+ causal attention term 6 * S_ctx/2 per
token per layer per qk/v dim).  Prefill: 2 * N_active * tokens + attention.
Decode: per-token matmuls + attention over the cached context.

N_active counts matmul-visible params (embedding lookup excluded, lm_head
included; MoE counts routed experts at top_k/E utilization + shared).

``tabular_trial_flops`` is the serving tier's counterpart for the SubStrat
AutoML trials: the same 6·P-train / 2·P-eval pricing applied to the
batched engine's tabular MLP, used by ``obs/torchprof.pack_flops`` for
padded-vs-useful megabatch accounting.

The port of the JAX package's ``launch/flops.py``: the same formulas, on
the port's ``models/config.ModelConfig`` and ``ShapeSpec``.
"""
from __future__ import annotations

from ..models.config import ModelConfig, ShapeSpec

__all__ = ["active_params", "model_flops", "tabular_trial_flops",
           "gen_dst_generation_flops"]


def tabular_trial_flops(n_tr: int, n_val: int, d: int, n_classes: int,
                        steps: int, hidden: int = 32) -> float:
    """Analytic FLOPs of one tabular AutoML trial: a ``d → hidden →
    n_classes`` MLP trained full-batch for ``steps`` epochs on ``n_tr``
    rows, evaluated once on ``n_val`` rows (6·P per trained example-step,
    2·P per validation example)."""
    p = d * hidden + hidden * n_classes
    return 6.0 * p * float(steps) * float(n_tr) + 2.0 * p * float(n_val)


def gen_dst_generation_flops(phi: int, n: int, M: int, B: int, *,
                             mode: str = "delta",
                             tile_p: int = 8) -> tuple[float, float]:
    """``(useful, launched)`` FLOPs of one Gen-DST generation's fitness pass
    (DESIGN.md §16.5), for the roofline's padded-vs-useful accounting.

    ``useful`` is the algorithmic minimum per live candidate: the
    scatter-equivalent count update — 4 ops/column for a one-row ``delta``
    (subtract old + add new, each a read-modify-write), or ``2·n·M`` adds
    for a ``full`` histogram rebuild — plus the masked-entropy reduction
    (~5 ops per (M, B) histogram cell: normalize, log2, multiply,
    predicate, accumulate).

    ``launched`` is what the fused kernel actually executes: the delta is
    materialized as one-hot compares against the bin iota (6 ops per cell
    instead of 4 per column), the full rebuild as a one-hot matmul
    (``2·n·M·B``), and the candidate axis is padded up to the ``tile_p``
    grid — padded lanes compute a fitness nobody reads.  The histogram
    path's own row-tile padding is not priced here (it varies with the
    entropy kernel's tile_n and is negligible at Gen-DST row counts).
    """
    entropy = 5.0 * M * B
    if mode == "delta":
        useful_pc = 4.0 * M + entropy
        launched_pc = 6.0 * M * B + entropy
    elif mode == "full":
        useful_pc = 2.0 * n * M + entropy
        launched_pc = 2.0 * n * M * B + entropy
    else:
        raise ValueError(f"unknown Gen-DST generation mode: {mode!r}")
    phi_padded = -(-phi // tile_p) * tile_p
    return useful_pc * phi, launched_pc * phi_padded


def _attn_params(cfg: ModelConfig) -> float:
    return cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * cfg.d_model


def _mlp_params(cfg: ModelConfig) -> float:
    return cfg.d_model * cfg.d_ff * (3 if cfg.glu else 2)


def _ssm_params(cfg: ModelConfig) -> float:
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    return cfg.d_model * d_in_proj + cfg.d_inner * cfg.d_model


def active_params(cfg: ModelConfig) -> float:
    L = cfg.n_layers
    head = cfg.d_model * cfg.vocab_size          # lm_head matmul
    if cfg.family in ("dense", "vlm"):
        return L * (_attn_params(cfg) + _mlp_params(cfg)) + head
    if cfg.family == "moe":
        routed = cfg.moe_top_k * cfg.d_model * cfg.d_ff * 3
        shared = cfg.n_shared_experts * cfg.d_model * cfg.d_ff * 3
        router = cfg.d_model * cfg.n_experts
        return L * (_attn_params(cfg) + routed + shared + router) + head
    if cfg.family == "ssm":
        return L * _ssm_params(cfg) + head
    if cfg.family == "hybrid":
        n_shared = L // (cfg.shared_attn_every or L)
        shared_blk = _attn_params(cfg) + _mlp_params(cfg)
        return L * _ssm_params(cfg) + n_shared * shared_blk + head
    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (_attn_params(cfg) + _mlp_params(cfg))
        dec = cfg.n_layers * (2 * _attn_params(cfg) + _mlp_params(cfg))
        return enc + dec + head
    raise ValueError(cfg.family)


def _attn_ctx_flops_per_tok(cfg: ModelConfig, ctx: float, n_attn_layers: float) -> float:
    """qk^T + att*v flops for one token attending over ``ctx`` keys."""
    return n_attn_layers * 4 * cfg.n_heads * cfg.head_dim * ctx


def _n_attn_layers(cfg: ModelConfig) -> float:
    if cfg.family in ("dense", "vlm", "moe"):
        return cfg.n_layers
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // (cfg.shared_attn_every or cfg.n_layers)
    if cfg.family == "encdec":
        return 2 * cfg.n_layers + cfg.n_enc_layers  # self+cross dec, self enc
    raise ValueError(cfg.family)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global useful FLOPs for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    P = active_params(cfg)
    n_attn = _n_attn_layers(cfg)

    if cfg.family == "encdec":
        S_dec = max(8, S // cfg.dec_ratio)
        tokens = B * (S + S_dec) / 2  # rough: enc runs S, dec runs S_dec
        # attention ctx: enc self S, dec self S_dec/2 causal, cross S
        attn = B * (
            cfg.n_enc_layers * S * 4 * cfg.n_heads * cfg.head_dim * S
            + cfg.n_layers * S_dec * 4 * cfg.n_heads * cfg.head_dim * (S_dec / 2 + S)
        )
    else:
        tokens = B * S
        attn = tokens * _attn_ctx_flops_per_tok(cfg, S / 2, n_attn)
        if cfg.family in ("ssm", "hybrid"):
            # SSD: state update+readout ~ 6 * d_inner * N per token
            attn += tokens * 6 * cfg.d_inner * cfg.ssm_state * cfg.n_layers

    if shape.kind == "train":
        return 6 * P * tokens + 3 * attn
    if shape.kind == "prefill":
        return 2 * P * tokens + attn
    # decode: one new token per sequence, full-context attention
    per_tok = 2 * P + _attn_ctx_flops_per_tok(cfg, S, n_attn)
    if cfg.family in ("ssm", "hybrid"):
        per_tok = 2 * P + _attn_ctx_flops_per_tok(cfg, S, n_attn) \
            + 6 * cfg.d_inner * cfg.ssm_state * cfg.n_layers
    if cfg.family == "encdec":
        S_dec = max(8, S // cfg.dec_ratio)
        per_tok = 2 * (P - cfg.n_enc_layers * (_attn_params(cfg) + _mlp_params(cfg))) \
            + cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * (S_dec + S)
    return B * per_tok

"""Model configuration of the LM slice: the fields of the JAX package's
``models/config.py`` that serving its six families reads.

Dtypes are ``torch.dtype``s.  Left out (see ROADMAP, deliberate
differences): the launcher and sharding fields (``act_shard_spec``,
``moe_ep_shard``, ``grad_shard``, ``mesh_*``), ``remat`` and
``scan_layers`` (layers are a Python loop; nothing is rematerialised), and
``attn_impl`` / ``ssm_impl`` (the device picks the implementation: the CUDA
kernels for CUDA tensors, their plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | encdec | ssm | hybrid | moe | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU / plain, tanh form)
    glu: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # hybrid (zamba2): shared attention block applied every k ssm blocks
    shared_attn_every: int = 0
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # encdec (whisper)
    n_enc_layers: int = 0
    dec_ratio: int = 8              # decoder_len = enc_len // dec_ratio
    max_dec_len: int = 4096
    # vlm
    n_img_tokens: int = 0
    # numerics
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    logit_dtype: torch.dtype = torch.float32

    @property
    def d_inner(self) -> int:       # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    # decode: seq_len = existing KV/state context length, 1 new token.


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

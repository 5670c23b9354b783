"""CUDA wrapper of the SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces the JAX package's Pallas kernel ``ssd_scan_pallas``
(``src/repro/kernels/ssd_scan/kernel.py:62``).  The source states the design
and the bound.  Unlike the TPU kernel it reads the model layout in place
(x (B, S, H, P), B/C (B, S, G, N), through their batch and position strides),
takes a partial last chunk, and also returns the final state.

The launcher routes by dtype: bfloat16 goes to the chunked body (three
kernels: chunk states, state passing, chunk scan; every chunk in parallel,
products on the tensor cores), float32 to the body that walks the chunks of
one (batch, head) in one block.  The chunked body keeps the chunk states in
float32 scratch allocated here, B H ceil(S/Q) (2 P N + 1) floats: the
chunk states, the entering states as bf16 hi/lo planes, the chunk decays.

Tolerance against ``ref.ssd_scan_model_ref`` (the per-timestep recurrence)
run in float32 on the same values: the chunked form sums in another order,
in float32 (the bfloat16 body's computed operands carry ~16 bits as bf16
hi + lo pairs), so y agrees within 1e-3 in float32 and, after the one
rounding of bfloat16 outputs, within 5e-2 (``tests/test_ssd_kernel.py:35``
holds the Pallas kernel so); the final state within 1e-3 relative.

``launches`` counts the kernel's launches; it is incremented only where the
kernel is launched.

``ssd_scan_cuda`` is a ``torch.library.custom_op`` (``repro_torch::ssd_scan``),
so that a trace on fake tensors (the dry-run, ``launch/dryrun.py``) sees one
op: its ``register_fake`` gives y (B, S, H, P) in x's dtype and the final
state (B, H, P, N) float32 on x's device, and the bfloat16 body's scratch,
which the real op holds during the launch, and launches nothing.  Its FLOP
formula (``ssd_scan_flops``) counts the products of the three kernels per
head and chunk of length L (the source's bound, ``csrc/ssd_scan.cu``):
C B^T (2 L^2 N), its decay-weighted rows times x dt (2 L^2 P), the chunk
state (2 L P N) and the entering state's C h^T (2 L P N), so
``B H (sum over chunks of 2 L^2 (N + P)) + 4 B H S P N``, with the chunk
``chunk_for`` picks.  On real tensors the op runs the launch below and
nothing else.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build

__all__ = ["ssd_scan_cuda", "ssd_scan_flops", "chunk_for", "launches"]

launches = 0
_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a Hopper block may use
_TI = 32                        # rows of the decay-weighted tile (csrc/ssd_scan.cu)
MAX_CHUNK = 64                  # float32 body: the fastest chunk at zamba2's shape on the H100
BF16_CHUNK = 128                # bfloat16 body: 64 or 128 (csrc/ssd_scan.cu instantiates both)
_HB = 4                         # heads per block of the bfloat16 body (csrc HB)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(Q: int, P: int, N: int) -> int:
    return 4 * (2 * Q * (N + 1) + Q * (P + 1) + P * (N + 1) + _TI * (Q + 1) + 4 * Q)


def _r32(v: int) -> int:
    return -(-v // 32) * 32


def _bf16_smem_bytes(Q: int, P: int, N: int) -> int:
    """Shared memory of the chunked body's chunk-scan kernel, its largest
    (``ScanSmem`` in csrc/ssd_scan.cu): C and B, the lower 16 x 16 tiles of
    C B^T in float32, two buffers of x and of the entering state's bf16 hi/lo
    planes, la and dt, and two buffers of decay tables."""
    ldc, ldx, nb = _r32(N) + 8, _r32(P) + 8, Q // 16
    return (4 * Q * ldc + 16 * 24 * 4 * nb * (nb + 1) // 2 + 4 * Q * ldx + 8 * _r32(P) * ldc
            + 8 * _HB * Q + 8 * Q * nb + 8 * Q)


def chunk_for(block_q: int, S: int, P: int, N: int, bf16: bool = False) -> int:
    """The chunk the kernel walks.  The chunk length changes only the
    summation order.

    float32 body: ``min(block_q, S, 64)``, halved until its tiles fit shared
    memory; 64 halves the quadratic CUDA-core work of 128 and lets three
    blocks share an SM.

    bfloat16 body: ``BF16_CHUNK`` whatever block_q and S (S < chunk is one
    partial chunk), or 64 if 128 does not fit shared memory.  Its products
    are on the tensor cores, so the quadratic work no longer sets the chunk:
    128 halves the chunk states that pass through the L2 and the sequential
    steps of the state passing."""
    if bf16:
        for Q in (BF16_CHUNK, 64):
            if _bf16_smem_bytes(Q, P, N) <= _SMEM_LIMIT:
                return Q
        raise ValueError(f"ssd_scan_cuda: P={P}, N={N} do not fit shared memory")
    Q = max(1, min(block_q, S, MAX_CHUNK))
    while Q > 1 and _smem_bytes(Q, P, N) > _SMEM_LIMIT:
        Q //= 2
    if _smem_bytes(Q, P, N) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan_cuda: P={P}, N={N} do not fit shared memory")
    return Q


def _inner_contiguous(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def _check(x, dt, a, bm, cm, fake: bool = False) -> None:
    """Raises on what the kernel does not take (``fake``: meta tensors too)."""
    if not all((t.is_cuda or (fake and t.is_meta)) and t.device == x.device
               for t in (x, dt, a, bm, cm)):
        raise ValueError("ssd_scan_cuda: tensors must be on one CUDA device")
    if x.dtype not in _DTYPES or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan_cuda: x, bm, cm must share a dtype in {list(_DTYPES)}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("ssd_scan_cuda: dt and a must be float32")
    if x.dim() != 4 or bm.dim() != 4:
        raise ValueError(f"ssd_scan_cuda: bad shapes {tuple(x.shape)}, {tuple(bm.shape)}")
    B, S, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    if (dt.shape != (B, S, H) or a.shape != (H,) or bm.shape[:2] != (B, S)
            or cm.shape != bm.shape or G == 0 or H % G != 0):
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, bm {tuple(bm.shape)}, cm {tuple(cm.shape)} "
                         f"do not fit (H must be a multiple of G)")
    if not (_inner_contiguous(x) and _inner_contiguous(bm) and cm.stride() == bm.stride()
            and dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd_scan_cuda: x, bm, cm need contiguous (heads, width) dims "
                         "and bm, cm equal strides; dt and a must be contiguous")


def _scratch(x, Q: int, P: int, N: int):
    """The bfloat16 body's float32 scratch: B H ceil(S / Q) (2 P N + 1) floats."""
    B, S, H = x.shape[:3]
    return torch.empty(B * H * -(-S // Q) * (2 * P * N + 1), dtype=torch.float32,
                       device=x.device)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
                  cm: torch.Tensor, *, block_q: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (B, S, H, P), dt (B, S, H) float32, a (H,) float32,
    bm/cm (B, S, G, N) in x's dtype (float32 or bfloat16) -> y (B, S, H, P)
    in x's dtype and the final state (B, H, P, N) float32.

    x, bm and cm may be views with any batch and position strides (bm and cm
    with the same strides) as long as their (heads, width) dims are
    contiguous; dt and a must be contiguous.  S need not be a multiple of
    the chunk."""
    global launches
    _check(x, dt, a, bm, cm)
    B, S, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * S * H == 0:
        return y, h.zero_()
    bf16 = x.dtype == torch.bfloat16
    Q = chunk_for(block_q, S, P, N, bf16=bf16)
    scratch = _scratch(x, Q, P, N) if bf16 else None
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.launch_ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                              cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, G, P, N, Q,
                              x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
                              scratch.data_ptr() if bf16 else None, _DTYPES[x.dtype], stream)
    _build.check(err, "ssd_scan")
    launches += 1
    return y, h


@ssd_scan_cuda.register_fake
def _(x, dt, a, bm, cm, *, block_q=128):
    _check(x, dt, a, bm, cm, fake=True)
    B, S, H, P = x.shape
    N = bm.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16 and B * S * H:
        _scratch(x, chunk_for(block_q, S, P, N, bf16=True), P, N)   # held during the launch
    return y, h


@register_flop_formula(torch.ops.repro_torch.ssd_scan, get_raw=True)
def ssd_scan_flops(x, dt, a, bm, cm, *, block_q=128, out_val=None) -> int:
    """The products of the three kernels (module docstring): per head and
    chunk of length L, ``2 L^2 (N + P) + 4 L P N``."""
    B, S, H, P = x.shape
    N = bm.shape[3]
    if B * S * H == 0:
        return 0
    Q = chunk_for(block_q, S, P, N, bf16=x.dtype == torch.bfloat16)
    full, rem = divmod(S, Q)
    return B * H * (2 * (N + P) * (full * Q * Q + rem * rem) + 4 * S * P * N)

"""MViT pooled-attention core K3: the CUDA kernel and its plain version (JAX
``ops/pallas/mvit_attention.py``).

Contract (JAX ``mvit_attention.py:15-28``), for k/v pooled to a (T, 1, 1)
grid: the class-token query row is left to the caller; k and v arrive with
the class token LAST; ``band`` is the (Ng, Nk-1) additive temporal rel-pos
bias of the grid keys; every grid row gets the ``+ q`` residual:

    out = softmax(scale * q k^T + [band | 0]) v + q

Numerics (both versions): scores and softmax statistics in f32, the exp
rounded to the compute dtype before the value product, the denominator
summed from the rounded exps and applied to the f32 output, which is rounded
once before the residual add.

``fused_pooled_attention`` launches ``csrc/mvit_attention.cu`` for a CUDA
tensor on an sm_90 card (replacing ``fused_pooled_attention``,
``pallas_call`` at ``mvit_attention.py:103``) and runs
``pooled_attention_math`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.runtime import use_kernel
from ..mvit_math import fmatmul, softmax_pv

MAX_HEAD_DIM = 128

# kernel launches since the last reset (CPU calls and plain runs never count)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pooled_attention_math(q, k, v, band, scale: float) -> torch.Tensor:
    """Plain version. q (BH, Ng, d), k/v (BH, Nk, d) in the compute dtype,
    band (BH, Ng, Nk-1) float; returns (BH, Ng, d) in the compute dtype."""
    s = fmatmul(q, k.transpose(1, 2)) * scale
    s[..., :-1] += band.float()
    return softmax_pv(s, v) + q


def fused_pooled_attention(q, k, v, band, scale: float) -> torch.Tensor:
    """K3 on (BH, Ng, d) grid queries against (BH, Nk, d) k/v (class token
    last) with a (BH, Ng, Nk - 1) band; returns (BH, Ng, d)."""
    bh, ng, d = q.shape
    nk = k.shape[1]
    cd = q.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pooled attention takes float32 or bfloat16, got {cd}")
    for name, t, shape in (("k", k, (bh, nk, d)), ("v", v, (bh, nk, d)),
                           ("band", band, (bh, ng, nk - 1))):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name}: expected {shape} on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if k.dtype != cd or v.dtype != cd:
        raise ValueError("q, k and v must share the compute dtype")
    if not use_kernel(q):
        return pooled_attention_math(q, k, v, band, scale)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"pooled attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    return _launch(q.contiguous(), k.contiguous(), v.contiguous(), band.float().contiguous(),
                   scale)


def _launch(q, k, v, band, scale):
    """The C entry of ``csrc/mvit_attention.cu`` in its K3 form (band given,
    no flags; ``mvit_block.cu`` drives the same entry with its own flags)."""
    global LAUNCHES
    from .build import load

    bh, ng, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    if bh == 0 or ng == 0:
        return out
    lib = load()
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.avdd_pooled_attention(
            ptr(q), ptr(k), ptr(v), ptr(band), ctypes.c_void_p(0), ptr(out),
            bh, 1, ng, nk, d, nk - 1, 1, ng * d, 0, d, ng * d, 0, d,
            ctypes.c_float(scale), 0, 0 if q.dtype == torch.float32 else 1,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"pooled attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

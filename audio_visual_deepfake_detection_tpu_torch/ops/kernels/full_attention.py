"""Full (non-banded) multi-head attention K8: the CUDA kernel and its plain
version (JAX ``ops/pallas/full_attention.py``).

The attention of every Emotion2Vec ``AltBlock``:

    out = softmax(q k^T + key_bias) v

for q, k, v (B, H, T, d) with q already scaled by d ** -0.5, and an optional
(B, T) bool key padding mask (True = masked key, fairseq's convention).

``full_mha_math`` is the XLA path of the JAX ``AltAttention``: f32 scores,
masked keys at -inf, an f32 softmax rounded to the compute dtype, then the
value product (f32 accumulation, rounded once).

``full_mha`` launches ``csrc/full_attention.cu`` for a CUDA tensor on an
sm_90 card (replacing ``full_mha``, ``pallas_call`` at
``full_attention.py:101``) and runs ``full_mha_math`` for a CPU tensor. The
kernel keeps the TPU kernel's arithmetic: masked keys get an additive -1e30,
a two-pass softmax over all keys (maximum, then exps rounded to the compute
dtype with the denominator summed in f32 from the rounded exps), P.V
accumulated in f32 and one divide per output element at the end. Padding
query rows attend the valid keys, so they come out finite. The TPU wrapper's
pad of T to a multiple of 128 is lane layout and is not carried over: the
kernel masks its ragged last key tile itself. In bfloat16 the scores stay in
registers (wgmma, both passes recompute q k^T), so T has no cap; the float32
kernel keeps score rows in shared memory and takes T up to ~6600.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.runtime import use_kernel
from ..mvit_math import fmatmul

HEAD_DIMS = (32, 64)      # what the kernel is built and checked for
NEG = -1e30
SMEM_MAX = 232448      # dynamic shared memory of a Hopper block

# kernel launches since the last reset (CPU calls and plain runs never count)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def full_mha_math(q, k, v, padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: (B, H, T, d) q (pre-scaled), k, v in the compute dtype,
    ``padding_mask`` (B, T) bool or None; returns (B, H, T, d)."""
    att = fmatmul(q, k.transpose(-1, -2))
    if padding_mask is not None:
        att = att.masked_fill(padding_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(att, dim=-1).to(v.dtype)
    return fmatmul(p, v).to(v.dtype)


def full_mha(q, k, v, padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 on (B, H, T, d) q (pre-scaled), k, v; returns (B, H, T, d) as a
    view of a (B, T, H, d) buffer, so the caller's merge of the heads back
    into (B, T, H d) copies nothing."""
    b, h, t, d = q.shape
    cd = q.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"full attention takes float32 or bfloat16, got {cd}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != cd or a.device != q.device:
            raise ValueError(f"{name}: expected {tuple(q.shape)} {cd} on {q.device}, got "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")
    if padding_mask is not None and (tuple(padding_mask.shape) != (b, t)
                                     or padding_mask.dtype != torch.bool
                                     or padding_mask.device != q.device):
        raise ValueError(f"padding_mask must be ({b}, {t}) bool on {q.device}")
    if not use_kernel(q):
        return full_mha_math(q, k, v, padding_mask)
    if d not in HEAD_DIMS:
        raise ValueError(f"full attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    return _launch(*(_rows_ok(a) for a in (q, k, v)), padding_mask)


def _rows_ok(a):
    """The kernel reads (sample, head, row) through strides, rows of d
    contiguous values on 16-byte boundaries; anything else is copied."""
    step = 16 // a.element_size()
    ok = a.stride(3) == 1 and a.data_ptr() % 16 == 0 and \
        all(s % step == 0 for s in a.stride()[:3])
    return a if ok else a.contiguous()


def _launch(q, k, v, padding_mask):
    global LAUNCHES
    from .build import load

    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    if b == 0 or t == 0:
        return out
    bias = None
    if padding_mask is not None:     # (b, t) f32: NEG at a masked key, else 0
        bias = torch.where(padding_mask, NEG, 0.0)
    lib = load()
    code = 0 if q.dtype == torch.float32 else 1
    need = lib.avdd_full_mha_smem(t, d, code)
    if need > SMEM_MAX:      # float32 only: bfloat16 needs the same 34 KB at any T
        raise ValueError(f"full attention kernel, {q.dtype}: T={t} needs {need} bytes of "
                         f"shared memory for its score rows, a block has {SMEM_MAX}")
    ptr = lambda a: ctypes.c_void_p(a.data_ptr() if a is not None else 0)  # noqa: E731
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.avdd_full_mha(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), b, h, t, d,
                                *strides, code,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

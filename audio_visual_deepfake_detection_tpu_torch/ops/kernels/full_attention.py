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
so a sample whose keys are all masked averages v, and padding query rows
attend the valid keys, so they come out finite. The TPU wrapper's pad of T
to a multiple of 128 is lane layout and is not carried over: the kernel
masks its ragged last key tile itself. T has no cap in either dtype.

- bfloat16: a two-pass softmax over all keys (maximum, then exps rounded to
  bf16 with the denominator summed in f32 from the rounded exps), P.V on
  wgmma accumulated in f32, one divide per output element at the end; the
  scores stay in registers (both passes recompute q k^T).
- float32: 3xTF32 on the tensor cores (each operand split into a TF32 high
  part and a residual, hi.hi + hi.lo + lo.hi, each 32-deep stage's sum
  folded into f32): the f32 pooled attention's kernel
  (``csrc/mvit_attention_f32.cu``, its KEY_BIAS mode) stages each 32-key
  tile of k and v as it is, splits it in shared memory (v transposed) and
  runs an online softmax over the tiles. It differs from ``full_mha_math``
  by f32 rounding only.

``ROUTES`` counts the launches by the kernel the C entry reports it took
(``ROUTE_NAMES``): there is no other route, a CUDA tensor launches one of
them or the wrapper raises.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from ...core.runtime import use_kernel
from ..mvit_math import fmatmul

# head dims the kernel takes: multiples of HEAD_DIM_STEP up to MAX_HEAD_DIM
# (bf16: the wgmma kernel at widths 64 and 128; f32: the 3xTF32 kernel's
# instances of 32, 64, 96 and 128, d rounded up to one)
HEAD_DIM_STEP = 16
MAX_HEAD_DIM = 128
NEG = -1e30
ROUTE_NAMES = ("wgmma bf16", "wgmma 3xTF32")

# kernel launches since the last reset (CPU calls and plain runs never count),
# and by the kernel the C entry reports it took (ROUTE_NAMES)
LAUNCHES = 0
ROUTES = collections.Counter()


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    ROUTES.clear()


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
    if not head_dim_ok(d):
        raise ValueError(f"full attention kernel takes head_dim a multiple of {HEAD_DIM_STEP} "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    return _launch(*(_rows_ok(a) for a in (q, k, v)), padding_mask)


def head_dim_ok(d: int) -> bool:
    """Whether the kernel takes head dim ``d``: a multiple of 16 from 16 to
    128, both dtypes (``csrc/full_attention.cu::avdd_full_mha`` checks the
    same)."""
    return d % HEAD_DIM_STEP == 0 and HEAD_DIM_STEP <= d <= MAX_HEAD_DIM


def _rows_ok(a):
    """The kernel reads (sample, head, row) through strides, rows of d
    contiguous values on 16-byte boundaries; anything else is copied into a
    fresh allocation (``contiguous`` would keep a contiguous view off 16
    bytes as it is)."""
    step = 16 // a.element_size()
    ok = a.stride(3) == 1 and a.data_ptr() % 16 == 0 and \
        all(s % step == 0 for s in a.stride()[:3])
    return a if ok else a.clone(memory_format=torch.contiguous_format)


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
    ptr = lambda a: ctypes.c_void_p(a.data_ptr() if a is not None else 0)  # noqa: E731
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.avdd_full_mha(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), b, h, t, d,
                                *strides, code, ctypes.c_void_p(stream), ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"full attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    ROUTES[ROUTE_NAMES[route.value]] += 1
    return out

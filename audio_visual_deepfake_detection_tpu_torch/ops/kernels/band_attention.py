"""Banded sliding-window attention K7: the CUDA kernel, its plain version and
the differentiable wrapper (JAX ``ops/pallas/band_attention.py``).

For q (pre-scaled by ``D ** -0.5``), k, v of shape (B, H, T, D) and a (B, T)
bool key mask, query row i attends keys ``i - w .. i + w``: a finite -1e4
penalty on masked keys, -inf outside the sequence (edge rows renormalise), a
softmax over the 2w+1 offsets, and rows whose own key slot is masked zeroed.

``band_attention_plain`` mirrors the Pallas body ``_band_kernel``
(``band_attention.py:42-73``) op for op **in the input dtype**: in bf16 the
scores, the exps, the division and the running sum are bf16 values.
``ops/attention.py::band_attention_xla`` is the other formulation of the same
function, with an f32 softmax; the two agree to rounding in f32 and differ by
bf16 rounding in bf16. Both are kept because the JAX package keeps both: the
kernel's forward follows the first, its backward differentiates the second.

``band_attention_kernel`` launches ``csrc/band_attention.cu`` for a CUDA
tensor on an sm_90 card (replacing ``band_attention_pallas``,
``pallas_call`` at ``band_attention.py:105``) and runs
``band_attention_plain`` for a CPU tensor. Up to ``MAX_W`` and head rows of
``MAX_TILED_ROW_BYTES``, the kernel computes 8-row tiles of one sample
across a 512-byte run of heads from k and v rows staged with their ±w halo
(zeros outside the sequence); any wider window or head row (up to
``MAX_HEAD_DIM``) runs ``band_rows_kernel`` (bf16, and f32 past head width
``MAX_F32_WGMMA_HEAD_DIM``: 16 query rows a block, k then v staged by key
tiles, bf16 scores summed on ``mma.sync``, then the plain version's steps
in its order: a context summed in f32 drifts from the plain version's
running bf16 sums past the bf16 check's bound at wide windows) or, f32 up
to that width, K1's banded attention on the tensor cores
(``csrc/band_attend.cuh``: 3xTF32 on ``wgmma`` after a launch that splits k
and v into TF32 parts). ``kernel_limits`` says which head widths and
windows the kernel takes, ``route_of`` which route a shape takes, and
``ROUTES`` counts the launches by the route the C entry reports it took
(``ROUTE_NAMES``). ``band_attention_fused`` is the
JAX ``band_attention_fused`` (``:124``, a ``custom_vjp``): forward = the
kernel, backward = autograd through ``band_attention_xla`` recomputed from
the saved q, k, v and mask. Neither package has a backward kernel.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import struct

import torch

from ...core.runtime import use_kernel
from ..attention import NEG_PENALTY, band_attention_xla, shift_time

MAX_W = 16                  # largest half window of the tiled kernel
MAX_TILED_ROW_BYTES = 512   # its widest head row: a warp's 32 16-byte pieces
MAX_HEAD_DIM = 512          # the widest head the kernel takes
MAX_F32_WGMMA_HEAD_DIM = 128   # past the tiled kernel, f32 on the tensor cores up to it
# csrc/band_attention.cu's ROUTE_*: the tiled kernel; past it
# band_rows_kernel in bf16, K1's banded attention on the tensor cores in
# f32, band_rows_kernel in f32
ROUTE_NAMES = ("tiled", "staged rows bf16", "wgmma 3xTF32", "staged rows f32")

# kernel launches since the last reset (CPU calls and plain runs never count),
# all together and by the route the C entry reports it took (ROUTE_NAMES)
LAUNCHES = 0
ROUTES = collections.Counter()
_SAME_DEVICE = contextlib.nullcontext()     # the launch's device is already current
# csrc/band_attention.cu::BandArgs: q, k, v, valid, out, stream, scratch,
# route; 12 strides; B, H, T, D, w, dtype (one packed argument: the host's
# cost of a launch)
_ARGS = struct.Struct("<8Q12q6i")
_ROUTE = ctypes.c_int(-1)                   # the C entry writes the route here
_ROUTE_AT = ctypes.addressof(_ROUTE)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    ROUTES.clear()


def band_attention_plain(q, k, v, kv_valid, w_overlap: int) -> torch.Tensor:
    """Plain version of the kernel: every operation in ``q.dtype``."""
    t = q.shape[-2]
    dt = q.dtype
    pen = torch.where(kv_valid, 0.0, NEG_PENALTY).to(dt)[:, None, :, None]   # (B, 1, T, 1)
    qvalid = kv_valid.to(dt)[:, None, :, None]
    row = torch.arange(t, device=q.device)[:, None]
    neg_inf = torch.tensor(float("-inf"), dtype=dt, device=q.device)
    offsets = range(-w_overlap, w_overlap + 1)
    scores = []
    for d in offsets:
        s = (q * shift_time(k, d)).sum(-1, keepdim=True)                    # (B, H, T, 1)
        in_range = (row + d >= 0) & (row + d < t)
        scores.append(torch.where(in_range, s + shift_time(pen, d), neg_inf))
    m = scores[0]
    for s in scores[1:]:
        m = torch.maximum(m, s)
    exps = [torch.exp(s - m) for s in scores]
    denom = exps[0]
    for e in exps[1:]:
        denom = denom + e
    acc = torch.zeros_like(q)
    for e, d in zip(exps, offsets):
        acc = acc + (e / denom) * shift_time(v, d)
    return acc * qvalid


def _check(q, k, v, kv_valid, w_overlap):
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    b, _, t, _ = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"band attention takes float32 or bfloat16, got {q.dtype}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name}: expected {tuple(q.shape)} {q.dtype} on {q.device}, got "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")
    if tuple(kv_valid.shape) != (b, t) or kv_valid.dtype != torch.bool \
            or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be ({b}, {t}) bool on {q.device}")
    if w_overlap < 0:
        raise ValueError(f"w_overlap must be >= 0, got {w_overlap}")


def band_attention_kernel(q, k, v, kv_valid, w_overlap: int) -> torch.Tensor:
    """K7 without autograd: the kernel on the card, the plain version on the
    CPU. Returns (B, H, T, D); on the card with the strides of a (B, T, H, D)
    buffer, so merging the heads back into (B, T, H D) copies nothing."""
    _check(q, k, v, kv_valid, w_overlap)
    if not use_kernel(q):
        return band_attention_plain(q, k, v, kv_valid, w_overlap)
    return _launch(q, k, v, kv_valid, w_overlap)


def _rows_ok(a):
    """The kernel reads rows of D contiguous values through (batch, head,
    row) strides, each row 16-byte aligned (the stride of a dimension of
    size 1 is never used); anything else is copied."""
    vec = 16 // a.element_size()
    if a.stride(3) == 1 and a.data_ptr() % 16 == 0 and all(
            s % vec == 0 for s, n in zip(a.stride()[:3], a.shape[:3]) if n > 1):
        return a
    return a.clone(memory_format=torch.contiguous_format)


def kernel_shape_ok(head_dim: int, element_size: int, w_overlap: int) -> bool:
    """Whether the kernel takes a head width and window: a head row of whole
    16-byte pieces, head_dim at most MAX_HEAD_DIM (bf16: 8, 16, .., 512;
    f32: 4, 8, .., 512), and any w_overlap >= 0. The same rule as
    ``csrc/band_attention.cu::avdd_band_attention``'s check."""
    row = head_dim * element_size
    return row > 0 and row % 16 == 0 and head_dim <= MAX_HEAD_DIM and w_overlap >= 0


def tiled(head_dim: int, element_size: int, w_overlap: int) -> bool:
    """Whether a shape of ``kernel_shape_ok`` takes the tiled kernel (w up to
    MAX_W, head rows up to MAX_TILED_ROW_BYTES); every other one takes a route past it
    (``route_of``)."""
    return w_overlap <= MAX_W and head_dim * element_size <= MAX_TILED_ROW_BYTES


def route_of(head_dim: int, dtype, w_overlap: int) -> str:
    """The ``ROUTE_NAMES`` entry a launch at a shape of ``kernel_shape_ok``
    takes."""
    size = torch.empty((), dtype=dtype).element_size()
    if tiled(head_dim, size, w_overlap):
        return ROUTE_NAMES[0]
    if dtype == torch.bfloat16:
        return ROUTE_NAMES[1]
    return ROUTE_NAMES[2 if head_dim <= MAX_F32_WGMMA_HEAD_DIM else 3]


def kernel_limits(q, w_overlap):
    """Raise ValueError, naming what is out of range, for a head width or
    window ``kernel_shape_ok`` refuses."""
    d, size = q.shape[-1], q.element_size()
    if kernel_shape_ok(d, size, w_overlap):
        return
    if not kernel_shape_ok(d, size, 0):
        raise ValueError(
            f"band attention kernel takes head rows of whole 16-byte pieces ({q.dtype}: "
            f"head_dim a multiple of {16 // size} up to {MAX_HEAD_DIM}), got head_dim {d}")
    raise ValueError(f"band attention kernel takes w_overlap >= 0, got {w_overlap}")


def _launch(q, k, v, kv_valid, w_overlap):
    global LAUNCHES
    from .build import load

    kernel_limits(q, w_overlap)
    b, h, t, d = q.shape
    out = torch.empty_strided((b, h, t, d), (t * h * d, d, h * d, 1), dtype=q.dtype,
                              device=q.device)
    if b == 0 or t == 0:
        return out
    q, k, v = _rows_ok(q), _rows_ok(k), _rows_ok(v)
    kv_valid = kv_valid.contiguous()
    dev = q.device.index
    dtype = 0 if q.dtype == torch.float32 else 1
    lib = load()
    scratch = None          # past the tiled kernel: k, v split (wgmma) or scores off chip
    if not tiled(d, q.element_size(), w_overlap):
        n = lib.avdd_band_attention_scratch(b, h, t, d, w_overlap, dtype)
        scratch = torch.empty(n, dtype=torch.uint8, device=q.device) if n else None
    with torch.cuda.device(dev) if dev != torch.cuda.current_device() else _SAME_DEVICE:
        err = lib.avdd_band_attention(_ARGS.pack(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev),
            0 if scratch is None else scratch.data_ptr(), _ROUTE_AT, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], t * h * d, d, h * d, b, h, t, d, w_overlap, dtype))
    if err != 0:
        raise RuntimeError(f"band attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    ROUTES[ROUTE_NAMES[_ROUTE.value]] += 1
    return out


class _BandAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid, w_overlap):
        ctx.save_for_backward(q, k, v, kv_valid)
        ctx.w_overlap = w_overlap
        return band_attention_kernel(q, k, v, kv_valid, w_overlap)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid = ctx.saved_tensors
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(True) for a in (q, k, v)]
            out = band_attention_xla(*ins, kv_valid, ctx.w_overlap)
        dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None


def band_attention_fused(q, k, v, kv_valid, w_overlap: int) -> torch.Tensor:
    """Differentiable K7: kernel (or, on the CPU, plain) forward, backward
    through ``band_attention_xla`` from the saved inputs."""
    return _BandAttention.apply(q, k, v, kv_valid, w_overlap)

"""MViT pooled-attention core K3: the CUDA kernel and its plain versions (JAX
``ops/pallas/mvit_attention.py``).

Contract (JAX ``mvit_attention.py:15-28``), for k/v pooled to a (T, 1, 1)
grid: the class-token query row is left to the caller; k and v arrive with
the class token LAST; ``band`` is the (Ng, Nk-1) additive temporal rel-pos
bias of the grid keys; every grid row gets the ``+ q`` residual:

    out = softmax(scale * q k^T + [band | 0]) v + q

Two entries:
- ``pooled_attention_table`` (what ``frontends/mvit.py`` calls): the band is
  built from the temporal rel-pos table, ``band[n, k] = q[n] .
  rel_t[t_n - k + T - 1]`` with ``t_n = n // S``, inside the kernel; no band
  array exists. Its plain version builds the band as the XLA path does
  (``toeplitz_band`` rounded to the compute dtype when ``band_round``, the
  gather and one product per time step otherwise);
- ``fused_pooled_attention`` (the JAX signature): the caller's band array.

Numerics (every version): scores and softmax statistics in f32, the exp
rounded to the compute dtype before the value product, the denominator
summed from the rounded exps and applied to the f32 output, which is rounded
once before the residual add.

A CUDA tensor on an sm_90 card launches ``csrc/mvit_attention.cu``
(replacing ``fused_pooled_attention``, ``pallas_call`` at
``mvit_attention.py:103``), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ...core.runtime import use_kernel
from ..mvit_math import fmatmul, softmax_pv, toeplitz_band

MAX_HEAD_DIM = 128
BAND_ROUND, BAND_TABLE = 2, 8           # csrc/mvit_attention.cu flags
ROUTE_NAMES = ("fma", "wgmma, band given", "wgmma, band from the table")

# kernel launches since the last reset (CPU calls and plain runs never count),
# and by the kernel the C entry reports it took (ROUTE_NAMES)
LAUNCHES = 0
ROUTES = collections.Counter()


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    ROUTES.clear()


def pooled_attention_math(q, k, v, band, scale: float) -> torch.Tensor:
    """Plain version. q (BH, Ng, d), k/v (BH, Nk, d) in the compute dtype,
    band (BH, Ng, Nk-1) float; returns (BH, Ng, d) in the compute dtype."""
    s = fmatmul(q, k.transpose(1, 2)) * scale
    s[..., :-1] += band.float()
    return softmax_pv(s, v) + q


def table_band(q, rel_t, t: int, s: int, band_round: bool) -> torch.Tensor:
    """The (B, nh, t * s, t) f32 band of grid queries q (B, nh, t * s, d)
    (t-major) from the table rel_t (>= 2t - 1, d), both in the compute
    dtype, as the XLA path builds it: the Toeplitz product of the whole
    table rounded to the compute dtype when ``band_round`` (S <= 4), else
    the gathered table rows and one product per query time step."""
    b, nh, _, d = q.shape
    qg = q.reshape(b, nh, t, s, d)
    if band_round:
        return toeplitz_band(qg, rel_t, t, round_to=q.dtype)
    ar = torch.arange(t, device=q.device)
    rt = rel_t[ar[:, None] - ar[None, :] + t - 1]                  # (t_q, t_k, d)
    qt = qg.permute(2, 0, 1, 3, 4).reshape(t, -1, d)
    return fmatmul(qt, rt.transpose(1, 2)).reshape(t, b, nh, s, t).permute(
        1, 2, 0, 3, 4).reshape(b, nh, t * s, t)


def pooled_attention_table_math(q, k, v, rel_t, t: int, s: int, scale: float,
                                band_round: bool) -> torch.Tensor:
    """Plain version of the table entry: ``table_band`` then
    ``pooled_attention_math``; returns (B, nh, Ng, d)."""
    b, nh, ng, d = q.shape
    band = table_band(q, rel_t, t, s, band_round)
    return pooled_attention_math(q.reshape(b * nh, ng, d), k, v, band.reshape(b * nh, ng, t),
                                 scale).reshape(b, nh, ng, d)


def _check(q, k, v, bh, d, extra):
    cd = q.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pooled attention takes float32 or bfloat16, got {cd}")
    nk = k.shape[1]
    for name, a, shape in (("k", k, (bh, nk, d)), ("v", v, (bh, nk, d))) + extra:
        if tuple(a.shape) != shape or a.device != q.device:
            raise ValueError(f"{name}: expected {shape} on {q.device}, got "
                             f"{tuple(a.shape)} on {a.device}")
    if k.dtype != cd or v.dtype != cd:
        raise ValueError("q, k and v must share the compute dtype")


def _check_head_dim(d):
    if d > MAX_HEAD_DIM:
        raise ValueError(f"pooled attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")


def pooled_attention_table(q, k, v, rel_t, t: int, s: int, scale: float, band_round: bool,
                           out=None) -> torch.Tensor:
    """K3 with the band from the table. q (B, nh, t * s, d) grid queries
    (any strides with a unit last one, e.g. the grid rows of the pooled
    (B, nh, 1 + N, d) q), k/v (B * nh, t + 1, d) with the class token last,
    rel_t (>= 2t - 1, d) in q's dtype. Returns (B, nh, t * s, d), written
    into ``out`` when given (any strides with a unit last one)."""
    b, nh, ng, d = q.shape
    if ng != t * s:
        raise ValueError(f"q has {ng} grid rows, expected t * s = {t * s}")
    _check(q, k, v, b * nh, d, ())
    if k.shape[1] != t + 1 or rel_t.dim() != 2 or rel_t.shape[0] < 2 * t - 1 \
            or rel_t.shape[1] != d or rel_t.dtype != q.dtype or rel_t.device != q.device:
        raise ValueError(f"k/v need t + 1 = {t + 1} keys and rel_t (>= {2 * t - 1}, {d}) in "
                         f"{q.dtype}; got {tuple(k.shape)}, {tuple(rel_t.shape)} {rel_t.dtype}")
    if out is not None and (tuple(out.shape) != (b, nh, ng, d) or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"out: expected {(b, nh, ng, d)} {q.dtype}, got {tuple(out.shape)}")
    if not use_kernel(q):
        res = pooled_attention_table_math(q, k, v, rel_t, t, s, scale, band_round)
        return res if out is None else out.copy_(res)
    _check_head_dim(d)
    if q.stride(-1) != 1:
        q = q.contiguous()
    if out is None or out.stride(-1) != 1:
        dst = torch.empty((b, nh, ng, d), dtype=q.dtype, device=q.device)
    else:
        dst = out
    _launch(q, k.contiguous(), v.contiguous(), None, rel_t[:2 * t - 1].contiguous(), dst,
            t, s, scale, BAND_TABLE | (BAND_ROUND if band_round else 0))
    return dst if out is None or dst is out else out.copy_(dst)


def fused_pooled_attention(q, k, v, band, scale: float) -> torch.Tensor:
    """K3 on (BH, Ng, d) grid queries against (BH, Nk, d) k/v (class token
    last) with a (BH, Ng, Nk - 1) band; returns (BH, Ng, d)."""
    bh, ng, d = q.shape
    nk = k.shape[1]
    _check(q, k, v, bh, d, (("band", band, (bh, ng, nk - 1)),))
    if not use_kernel(q):
        return pooled_attention_math(q, k, v, band, scale)
    _check_head_dim(d)
    out = torch.empty((1, bh, ng, d), dtype=q.dtype, device=q.device)
    _launch(q.contiguous()[None], k.contiguous(), v.contiguous(), band.float().contiguous(),
            None, out, nk - 1, 1, scale, 0)
    return out[0]


def _launch(q, k, v, band, rel, out, t, s, scale, flags):
    """The C entry of ``csrc/mvit_attention.cu`` on q and out (B, nh, Nq, d)
    through their strides (``mvit_block.cu`` drives the same entry with K4's
    flags)."""
    global LAUNCHES
    from .build import load

    b, nh, ng, d = q.shape
    if b * nh == 0 or ng == 0:
        return
    lib = load()
    ptr = lambda a: ctypes.c_void_p(None if a is None else a.data_ptr())  # noqa: E731
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.avdd_pooled_attention(
            ptr(q), ptr(k), ptr(v), ptr(band), ptr(rel), ptr(out),
            b, nh, ng, k.shape[1], d, t, s, *q.stride()[:3], *out.stride()[:3],
            ctypes.c_float(scale), flags, 0 if q.dtype == torch.float32 else 1,
            ctypes.c_void_p(stream), ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"pooled attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    ROUTES[ROUTE_NAMES[route.value]] += 1

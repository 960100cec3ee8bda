"""The MViT encoder's plain math, op for op as the JAX XLA path rounds it.

The eager blocks of ``frontends/mvit.py`` run on these, and so do the plain
versions of kernels K3 (``ops/kernels/mvit_attention.py``) and K4
(``ops/kernels/mvit_block.py``):
- LN statistics in f32 (flax's fast variance, clamped at 0),
- compute-dtype products accumulated in f32, rounded once, then the bias
  added in the compute dtype,
- scores and softmax statistics in f32, the exp rounded to the compute dtype
  before the value product, the denominator applied to the f32 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def layer_norm(x, weight, bias, cdtype, eps: float = LN_EPS):
    """flax LayerNorm: f32 statistics with the fast variance clamped at 0,
    ``(x - mu) * (rsqrt(var + eps) * w) + b``, rounded to ``cdtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return ((xf - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()).to(cdtype)


def cdot(a, w):
    """a @ w.T with f32 accumulation, rounded to a's dtype (w: (out, in)).
    On the card a bf16 product goes to cuBLAS in bf16, which accumulates in
    f32 and rounds once (set_numerics keeps its split-K sums in f32)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.matmul(a, w.to(a.dtype).t())
    return torch.matmul(a.float(), w.float().t()).to(a.dtype)


def fmatmul(a, b):
    """a @ b of compute-dtype values with an f32 result (exact products, f32
    sums), broadcasting batch dims. On the card bf16 operands go to cuBLAS
    as they are, with an f32 output, instead of through f32 copies."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if b.dim() == 2:        # one matrix: fold a's batch into the rows
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
        return out.reshape(*batch, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def softmax_pv(att, v):
    """The XLA path's softmax and value product: ``att`` f32 scores (consumed
    in place), the exp rounded to v's dtype, z summed from the rounded exps
    in f32, P.V in f32 divided by z, rounded once."""
    att -= att.amax(-1, keepdim=True)
    e = att.exp_().to(v.dtype)
    z = e.sum(-1, keepdim=True, dtype=torch.float32)
    return (fmatmul(e, v) / z).to(v.dtype)


def dense(a, w, b):
    """flax Dense in a's compute dtype: rounded product, then + bias."""
    return cdot(a, w.to(a.dtype)) + b.to(a.dtype)


def gelu(h):
    """Exact GELU of compute-dtype values, in f32, rounded back."""
    return F.gelu(h.float()).to(h.dtype)


def token_pool(z, taps, thw, stride, ln_w, ln_b):
    """TokenPool: depthwise conv (3,3,3), padding 1, of the (B, nh, 1 + N, d)
    head tokens over the (T, Hs, Ws) grid, the class token split off and
    re-attached, then the per-head LN (after re-attaching). ``taps`` is
    (27, d) f32 holding compute-dtype values. Returns (tokens, new thw)."""
    cd = z.dtype
    b, nh, _, d = z.shape
    t, hs, ws = thw
    cls, g = z[:, :, :1], z[:, :, 1:]
    g = g.reshape(b * nh, t, hs, ws, d).permute(0, 4, 1, 2, 3).float()
    w = taps.float().t().reshape(d, 1, 3, 3, 3)
    # cuDNN runs this depthwise conv as ~85 small launches per call on an
    # H100 (31% of an MViT-v2-b forward, PERF.md); PyTorch's own depthwise
    # 3D kernel does it in one, accumulating in f32 as well
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv3d(g, w, None, stride=stride, padding=1, groups=d).to(cd)
    new_thw = tuple(y.shape[2:])
    y = y.permute(0, 2, 3, 4, 1).reshape(b, nh, -1, d)
    return layer_norm(torch.cat([cls, y], dim=2), ln_w, ln_b, cd), new_thw


def toeplitz_band(qg, rel_t, t: int, round_to=None):
    """band[..., n, k] = qg[..., n, :] . rel_t[t_n - k + t - 1] for grid rows
    qg (..., t, S, d) (t-major) against the t pooled keys; an index gather in
    place of the TPU kernel's reshape shear. Returns (..., t * S, t) f32,
    rounded through ``round_to`` first when given."""
    # one zero row makes the 2t - 1 table rows an even 2t columns: cuBLAS
    # runs odd widths on an unaligned, slower kernel
    g = fmatmul(qg, F.pad(rel_t[:2 * t - 1], (0, 0, 0, 1)).t())       # (..., t, S, 2t)
    if round_to is not None:
        g = g.to(round_to).float()
    ar = torch.arange(t, device=qg.device)
    idx = (ar[:, None] - ar[None, :] + t - 1)                          # (t_q, k)
    idx = idx[:, None, :].expand(t, qg.shape[-2], t)
    band = torch.gather(g, -1, idx.expand(*g.shape[:-1], t))
    return band.reshape(*g.shape[:-3], t * qg.shape[-2], t)

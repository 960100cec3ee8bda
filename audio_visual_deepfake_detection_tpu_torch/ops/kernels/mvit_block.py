"""Whole MViT MultiscaleBlock K4: the CUDA kernels, their plain version and
the packing (JAX ``ops/pallas/mvit_block.py``).

The block is the steady-state stride-1 MultiscaleBlock whose k/v pool to a
(T, 1, 1) grid: LN1 -> qkv -> three depthwise (3,3,3) TokenPools with a
per-head LN -> pooled attention with the temporal rel-pos band -> residual
pool -> proj -> residual -> LN2 -> MLP (exact GELU) -> residual.

``fused_multiscale_block`` launches ``csrc/mvit_block.cu`` for a CUDA tensor
on an sm_90 card (replacing ``fused_multiscale_block``, ``pallas_call`` at
``mvit_block.py:343``) and runs ``msblock_math`` for a CPU tensor.
``msblock_math`` follows the XLA path of the JAX ``MultiscaleBlock`` /
``MultiscaleAttention`` (``frontends/mvit.py:262-504``) op for op, on the
shared helpers of ``ops/mvit_math.py``:
- LN statistics in f32 (flax's fast variance, clamped at 0),
- compute-dtype products accumulated in f32, rounded once, then the bias
  added in the compute dtype,
- q pre-scaled in the compute dtype; scores and softmax statistics in f32,
  the exp rounded to the compute dtype before the value product, the
  denominator applied to the f32 output,
- the temporal band ``band[n, k] = q[n] . rel_t[t_n - k + T - 1]`` rounded to
  the compute dtype when the spatial grid has at most 4 cells (the XLA
  Toeplitz branch, ``mvit.py:329-347``) and kept in f32 otherwise.
The JAX packing's 128-lane padding, tiled tap vectors and 0/1 head-select
matrices are TPU layout and are not carried over: ``pack_msblock_params``
keeps torch's (out, in) weights and per-head (27, d) taps.

In bfloat16 the kernel's four products run on ``wgmma`` from those (out, in)
weights as they are (rows along the contraction are what its shared-memory
operand wants), so the packing has no layout of its own for the card. In
float32 they run in 3xTF32 (``csrc/mvit_block_f32.cu``): the packing adds
``split``, the four weights and the temporal table split once into TF32
high parts and residuals (``tf32_split``, the table's head dim padded to a
multiple of 32), which the kernel reads instead of splitting them on every
call; ``msblock_math`` keeps to the f32 weights.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...core.runtime import use_kernel
from ..mvit_math import dense, fmatmul, gelu, layer_norm, softmax_pv, token_pool, toeplitz_band
from .fused_block import tf32_split

MAX_SPATIAL = 16     # the port's gate takes stage 2 (S = 16) too
MAX_HEAD_DIM = 128

# kernel launches since the last reset: one per block (CPU calls and plain
# runs never count)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


# ----------------------------------------------------------------- packing

class MSBlockPacked(NamedTuple):
    ln1: torch.Tensor       # (2, C) f32: weight, bias
    wqkv: torch.Tensor      # (3C, C) compute dtype, torch (out, in)
    bqkv: torch.Tensor      # (3C,) f32
    taps: torch.Tensor      # (3, 27, d) f32 of compute-dtype values: q, k, v
    pool_ln: torch.Tensor   # (3, 2, d) f32
    rel_t: torch.Tensor     # (R, d) compute dtype, R >= 2T - 1
    wp: torch.Tensor        # (C, C)
    bp: torch.Tensor        # (C,)
    ln2: torch.Tensor       # (2, C)
    w1: torch.Tensor        # (4C, C)
    b1: torch.Tensor        # (4C,)
    w2: torch.Tensor        # (C, 4C)
    b2: torch.Tensor        # (C,)
    # float32 only: wqkv, wp, w1, w2 and rel_t (padded to head_width(d)
    # columns) split, each hi then lo, flat f32 (split_weights); else None
    split: Optional[torch.Tensor] = None


def head_width(d: int) -> int:
    """The f32 kernel's padded head dim: a multiple of 32."""
    return -(-d // 32) * 32


def split_weights(wqkv, wp, w1, w2, rel_t) -> torch.Tensor:
    """The f32 kernel's TF32 operands of the four weights and the table, in
    one flat f32 buffer: each tensor's hi then its lo (``tf32_split``), the
    table (R, d) zero-padded to (R, head_width(d))."""
    d = rel_t.shape[1]
    rel = F.pad(rel_t.float(), (0, head_width(d) - d))
    return torch.cat([part.reshape(-1) for w in (wqkv, wp, w1, w2, rel)
                      for part in tf32_split(w.float())])


def pack_msblock_params(params, n_head: int, cdtype) -> MSBlockPacked:
    """A MultiscaleBlock's torchvision-named parameters (``norm1.weight``,
    ``attn.qkv.weight``, ``attn.pool_q.pool.weight``, ...) -> kernel inputs
    (in float32 with ``split``)."""
    def f32(name):
        return params[name].detach().float().contiguous()

    def mat(name):
        return params[name].detach().to(cdtype).contiguous()

    def rounded(name):
        return params[name].detach().to(cdtype).float()

    c = params["norm1.weight"].shape[0]
    d = c // n_head
    taps = torch.stack([rounded(f"attn.pool_{w}.pool.weight").reshape(d, 27).t()
                        for w in "qkv"]).contiguous()
    pool_ln = torch.stack([torch.stack([f32(f"attn.pool_{w}.norm_act.0.weight"),
                                        f32(f"attn.pool_{w}.norm_act.0.bias")])
                           for w in "qkv"]).contiguous()
    packed = MSBlockPacked(
        ln1=torch.stack([f32("norm1.weight"), f32("norm1.bias")]),
        wqkv=mat("attn.qkv.weight"), bqkv=f32("attn.qkv.bias"),
        taps=taps, pool_ln=pool_ln,
        rel_t=mat("attn.rel_pos_t"),
        wp=mat("attn.project.weight"), bp=f32("attn.project.bias"),
        ln2=torch.stack([f32("norm2.weight"), f32("norm2.bias")]),
        w1=mat("mlp.0.weight"), b1=f32("mlp.0.bias"),
        w2=mat("mlp.3.weight"), b2=f32("mlp.3.bias"))
    if cdtype != torch.float32:
        return packed
    return packed._replace(split=split_weights(packed.wqkv, packed.wp, packed.w1, packed.w2,
                                               packed.rel_t))


# -------------------------------------------------------------- plain math

def msblock_math(x, p: MSBlockPacked, *, t: int, grid_hw, n_head: int) -> torch.Tensor:
    """Plain version: x (B, 1 + t*hs*ws, C) in the compute dtype -> same."""
    cd = x.dtype
    b, n, c = x.shape
    hs, ws = grid_hw
    s = hs * ws
    d = c // n_head
    xn = layer_norm(x, p.ln1[0], p.ln1[1], cd)
    qkv = dense(xn, p.wqkv, p.bqkv).reshape(b, n, 3, n_head, d).permute(2, 0, 3, 1, 4)
    thw = (t, hs, ws)
    q, _ = token_pool(qkv[0], p.taps[0], thw, (1, 1, 1), *p.pool_ln[0])
    k, _ = token_pool(qkv[1], p.taps[1], thw, (1, hs, ws), *p.pool_ln[1])
    v, _ = token_pool(qkv[2], p.taps[2], thw, (1, hs, ws), *p.pool_ln[2])
    qs = q * torch.tensor(d ** -0.5, dtype=cd, device=x.device)
    att = fmatmul(qs, k.transpose(2, 3))                             # (b, nh, n, t+1)
    att[:, :, 1:, 1:] += toeplitz_band(q[:, :, 1:].reshape(b, n_head, t, s, d), p.rel_t, t,
                                       round_to=cd if s <= 4 else None)
    o = softmax_pv(att, v)
    o = o + F.pad(q[:, :, 1:], (0, 0, 1, 0))
    ctx = o.transpose(1, 2).reshape(b, n, c)
    y1 = x + dense(ctx, p.wp, p.bp)
    h = gelu(dense(layer_norm(y1, p.ln2[0], p.ln2[1], cd), p.w1, p.b1))
    return y1 + dense(h, p.w2, p.b2)


# ----------------------------------------------------------------- wrapper

def fused_multiscale_block(x, p: MSBlockPacked, *, t: int, grid_hw,
                           n_head: int) -> torch.Tensor:
    """One block. x (B, 1 + t*hs*ws, C) in float32 or bfloat16."""
    b, n, c = x.shape
    hs, ws = grid_hw
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"multiscale block takes float32 or bfloat16, got {x.dtype}")
    if n != 1 + t * hs * ws or c % n_head or hs * ws > MAX_SPATIAL:
        raise ValueError(f"multiscale block: x {tuple(x.shape)} does not fit t={t}, "
                         f"grid {grid_hw}, {n_head} heads (S <= {MAX_SPATIAL})")
    if p.rel_t.shape[0] < 2 * t - 1:
        raise ValueError(f"rel_pos_t has {p.rel_t.shape[0]} rows, t={t} needs {2 * t - 1}")
    if not use_kernel(x):
        return msblock_math(x, p, t=t, grid_hw=grid_hw, n_head=n_head)
    return _launch(x.contiguous(), p, t, hs, ws, n_head)


def _launch(x, p, t, hs, ws, n_head):
    global LAUNCHES
    from .build import load

    b, n, c = x.shape
    d = c // n_head
    if d > MAX_HEAD_DIM or d % 4 or c % 64:
        raise ValueError(f"multiscale block kernel takes C % 64 == 0 and head_dim "
                         f"<= {MAX_HEAD_DIM} (multiple of 4); got C={c}, d={d}")
    cd = x.dtype
    f32 = cd == torch.float32
    for name, a in zip(MSBlockPacked._fields, p):
        if name == "split":
            want = (24 * c * c + 2 * p.rel_t.shape[0] * head_width(d),) if f32 else None
            if (a is None) != (want is None) or (a is not None and (
                    tuple(a.shape) != want or a.dtype != torch.float32
                    or a.device != x.device or not a.is_contiguous())):
                raise ValueError(f"packed split: expected {want} f32 on {x.device}, got "
                                 f"{None if a is None else (tuple(a.shape), a.dtype)}")
            continue
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"packed {name} must be contiguous on {x.device}")
        if a.dtype != (cd if name in ("wqkv", "rel_t", "wp", "w1", "w2") else torch.float32):
            raise ValueError(f"packed {name} has dtype {a.dtype}")
    out = torch.empty((b, n, c), dtype=cd, device=x.device)
    if b == 0:
        return out
    # scratch the launches hand to one another, carved from one allocation
    # (a call's host time is what a small batch waits for), in the kernel's
    # argument order: qkv (b, n, 3c), qp (b, n, c), kvp, ctx, y1 (b, n, c),
    # hid (b, n, 4c) in the compute dtype, then the LN row statistics (b, n,
    # 2) f32. kvp: bf16 the pooled k and v (2, b, nh, t + 1, d); f32 k split
    # (2, b nh, t, w), v split and transposed (2, b nh, w, tp) and the class
    # token's k and v (2, b nh, d), w = head_width(d), tp = t rounded up to 32
    rows, es, bhn = b * n, x.element_size(), b * n_head
    kvp = 2 * bhn * (t + 1) * d * es
    if f32:
        w, tp = head_width(d), -(-t // 32) * 32
        kvp = 4 * (2 * bhn * t * w + 2 * bhn * w * tp + 2 * bhn * d)
    sizes = [rows * 3 * c * es, rows * c * es, kvp, rows * c * es, rows * c * es,
             rows * 4 * c * es, rows * 2 * 4]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + (size + 255) // 256 * 256)
    scratch = torch.empty(offsets[-1], dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    lib = load()
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.avdd_msblock(
            ptr(x), *(ptr(a) for a in p[:-1]), ctypes.c_void_p(p.split.data_ptr() if f32 else None),
            *(ctypes.c_void_p(base + o) for o in offsets[:-1]), ptr(out), b, t, hs, ws, c,
            n_head, p.rel_t.shape[0], 0 if f32 else 1, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"multiscale block kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

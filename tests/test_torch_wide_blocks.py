"""PyTorch port, the fused block (K1 / K6) and banded attention (K7) at the
block shapes beyond the production one, against the JAX package on the CPU.

The fused block kernel takes C a multiple of 64 up to 1024, head widths 32,
64, 96 and 128, any half window or dense attention
(``fused_block.kernel_shape_ok``), the band kernel half windows up to 16
(``band_attention.kernel_shape_ok``); the Pallas kernels are generated per
shape. On the CPU each wrapper runs its plain version, so these tests hold
the plain versions and the blocks built on them to the JAX package at those
shapes:

- ``block_math`` in f32 against the JAX ``block_math`` at the production
  block and at C 512, 4 heads, dense, T >= 64, all four modes (2e-5);
- ``block_math`` against the JAX ``block_math`` on the same packed inputs,
  the port's ``TransformerBlock`` against the JAX XLA block, and the port's
  eval and training entries against the Pallas kernel in interpret mode,
  for d_head 32 / 64 / 96 / 128 and w = 9 and 16 at T = 48, dense at T =
  130 and w = 17 and 20 (the card's tensor-core attention) at T = 150 (f32
  2e-5, bf16 2e-2, the JAX package's kernel tolerances);
- the K6 gradients against ``jax.vjp`` of the JAX
  ``fused_transformer_block_train`` at C = 128, one head of 128, w = 9, with
  droppath coefficients (2e-4; parameters 5e-4 of the leaf's largest);
- ``band_attention_plain`` against ``band_attention_pallas`` in interpret
  mode at w = 9, 15 and 16 (f32 1e-5, bf16 2e-2);
- the two shape rules themselves.
The localizer at those shapes is in tests/test_torch_wide_localizer.py."""

import torch_one_thread  # noqa: F401

import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.models.blocks import TransformerBlock as JBlock
from audio_visual_deepfake_detection_tpu.ops.pallas import band_attention as jband
from audio_visual_deepfake_detection_tpu.ops.pallas import fused_block as jfb
from audio_visual_deepfake_detection_tpu_torch.models.blocks import TransformerBlock
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as tband
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as tfb
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    block_state_dict_from_flax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_variants import random_tree  # noqa: E402

B, T = 2, 48
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
CROSS = {"self": False, "ds_self": False, "qv_k": True, "kv": True}
# (C, heads, window, T): head widths 32, 64, 96 and 128 at half windows 9 and
# 16; dense and half windows past 16 (the card's tensor-core attention) at
# lengths that are no multiple of its 64-key tiles
SHAPES = [(128, 4, 19, T), (128, 2, 33, T), (192, 2, 33, T), (128, 1, 19, T),
          (128, 4, -1, 130), (128, 2, 41, 150), (128, 4, 35, 150)]
SHAPE_IDS = [f"C{c}-h{h}-w{w // 2}" if t == T else
             f"C{c}-h{h}-{'dense' if w < 0 else f'w{w // 2}'}-T{t}" for c, h, w, t in SHAPES]


# ------------------------------------------------------------ the block

def _mask(t=T):
    m = np.ones((B, t), bool)
    m[0, t - 5:] = False
    m[1, t // 4:] = False
    return m


def _setup(rng, c, heads, mode, window, t=T):
    """JAX block params + inputs. The parameters are drawn on the block's
    shapes (``random_tree``: O(1) layer scales, LN affines 1 + 0.3 N, biases
    0.1 N, so every branch of the block counts), not by its init, which would
    compile the block once more."""
    mask = _mask(t)
    mf = mask[..., None].astype(np.float32)
    x = rng.standard_normal((B, t, c)).astype(np.float32) * mf
    xo = rng.standard_normal((B, t, c)).astype(np.float32) * mf
    cross = CROSS[mode]

    def make(det):
        return JBlock(n_embd=c, n_head=heads, window_size=window,
                      ds_stride=2 if mode == "ds_self" else 1, cross=cross, deterministic=det)

    kw = {} if not cross else dict(x_k=jnp.asarray(xo), mask_k=jnp.asarray(mask),
                                   x_v=jnp.asarray(xo if mode == "kv" else x),
                                   mask_v=jnp.asarray(mask))
    shapes = jax.eval_shape(lambda: make(True).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                    jnp.asarray(mask), **kw))["params"]
    return make, kw, random_tree(shapes, rng), x, xo, mask


@functools.lru_cache(maxsize=None)
def _jax_block_math(n_head, w_overlap, mode):
    return jax.jit(functools.partial(jfb.block_math, n_head=n_head, w_overlap=w_overlap,
                                     mode=mode))


def _kernel_args(mode, x, xo, mask):
    if mode == "ds_self":
        return x[:, 0::2], x[:, 1::2], mask[:, 0::2]
    return x, (xo if CROSS[mode] else None), mask


def _torch_layout(jpacked):
    """JAX packed inputs as numpy, dense weights (in, out) -> (out, in)."""
    return [np.array(a, np.float32).T if i in range(1, 7) else np.array(a, np.float32)
            for i, a in enumerate(jpacked)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("mode", ["self", "qv_k", "kv", "ds_self"])
@pytest.mark.parametrize("c,heads,window,t", SHAPES, ids=SHAPE_IDS)
def test_block_matches_jax(rng, c, heads, window, t, mode):
    """f32: the port's block (K1's entry, plain on the CPU) against the JAX
    block's XLA path, the masks exactly. bf16: ``block_math`` against the
    JAX ``block_math`` on the same packed inputs, with droppath
    coefficients; the packing itself to 1e-6."""
    make, kw, p, x, xo, mask = _setup(rng, c, heads, mode, window, t=t)
    ref, ref_mask = jax.jit(lambda prm, xv, mv: make(True).apply({"params": prm}, xv, mv, **kw))(
        p, jnp.asarray(x), jnp.asarray(mask))
    ours = TransformerBlock(c, heads, ds_stride=2 if mode == "ds_self" else 1,
                            window_size=window, cross=CROSS[mode])
    ours.load_state_dict(block_state_dict_from_flax(p), strict=True)
    tfb.reset_launches()
    with torch.no_grad():
        if CROSS[mode]:
            got, got_mask = ours(_t(x), _t(mask), xo=_t(xo), mode=mode)
        else:
            got, got_mask = ours(_t(x), _t(mask))
    assert tfb.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    assert np.array_equal(got_mask.numpy(), np.asarray(ref_mask))

    jpacked = jfb.pack_block_params(p, c, CROSS[mode], jnp.bfloat16)
    tpacked = tfb.pack_block_params(block_state_dict_from_flax(p), c, CROSS[mode],
                                    torch.bfloat16)
    jnp_packed = _torch_layout(jpacked)
    for a, b in zip(jnp_packed, tpacked):
        np.testing.assert_allclose(b.float().numpy(), a, rtol=1e-6, atol=1e-6)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    xb = xa if xb is None else xb
    mrow = m.astype(np.float32)[..., None]
    coefs = np.array([[1.0, 1 / 0.9], [0.0, 1.0]], np.float32)
    bf = jnp.bfloat16
    ref = _jax_block_math(heads, window // 2, mode)(
        jnp.asarray(xa, bf), jnp.asarray(xb, bf), jnp.asarray(mrow), jnp.asarray(coefs),
        *jpacked)
    tin = [_t(a, torch.float32 if i in (0, 7) else torch.bfloat16)
           for i, a in enumerate(jnp_packed)]
    got = tfb.block_math(_t(xa, torch.bfloat16), _t(xb, torch.bfloat16), _t(mrow), _t(coefs),
                         *tin, n_head=heads, w_overlap=window // 2, mode=mode)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **BF16_TOL)


# f32, the compute dtype of every shipped YAML: the production block (C 256,
# 4 heads, window 7) and the ConvTransformer's default (C 512, 4 heads,
# dense), T >= 64
F32_SHAPES = [(256, 4, 7, 64), (512, 4, -1, 96)]


@pytest.mark.parametrize("mode", ["self", "qv_k", "kv", "ds_self"])
@pytest.mark.parametrize("c,heads,window,t", F32_SHAPES, ids=["C256-h4-w3-T64", "C512-h4-dense-T96"])
def test_f32_block_math_matches_jax(rng, c, heads, window, t, mode):
    """``block_math`` in f32 against the JAX ``block_math`` on the same f32
    packed inputs, with droppath coefficients (the f32 block tolerance,
    2e-5): the function the f32 kernel is held to on the card."""
    _, _, p, x, xo, mask = _setup(rng, c, heads, mode, window, t=t)
    jpacked = jfb.pack_block_params(p, c, CROSS[mode], jnp.float32)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    xb = xa if xb is None else xb
    mrow = m.astype(np.float32)[..., None]
    coefs = np.array([[1.0, 1 / 0.9], [0.0, 1.0]], np.float32)
    ref = _jax_block_math(heads, window // 2, mode)(
        jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(mrow), jnp.asarray(coefs), *jpacked)
    tin = [_t(a) for a in _torch_layout(jpacked)]
    got = tfb.block_math(_t(xa), _t(xb), _t(mrow), _t(coefs), *tin, n_head=heads,
                         w_overlap=window // 2, mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


ENTRY_CASES = [(128, 4, 19, "qv_k", 32), (128, 2, 33, "ds_self", 32), (192, 2, 33, "kv", 32),
               (128, 1, 19, "self", 32), (128, 2, 41, "self", 48)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,heads,window,mode,t", ENTRY_CASES,
                         ids=SHAPE_IDS[:4] + ["C128-h2-w20-T48"])
def test_entries_match_pallas_kernel_interpret(rng, c, heads, window, mode, t, dtype):
    """K1's and K6's entries against the Pallas kernel, whose grid is
    generated for the shape, in interpret mode (T = 32; at w = 20, T = 48)."""
    _, _, p, x, xo, mask = _setup(rng, c, heads, mode, window, t=t)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    jpacked = jfb.pack_block_params(p, c, CROSS[mode], jdt)
    tpacked = tfb.pack_block_params(block_state_dict_from_flax(p), c, CROSS[mode], tdt)
    coefs = np.array([[1 / 0.9, 0.0], [1.0, 1 / 0.9]], np.float32)
    kw = dict(n_head=heads, w_overlap=window // 2, mode=mode)
    jx = [jnp.asarray(xa, jdt), None if xb is None else jnp.asarray(xb, jdt), jnp.asarray(m)]
    tx = [_t(xa, tdt), None if xb is None else _t(xb, tdt), _t(m)]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    ref = jfb.fused_transformer_block(*jx, *jpacked, interpret=True, **kw)
    got = tfb.fused_transformer_block(*tx, *tpacked, **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)
    ref = jfb.fused_transformer_block_train(*jx, jnp.asarray(coefs), *jpacked, interpret=True,
                                            **kw)
    tfb.reset_launches()
    got = tfb.fused_transformer_block_train(*tx, _t(coefs), *tpacked, **kw)
    assert tfb.LAUNCHES == 0 and tfb.TRAIN_LAUNCHES == 0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("mode", ["kv"])
def test_train_grads_match_jax_vjp_at_head_width_128(rng, mode):
    """C = 128, one head of 128, w = 9, a cross block, droppath coefficients
    from {0, 1/0.9}: the K6 entry's gradients of x, xo and the 8 packed
    tensors against ``jax.vjp`` of the JAX ``fused_transformer_block_train``
    (Pallas forward in interpret mode, backward through its mirror)."""
    c, heads, window = 128, 1, 19
    _, _, p, x, xo, mask = _setup(rng, c, heads, mode, window)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    coefs = np.array([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], np.float32)
    jpacked = jfb.pack_block_params(p, c, CROSS[mode], jnp.float32)
    g = rng.standard_normal(xa.shape).astype(np.float32)
    kw = dict(n_head=heads, w_overlap=window // 2, mode=mode)
    jm, jc = jnp.asarray(m), jnp.asarray(coefs)
    if xb is None:
        fn = lambda xv, *pk: jfb.fused_transformer_block_train(  # noqa: E731
            xv, None, jm, jc, *pk, interpret=True, **kw)
        prim = [jnp.asarray(xa)] + list(jpacked)
    else:
        fn = lambda xv, xov, *pk: jfb.fused_transformer_block_train(  # noqa: E731
            xv, xov, jm, jc, *pk, interpret=True, **kw)
        prim = [jnp.asarray(xa), jnp.asarray(xb)] + list(jpacked)
    ref = [np.asarray(a) for a in jax.jit(lambda *a: jax.vjp(fn, *a)[1](jnp.asarray(g)))(*prim)]
    leaves = [_t(a).requires_grad_(True) for a in ([xa] if xb is None else [xa, xb])]
    packed = [_t(a).requires_grad_(True) for a in _torch_layout(jpacked)]
    y = tfb.fused_transformer_block_train(leaves[0], None if xb is None else leaves[1], _t(m),
                                          _t(coefs), *packed, **kw)
    (y * _t(g)).sum().backward()
    got = [a.grad.numpy() for a in leaves] + _torch_layout([a.grad.numpy() for a in packed])
    assert len(got) == len(ref)
    for i, (a, r) in enumerate(zip(got, ref)):
        if i < len(leaves):
            np.testing.assert_allclose(a, r, rtol=2e-4, atol=2e-4)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(np.asarray(a).reshape(r.shape) / scale, r / scale,
                                       rtol=5e-4, atol=5e-4, err_msg=f"packed {i}")


# ------------------------------------- the tensor-core attention's tiling

KT, AT_ROWS = 64, 128          # csrc/fused_block_attend.cu: keys a tile, query rows a block


def _attend_tiles(q, k, v, valid, n_head, w):
    """csrc/fused_block_attend.cu's arithmetic in torch, bf16 (B, T, C) q
    (scaled), k, v and a (B, T) bool mask: per (sample, head, block of 128
    query rows) the key tiles of 64 it visits (all; a band: those meeting
    [r0 - w, r0 + 127 + w]), scores f32-summed and rounded, the masks
    (dense: rnd16(-1e30) on invalid keys, -inf past T; banded: the rounded
    -1e4 penalty, -1e30 outside the band and T), pass 1 a running maximum
    and a denominator rescaled tile by tile, pass 2 p = rnd16(e * (1 / den))
    (dense: 0 on invalid keys), P.V in f32, rounded; invalid rows zero."""
    bf = torch.bfloat16
    b, t, c = q.shape
    d = c // n_head
    fill = torch.tensor(tfb.NEG_INF, dtype=bf).float()
    pen = torch.tensor(tfb.NEG_PENALTY, dtype=bf)
    out = torch.zeros_like(q)
    for bi in range(b):
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            for r0 in range(0, t, AT_ROWS):
                rows = torch.arange(r0, min(r0 + AT_ROWS, t))
                lo, hi = 0, (t - 1) // KT
                if w > 0:
                    lo, hi = max(r0 - w, 0) // KT, min(r0 + AT_ROWS - 1 + w, t - 1) // KT

                def tile(j):
                    keys = torch.arange(j * KT, (j + 1) * KT)
                    inseq = keys < t
                    at = keys.clamp(max=t - 1)
                    kk = k[bi, at, sl].float() * inseq[:, None]
                    sc = (q[bi, rows, sl].float() @ kk.T).to(bf)
                    ok = inseq & valid[bi, at]
                    if w > 0:
                        sc = torch.where(ok[None], sc, sc + pen).float()
                        far = (keys[None] - rows[:, None]).abs() > w
                        sc = torch.where(far | ~inseq[None], tfb.NEG_INF, sc)
                    else:
                        sc = torch.where(ok[None], sc.float(),
                                         torch.where(inseq[None], fill, -math.inf))
                    return sc, ok, v[bi, at, sl].float() * inseq[:, None]

                m = torch.full((len(rows),), -math.inf)
                z = torch.zeros(len(rows))
                for j in range(lo, hi + 1):
                    sc, _, _ = tile(j)
                    mn = torch.maximum(m, sc.amax(1))
                    z = z * torch.exp(m - mn) + torch.exp(sc - mn[:, None]).sum(1)
                    m = mn
                inv = 1.0 / z
                acc = torch.zeros(len(rows), d)
                for j in range(lo, hi + 1):
                    sc, ok, vv = tile(j)
                    pr = (torch.exp(sc - m[:, None]) * inv[:, None]).to(bf).float()
                    if w <= 0:
                        pr = pr * ok[None]
                    acc += pr @ vv
                out[bi, rows, sl] = acc.to(bf) * valid[bi, rows][:, None]
    return out


@pytest.mark.parametrize("t,heads,d,w", [(150, 2, 64, 0), (65, 4, 32, 0), (24, 1, 128, 0),
                                         (1, 2, 96, 0), (150, 2, 64, 20), (300, 1, 32, 48),
                                         (130, 2, 96, 100), (24, 4, 32, 17)])
def test_tensor_core_attention_tiling_matches_plain(rng, t, heads, d, w):
    """The tensor-core attention's tiling and online softmax (torch
    rendering) against the plain ``attention_ctx`` in bf16, dense and w >
    16, at ragged T: a padded tail, a fully padded sample, a band wider
    than T (2e-2, the bf16 block tolerance)."""
    c = heads * d
    lens = [t, (3 * t) // 4, 0]
    valid = torch.from_numpy(np.arange(t)[None, :] < np.asarray(lens)[:, None])
    q, k, v = (_t(rng.standard_normal((3, t, c)).astype(np.float32), torch.bfloat16)
               for _ in range(3))
    q = (q.float() * d ** -0.5).to(torch.bfloat16)
    got = _attend_tiles(q, k, v, valid, heads, w)
    ref = tfb.attention_ctx(q, k, v, valid.float()[..., None], n_head=heads, w_overlap=w)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), **BF16_TOL)


# ------------------------------------------------------------ K7

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [9, 15, 16])
def test_band_plain_matches_pallas_interpret_beyond_w8(rng, w, dtype):
    """Partial masks, a fully masked sample, and T both above and below
    2w + 1."""
    for t, lens in ((48, (48, 30, 0)), (20, (20, 11, 3))):
        q = (rng.standard_normal((3, 2, t, 32)) * 32 ** -0.5).astype(np.float32)
        k, v = (rng.standard_normal((3, 2, t, 32)).astype(np.float32) for _ in range(2))
        valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        ref = jband.band_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                          jnp.asarray(v, jdt), jnp.asarray(valid), w,
                                          interpret=True)
        tband.reset_launches()
        got = tband.band_attention_kernel(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(valid), w)
        assert tband.LAUNCHES == 0 and got.dtype == tdt
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_quotient_from_reciprocal_rounds_as_division_up_to_w16():
    """The K7 kernel's quotient rnd(e * (1 / den)) equals rnd(e / den) bit
    for bit for every bf16 e in [0, 1] and den in [17, 33], the sums of the
    exps that w = 9 .. 16 adds to those of w <= 8."""
    e = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    den = torch.arange(0x4188, 0x4205, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    assert e.max() == 1 and den.min() == 17 and den.max() == 33
    by_reciprocal = (e[:, None] * (1.0 / den)[None, :]).to(torch.bfloat16)
    by_division = (e[:, None] / den[None, :]).to(torch.bfloat16)
    assert torch.equal(by_reciprocal.view(torch.int16), by_division.view(torch.int16))


# ------------------------------------------------------------ the shape rules

@pytest.mark.parametrize("c,heads,w,ok", [
    (256, 4, 3, True), (512, 4, 9, True), (256, 8, 3, True), (384, 4, 16, True),
    (1024, 8, 0, True), (1024, 8, -1, True), (64, 2, 1, True), (1024, 32, 16, True),
    (960, 10, 5, True), (192, 2, 16, True),
    (1088, 17, 3, True), (1088, 8, 3, True), (192, 4, 3, True), (256, 1, 3, True),
    (256, 4, 17, True), (256, 4, 48, True), (96, 1, 3, False), (32, 1, 3, False),
    (320, 4, 3, True), (256, 3, 3, False),
    (2048, 16, 9, True), (2048, 4, 0, True), (1536, 12, 18, True), (128, 16, 3, True),
    (512, 1, 3, True), (384, 8, 9, True),
    (2112, 8, 3, False), (1024, 1, 3, False), (256, 64, 3, False), (384, 32, 3, False),
    (352, 4, 3, False), (2176, 17, 0, False)])
def test_fused_block_shape_rule(c, heads, w, ok):
    """Domain corners taken, at any window (w = 17 and 48: the tensor-core
    attention): C a multiple of 64 up to 2048, head widths that are
    multiples of 8 from 8 to 512 (48, 80, 136, 256 and 512 included); C =
    2112, head width 1024, 4 or 12, C not a multiple of 64 refused. On the
    CPU a refused shape still runs the plain version: the rule is the
    card's."""
    assert tfb.kernel_shape_ok(c, heads, w) is ok
    if ok:
        wgmma = c <= 1024 and c // heads in (32, 64, 96, 128)
        assert tfb.wgmma_shape_ok(c, heads) is wgmma


@pytest.mark.parametrize("d,size,w,ok", [
    (64, 2, 16, True), (128, 2, 15, True), (32, 4, 16, True), (128, 4, 0, True),
    (64, 2, 17, True), (6, 4, 3, False), (136, 4, 3, True), (264, 2, 3, True),
    (64, 2, -1, False),
    (512, 2, 40, True), (512, 4, 100, True), (256, 4, 18, True), (4, 4, 24, True),
    (520, 2, 3, False), (1024, 4, 3, False), (4, 2, 3, False), (12, 2, 3, False)])
def test_band_attention_shape_rule(d, size, w, ok):
    """Any half window; head rows of whole 16-byte pieces up to head_dim 512
    in either dtype (the tiled kernel up to w = 16 and 512-byte rows,
    ``route_of``'s routes beyond)."""
    assert tband.kernel_shape_ok(d, size, w) is ok
    if ok:
        assert tband.tiled(d, size, w) is (w <= 16 and d * size <= 512)
    q = torch.empty((1, 1, 1, d), dtype=torch.bfloat16 if size == 2 else torch.float32)
    if ok:
        tband.kernel_limits(q, w)
    else:
        with pytest.raises(ValueError):
            tband.kernel_limits(q, w)


def test_launch_refuses_a_shape_outside_the_domain():
    """The launch path raises ValueError before reaching the library for a
    shape the kernel does not take: there is no plain fallback on the card."""
    x = torch.zeros((1, 4, 96))
    vecs = torch.zeros((tfb.NUM_VEC_ROWS, 96))
    w = torch.zeros((96, 96))
    with pytest.raises(ValueError, match="fused block kernel takes"):
        tfb._launch(x, None, torch.ones((1, 4), dtype=torch.bool), vecs, w, w, w, w,
                    torch.zeros((384, 96)), torch.zeros((96, 384)), torch.zeros((1, 384)),
                    n_head=1, w_overlap=3, mode="self")

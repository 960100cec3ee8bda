"""PyTorch port, K1 / K6, K7 and K8 at every head width and window of their
domain beyond the wgmma designs, against the JAX package on the CPU.

The fused block kernel takes C a multiple of 64 up to 2048 and head widths
that are multiples of 8 from 8 to 512 (``fused_block.kernel_shape_ok``;
``csrc/fused_block_generic.cu`` runs what ``wgmma_shape_ok`` leaves), the
band kernel any half window and head rows up to 512 wide
(``band_attention.kernel_shape_ok``; ``band_any_kernel`` past w = 16 or 512
bytes), K8 head dims that are multiples of 16 up to 128. On the CPU each
wrapper runs its plain version, so these tests hold the plain versions and
the blocks built on them to the JAX package at those shapes:

- the port's ``TransformerBlock`` (f32) against the JAX block's XLA path and
  ``block_math`` (bf16) against the JAX ``block_math`` at (C, heads) (384,
  8) d 48, (256, 1) d 256, (128, 16) d 8, (320, 4) d 80 and (512, 1) d 512,
  w = 9, 18 and dense, T 48-150, every mode, and K1's and K6's entries
  against the Pallas kernel in interpret mode at d 48, 256 and 8 (f32 2e-5,
  bf16 2e-2);
- the K6 gradients against ``jax.vjp`` at d = 48 (2e-4);
- ``band_attention_plain`` against ``band_attention_pallas`` in interpret
  mode at w = 17 and 24, and at d = 256 in f32 and 512 in bf16 (f32 1e-5,
  bf16 2e-2), and against ``band_attention_xla`` at w = 40 (f32 1e-5);
- the port's K8 math against the JAX ``full_mha`` at d = 16, 48, 96, 128;
- the shipped localizer of ``configs_train/deepfake_exp10.yaml`` with one
  head of 256 and windows of 37 (``exp10-h1-w37``) at T = 576 against the
  JAX package: the outputs;
- torch renderings of the new kernels' tilings against the plain versions:
  the generic block attention's 32-row / 32-key tiles, lane-wise running
  softmax and offset-ordered context; K7's streamed offsets; K8's head dims
  padded to its instances' widths and its context in 64-column halves."""

import torch_one_thread  # noqa: F401

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.models import AVLocalizer as JAVLocalizer
from audio_visual_deepfake_detection_tpu.ops import attention as jattention
from audio_visual_deepfake_detection_tpu.ops.pallas import band_attention as jband
from audio_visual_deepfake_detection_tpu.ops.pallas import fused_block as jfb
from audio_visual_deepfake_detection_tpu.ops.pallas import full_attention as jk8
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig
from audio_visual_deepfake_detection_tpu_torch.models import AVLocalizer
from audio_visual_deepfake_detection_tpu_torch.models.blocks import TransformerBlock
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as tband
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import full_attention as tk8
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as tfb
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    block_state_dict_from_flax, state_dict_from_flax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_full_attention import TOL as K8_TOL, _case as k8_case  # noqa: E402
from test_torch_wide_blocks import (  # noqa: E402
    BF16_TOL, CROSS, F32_TOL, _jax_block_math, _kernel_args, _setup, _t, _torch_layout)
from test_torch_variants import assert_close, localizer_params, ragged  # noqa: E402

# (C, heads, window, T, mode): every new head width at w = 9, 18 and dense,
# each mode at least once
SHAPES = [(384, 8, 19, 48, "self"), (384, 8, -1, 64, "ds_self"), (256, 1, 37, 48, "qv_k"),
          (256, 1, -1, 96, "kv"), (128, 16, 19, 48, "self"), (128, 16, -1, 130, "kv"),
          (320, 4, 37, 150, "ds_self"), (320, 4, 19, 48, "qv_k"), (512, 1, -1, 64, "self"),
          (512, 1, 37, 48, "kv")]
SHAPE_IDS = [f"C{c}-h{h}-{'dense' if w < 0 else f'w{w // 2}'}-T{t}-{m}"
             for c, h, w, t, m in SHAPES]


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("c,heads,window,t,mode", SHAPES, ids=SHAPE_IDS)
def test_block_matches_jax(rng, c, heads, window, t, mode):
    """f32: the port's block (K1's entry, plain on the CPU) against the JAX
    block's XLA path, the masks exactly. bf16: ``block_math`` against the
    JAX ``block_math`` on the same packed inputs, with droppath
    coefficients."""
    assert tfb.kernel_shape_ok(c, heads, window // 2) and not tfb.wgmma_shape_ok(c, heads)
    make, kw, p, x, xo, mask = _setup(rng, c, heads, mode, window, t=t)
    ref, ref_mask = jax.jit(lambda prm, xv, mv: make(True).apply({"params": prm}, xv, mv, **kw))(
        p, jnp.asarray(x), jnp.asarray(mask))
    ours = TransformerBlock(c, heads, ds_stride=2 if mode == "ds_self" else 1,
                            window_size=window, cross=CROSS[mode])
    ours.load_state_dict(block_state_dict_from_flax(p), strict=True)
    with torch.no_grad():
        if CROSS[mode]:
            got, got_mask = ours(_t(x), _t(mask), xo=_t(xo), mode=mode)
        else:
            got, got_mask = ours(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    assert np.array_equal(got_mask.numpy(), np.asarray(ref_mask))

    jpacked = jfb.pack_block_params(p, c, CROSS[mode], jnp.bfloat16)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    xb = xa if xb is None else xb
    mrow = m.astype(np.float32)[..., None]
    coefs = np.array([[1.0, 1 / 0.9], [0.0, 1.0]], np.float32)
    bf = jnp.bfloat16
    ref = _jax_block_math(heads, window // 2, mode)(
        jnp.asarray(xa, bf), jnp.asarray(xb, bf), jnp.asarray(mrow), jnp.asarray(coefs),
        *jpacked)
    tin = [_t(a, torch.float32 if i in (0, 7) else torch.bfloat16)
           for i, a in enumerate(_torch_layout(jpacked))]
    got = tfb.block_math(_t(xa, torch.bfloat16), _t(xb, torch.bfloat16), _t(mrow), _t(coefs),
                         *tin, n_head=heads, w_overlap=window // 2, mode=mode)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **BF16_TOL)


ENTRY_CASES = [(384, 8, 19, 32, "qv_k"), (256, 1, 37, 40, "ds_self"), (128, 16, -1, 33, "kv")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,heads,window,t,mode", ENTRY_CASES,
                         ids=[f"C{c}-h{h}-{'dense' if w < 0 else f'w{w // 2}'}-{m}"
                              for c, h, w, t, m in ENTRY_CASES])
def test_entries_match_pallas_kernel_interpret(rng, c, heads, window, t, mode, dtype):
    """K1's and K6's entries against the Pallas kernel, generated for the
    shape, in interpret mode."""
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
    tfb.reset_launches()
    got = tfb.fused_transformer_block(*tx, *tpacked, **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)
    ref = jfb.fused_transformer_block_train(*jx, jnp.asarray(coefs), *jpacked, interpret=True,
                                            **kw)
    got = tfb.fused_transformer_block_train(*tx, _t(coefs), *tpacked, **kw)
    assert tfb.LAUNCHES == 0 and tfb.TRAIN_LAUNCHES == 0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_train_grads_match_jax_vjp_at_head_width_48(rng):
    """C = 384, 8 heads of 48, w = 9, a cross block, droppath coefficients:
    the K6 entry's gradients of x, xo and the 8 packed tensors against
    ``jax.vjp`` of the JAX ``fused_transformer_block_train`` (2e-4;
    parameters 5e-4 of the leaf's largest)."""
    c, heads, window, mode = 384, 8, 19, "qv_k"
    _, _, p, x, xo, mask = _setup(rng, c, heads, mode, window, t=32)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    coefs = np.array([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], np.float32)
    jpacked = jfb.pack_block_params(p, c, CROSS[mode], jnp.float32)
    g = rng.standard_normal(xa.shape).astype(np.float32)
    kw = dict(n_head=heads, w_overlap=window // 2, mode=mode)
    jm, jc = jnp.asarray(m), jnp.asarray(coefs)
    fn = lambda xv, xov, *pk: jfb.fused_transformer_block_train(  # noqa: E731
        xv, xov, jm, jc, *pk, interpret=True, **kw)
    prim = [jnp.asarray(xa), jnp.asarray(xb)] + list(jpacked)
    ref = [np.asarray(a) for a in jax.jit(lambda *a: jax.vjp(fn, *a)[1](jnp.asarray(g)))(*prim)]
    leaves = [_t(a).requires_grad_(True) for a in (xa, xb)]
    packed = [_t(a).requires_grad_(True) for a in _torch_layout(jpacked)]
    y = tfb.fused_transformer_block_train(leaves[0], leaves[1], _t(m), _t(coefs), *packed, **kw)
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


def test_exp10_one_head_windows_of_37_matches_jax(monkeypatch):
    """``exp10-h1-w37``: the shipped localizer (HRLR backbone, arch (2, 2,
    5), C 256, absolute position embedding) with ``n_head: 1`` and windows
    (37, 37, 37, 37, 37, -1), its input narrowed to 24 channels, at T = 576,
    the least length its windows' padding rule takes in both packages
    (stride 16 x 36): every block through K1's entry at d = 256 (w = 18 and
    dense), outputs at 1e-4 against the JAX package (its detections are
    held card vs CPU by ``chip_smoke.py::h1w37_path``)."""
    t = 576
    arch = dict(variant="av_recovery_norecon", input_dim=24, num_classes=1, max_seq_len=t,
                embd_dim=256, fpn_dim=256, head_dim=256, n_head=1,
                mha_win_size=(37, 37, 37, 37, 37, -1), use_abs_pe=True, droppath=0.1)
    jcfg, cfg = JArchConfig(**arch), ArchConfig(**arch)
    assert cfg.max_div_factor == jcfg.max_div_factor == t
    assert tfb.kernel_shape_ok(256, 1, 18) and not tfb.wgmma_shape_ok(256, 1)
    p = localizer_params(jcfg, 4)
    ours = AVLocalizer(cfg).eval()
    ours.load_state_dict(state_dict_from_flax(p), strict=True)
    x, mask = ragged(np.random.default_rng(8), 2, t, 24, lens=[t, 401])
    ref = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply({"params": p}, x, m))(
        jnp.asarray(x), jnp.asarray(mask))
    calls = []
    orig = tfb.fused_transformer_block
    monkeypatch.setattr(tfb, "fused_transformer_block",
                        lambda *a, **k: (calls.append(k["w_overlap"]), orig(*a, **k))[1])
    with torch.no_grad():
        got = ours(_t(x), _t(mask))
    assert sorted(set(calls)) == [-1, 18] and len(calls) == 18
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(got[key], ref[key]):
            assert_close(g, r, atol=1e-4, rtol=1e-4, msg=key)


# ------------------------------------------------------------ K7

@pytest.mark.parametrize("dtype,w", [("float32", 17), ("bfloat16", 17), ("bfloat16", 24)])
def test_band_plain_matches_pallas_interpret_beyond_w16(rng, w, dtype):
    """Partial masks, a fully masked sample, and T above and below 2w + 1
    (but not below w: the JAX shifts need T >= w). The interpreter's cost
    grows with the offsets it unrolls (~20 s a call at w = 24 on one CPU
    thread, ~60 s at w = 40), so w = 40 is held to the Pallas kernel's XLA
    twin below."""
    _band_case_vs_pallas(rng, 40, (40, 23, 0), 1, 16, w, dtype)
    if dtype == "float32":
        _band_case_vs_pallas(rng, w + 3, (w + 3, w // 2, 1), 1, 16, w, dtype)


def test_band_plain_matches_xla_at_w40(rng):
    """w = 40 in f32 against ``band_attention_xla`` (the JAX package's other
    formulation of the same function, f32 softmax: equal to rounding in
    f32), T 50 and 43 with partial and empty masks (1e-5)."""
    for t, lens in ((50, (50, 31, 0)), (43, (43, 20, 1))):
        q = (rng.standard_normal((3, 2, t, 16)) * 0.25).astype(np.float32)
        k, v = (rng.standard_normal((3, 2, t, 16)).astype(np.float32) for _ in range(2))
        valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
        ref = jax.jit(lambda a, b, c, m: jattention.band_attention_xla(a, b, c, m, 40))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))
        got = tband.band_attention_kernel(_t(q), _t(k), _t(v), _t(valid), 40)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,d", [("float32", 256), ("bfloat16", 512)])
def test_band_plain_matches_pallas_interpret_wide_heads(rng, dtype, d):
    """Head rows past 512 bytes: d = 256 in f32, 512 in bf16, w = 18."""
    _band_case_vs_pallas(rng, 40, (40, 23, 0), 1, d, 18, dtype)


def _band_case_vs_pallas(rng, t, lens, h, d, w, dtype):
    q = (rng.standard_normal((3, h, t, d)) * d ** -0.5).astype(np.float32)
    k, v = (rng.standard_normal((3, h, t, d)).astype(np.float32) for _ in range(2))
    valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jband.band_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                      jnp.asarray(v, jdt), jnp.asarray(valid), w, interpret=True)
    tband.reset_launches()
    got = tband.band_attention_kernel(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(valid), w)
    assert tband.LAUNCHES == 0 and got.dtype == tdt
    assert tband.kernel_shape_ok(d, got.element_size(), w)
    assert not tband.tiled(d, got.element_size(), w)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def _band_any(q, k, v, valid, w):
    """``band_any_kernel`` (csrc/band_attention.cu) in torch: per query row,
    the offsets inside the sequence streamed in order in three passes (the
    maximum; the exps, rounded, summed from the first in-range offset; the
    quotients e / den rounded and the context summed offset by offset), every
    step rounded to the input dtype where the kernel rounds it."""
    dt = q.dtype
    b, h, t, d = q.shape
    rnd = lambda x: x.to(dt).float()  # noqa: E731
    pen = rnd(torch.tensor(tband.NEG_PENALTY))
    out = torch.zeros(b, h, t, d, dtype=dt)
    for i in range(t):
        lo, hi = max(-w, -i), min(w, t - 1 - i)
        offs = range(lo, hi + 1)
        keys = [i + o for o in offs]
        s = [rnd((q[:, :, i] * k[:, :, j]).float().sum(-1)) for j in keys]
        s = [torch.where(valid[:, j][:, None], sj, rnd(sj + pen)) for j, sj in zip(keys, s)]
        mx = torch.stack(s).amax(0)
        e = [rnd(torch.exp(rnd(sj - mx))) for sj in s]
        den = e[0]
        for ej in e[1:]:
            den = rnd(den + ej)
        acc = torch.zeros(b, h, d)
        for ej, j in zip(e, keys):
            acc = rnd(acc + rnd(rnd(ej / den)[..., None] * v[:, :, j].float()))
        out[:, :, i] = (acc * valid[:, i][:, None, None]).to(dt)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,w", [(40, 17), (30, 100), (64, 24)])
def test_band_streamed_offsets_match_plain(rng, dtype, t, w):
    """K7's streamed offsets (torch rendering) equal ``band_attention_plain``
    bit for bit: skipping offsets outside the sequence and starting the sum
    of the exps at the first one in range change nothing (their exps are 0),
    at windows wider than T too."""
    tdt = getattr(torch, dtype)
    q, k, v = (_t(rng.standard_normal((2, 2, t, 24)).astype(np.float32), tdt) for _ in range(3))
    valid = _t(np.arange(t)[None, :] < np.asarray([t, t // 3])[:, None])
    got = _band_any(q, k, v, valid, w)
    ref = tband.band_attention_plain(q, k, v, valid, w)
    assert torch.equal(got, ref)


# ------------------------------------------------------------ K8

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96, 128])
def test_k8_math_matches_jax_at_head_dims_16_to_128(d, dtype, masked):
    jq, tq, mask = k8_case(70, d, dtype, masked, seed=d)
    assert tk8.head_dim_ok(d)
    jmask = None if mask is None else jnp.asarray(mask)
    got = tk8.full_mha_math(*tq, None if mask is None else torch.from_numpy(mask))
    kernel = np.asarray(jk8.full_mha(*jq, jmask, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), kernel, atol=K8_TOL[dtype], rtol=0)


@pytest.mark.parametrize("d", [16, 48, 80, 112])
def test_k8_padded_head_width_leaves_the_softmax_unchanged(rng, d):
    """K8's instances run d rounded up (f32: to 32, 64, 96 or 128; bf16: to
    64 or 128, its context in 64-column halves): q, k, v zero past d give
    the scores, the key-bias softmax and the first d context columns of d;
    the halves put together are the whole context."""
    q, k, v = (_t(rng.standard_normal((2, 3, 50, d)).astype(np.float32)) for _ in range(3))
    q = q * d ** -0.5
    mask = torch.from_numpy(np.arange(50)[None, :] >= np.asarray([50, 31])[:, None])
    ref = tk8.full_mha_math(q, k, v, mask)
    for width, halves in (((d + 31) // 32 * 32, 1), (64 if d <= 64 else 128, 64)):
        pad = lambda a: torch.nn.functional.pad(a, (0, width - d))  # noqa: E731
        got = tk8.full_mha_math(pad(q), pad(k), pad(v), mask)
        np.testing.assert_allclose(got[..., :d].numpy(), ref.numpy(), atol=1e-6, rtol=0)
        assert torch.count_nonzero(got[..., d:]) == 0
        if halves == 64:
            parts = [tk8.full_mha_math(pad(q), pad(k), pad(v)[..., 64 * u:64 * (u + 1)], mask)
                     for u in range(width // 64)]
            np.testing.assert_allclose(torch.cat(parts, -1)[..., :d].numpy(), ref.numpy(),
                                       atol=1e-6, rtol=0)


# ------------------------------- the generic block attention's tiling

AR, AK = 32, 32          # csrc/fused_block_generic.cu: query rows a block, keys a tile


def _generic_attend(q, k, v, valid, n_head, w):
    """``attend_kernel`` of csrc/fused_block_generic.cu in torch on (B, T, C)
    q (scaled), k, v of the compute dtype and a (B, T) bool mask: per
    (sample, head, 32 query rows) the 32-key tiles from the block's first
    key to its last (all keys when dense); scores as block_math forms them
    (dense: f32 sums rounded, rnd(-1e30) on masked keys; banded: products
    rounded, summed, rounded, plus the rounded penalty); pass 1 each lane's
    (key index mod 32) running maximum and rescaled sum of exps over its
    keys, merged; pass 2 the weights rnd(e / sum) (dense) or rnd(e x (1 /
    sum)) (banded), the context in f32 rounded once (dense) or rounded at
    every key in key order (banded); rows past the mask zero."""
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()  # noqa: E731
    b, t, c = q.shape
    d = c // n_head
    fill = rnd(torch.tensor(tfb.NEG_INF))
    out = torch.zeros(b, t, c, dtype=dt)
    for bi in range(b):
        pen = rnd((valid[bi].float() - 1.0) * -tfb.NEG_PENALTY)
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            qq, kk, vv = (a[bi, :, sl].float() for a in (q, k, v))
            if w <= 0:
                vv = vv * valid[bi][:, None]
            for r0 in range(0, t, AR):
                rows = torch.arange(r0, min(r0 + AR, t))
                lo, hi = (0, t) if w <= 0 else (max(r0 - w, 0), min(r0 + AR + w, t))
                keys = torch.arange(lo, hi)
                if w <= 0:
                    s = rnd(qq[rows] @ kk[keys].T)
                    s = torch.where(valid[bi, keys][None], s, fill)
                else:
                    s = rnd(rnd(qq[rows][:, None, :] * kk[keys][None]).sum(-1))
                    s = rnd(s + pen[keys][None])
                    far = (keys[None] - rows[:, None]).abs() > w
                    s = torch.where(far, -math.inf, s)
                lane = (keys - lo) % AK
                m = torch.full((len(rows), AK), -math.inf)
                z = torch.zeros(len(rows), AK)
                for j in range(len(keys)):      # lane-wise running softmax, key by key
                    sj, ln = s[:, j], lane[j]
                    up = sj > m[:, ln]
                    z[:, ln] = torch.where(sj == -math.inf, z[:, ln], torch.where(
                        up, z[:, ln] * torch.exp(m[:, ln] - sj) + 1.0,
                        z[:, ln] + torch.exp(sj - m[:, ln])))
                    m[:, ln] = torch.where(up, sj, m[:, ln])
                mx = m.amax(1)
                tot = torch.where(m == -math.inf, 0.0, z * torch.exp(m - mx[:, None])).sum(1)
                e = torch.exp(s - mx[:, None])
                if w <= 0:
                    p = rnd(e / tot[:, None])
                    ctx = rnd(p @ vv[keys])
                else:
                    p = rnd(e * (1.0 / tot)[:, None])
                    ctx = torch.zeros(len(rows), d)
                    for j in range(len(keys)):
                        ctx = rnd(ctx + rnd(p[:, j:j + 1] * vv[keys[j]][None]))
                out[bi, rows, sl] = (ctx * valid[bi, rows][:, None]).to(dt)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,heads,d,w", [(70, 2, 48, 0), (40, 1, 256, 18), (33, 4, 8, 3),
                                         (50, 2, 80, 9), (24, 1, 512, 0), (20, 2, 16, 40)])
def test_generic_attention_tiling_matches_plain(rng, dtype, t, heads, d, w):
    """The generic block attention's tiling (torch rendering) against the
    plain ``attention_ctx``, dense and banded, at ragged T: a padded tail, a
    fully padded sample, a band wider than T (f32 1e-6; bf16 2e-2, the bf16
    block tolerance, where f32 sums in another order move a rounding)."""
    tdt = getattr(torch, dtype)
    c = heads * d
    valid = _t(np.arange(t)[None, :] < np.asarray([t, (3 * t) // 4, 0])[:, None])
    q, k, v = (_t(rng.standard_normal((3, t, c)).astype(np.float32), tdt) for _ in range(3))
    q = (q.float() * d ** -0.5).to(tdt)
    got = _generic_attend(q, k, v, valid, heads, w)
    ref = tfb.attention_ctx(q, k, v, valid.float()[..., None], n_head=heads, w_overlap=w)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), **tol)

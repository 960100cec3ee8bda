"""PyTorch port, K1 / K6, K7 and K8 at every head width and window of their
domain beyond the wgmma designs, against the JAX package on the CPU.

The fused block kernel takes C a multiple of 64 up to 2048 and head widths
that are multiples of 8 from 8 to 512 (``fused_block.kernel_shape_ok``;
the scratch routes run what ``wgmma_shape_ok`` leaves), the
band kernel any half window and head rows up to 512 wide
(``band_attention.kernel_shape_ok``; past w = 16 or 512-byte head rows
``band_rows_kernel``, or K1's f32 attention up to head width 128), K8 head
dims that are multiples of 16 up to 128. On the CPU each
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
- torch renderings of the kernels' tilings against the plain versions: the
  scratch routes' attention at head widths padded with zeros to an
  instance's or, past 128, in 128-channel score chunks and 128-column
  blocks (f32 in the tensor-core model of ``tests/tf32_model.py``, and
  bf16); the bf16 GEMM mainloop's per-slice f32 sums at K = 8192 against
  ``cdot``; K7 past its tiled kernel (``band_rows_kernel``'s steps, K1's
  f32 attention on K7's operands) against ``band_attention_plain`` under ``chip_smoke.check_k7``'s rule,
  and the route every K7 shape takes; K8's head dims padded to its
  instances' widths and its context in 64-column halves."""

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
from tf32_model import tc_k8, tc_matmul  # noqa: E402

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


# ------------------------- the scratch routes' attention tilings and sums

F_ROWS, F_KEYS = 64, 32      # csrc/fused_block_f32_attend.cu: query rows a block, keys a tile
B_ROWS, B_KEYS = 128, 64     # csrc/fused_block_attend.cu
COLS = 128                   # context columns a block past head width 128 (both)
INSTANCES = (32, 64, 96, 128)


def _width(d):
    """The attention instance a head width runs on: the next of 32 / 64 /
    96 / 128 (zeros past d), or, past 128, d itself in 128-column blocks."""
    return next((x for x in INSTANCES if x >= d), d)


def _pad(a, width):
    return torch.nn.functional.pad(a, (0, width - a.shape[-1]))


def _tiles(t, rows, keys, w, band):
    """(query rows, visited key-tile indices) per block of ``rows`` rows."""
    for r0 in range(0, t, rows):
        lo, hi = 0, (t - 1) // keys
        if band:
            lo, hi = max(r0 - w, 0) // keys, min(r0 + rows - 1 + w, t - 1) // keys
        yield torch.arange(r0, min(r0 + rows, t)), range(lo, hi + 1)


def _f32_scores_gemm(q, k, v, valid, n_head):
    """The dense f32 attention past head width 128 (csrc/
    fused_block_f32_attend.cu's scores GEMMs) in the tensor-core model: per
    (sample, head) the T x T scores over d (``tc_matmul``, 32-channel
    stages; q and k zero to d rounded up to 32 add nothing), masked keys
    -1e30, an f32 softmax of the whole row (e / sum, masked keys' p zero),
    P.V over the keys padded to 32 (``tc_matmul``, 32-key stages); invalid
    rows zero. Returns f64 holding f32 values (B, T, C)."""
    b, t, c = q.shape
    d = c // n_head
    tp = (t + 31) // 32 * 32
    out = torch.zeros(b, t, c, dtype=torch.float64)
    for bi in range(b):
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            s = tc_matmul(q[bi, :, sl], k[bi, :, sl], 32).float()
            s = torch.where(valid[bi][None], s, torch.tensor(tfb.NEG_INF))
            e = torch.exp(s - s.amax(1, keepdim=True))
            pr = torch.where(valid[bi][None], e / e.sum(1, keepdim=True), 0.0)
            vt = torch.nn.functional.pad(v[bi, :, sl].t(), (0, tp - t)).contiguous()
            ctx = tc_matmul(torch.nn.functional.pad(pr, (0, tp - t)), vt, 32)
            out[bi, :, sl] = ctx * valid[bi][:, None]
    return out


def _f32_scratch_attend(q, k, v, valid, n_head, w, pad=True, band=None):
    """csrc/fused_block_f32_attend.cu at a head width of the scratch route,
    in torch over the tensor-core model of tests/tf32_model.py: each head's
    q, k, v zero past d to its instance's width (``pad``; d > 128: none),
    per (sample, head, 64 query rows, 128 context columns past d = 128: a
    block each, every block recomputing the scores) the 32-key tiles it
    visits; scores per 32 channels in 3xTF32 (``tc_matmul``, stage 32, each
    block's sum added in f32: the wide kernel's 64-channel steps hold two
    such blocks and skip those past d), the masks, an online softmax, P.V
    the same way, the context divided at the end; invalid rows zero. Dense
    past d = 128: ``_f32_scores_gemm``. ``band``: banded (K1: w > 0; K7:
    always, w = 0 its own key). Returns f64 holding f32 values (B, T, C)."""
    b, t, c = q.shape
    d = c // n_head
    band = w > 0 if band is None else band
    if d > 128 and not band:
        return _f32_scores_gemm(q, k, v, valid, n_head)
    width = _width(d) if pad else d
    cols = [slice(0, width)] if width <= 128 else [slice(c0, min(c0 + COLS, width))
                                                   for c0 in range(0, width, COLS)]
    out = torch.zeros(b, t, c, dtype=torch.float64)
    for bi in range(b):
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            qq, kk, vv = (_pad(a[bi, :, sl], width) for a in (q, k, v))
            for rows, key_tiles in _tiles(t, F_ROWS, F_KEYS, w, band):
                for cs in cols:
                    m = torch.full((len(rows),), -math.inf, dtype=torch.float64)
                    z = torch.zeros(len(rows), dtype=torch.float64)
                    o = torch.zeros(len(rows), cs.stop - cs.start, dtype=torch.float64)
                    for j in key_tiles:
                        keys = torch.arange(j * F_KEYS, (j + 1) * F_KEYS)
                        inseq = keys < t
                        at = keys.clamp(max=t - 1)
                        ok = inseq & valid[bi, at]
                        s = tc_matmul(qq[rows], kk[at] * inseq[:, None], 32)
                        if band:
                            s = torch.where(ok[None], s, (s + tfb.NEG_PENALTY).float().double())
                            far = (keys[None] - rows[:, None]).abs() > w
                            s = torch.where(far | ~inseq[None], -math.inf, s)
                        else:
                            s = torch.where(ok[None], s,
                                            torch.where(inseq[None], tfb.NEG_INF, -math.inf))
                        s = s.float()
                        mn = torch.maximum(m.float(), s.amax(1))
                        mu = torch.where(mn == -math.inf, 0.0, mn)
                        sc = torch.exp(m.float() - mu)
                        e = torch.exp(s - mu[:, None])
                        z = (z.float() * sc + e.sum(1)).double()
                        if not band:
                            e = e * ok[None]
                        pv = tc_matmul(e, (vv[at, cs] * inseq[:, None]).t().contiguous(), 32)
                        o = (o.float() * sc[:, None] + pv.float()).double()
                        m = mn.double()
                    ctx = (o.float() / z.float()[:, None]) * valid[bi, rows][:, None]
                    keep = min(cs.stop, d) - cs.start
                    if keep > 0:
                        out[bi, rows, h * d + cs.start:h * d + cs.start + keep] = \
                            ctx[:, :keep].double()
    return out


def _bf16_scratch_attend(q, k, v, valid, n_head, w):
    """csrc/fused_block_attend.cu at a head width of the bf16 scratch route,
    in torch (bf16 (B, T, C) q (scaled), k, v; (B, T) bool mask): q, k, v
    zero past d to the instance's width (d <= 128), or past d = 128 per
    block of 128 context columns, the scores recomputed in each, f32 sums
    over 128-channel chunks of q and k; per (sample, head, 128 query rows)
    the 64-key tiles it visits, the scores rounded and masked as block_math
    forms them, pass 1 a running maximum and denominator, pass 2 p =
    rnd16(e * (1 / den)) (dense: 0 on invalid keys), P.V in f32, rounded;
    invalid rows zero."""
    bf = torch.bfloat16
    b, t, c = q.shape
    d = c // n_head
    band = w > 0
    width = _width(d)
    cols = [slice(0, width)] if width <= 128 else [slice(c0, min(c0 + COLS, width))
                                                   for c0 in range(0, width, COLS)]
    fill = torch.tensor(tfb.NEG_INF, dtype=bf).float()
    pen = torch.tensor(tfb.NEG_PENALTY, dtype=bf)
    out = torch.zeros_like(q)
    for bi in range(b):
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            qq, kk, vv = (_pad(a[bi, :, sl].float(), width) for a in (q, k, v))
            for rows, key_tiles in _tiles(t, B_ROWS, B_KEYS, w, band):

                def tile(j):
                    keys = torch.arange(j * B_KEYS, (j + 1) * B_KEYS)
                    inseq = keys < t
                    at = keys.clamp(max=t - 1)
                    kt = kk[at] * inseq[:, None]
                    sc = torch.zeros(len(rows), B_KEYS)
                    for c0 in range(0, width, 128):      # the chunks, summed in f32
                        sc = sc + qq[rows, c0:c0 + 128] @ kt[:, c0:c0 + 128].T
                    sc = sc.to(bf)
                    ok = inseq & valid[bi, at]
                    if band:
                        sc = torch.where(ok[None], sc, sc + pen).float()
                        far = (keys[None] - rows[:, None]).abs() > w
                        sc = torch.where(far | ~inseq[None], tfb.NEG_INF, sc)
                    else:
                        sc = torch.where(ok[None], sc.float(),
                                         torch.where(inseq[None], fill, -math.inf))
                    return sc, ok, vv[at] * inseq[:, None]

                for cs in cols:
                    m = torch.full((len(rows),), -math.inf)
                    z = torch.zeros(len(rows))
                    for j in key_tiles:
                        sc, _, _ = tile(j)
                        mn = torch.maximum(m, sc.amax(1))
                        z = z * torch.exp(m - mn) + torch.exp(sc - mn[:, None]).sum(1)
                        m = mn
                    inv = 1.0 / z
                    acc = torch.zeros(len(rows), cs.stop - cs.start)
                    for j in key_tiles:
                        sc, ok, vt = tile(j)
                        pr = (torch.exp(sc - m[:, None]) * inv[:, None]).to(bf).float()
                        if not band:
                            pr = pr * ok[None]
                        acc += pr @ vt[:, cs]
                    keep = min(cs.stop, d) - cs.start
                    if keep > 0:
                        out[bi, rows, h * d + cs.start:h * d + cs.start + keep] = (
                            acc[:, :keep].to(bf) * valid[bi, rows][:, None])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,heads,d,w", [(70, 2, 48, 0), (40, 1, 256, 18), (33, 4, 8, 3),
                                         (50, 2, 80, 9), (24, 1, 512, 0), (20, 2, 16, 40),
                                         (40, 1, 512, 5), (33, 1, 136, 0)])
def test_scratch_attention_tiling_matches_plain(rng, dtype, t, heads, d, w):
    """The scratch routes' attention (torch renderings of the launches at
    head widths past the instances: padded with zeros to 32 / 64 / 96 / 128,
    or past 128 in 128-channel score chunks and 128-column blocks that each
    recompute the scores, f32 dense past 128 the scores GEMMs and a row
    softmax) against the plain ``attention_ctx``, dense and
    banded, at ragged T: a padded tail, a fully padded sample, a band wider
    than T. f32 in the tensor-core model: the padded rendering is the
    unpadded one to 1e-6 (zeros add nothing to a model sum) and both are
    ``attention_ctx`` within the f32 tiling's 2e-5; bf16 ``BF16_TOL``."""
    tdt = getattr(torch, dtype)
    c = heads * d
    valid = _t(np.arange(t)[None, :] < np.asarray([t, (3 * t) // 4, 0])[:, None])
    q, k, v = (_t(rng.standard_normal((3, t, c)).astype(np.float32), tdt) for _ in range(3))
    q = (q.float() * d ** -0.5).to(tdt)
    ref = tfb.attention_ctx(q, k, v, valid.float()[..., None], n_head=heads, w_overlap=w)
    if dtype == "float32":
        got = _f32_scratch_attend(q, k, v, valid, heads, w)
        if _width(d) != d:
            bare = _f32_scratch_attend(q, k, v, valid, heads, w, pad=False)
            np.testing.assert_allclose(got.numpy(), bare.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), ref.double().numpy(), rtol=2e-5, atol=2e-5)
    else:
        got = _bf16_scratch_attend(q, k, v, valid, heads, w)
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), **BF16_TOL)


# ------------------------- K7 past its tiled kernel: K1's attention kernels

def _k7_rows(q, k, v, valid, w):
    """csrc/band_attention.cu::band_rows_kernel in torch ((B, H, T, D) q
    (scaled), k, v; (B, T) bool mask). A score: bf16 the products rounded
    to bf16 (mul.rn.bf16x2) summed by the tensor cores (mma.sync against
    ones) in f32; f32 each lane's fused multiply-adds over its pieces, then
    the lanes' sums; here both are the exact sum rounded to f32, which the
    kernel's order moves by an f32 rounding or so. Then in the input dtype,
    per row in offset order, the plain version's steps: the score rounded,
    the penalty added where the key is masked (rounded), the exps rounded,
    their running sum rounded, p = e / sum rounded, p v into the running
    context (bf16: product and sum each rounded; f32: one fused
    multiply-add); offsets outside the sequence skipped (their exps are 0);
    rows whose own key is masked zero. The kernel's row blocks and key
    stages change no sum's order, so this runs offset by offset, the band
    capped at the sequence."""
    dt = q.dtype
    b, h, t, d = q.shape
    w = min(w, t - 1)
    rnd = lambda x: x.to(dt).float()  # noqa: E731
    pen = torch.tensor(tband.NEG_PENALTY, dtype=dt).float()
    rows = torch.arange(t)
    scores = []
    for o in range(-w, w + 1):
        keys = rows + o
        inseq = (keys >= 0) & (keys < t)
        at = keys.clamp(0, t - 1)
        s = rnd((q * k[:, :, at]).double().sum(-1).float())
        s = torch.where(valid[:, at][:, None], s, rnd(s + pen))
        scores.append((torch.where(inseq, s, -math.inf), inseq, at))
    m = torch.stack([s for s, _, _ in scores]).amax(0)
    exps = [torch.where(inseq, rnd(torch.exp(rnd(s - m))), 0.0) for s, inseq, _ in scores]
    den = torch.zeros_like(m)
    for e in exps:
        den = rnd(den + e)
    acc = torch.zeros(b, h, t, d)
    for e, (_, inseq, at) in zip(exps, scores):
        p = rnd(e / den)[..., None]
        vv = v[:, :, at].float()
        step = rnd(acc + rnd(p * vv)) if dt == torch.bfloat16 else \
            (acc.double() + p.double() * vv.double()).float()
        acc = torch.where(inseq[:, None], step, acc)
    return (acc * valid[:, None, :, None]).to(dt)


def _k7_past_tiled(q, k, v, valid, w, pad=True):
    """K7's route past its tiled kernel in torch. f32 up to head width 128:
    K1's banded attention (csrc/band_attend.cuh) on its (B, H, T, D)
    operands, which are the (B, T, H D) rows K1's kernels read
    (``_f32_scratch_attend`` in the tensor-core model), always banded, the
    band capped at the sequence (w >= T is w = T - 1); bf16, and f32 past
    128: ``_k7_rows``."""
    b, h, t, d = q.shape
    if tband.route_of(d, q.dtype, w) != "wgmma 3xTF32":
        return _k7_rows(q, k, v, valid, w)
    flat = lambda a: a.transpose(1, 2).reshape(b, t, h * d)  # noqa: E731
    got = _f32_scratch_attend(flat(q), flat(k), flat(v), valid, h, min(w, t - 1), pad=pad,
                              band=True).float()
    return got.reshape(b, t, h, d).transpose(1, 2)


# (dtype, T, heads, D, w): windows 17 / 40 / 100 with T above and below 2w +
# 1 (and below w), heads padded to an instance (f32 also at widths 4 mod 8),
# past 128 in 128-column blocks, small windows and w = 0 where the head row
# alone (over 512 bytes) leaves the tiled kernel
K7_ROUTE_CASES = [("float32", 40, 1, 24, 17), ("bfloat16", 40, 1, 24, 17),
                  ("float32", 30, 2, 20, 40), ("bfloat16", 30, 2, 16, 40),
                  ("float32", 150, 1, 64, 100), ("bfloat16", 150, 1, 48, 100),
                  ("float32", 24, 1, 132, 3), ("bfloat16", 40, 1, 264, 17),
                  ("float32", 40, 1, 256, 0), ("bfloat16", 30, 1, 512, 0)]


@pytest.mark.parametrize("dtype,t,heads,d,w", K7_ROUTE_CASES,
                         ids=[f"{c[0][:4]}-T{c[1]}-h{c[2]}-d{c[3]}-w{c[4]}"
                              for c in K7_ROUTE_CASES])
def test_band_past_tiled_kernel_matches_plain(rng, dtype, t, heads, d, w):
    """K7 past its tiled kernel (torch renderings of its routes: bf16, and
    f32 past head width 128, ``band_rows_kernel``'s steps in the plain
    version's order; f32 up to 128 K1's banded attention on K7's operands,
    64 query rows a block, the 32-key tiles that meet the band, an f32
    online softmax, heads padded with zeros to an instance's width) against
    ``band_attention_plain`` under ``chip_smoke.check_k7``'s rule (f32
    atol 1e-5; bf16 atol = rtol = 2e-2 and no further than 1.5x the plain
    version from the f32 function), masks full, partial, one row and none.
    On the CPU the wrapper runs the plain version and counts nothing."""
    import chip_smoke

    tdt = getattr(torch, dtype)
    assert tband.kernel_shape_ok(d, tdt.itemsize, w) and not tband.tiled(d, tdt.itemsize, w)
    assert tband.route_of(d, tdt, w) == (
        "staged rows bf16" if dtype == "bfloat16" else "wgmma 3xTF32" if d <= 128
        else "staged rows f32")
    valid = _t(np.arange(t)[None, :] < np.asarray([t, (2 * t) // 3, 1, 0])[:, None])
    q, k, v = (_t(rng.standard_normal((4, t, heads * d)).astype(np.float32))
               .reshape(4, t, heads, d).transpose(1, 2) for _ in range(3))
    q, k, v = (q * d ** -0.5).to(tdt), k.to(tdt), v.to(tdt)
    tband.reset_launches()
    ref = tband.band_attention_kernel(q, k, v, valid, w)
    assert tband.LAUNCHES == 0 and not tband.ROUTES
    assert torch.equal(ref, tband.band_attention_plain(q, k, v, valid, w))
    got = _k7_past_tiled(q, k, v, valid, w).to(tdt)
    err, ok, rule = chip_smoke.check_k7(got, ref, q, k, v, valid, w)
    assert ok, f"max|d| {err:.3e} ({rule})"
    assert torch.count_nonzero(got[3]) == 0          # no valid key: every row's own is masked
    if tband.route_of(d, tdt, w) == "wgmma 3xTF32" and d % 32:   # zeros past d add nothing
        bare = _k7_past_tiled(q, k, v, valid, w, pad=False)
        np.testing.assert_allclose(got.numpy(), bare.numpy(), rtol=0, atol=1e-6)


def test_band_every_shape_takes_one_route():
    """Every head width and window ``kernel_shape_ok`` takes goes to one
    route: the tiled kernel (w <= 16, head rows <= 512 bytes); past it bf16
    ``band_rows_kernel``, f32 K1's attention on the tensor cores up to head
    width 128 (its instances 32 / 64 / 96 / 128, narrower heads padded with
    zeros) and ``band_rows_kernel`` past 128, up to 512. Every route is
    some shape's."""
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        size = dtype.itemsize
        for d in range(1, tband.MAX_HEAD_DIM + 9):
            for w in (0, 1, 8, 16, 17, 33, 100, 10 ** 6):
                if not tband.kernel_shape_ok(d, size, w):
                    assert d * size % 16 or d > tband.MAX_HEAD_DIM
                    continue
                route = tband.route_of(d, dtype, w)
                if w <= tband.MAX_W and d * size <= tband.MAX_TILED_ROW_BYTES:
                    assert route == "tiled" and tband.tiled(d, size, w)
                elif dtype == torch.bfloat16:
                    assert route == "staged rows bf16" and not tband.tiled(d, size, w)
                elif d <= 128:
                    assert route == "wgmma 3xTF32" and _width(d) in INSTANCES
                else:
                    assert route == "staged rows f32"
                counts[route] = counts.get(route, 0) + 1
    assert set(counts) == set(tband.ROUTE_NAMES)
    assert not tband.kernel_shape_ok(64, 2, -1)


def _bf16_slice_sums(a, m, depth=64):
    """a @ m.T as the bf16 scratch route's GEMM forms it (the PROD_BF16
    mainloop of csrc/wgmma.cuh): per 64-deep slice, four k16 steps summed
    by the tensor cores (each modelled as ``tc_k8`` on 16 exact products:
    aligned to the largest term and cut toward zero), the slice's sum added
    into an f32 accumulator rounding to nearest, the whole rounded once to
    bf16."""
    a64, m64 = a.double(), m.double()
    acc = torch.zeros(a.shape[0], m.shape[0], dtype=torch.float64)
    for k0 in range(0, a.shape[1], depth):
        part = torch.zeros_like(acc)
        for s in range(k0, k0 + depth, 16):
            part = tc_k8(part, a64[:, s:s + 16], m64[:, s:s + 16])
        acc = (acc + part).float().double()
    return acc.float().to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["fc2", "gelu_rows"])
def test_bf16_mainloop_slice_sums_match_cdot_at_c2048(rng, kind):
    """fc2 at C = 2048 (K = 4C = 8192: 128 slices) on a few rows: the bf16
    mainloop's per-slice f32 sums, rounded once, against ``_cdot`` (one f32
    sum, rounded once): every output within one bf16 ulp of it, and nearly
    all equal (the two f32 sums differ by f32 rounding only, which moves a
    bf16 rounding only near a tie). ``gelu_rows`` draws the hidden units as
    fc2 sees them (GELU'd, mostly positive), ``fc2`` standard normal."""
    k = 4 * 2048
    a = rng.standard_normal((4, k)).astype(np.float32)
    if kind == "gelu_rows":
        a = np.asarray(tfb._gelu_cheap(torch.from_numpy(a)))
    a = _t(a, torch.bfloat16)
    m = _t((rng.standard_normal((16, k)) * k ** -0.5).astype(np.float32), torch.bfloat16)
    got = _bf16_slice_sums(a, m).float()
    ref = tfb._cdot(a, m).float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref.abs())[1] - 8)
    assert bool(((got - ref).abs() <= ulp).all())
    assert float((got == ref).float().mean()) >= 0.9

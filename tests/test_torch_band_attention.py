"""PyTorch port, banded attention (K7) vs the JAX package on the CPU.

``band_attention_plain`` (the kernel's plain version, every operation in the
input dtype) against the Pallas kernel ``band_attention_pallas`` in interpret
mode: f32 1e-5, bf16 2e-2. The ported ``band_attention_xla`` (f32 softmax)
against the JAX one. The gradients of the differentiable wrapper against
``jax.vjp`` of ``band_attention_xla``, which is what the JAX
``band_attention_fused`` differentiates (that function itself calls the
kernel without ``interpret`` and cannot run on the CPU). ``full_attention``
and ``shift_time`` against theirs. Then the CUDA kernel's decomposition in
plain torch (8-row tiles from their staged rows alone, the quotient as e
times the reciprocal of the sum) stitched back against the plain version,
and the kernel's limits."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.ops import attention as jattn
from audio_visual_deepfake_detection_tpu.ops.pallas import band_attention as jband
from audio_visual_deepfake_detection_tpu_torch.ops import attention as tattn
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as tband

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case(rng, b, h, t, d, lens):
    q = (rng.standard_normal((b, h, t, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, h, t, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t, d)).astype(np.float32)
    valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, valid


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,w,lens", [(24, 3, (24, 17, 1)), (5, 3, (5, 3, 0)),
                                      (16, 1, (16, 9, 4)), (3, 3, (3, 2, 1))])
def test_plain_matches_pallas_interpret(rng, t, w, lens, dtype):
    """Partial masks, a fully masked sample and T < 2w + 1."""
    q, k, v, valid = _case(rng, 3, 2, t, 16, lens)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jband.band_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                      jnp.asarray(v, jdt), jnp.asarray(valid), w,
                                      interpret=True)
    tband.reset_launches()
    got = tband.band_attention_kernel(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(valid), w)
    assert tband.LAUNCHES == 0          # a CPU tensor takes the plain version
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_formulation_matches_jax(rng, dtype):
    q, k, v, valid = _case(rng, 3, 2, 24, 16, (24, 17, 0))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jattn.band_attention_xla(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                   jnp.asarray(v, jdt), jnp.asarray(valid), 3)
    got = tattn.band_attention_xla(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(valid), 3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **TOLS[dtype])
    # the two formulations are one function: equal to rounding in f32
    if dtype == "float32":
        plain = tband.band_attention_plain(_t(q), _t(k), _t(v), _t(valid), 3)
        np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lens", [(24, 17, 1), (24, 24, 0)])
def test_fused_wrapper_grads_match_jax_vjp(rng, lens):
    """A fully masked sample must give finite (zero) gradients."""
    q, k, v, valid = _case(rng, 3, 2, 24, 16, lens)
    g = rng.standard_normal(q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattn.band_attention_xla(a, b, c, jnp.asarray(valid), 3),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = tattn.band_attention(tq, tk, tv, _t(valid), 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    got.backward(_t(g))
    for name, a, r in zip("qkv", (tq, tk, tv), ref):
        assert torch.isfinite(a.grad).all(), name
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_fused_wrapper_reads_head_views_without_copy(rng):
    """q, k, v as the block hands them over: (B, T, H D) split into heads by
    a view; the result equals the one on contiguous copies."""
    b, h, t, d = 2, 2, 12, 16
    qkv = [torch.from_numpy(rng.standard_normal((b, t, h * d)).astype(np.float32))
           for _ in range(3)]
    valid = torch.arange(t)[None, :] < torch.tensor([t, 7])[:, None]
    views = [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv]
    assert not views[0].is_contiguous()
    got = tband.band_attention_fused(*views, valid, 3)
    ref = tband.band_attention_plain(*(a.contiguous() for a in views), valid, 3)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches_jax(rng, dtype):
    q, k, v, valid = _case(rng, 3, 2, 12, 16, (12, 7, 0))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jattn.full_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                               jnp.asarray(valid))
    tq, tk, tv = (_t(a, tdt).requires_grad_(True) for a in (q, k, v))
    got = tattn.full_attention(tq, tk, tv, _t(valid))
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else TOLS[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32), **tol)
    got.float().sum().backward()        # the fully masked sample poisons nothing
    assert all(torch.isfinite(a.grad.float()).all() for a in (tq, tk, tv))


@pytest.mark.parametrize("d", [-7, -2, 0, 3, 5])
def test_shift_time_matches_jax(rng, d):
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    if abs(d) <= 5:
        ref = np.asarray(jattn.shift_time(jnp.asarray(x), d))
    else:
        ref = np.zeros_like(x)          # the JAX slice cannot go past the end
    np.testing.assert_array_equal(tattn.shift_time(_t(x), d).numpy(), ref)


def test_unported_options_raise(rng):
    """Once the options the port refused: ``band_attention`` with a relative
    position bias and time weighting is the JAX ``band_attention`` with
    them (the banded formulation, K7 not launched), values and gradients
    at f32 1e-5, and each option changes the result. The kernel's plain
    version still refuses a mask of the wrong length."""
    b, h, t, w = 2, 3, 20, 3
    q, k, v, valid = _case(rng, b, h, t, 16, (20, 11))
    rel = (0.5 * rng.standard_normal((h, 2 * w + 1))).astype(np.float32)
    tw = (1 + 0.5 * rng.standard_normal((h, 2 * w + 1))).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    tband.reset_launches()
    outs = []
    for r, m in ((rel, None), (None, tw), (rel, tw)):
        args = [jnp.asarray(a) for a in (q, k, v)]
        want, vjp = jax.vjp(lambda *a: jattn.band_attention(
            *a[:3], jnp.asarray(valid), w, None if r is None else a[3],
            None if m is None else a[-1]), *args, *(jnp.asarray(x) for x in (r, m)
                                                     if x is not None))
        ref_grads = vjp(jnp.asarray(g))
        ins = [_t(a).requires_grad_(True) for a in (q, k, v)
               + tuple(x for x in (r, m) if x is not None)]
        it = iter(ins[3:])
        got = tattn.band_attention(*ins[:3], _t(valid), w,
                                   None if r is None else next(it),
                                   None if m is None else next(it))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOLS["float32"])
        got.backward(_t(g))
        for a, ref in zip(ins, ref_grads):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref), **TOLS["float32"])
        outs.append(got.detach())
    assert tband.LAUNCHES == 0
    plain = tattn.band_attention(_t(q), _t(k), _t(v), _t(valid), w)
    for got in outs:
        assert (got - plain).abs().max() > 1e-2
    with pytest.raises(ValueError):
        tband.band_attention_kernel(_t(q), _t(k), _t(v), _t(valid)[:, :4], 3)


TILE = 8            # query rows of a block of csrc/band_attention.cu (ROWS)


def _kernel_tiles(q, k, v, valid, w):
    """The kernel's decomposition in plain torch: each TILE-row tile of each
    sample computed from its own staged rows alone. The staged k / v rows
    r0 - w .. r0 + TILE + w - 1 are zeros outside the sequence, the key masks
    are read from the staged rows (inside the sequence and not masked), the
    arithmetic runs in f32 rounded to the input dtype where the kernel
    rounds: products, their f32 sum once, the penalised score, s - max, the
    exp, the running sum, the quotient as e times the f32 reciprocal of the
    sum, each product and running sum of the context."""
    b, h, t, d = q.shape
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()  # noqa: E731
    pen = rnd(torch.tensor(-1e4))
    out = torch.empty_like(q)
    for r0 in range(0, t, TILE):
        n = min(TILE, t - r0)
        ks, vs = (torch.zeros((b, h, TILE + 2 * w, d)) for _ in range(2))
        live = torch.zeros((b, TILE + 2 * w), dtype=torch.bool)
        lo, hi = max(r0 - w, 0), min(r0 + TILE + w, t)
        at = slice(lo - (r0 - w), hi - (r0 - w))
        ks[:, :, at], vs[:, :, at], live[:, at] = k[:, :, lo:hi], v[:, :, lo:hi], valid[:, lo:hi]
        rows = torch.arange(r0, r0 + n)
        qt = q[:, :, r0:r0 + n].float()
        scores = []
        for dd in range(-w, w + 1):
            j = slice(w + dd, w + dd + n)                        # staged rows of keys r + dd
            s = rnd(rnd(qt * ks[:, :, j]).sum(-1))
            s = torch.where(live[:, None, j], s, rnd(s + pen))
            inseq = (rows + dd >= 0) & (rows + dd < t)
            scores.append(torch.where(inseq, s, float("-inf")))
        mx = torch.stack(scores).amax(0)
        exps = [rnd(torch.exp(rnd(s - mx))) for s in scores]
        den = exps[0]
        for e in exps[1:]:
            den = rnd(den + e)
        inv = 1.0 / den
        acc = torch.zeros_like(qt)
        for dd, e in zip(range(-w, w + 1), exps):
            p = rnd(e * inv)[..., None]
            acc = rnd(acc + rnd(p * vs[:, :, w + dd:w + dd + n]))
        own = live[:, None, w:w + n, None]                      # the row's own key slot
        out[:, :, r0:r0 + n] = torch.where(own, acc, 0.0).to(dt)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("w", [0, 1, 3, 8])
@pytest.mark.parametrize("t", [150, 97, 1])
def test_kernel_tiles_stitch_to_plain(rng, t, w, d, dtype):
    """T that 8 does not divide (18 full tiles and a ragged one; 12 and a
    row; one row), valid lengths T, 2T/3, 1 and 0 (a fully masked sample,
    and masked rows after each length): the tiles stitched together are
    band_attention_plain on the whole sequence. In bf16 the f32 sums run in
    another order than torch's, which may move a score by one bf16 step:
    nearly every element is equal, all within the kernel's tolerance."""
    lens = (t, (2 * t) // 3, 1, 0)
    q, k, v, valid = _case(rng, 4, 4, t, d, lens)
    tdt = getattr(torch, dtype)
    q, k, v, valid = _t(q, tdt), _t(k, tdt), _t(v, tdt), _t(valid)
    got = _kernel_tiles(q, k, v, valid, w)
    want = tband.band_attention_plain(q, k, v, valid, w)
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    assert not got[3].any() and not got[2, :, 1:].any()     # masked rows come out zero
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **TOLS[dtype])
        assert (got == want).float().mean().item() >= 0.99


def test_quotient_from_reciprocal_rounds_as_division():
    """The kernel's quotient rnd(e * (1 / den)) equals plain's rnd(e / den)
    bit for bit for every bf16 e in [0, 1] and den in [1, 17] (the exps and
    their sums at w <= 8), subnormal e included."""
    e = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    den = torch.arange(0x3F80, 0x4189, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    assert e.max() == 1 and den.min() == 1 and den.max() == 17
    by_reciprocal = (e[:, None] * (1.0 / den)[None, :]).to(torch.bfloat16)
    by_division = (e[:, None] / den[None, :]).to(torch.bfloat16)
    assert torch.equal(by_reciprocal.view(torch.int16), by_division.view(torch.int16))


@pytest.mark.parametrize("dtype,d,ok", [
    ("bfloat16", 64, True), ("bfloat16", 32, True), ("bfloat16", 128, True),
    ("bfloat16", 48, True), ("bfloat16", 256, True), ("bfloat16", 20, False),
    ("bfloat16", 264, False), ("float32", 64, True), ("float32", 128, True),
    ("float32", 6, False), ("float32", 160, False)])
def test_kernel_limits_name_the_head_width(dtype, d, ok):
    q = torch.empty((1, 1, 1, d), dtype=getattr(torch, dtype))
    if ok:
        tband.kernel_limits(q, tband.MAX_W)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            tband.kernel_limits(q, 3)
    with pytest.raises(ValueError, match="w_overlap"):
        tband.kernel_limits(torch.empty((1, 1, 1, 64)), tband.MAX_W + 1)


def test_rows_ok_copies_only_what_the_kernel_cannot_read():
    """Head views of (B, T, H D) projections go to the kernel as they are;
    a transposed row or a row off 16-byte alignment is copied."""
    base = torch.randn(2, 12, 4 * 64).to(torch.bfloat16)
    heads = base.reshape(2, 12, 4, 64).transpose(1, 2)
    assert tband._rows_ok(heads) is heads
    one = torch.randn(4 * 12 * 64).as_strided((1, 4, 12, 64), (7, 768, 64, 1))
    assert tband._rows_ok(one) is one                    # a size-1 batch is never stepped
    shifted = torch.randn(2 * 12 * 4 * 64 + 1).to(torch.bfloat16)[1:]
    for bad in (heads.transpose(2, 3).contiguous().transpose(2, 3),     # D not contiguous
                shifted.view(2, 12, 4, 64).transpose(1, 2),             # off by 2 bytes
                torch.randn(2, 4, 12, 66)[..., :64]):                    # row stride 66
        copied = tband._rows_ok(bad)
        assert copied is not bad and copied.is_contiguous() and torch.equal(copied, bad)

"""PyTorch port, banded attention (K7) vs the JAX package on the CPU.

``band_attention_plain`` (the kernel's plain version, every operation in the
input dtype) against the Pallas kernel ``band_attention_pallas`` in interpret
mode: f32 1e-5, bf16 2e-2. The ported ``band_attention_xla`` (f32 softmax)
against the JAX one. The gradients of the differentiable wrapper against
``jax.vjp`` of ``band_attention_xla``, which is what the JAX
``band_attention_fused`` differentiates (that function itself calls the
kernel without ``interpret`` and cannot run on the CPU). ``full_attention``
and ``shift_time`` against theirs."""

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
    q, k, v, valid = _case(rng, 1, 1, 8, 16, (8,))
    with pytest.raises(NotImplementedError):
        tattn.band_attention(_t(q), _t(k), _t(v), _t(valid), 3, rel_pe=torch.zeros(1, 7))
    with pytest.raises(ValueError):
        tband.band_attention_kernel(_t(q), _t(k), _t(v), _t(valid)[:, :4], 3)

"""PyTorch port, primitive ops vs the JAX package on the CPU: norms, masked
convs (stride 1, stride 2, depthwise), dense, the resamples and the PE.
Everything in float32; tolerance 1e-6 (both sides run the same f32 math,
only the summation order differs)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.ops import conv as jconv
from audio_visual_deepfake_detection_tpu.ops import norm as jnorm
from audio_visual_deepfake_detection_tpu.ops import pe as jpe
from audio_visual_deepfake_detection_tpu.ops import resample as jres
from audio_visual_deepfake_detection_tpu_torch.ops import conv as tconv
from audio_visual_deepfake_detection_tpu_torch.ops import norm as tnorm
from audio_visual_deepfake_detection_tpu_torch.ops import pe as tpe
from audio_visual_deepfake_detection_tpu_torch.ops import resample as tres

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_channel_layer_norm_and_instance_norm(rng):
    x = rng.standard_normal((2, 9, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tnorm.channel_layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jnorm.channel_layer_norm(jnp.asarray(x), w, b)), **TOL)
    np.testing.assert_allclose(
        tnorm.instance_norm_time(_t(x)).numpy(),
        np.asarray(jnorm.instance_norm_time(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("k,stride,groups,bias", [
    (3, 1, 1, True), (3, 2, 1, True), (1, 1, 1, False), (3, 1, 8, False)])
def test_masked_conv_matches_jax(rng, k, stride, groups, bias):
    b, t, cin, cout = 2, 16, 8, 8 if groups > 1 else 12
    x = rng.standard_normal((b, t, cin)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, 11:] = False
    mod = jconv.MaskedConv1D(cout, k, stride=stride, groups=groups, use_bias=bias)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    p = jax.device_get(params["params"])
    if bias:
        p["bias"] = rng.standard_normal(cout).astype(np.float32)
    ref, ref_mask = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))

    ours = tconv.MaskedConv1D(cin, cout, k, stride=stride, groups=groups, bias=bias)
    with torch.no_grad():
        ours.conv.weight.copy_(_t(np.transpose(p["kernel"], (2, 1, 0))))
        if bias:
            ours.conv.bias.copy_(_t(p["bias"]))
        got, got_mask = ours(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_dense_matches_jax(rng):
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    mod = jconv.Dense(6)
    p = jax.device_get(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    p["bias"] = rng.standard_normal(6).astype(np.float32)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    got = tconv.dense(_t(x), _t(p["kernel"].T), _t(p["bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("in_len,out_len", [(7, 20), (20, 7), (12, 12), (5, 768)])
def test_linear_resample_matches_jax(rng, in_len, out_len):
    x = rng.standard_normal((2, in_len, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tres.linear_resample_time(_t(x), out_len, axis=1).numpy(),
        np.asarray(jres.linear_resample_time(jnp.asarray(x), out_len, axis=1)), **TOL)


@pytest.mark.parametrize("in_len,out_len", [(6, 24), (24, 6), (10, 7), (7, 10)])
def test_nearest_resample_and_mask_match_jax(rng, in_len, out_len):
    x = rng.standard_normal((2, in_len, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tres.nearest_resample_time(_t(x), out_len, axis=1).numpy(),
        np.asarray(jres.nearest_resample_time(jnp.asarray(x), out_len, axis=1)))
    m = rng.random((2, in_len)) > 0.3
    np.testing.assert_array_equal(
        tres.downsample_mask(_t(m), out_len).numpy(),
        np.asarray(jres.downsample_mask(jnp.asarray(m), out_len)))


def test_sinusoid_pe_matches_jax():
    np.testing.assert_array_equal(tpe.sinusoid_encoding(768, 256).numpy(),
                                  np.asarray(jpe.sinusoid_encoding(768, 256)))

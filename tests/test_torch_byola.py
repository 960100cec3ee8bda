"""PyTorch port: the BYOL-A encoder vs the JAX package on the CPU, through
``byola_state_dict_from_flax`` with noisy parameters (random batch-norm
statistics and affines, variance > 0). f32 atol 1e-4 (another summation
order in the convs and the 512- and d-term products); bf16 at the JAX
package's own rule for the frontends (``tests/test_frontends_bf16.py``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.frontends import byola as jby
from audio_visual_deepfake_detection_tpu_torch.frontends import byola as tby
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import byola_state_dict_from_flax


def assert_bf16_close(a, b, rel=0.08):
    """``tests/test_frontends_bf16.py::_assert_bf16_close``: a = reference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(b).all()
    scale = max(float(np.std(a)), 1e-6)
    err = np.abs(a - b)
    assert float(np.median(err)) <= rel * 0.25 * scale, (np.median(err), scale)
    assert float(err.max()) <= rel * 4 * scale, (err.max(), scale)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def noisy_byola_params(rng, d=128):
    model = jby.AudioNTT2020(d=d)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 96, 64)))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if "bn_var" in name:
            val = 0.5 + rng.random(leaf.shape)
        elif "bn_scale" in name:
            val = 1 + 0.2 * rng.standard_normal(leaf.shape)
        elif leaf.ndim > 1:
            val = rng.standard_normal(leaf.shape) * float(np.prod(leaf.shape[:-1])) ** -0.5
        else:
            val = 0.1 * rng.standard_normal(leaf.shape)
        out[name] = np.asarray(val, np.float32)
    leaves = [out[jax.tree_util.keystr(p)] for p, _ in flat]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves)


def port_model(params, d=128, dtype=torch.float32):
    model = tby.AudioNTT2020(d=d, dtype=dtype)
    res = model.load_state_dict(byola_state_dict_from_flax(params), strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    return model.eval()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_audio_ntt_f32(rng):
    params = noisy_byola_params(rng)
    lms = rng.standard_normal((2, 96, 64)).astype(np.float32)
    want = np.asarray(jax.jit(jby.AudioNTT2020(d=128).apply)(params, jnp.asarray(lms)))
    with torch.no_grad():
        got = port_model(params)(torch.from_numpy(lms)).numpy()
    assert got.shape == want.shape == (2, 12, 128) and got.dtype == np.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_audio_ntt_bf16(rng):
    params = noisy_byola_params(rng)
    lms = rng.standard_normal((2, 96, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(jby.AudioNTT2020(d=128).apply)(params, jnp.asarray(lms)))
    want = np.asarray(jax.jit(jby.AudioNTT2020(d=128, dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(lms)))
    with torch.no_grad():
        got = port_model(params, dtype=torch.bfloat16)(torch.from_numpy(lms)).numpy()
    assert got.dtype == np.float32
    assert_bf16_close(ref, got)
    assert_bf16_close(want, got)


def test_byola_features_rows_and_values(rng):
    params = noisy_byola_params(rng)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, w: jby.byola_features(p, w, jby.AudioNTT2020(d=128)))(
        params, jnp.asarray(wav)))
    got = tby.byola_features(port_model(params), torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 101 // 8, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_state_dict_inverts_the_jax_converter(rng):
    params = noisy_byola_params(rng)
    back = jby.convert_byola_torch(byola_state_dict_from_flax(params), params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

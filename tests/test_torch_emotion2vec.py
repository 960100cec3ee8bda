"""PyTorch port: the whole Emotion2Vec vs the JAX package on the CPU, through
``emotion2vec_state_dict_from_flax`` with noisy parameters.

f32: atol 2e-4 / rtol 1e-3, the JAX package's own tolerance for the whole
model across its two extractor paths (``tests/test_conv_extractor_fused.py``
``:76``); the JAX side runs on its XLA path and with K5 and K8 in the Pallas
interpreter. bf16: the JAX package's distributional rule for the frontends
(``tests/test_frontends_bf16.py``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.frontends import emotion2vec as je2v
from audio_visual_deepfake_detection_tpu.ops.pallas import conv_extractor as jk5
from audio_visual_deepfake_detection_tpu.ops.pallas import full_attention as jk8
from audio_visual_deepfake_detection_tpu_torch.frontends import emotion2vec as te2v
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as tk5
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import full_attention as tk8
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    emotion2vec_state_dict_from_flax)

from test_torch_byola import assert_bf16_close

F32_TOL = dict(atol=2e-4, rtol=1e-3)
SMALL = dict(embed_dim=64, depth=1, prenet_depth=1, num_heads=2, conv_pos_groups=2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def noisy_emotion_params(cfg, rng, std=0.2):
    """Random O(std) values in every leaf; LN scales around 1, the ALiBi
    scale positive; dense kernels at 1/sqrt(fan_in) so the trunk stays O(1)."""
    model = je2v.Emotion2Vec(je2v.Emotion2VecConfig(**cfg))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 800)))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if "alibi_scale" in name:
            val = np.full(leaf.shape, 0.7)
        elif name.endswith("['scale']"):
            val = 1 + std * rng.standard_normal(leaf.shape)
        elif leaf.ndim == 2:
            val = rng.standard_normal(leaf.shape) * leaf.shape[0] ** -0.5
        elif leaf.ndim == 3 and "conv" in name:
            val = rng.standard_normal(leaf.shape) * (leaf.shape[0] * leaf.shape[1]) ** -0.5
        else:
            val = std * rng.standard_normal(leaf.shape)
        leaves.append(np.asarray(val, np.float32))
    return model, jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves)


def port_model(cfg, params, dtype=torch.float32):
    tm = te2v.Emotion2Vec(te2v.Emotion2VecConfig(**cfg), dtype=dtype)
    tm.load_state_dict(emotion2vec_state_dict_from_flax(params), strict=True)
    return tm.eval()


def _wav_and_mask(rng, lens, cap):
    wav = (rng.standard_normal((len(lens), cap)) * 0.1).astype(np.float32)
    mask = np.arange(cap)[None, :] >= np.asarray(lens)[:, None]
    return wav * ~mask, mask


def _jax_apply(monkeypatch, jm, params, wav, mask, interpret):
    for mod in (jk5, jk8):
        monkeypatch.setattr(mod, "ENABLED", False)
        monkeypatch.setattr(mod, "INTERPRET", interpret)
    fn = jax.jit(jm.apply)
    args = (jnp.asarray(wav),) if mask is None else (jnp.asarray(wav), jnp.asarray(mask))
    return np.asarray(fn(params, *args))


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "interpreter"])
@pytest.mark.parametrize("cfg,lens", [
    (SMALL, [8000, 6000]),
    (dict(SMALL, num_extra_tokens=2), [8000, 5000]),
    (dict(SMALL, use_alibi=True), [8000, 6500]),
    (dict(SMALL, use_alibi=True, num_extra_tokens=1), [6400, 6400]),
], ids=["small", "extra_tokens", "alibi", "alibi_extra"])
def test_small_model_f32(rng, monkeypatch, cfg, lens, interpret):
    jm, params = noisy_emotion_params(cfg, rng)
    wav, mask = _wav_and_mask(rng, lens, max(lens))
    if lens[0] == lens[1]:
        mask = None
    want = _jax_apply(monkeypatch, jm, params, wav, mask, interpret)
    tk5.reset_launches(), tk8.reset_launches()
    with torch.no_grad():
        got = port_model(cfg, params)(
            torch.from_numpy(wav), None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, je2v.conv_output_length(max(lens)), 64)
    assert got.dtype == np.float32 and np.abs(want).std() > 0.1
    # rows past a file's frames are padding queries: finite, and compared too
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert tk5.LAUNCHES == 0 and tk8.LAUNCHES == 0


def test_default_width_f32(rng, monkeypatch):
    cfg = dict(depth=2, prenet_depth=1)
    jm, params = noisy_emotion_params(cfg, rng)
    wav, mask = _wav_and_mask(rng, [9600, 7000], 9600)
    want = _jax_apply(monkeypatch, jm, params, wav, mask, False)
    with torch.no_grad():
        got = port_model(cfg, params)(torch.from_numpy(wav), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 29, 768)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_bf16_distributional(rng, monkeypatch):
    cfg = dict(SMALL, num_extra_tokens=1)
    jm, params = noisy_emotion_params(cfg, rng)
    wav, mask = _wav_and_mask(rng, [8000, 6000], 8000)
    ref = _jax_apply(monkeypatch, jm, params, wav, mask, False)
    jb = je2v.Emotion2Vec(je2v.Emotion2VecConfig(**cfg), dtype=jnp.bfloat16)
    want = _jax_apply(monkeypatch, jb, params, wav, mask, False)
    with torch.no_grad():
        got = port_model(cfg, params, torch.bfloat16)(
            torch.from_numpy(wav), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32
    assert_bf16_close(ref, got)
    assert_bf16_close(want, got)


def test_alibi_slopes_and_bias():
    for h in (2, 8, 12):
        np.testing.assert_array_equal(te2v.alibi_slopes(h), je2v.alibi_slopes(h))
    np.testing.assert_array_equal(te2v.alibi_bias(12, 7), je2v.alibi_bias(12, 7))
    assert te2v.alibi_slopes(12).shape == (12,)


def test_config_defaults_and_state_dict_round_trip(rng):
    assert te2v.Emotion2VecConfig() == te2v.Emotion2VecConfig(
        **{f: getattr(je2v.Emotion2VecConfig(), f)
           for f in je2v.Emotion2VecConfig.__dataclass_fields__})
    cfg = dict(SMALL, use_alibi=True, num_extra_tokens=2)
    _, params = noisy_emotion_params(cfg, rng)
    sd = emotion2vec_state_dict_from_flax(params)
    back = je2v.convert_emotion2vec_torch(sd, params, je2v.Emotion2VecConfig(**cfg))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(port_model(cfg, params).state_dict()) == set(sd)


def test_init_is_seeded():
    cfg = te2v.Emotion2VecConfig(**SMALL)
    a = te2v.init_emotion2vec(te2v.Emotion2Vec(cfg), seed=3).state_dict()
    b = te2v.init_emotion2vec(te2v.Emotion2Vec(cfg), seed=3).state_dict()
    c = te2v.init_emotion2vec(te2v.Emotion2Vec(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)

"""PyTorch port, the MViT-v2 video slice vs the JAX package on the CPU.

The whole encoder at a small config that holds every kernel geometry and
the transitions, against the JAX encoder with K2-K4 in the Pallas
interpreter and on its XLA path (atol 1e-4 / rtol 5e-4,
``tests/test_mvit_block_fused.py:140``); the chunk strategy, the feature
extractor, the resize, the weight carry, and a load of the torchvision
mirror of ``tests/test_mvit_golden.py`` (atol 2e-4, its ``:250``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.frontends import mvit as jmvit
from audio_visual_deepfake_detection_tpu.frontends import video as jvideo
from audio_visual_deepfake_detection_tpu.ops.pallas import mvit_attention as jk3
from audio_visual_deepfake_detection_tpu.ops.pallas import mvit_block as jk4
from audio_visual_deepfake_detection_tpu.ops.pallas import patch_embed as jk2
from audio_visual_deepfake_detection_tpu_torch.frontends import mvit as tmvit
from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline as tpipe
from audio_visual_deepfake_detection_tpu_torch.frontends import video as tvideo
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as tk3
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_block as tk4
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import patch_embed as tk2
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    mvit_state_dict_from_flax)

F32_TOL = dict(atol=1e-4, rtol=5e-4)
# blocks 0: S=64 -> K3; 2: S=16 -> K4; 4: S=4 -> K4; 1, 3, 5: transitions
SMALL = ([1, 2, 2, 1], [1, 2, 2, 2], [32, 64, 128, 128], 24)


def _noisy(params, rng, std=0.2):
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(rng.standard_normal(l.shape) * std, np.float32) for l in leaves])


def _pair(rng, setting=SMALL, temporal_size=8, t=8, **kw):
    """JAX encoder with random params + the port's encoder loaded from them."""
    jm = jmvit.MViTVideoEncoder(tuple(jmvit.generate_config(*setting)),
                                temporal_size=temporal_size, **kw)
    video = rng.random((1, t, 96, 96, 3)).astype(np.float32)
    params = _noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video)), rng)
    # the patch embed sees [0, 1] frames: keep its weights at the conv scale
    params["params"]["conv_proj"]["kernel"] *= 0.2
    tm = tmvit.MViTVideoEncoder(tmvit.generate_config(*setting),
                                temporal_size=temporal_size, **kw)
    tm.load_state_dict(mvit_state_dict_from_flax(params), strict=True)
    return jm, params, tm.eval()


def _interpret_all(monkeypatch, on: bool):
    for mod in (jk2, jk3, jk4):
        monkeypatch.setattr(mod, "ENABLED", False)
        monkeypatch.setattr(mod, "INTERPRET", on)
    monkeypatch.setattr(jk4, "MAX_SPATIAL", 16 if on else 4)


@pytest.mark.parametrize("path", ["xla", "interpret"])
def test_encoder_matches_jax(rng, monkeypatch, path):
    jm, params, tm = _pair(rng)
    video = rng.random((2, 8, 96, 96, 3)).astype(np.float32)
    _interpret_all(monkeypatch, path == "interpret")
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(video)))
    for mod in (tk2, tk3, tk4):
        mod.reset_launches()
    thw = tm.patch_grid(video.shape)
    routes = []
    for blk in tm.blocks:
        routes.append("K4" if blk.fused_geometry_ok(thw, 1 + int(np.prod(thw))) else
                      "eager" if blk.cfg.stride_q != (1, 1, 1) else "K3")
        thw = tuple((s + st - 1) // st for s, st in zip(thw, blk.cfg.stride_q))
    assert routes == ["K3", "eager", "K4", "eager", "K4", "eager"]
    with torch.no_grad():
        got = tm(torch.from_numpy(video))
    assert tk2.LAUNCHES == tk3.LAUNCHES == tk4.LAUNCHES == 0   # CPU: plain versions
    assert got.shape == want.shape == (2, 8, 24)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_hybrid_front_groups_equal_whole_forward(rng):
    """front_group tiling with a ragged, zero-padded tail group and both
    back-stage settings == the whole forward."""
    _, _, tm = _pair(rng, setting=([1, 1], [1, 2], [16, 32], 24), temporal_size=4, t=4,
                     batch_front_split=1)
    video = torch.from_numpy(rng.random((5, 4, 96, 96, 3)).astype(np.float32))
    with torch.no_grad():
        want = tm(video)
        for kw in (dict(front_group=2), dict(front_group=2, batched_back=True),
                   dict(front_group=3, sequential_patch=True), dict()):
            got = tmvit.hybrid_apply(tm, video, **kw)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_hybrid_front_groups_take_uint8_chunks(rng):
    """uint8 chunks through front groups with a zero-padded uint8 tail
    group == the whole forward on the same chunks normalized."""
    _, _, tm = _pair(rng, setting=([1, 1], [1, 2], [16, 32], 24), temporal_size=4, t=4,
                     batch_front_split=1)
    u8 = torch.from_numpy(rng.integers(0, 256, (5, 4, 96, 96, 3), dtype=np.uint8))
    with torch.no_grad():
        want = tm(u8.float() * np.float32(1 / 255))
        got = tmvit.hybrid_apply(tm, u8, front_group=2, batched_back=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_video_features_match_jax(rng, monkeypatch):
    """A 20-frame uint8 clip in 8-frame chunks (zero-padded tail)."""
    from audio_visual_deepfake_detection_tpu.frontends.pipeline import (
        FeatureExtractor, FrontendParams)

    jm, params, tm = _pair(rng, setting=([1, 1], [1, 2], [16, 32], 24), t=8,
                           batch_front_split=1)
    frames = rng.integers(0, 256, (20, 96, 96, 3), dtype=np.uint8)
    _interpret_all(monkeypatch, False)
    jex = FeatureExtractor(params=FrontendParams(video=params, byola=None, emotion=None),
                           video_model=jm, video_chunk=8)
    want = jex.video_features(frames)
    tex = tpipe.FeatureExtractor(video_model=tm, video_chunk=8)
    got = tex.video_features(frames)
    assert got.shape == want.shape == (20, 24)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the audio streams' default models are built at first use, beside the
    # given video model: 1 s of wav -> 101 mel frames -> 12 BYOL-A rows
    assert tex.byola_features(np.zeros(16000, np.float32)).shape == (12, 2048)


def test_video_chunks_features_take_uint8_chunks_as_they_are(rng, monkeypatch):
    """96x96 uint8 chunks go to the patch embed's uint8 entry as they are
    (zero-padded tail chunk and all): the features equal those of the same
    chunks normalized first, bit for bit, and the JAX extractor's on the
    uint8 chunks."""
    from audio_visual_deepfake_detection_tpu.frontends.pipeline import (
        FeatureExtractor, FrontendParams)

    jm, params, tm = _pair(rng, setting=([1, 1], [1, 2], [16, 32], 24), t=8,
                           batch_front_split=1)
    chunks = rng.integers(0, 256, (3, 8, 96, 96, 3), dtype=np.uint8)
    chunks[-1, 5:] = 0
    seen = []
    u8_entry = tk2.fused_patch_embed_u8
    monkeypatch.setattr(tk2, "fused_patch_embed_u8",
                        lambda v, *a: (seen.append(v.dtype), u8_entry(v, *a))[1])
    tex = tpipe.FeatureExtractor(video_model=tm, video_chunk=8)
    got = tex.video_chunks_features(chunks)
    assert seen == [torch.uint8]
    normalized = tex.video_chunks_features(chunks.astype(np.float32) * np.float32(1 / 255))
    assert seen == [torch.uint8] and np.array_equal(got, normalized)
    _interpret_all(monkeypatch, False)
    jex = FeatureExtractor(params=FrontendParams(video=params, byola=None, emotion=None),
                           video_model=jm, video_chunk=8)
    want = jex.video_chunks_features(chunks)
    assert got.shape == want.shape == (3, 8, 24)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_forward_builds_no_band_array(rng, monkeypatch):
    """The K3 block of a forward takes the table entry; the band-array entry
    is never called (on the card that entry is K3's JAX contract only)."""
    _, _, tm = _pair(rng)

    def refuse(*args, **kwargs):
        raise AssertionError("band-array entry called")

    table_calls = []
    table = tk3.pooled_attention_table
    monkeypatch.setattr(tk3, "fused_pooled_attention", refuse)
    monkeypatch.setattr(tk3, "pooled_attention_table",
                        lambda *a, **kw: (table_calls.append(a[4:6]), table(*a, **kw))[1])
    with torch.no_grad():
        out = tm(torch.from_numpy(rng.random((2, 8, 96, 96, 3)).astype(np.float32)))
    assert out.shape == (2, 8, 24) and table_calls == [(8, 64)]   # block 0: T 8, S 64


def test_bilinear_resize_matches_jax_downscale(rng):
    frames = rng.random((3, 128, 160, 3)).astype(np.float32)
    want = np.asarray(jvideo.bilinear_resize_video(jnp.asarray(frames), (96, 96)))
    got = tvideo.bilinear_resize_video(torch.from_numpy(frames), (96, 96))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    chunks, t = tvideo.chunk_video(frames, 2)
    jchunks, jt = jvideo.chunk_video(frames, 2)
    assert t == jt == 3 and np.array_equal(chunks, jchunks)


def test_weight_carry_round_trip(rng):
    jm = jmvit.MViTVideoEncoder(tuple(jmvit.generate_config(*SMALL)), temporal_size=8)
    params = _noisy(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 96, 96, 3)))), rng)
    back = jmvit.convert_mvit_torch(mvit_state_dict_from_flax(params), params)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.dtype == a.dtype and np.array_equal(np.asarray(b), np.asarray(a)), path


def test_loads_torchvision_mirror_state_dict(rng):
    from tests.test_mvit_golden import TorchMViT, _randomize

    setting = jmvit.generate_config([1, 2], [1, 2], [16, 32], 24)
    ref = TorchMViT(setting, input_thw=(4, 4, 4)).eval()
    _randomize(ref)
    ours = tmvit.MViTVideoEncoder(tmvit.generate_config([1, 2], [1, 2], [16, 32], 24),
                                  temporal_size=4, spatial_size=(48, 48))
    ours.load_state_dict(ref.state_dict(), strict=True)
    video = rng.standard_normal((2, 4, 48, 48, 3)).astype(np.float32)
    with torch.no_grad():
        got = ours(torch.from_numpy(video)).numpy()
        tokens, thw = ref(torch.from_numpy(video).permute(0, 4, 1, 2, 3))
    want = tokens.reshape(2, *thw, tokens.shape[-1]).mean(dim=(2, 3)).numpy()
    assert got.shape == want.shape == (2, 4, 24)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("name", ["mvit_v2_t", "mvit_v2_s", "mvit_v2_b"])
def test_family_configs_match_jax(name):
    jm, tm = getattr(jmvit, name)(), getattr(tmvit, name)()
    assert [tuple(map(getattr, [c] * 7, tmvit.MSBlockConfig.__dataclass_fields__))
            for c in tm.block_setting] == \
        [tuple(map(getattr, [c] * 7, jmvit.MSBlockConfig.__dataclass_fields__))
         for c in jm.block_setting]
    assert tm.batch_front_split == jm.batch_front_split

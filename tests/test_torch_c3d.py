"""PyTorch port, the C3D video encoder and tail-chunk bucketing against the
JAX package on the CPU.

``C3DVideoEncoder`` carries its weights into the JAX ``C3DVideoEncoder``
through the JAX package's own ``convert_c3d_torch`` (the port's state dict
under the reference's names, unchanged) and gives the same features at
1e-4 (``tests/test_video_frontend.py:86``): at small widths with every
width distinct, so that a transposed (c, h, w) flatten or a swapped
channel cannot pass by symmetry, and at the production widths (64, 96,
128, 128). ``FeatureExtractor`` builds the seeded C3D when no video model
is given, as the JAX one does; runs C3D's chunks in groups that change no
result; and with ``chunk_buckets`` gives the unbucketed rows and features
(1e-3, the JAX test's) and the JAX bucketed features (1e-4).
``cli/extract_features.py --video-encoder c3d`` writes the JAX package's
``extract_to_cache`` caches for a cv2-written mp4 (small C3D and audio
models on the same weights in both packages)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.frontends import pipeline as jfront
from audio_visual_deepfake_detection_tpu.frontends.video import (
    C3DVideoEncoder as JC3DVideoEncoder, convert_c3d_torch)
from audio_visual_deepfake_detection_tpu_torch.cli import extract_features as extract_cli
from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline as tfront
from audio_visual_deepfake_detection_tpu_torch.frontends.video import C3DVideoEncoder, init_c3d

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_e2e_media import FEAT_TOL, VIDEO_D, models  # noqa: E402
from test_torch_media import smooth_frames, write_mp4  # noqa: E402

SMALL_NF = (4, 6, 8, 10)
assert models                                       # the fixture, imported for its name


def jax_params(port: C3DVideoEncoder, frames_shape):
    """The port's weights in a JAX C3D of the same widths."""
    nf = tuple(blk[0].conv.weight.shape[0] for blk in (port.block0, port.block1, port.block2,
                                                       port.block3))
    jm = JC3DVideoEncoder(n_features=nf, out_dim=port.out_dim)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct(frames_shape, np.float32))
    return jm, convert_c3d_torch(port.state_dict(), template)


@pytest.mark.parametrize("nf,out_dim,t", [(SMALL_NF, 24, 6), ((64, 96, 128, 128), 256, 2)],
                         ids=["small", "production"])
def test_c3d_matches_jax(nf, out_dim, t):
    rng = np.random.default_rng(0)
    video = rng.uniform(0, 1, (2, t, 96, 96, 3)).astype(np.float32)
    port = init_c3d(C3DVideoEncoder(nf, out_dim), seed=3)
    names = list(port.state_dict())
    assert names[:2] == ["block0.0.conv.weight", "block0.0.conv.bias"]
    assert {"block3.0.conv.weight", "block3.2.conv.weight", "block3.5.conv.weight"} <= set(names)
    assert port.block3[5].conv.weight.shape == (out_dim, nf[3] * 4, 1)
    jm, p = jax_params(port, video.shape)
    want = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(video)))
    with torch.no_grad():
        got = port(torch.from_numpy(video))
    assert got.dtype == torch.float32 and got.shape == (2, t, out_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert np.abs(want).max() > 1e-2


def test_c3d_bf16_matches_jax_bf16():
    """Compute in bf16, parameters f32, output f32; the JAX module in bf16
    on the same weights within bf16 rounding."""
    rng = np.random.default_rng(1)
    video = rng.uniform(0, 1, (1, 4, 96, 96, 3)).astype(np.float32)
    port = init_c3d(C3DVideoEncoder(SMALL_NF, 24, dtype=torch.bfloat16), seed=4)
    assert all(prm.dtype == torch.float32 for prm in port.parameters())
    _, p = jax_params(port, video.shape)
    jm = JC3DVideoEncoder(n_features=SMALL_NF, out_dim=24, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply(p, jnp.asarray(video)))
    with torch.no_grad():
        got = port(torch.from_numpy(video))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2, rtol=3e-2)


def test_feature_extractor_defaults_to_c3d():
    """No video model given: the seeded production C3D in the compute dtype,
    as the JAX ``FeatureExtractor`` builds; the same seed gives the same
    weights."""
    ex = tfront.FeatureExtractor(seed=5, compute_dtype="bfloat16", device="cpu")
    model = ex.video_model
    assert isinstance(model, C3DVideoEncoder) and model.dtype == torch.bfloat16
    assert [blk[0].conv.weight.shape[0] for blk in (model.block0, model.block1, model.block2,
                                                    model.block3)] == [64, 96, 128, 128]
    assert model.out_dim == 256 and not model.training
    again = tfront.FeatureExtractor(seed=5, device="cpu").video_model
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_c3d_chunk_groups_change_no_result(monkeypatch):
    """Chunks run in groups of ``C3D_CHUNK_GROUP`` (here 2, over 5 uint8
    chunks at 64x64, resized on the way): the same features as one batch."""
    rng = np.random.default_rng(2)
    chunks = rng.integers(0, 256, (5, 4, 64, 64, 3), dtype=np.uint8)
    port = init_c3d(C3DVideoEncoder(SMALL_NF, 24), seed=6)
    ex = tfront.FeatureExtractor(video_model=port, video_chunk=4)
    whole = ex.video_chunks_features(chunks)
    seen = []
    forward = port.forward
    monkeypatch.setattr(port, "forward", lambda x: (seen.append(x.shape[0]), forward(x))[1])
    monkeypatch.setattr(tfront, "C3D_CHUNK_GROUP", 2)
    grouped = ex.video_chunks_features(chunks)
    assert seen == [2, 2, 1] and grouped.shape == (5, 4, 24)
    np.testing.assert_allclose(grouped, whole, atol=1e-6)


@pytest.mark.parametrize("perturb", [False, True], ids=["zero-bias", "biased"])
def test_bucketed_features_match_unbucketed_and_jax(perturb):
    """21 frames at chunks of 16 (one full chunk, a tail of 5) and buckets
    (8, 16): the tail runs at 8 frames, the rows are the frame count and
    the features the JAX package's bucketed ones at 1e-4; a video shorter
    than every bucket too. With zero conv biases (``init_c3d``'s and flax's
    fresh init, the JAX test's case) they are the zero-padded chunk's at
    1e-3. Biases make a padded frame's activations nonzero, so the tail's
    last rows then see other values past the end in the two layouts."""
    rng = np.random.default_rng(3)
    port = init_c3d(C3DVideoEncoder(SMALL_NF, 24), seed=7, perturb=perturb)
    jm, p = jax_params(port, (1, 16, 96, 96, 3))
    sizes = []
    ex_pad = tfront.FeatureExtractor(video_model=port, video_chunk=16)
    ex_buck = tfront.FeatureExtractor(video_model=port, video_chunk=16, chunk_buckets=(16, 8))
    assert ex_buck.chunk_buckets == (8, 16) and ex_pad.chunk_buckets is None
    run = ex_buck.video_chunks_features
    ex_buck.video_chunks_features = lambda c: (sizes.append(c.shape[1]), run(c))[1]
    j_buck = jfront.FeatureExtractor(
        params=jfront.FrontendParams(video=p, byola=None, emotion=None), video_model=jm,
        video_chunk=16, chunk_buckets=(8, 16))
    for n, want_sizes in ((21, [16, 8]), (3, [8])):
        frames = rng.integers(0, 256, (n, 96, 96, 3), dtype=np.uint8)
        sizes.clear()
        a, b = ex_pad.video_features(frames), ex_buck.video_features(frames)
        assert sizes == want_sizes
        assert a.shape == b.shape == (n, 24)
        np.testing.assert_allclose(b, j_buck.video_features(frames), atol=1e-4)
        if not perturb:
            np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-3)
        else:
            assert np.abs(b - a).max() > 1e-4


def test_extract_cli_c3d_writes_the_jax_caches(models, monkeypatch, tmp_path):
    """One cv2-written 112x112 mp4 of 37 frames and its wav through
    ``cli/extract_features.py --video-encoder c3d`` (chunks of 16, buckets on
    the second run) against JAX ``extract_to_cache`` with the same weights:
    the three caches at the encoders' tolerances, video rows = frames."""
    from scipy.io import wavfile

    rng = np.random.default_rng(4)
    rel = "spk/clip/00000/real.mp4"
    for sub in ("data", "wav"):
        os.makedirs(tmp_path / sub / os.path.dirname(rel))
    write_mp4(str(tmp_path / "data" / rel), smooth_frames(rng, 37, 112, 112))
    wavfile.write(str(tmp_path / "wav" / rel.replace(".mp4", ".wav")), 16000,
                  (rng.standard_normal(23680) * 3000).astype(np.int16))
    (tmp_path / "list.txt").write_text(rel + "\n")
    tex, jex = models["tex"], models["jex"]

    def c3d(dtype):
        return C3DVideoEncoder(SMALL_NF, VIDEO_D, dtype=dtype)

    def extractor(**kw):
        return tfront.FeatureExtractor(byola_model=tex.byola_model,
                                       emotion_model=tex.emotion_model, **kw)

    monkeypatch.setattr(extract_cli, "C3DVideoEncoder", c3d)
    monkeypatch.setattr(extract_cli, "FeatureExtractor", extractor)
    port_video = init_c3d(c3d(torch.float32), seed=9, perturb=False)
    jm, vparams = jax_params(port_video, (1, 16, 96, 96, 3))
    for out, flags, buckets in (("port", [], None),
                                ("port_b", ["--video-chunk-bucketing"], (4, 8, 12, 16))):
        extract_cli.main([str(tmp_path / "list.txt"), "--video-root", str(tmp_path / "data"),
                          "--wav-root", str(tmp_path / "wav"), "--output-root",
                          str(tmp_path / out), "--video-encoder", "c3d", "--video-chunk", "16",
                          "--seed", "9", "--device", "cpu", *flags])
        ref = jfront.FeatureExtractor(
            params=jfront.FrontendParams(video=vparams, byola=jex.params.byola,
                                         emotion=jex.params.emotion),
            video_model=jm, byola_model=jex.byola_model, emotion_model=jex.emotion_model,
            video_chunk=16, chunk_buckets=buckets)
        ref.extract_to_cache(str(tmp_path / "data" / rel),
                             str(tmp_path / "wav" / rel.replace(".mp4", ".wav")),
                             str(tmp_path / f"jax_{out}"), rel.replace(".mp4", ".npy"))
        for key, name in tfront.CACHE_DIR_NAMES.items():
            got = np.load(tmp_path / out / name / rel.replace(".mp4", ".npy"))
            want = np.load(tmp_path / f"jax_{out}" / name / rel.replace(".mp4", ".npy"))
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, **FEAT_TOL[key], err_msg=key)
            if key == "video":
                assert got.shape == (37, VIDEO_D)

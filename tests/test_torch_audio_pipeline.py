"""PyTorch port, the audio slice as a whole vs the JAX package on the CPU:
``FeatureExtractor``'s audio methods on wavs of different length (shared
converted weights), the device-side ragged resample, and wav + a
video-feature stand-in -> truncation -> ``build_online_inference_fn`` ->
detections, at the tolerances of ``tests/test_torch_localizer.py`` (scores
1e-4, segments 1e-3, video logit 2e-4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.data import metadata as jmeta
from audio_visual_deepfake_detection_tpu.frontends import byola as jby
from audio_visual_deepfake_detection_tpu.frontends import emotion2vec as je2v
from audio_visual_deepfake_detection_tpu.frontends import pipeline as jpipe
from audio_visual_deepfake_detection_tpu.infer import runner as jrunner
from audio_visual_deepfake_detection_tpu.infer.decode import TestConfig as JTestConfig
from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.ops import resample as jres
from audio_visual_deepfake_detection_tpu.train.state import init_model
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig, TestConfig
from audio_visual_deepfake_detection_tpu_torch.data import metadata as tmeta
from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline as tpipe
from audio_visual_deepfake_detection_tpu_torch.infer import (
    build_online_inference_fn, collate_streams)
from audio_visual_deepfake_detection_tpu_torch.models import AVLocalizer
from audio_visual_deepfake_detection_tpu_torch.ops import resample as tres
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import state_dict_from_flax

from test_torch_byola import noisy_byola_params, port_model as port_byola
from test_torch_emotion2vec import SMALL, noisy_emotion_params, port_model as port_emotion
from test_torch_localizer import TEST, _perturb

BYOLA_D, VIDEO_D = 16, 8
ARCH = dict(variant="av_recovery_norecon", input_dim=VIDEO_D + BYOLA_D + SMALL["embed_dim"],
            num_classes=1, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
DURATIONS = (3.84, 3.0)                  # seconds; 96 and 75 video frames at 25 fps


@pytest.fixture(scope="module")
def extractors():
    rng = np.random.default_rng(11)
    bparams = noisy_byola_params(rng, d=BYOLA_D)
    jem, eparams = noisy_emotion_params(SMALL, rng)
    jex = jpipe.FeatureExtractor(
        params=jpipe.FrontendParams(video=None, byola=bparams, emotion=eparams),
        byola_model=jby.AudioNTT2020(d=BYOLA_D), emotion_model=jem)
    tex = tpipe.FeatureExtractor(byola_model=port_byola(bparams, d=BYOLA_D),
                                 emotion_model=port_emotion(SMALL, eparams), device="cpu")
    wavs = [(rng.standard_normal(int(d * 16000)) * 0.1).astype(np.float32)
            for d in DURATIONS]
    return jex, tex, wavs


def test_trunc_rows_match():
    for d in (9.6, 3.84, 3.0, 0.5):
        assert tmeta.byola_trunc_rows(d) == jmeta.byola_trunc_rows(d)
        assert tmeta.emotion_trunc_rows(d) == jmeta.emotion_trunc_rows(d)
    assert (tmeta.byola_trunc_rows(9.6), tmeta.emotion_trunc_rows(9.6)) == (119, 479)


def test_emotion_features_batch(extractors):
    jex, tex, wavs = extractors
    want, got = jex.emotion_features_batch(wavs), tex.emotion_features_batch(wavs)
    assert [g.shape for g in got] == [w.shape for w in want] == [(191, 64), (149, 64)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3)


def test_byola_features_batch(extractors):
    jex, tex, wavs = extractors
    want, got = jex.byola_features_batch(wavs), tex.byola_features_batch(wavs)
    assert [g.shape for g in got] == [w.shape for w in want] == [(50, BYOLA_D)] * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_single_file_methods(extractors):
    jex, tex, wavs = extractors
    np.testing.assert_allclose(tex.byola_features(wavs[1]), jex.byola_features(wavs[1]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tex.emotion_features(wavs[1]), jex.emotion_features(wavs[1]),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("use_matmul", [False, True], ids=["gather", "matmul"])
def test_linear_resample_dynamic(use_matmul):
    """The port's gather lowering against either lowering of the JAX package."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 40, 5)).astype(np.float32)
    rows = np.array([40, 17, 1], np.int32)
    for i, n in enumerate(rows):
        x[i, n:] = 0
    want = np.asarray(jres.linear_resample_dynamic(jnp.asarray(x), jnp.asarray(rows), 96,
                                                   use_matmul=use_matmul))
    got = tres.linear_resample_dynamic(torch.from_numpy(x), torch.from_numpy(rows), 96).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for i, n in enumerate(rows):       # equals the static resample of the valid prefix
        ref = tres.linear_resample_time(torch.from_numpy(x[i, :n]), 96).numpy()
        np.testing.assert_allclose(got[i], ref, atol=1e-6, rtol=0)


def test_linear_resample_matrix():
    """The port's static resample against the JAX package's dense matrix."""
    want = jnp.asarray(jres.linear_resample_matrix(37, 96))
    x = np.random.default_rng(0).standard_normal((2, 37, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tres.linear_resample_time(torch.from_numpy(x), 96).numpy(),
        np.asarray(jnp.einsum("btc,to->boc", jnp.asarray(x), want)), atol=1e-6, rtol=0)


def test_wav_to_detections_matches_jax(extractors):
    """The slice as a whole: wavs -> both audio streams -> row truncation ->
    zero-padded streams with a video-feature stand-in -> device resample to
    max_seq_len, concat, localizer, decode, soft-NMS."""
    jex, tex, wavs = extractors
    rng = np.random.default_rng(5)
    jcfg = JArchConfig(**ARCH)
    params, _ = init_model(jcfg, 2, 0)
    p = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"])), rng)
    model = AVLocalizer(ArchConfig(**ARCH)).eval()
    model.load_state_dict(state_dict_from_flax(p), strict=True)
    video = [rng.standard_normal((int(d * 25), VIDEO_D)).astype(np.float32) for d in DURATIONS]
    caps = [96, 60, 200]

    def samples(ex, meta):
        by, emo = ex.byola_features_batch(wavs), ex.emotion_features_batch(wavs)
        return [{"streams": [video[i], by[i][:meta.byola_trunc_rows(d)],
                             emo[i][:meta.emotion_trunc_rows(d)]],
                 "duration": d, "video_id": f"v{i}"} for i, d in enumerate(DURATIONS)]

    t_streams, t_rows, t_dur, ids = collate_streams(samples(tex, tmeta), caps)
    j_streams, j_rows, j_dur, j_ids = jrunner.collate_streams(samples(jex, jmeta), caps)
    assert ids == j_ids and [r.tolist() for r in t_rows] == [r.tolist() for r in j_rows] \
        == [[96, 75], [47, 37], [191, 149]]
    j_out = [np.asarray(a) for a in jrunner.build_online_inference_fn(
        jcfg, JTestConfig(**TEST), 1.0, 1.0)({"params": p}, j_streams, j_rows, j_dur)]
    t_out = [a.numpy() for a in build_online_inference_fn(
        ArchConfig(**ARCH), TestConfig(**TEST), 1.0, 1.0)(model, t_streams, t_rows, t_dur)]
    segs, scores, _, valid, video_cls = t_out
    j_segs, j_scores, _, j_valid, j_video_cls = j_out
    for i in range(2):
        k = int(valid[i].sum())
        assert k == int(j_valid[i].sum()) and k > 0
        np.testing.assert_allclose(scores[i][:k], j_scores[i][:k], atol=1e-4)
        np.testing.assert_allclose(segs[i][:k], j_segs[i][:k], atol=1e-3)
    np.testing.assert_allclose(video_cls, j_video_cls, atol=2e-4)

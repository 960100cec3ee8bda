"""PyTorch port, batched soft-NMS / voting / batched_nms vs the JAX package
(``ops/nms.py`` under vmap) and vs the native C++ oracle
``runtime.host_softnms`` (atol 1e-5, as tests/test_nms.py:31-32)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.ops import nms as jnms
from audio_visual_deepfake_detection_tpu.runtime import host_softnms
from audio_visual_deepfake_detection_tpu_torch.ops import nms as tnms

METHOD_ID = {"hard": 0, "linear": 1, "gaussian": 2}


def _candidates(rng, b=3, n=60, t=100.0):
    start = rng.uniform(0, t, (b, n)).astype(np.float32)
    length = rng.uniform(0.5, 20, (b, n)).astype(np.float32)
    segs = np.stack([start, start + length], axis=-1)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = rng.random((b, n)) > 0.2
    return segs, scores, valid


@pytest.mark.parametrize("method,min_score", [
    ("gaussian", 0.2), ("gaussian", 0.001), ("linear", 0.1), ("hard", 0.0)])
def test_soft_nms_matches_jax_and_host_oracle(rng, method, min_score):
    segs, scores, valid = _candidates(rng)
    sigma, iou_t, max_out = 0.75, 0.1, 20
    got = [a.numpy() for a in tnms.soft_nms(
        torch.from_numpy(segs), torch.from_numpy(scores), torch.from_numpy(valid),
        max_out, iou_t, sigma, min_score, method)]
    ref = jax.vmap(lambda s, sc, v: jnms.soft_nms(
        s, sc, v, max_out, iou_t, sigma, min_score, method))(
        jnp.asarray(segs), jnp.asarray(scores), jnp.asarray(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-6)
    if method == "hard":
        return
    for i in range(segs.shape[0]):
        v = valid[i]
        h_segs, h_scores, _ = host_softnms(segs[i][v], scores[i][v], iou_t, sigma,
                                           min_score, METHOD_ID[method], max_out)
        k = int(got[2][i].sum())
        assert k == len(h_scores)
        np.testing.assert_allclose(got[0][i][:k], h_segs, atol=1e-5)
        np.testing.assert_allclose(got[1][i][:k], h_scores, atol=1e-5)


def test_seg_voting_matches_jax(rng):
    segs, scores, valid = _candidates(rng, n=30)
    nms_segs, nms_valid = segs[:, :5], valid[:, :5]
    got = tnms.seg_voting(torch.from_numpy(nms_segs), torch.from_numpy(nms_valid),
                          torch.from_numpy(segs), torch.from_numpy(scores), 0.5)
    ref = jax.vmap(lambda a, b, c, d: jnms.seg_voting(a, b, c, d, 0.5))(
        jnp.asarray(nms_segs), jnp.asarray(nms_valid), jnp.asarray(segs),
        jnp.asarray(scores))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_classes,multiclass,soft", [
    (1, False, True), (2, True, True), (1, False, False)])
def test_batched_nms_matches_jax(rng, num_classes, multiclass, soft):
    segs, scores, valid = _candidates(rng, n=40)
    cls = rng.integers(0, num_classes, scores.shape).astype(np.int32)
    kw = dict(num_classes=num_classes, iou_threshold=0.1, min_score=0.05,
              max_seg_num=12, use_soft_nms=soft, multiclass=multiclass,
              sigma=0.75, voting_thresh=0.9)
    got = [a.numpy() for a in tnms.batched_nms(
        torch.from_numpy(segs), torch.from_numpy(scores), torch.from_numpy(cls),
        torch.from_numpy(valid), **kw)]
    ref = jax.vmap(lambda s, sc, c, v: jnms.batched_nms(s, sc, c, v, **kw))(
        jnp.asarray(segs), jnp.asarray(scores), jnp.asarray(cls), jnp.asarray(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["none", "soft"])
def test_nms_pre_topk_breaks_ties_as_lax_top_k(rng, method):
    """``nms_pre_topk`` keeps the k best candidates; among equal scores, and
    across the k-th place, the lower index first, as ``lax.top_k`` does: the
    port's ``postprocess_batch`` gives the JAX one's detections exactly."""
    from audio_visual_deepfake_detection_tpu.infer import decode as jdecode
    from audio_visual_deepfake_detection_tpu_torch.core.config import TestConfig
    from audio_visual_deepfake_detection_tpu_torch.infer import decode as tdecode

    b, n, k = 4, 200, 37
    segs, _, valid = _candidates(rng, b=b, n=n, t=50.0)
    scores = (np.round(rng.random((b, n)) * 4) / 4).astype(np.float32)   # five values
    cls = np.zeros((b, n), np.int32)
    meta = [np.full(b, v, np.float32) for v in (25.0, 100.0, 0.3, 0.3)]
    cfg = dict(pre_nms_thresh=0.001, iou_threshold=0.1, min_score=0.001, max_seg_num=k,
               nms_method=method, nms_sigma=0.75, duration_thresh=0.001,
               multiclass_nms=False, voting_thresh=0.9, nms_pre_topk=k)
    want = jdecode.postprocess_batch(*map(jnp.asarray, (segs, scores, cls, valid, *meta)),
                                     jdecode.TestConfig(**cfg), 1)
    got = tdecode.postprocess_batch(*map(torch.from_numpy, (segs, scores, cls, valid, *meta)),
                                    TestConfig(**cfg), 1)
    # the same candidates kept: soft-NMS and voting then agree to atol 1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)

"""PyTorch port, losses and label assignment vs the JAX package on the CPU.

The same numpy inputs go through ``models/losses.py`` and the training half
of ``models/meta_arch.py`` in both packages; everything is f32 elementwise
arithmetic in the same order, so rtol 1e-6 (atol 1e-6 for values near 0)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.models import losses as jlosses
from audio_visual_deepfake_detection_tpu.models import meta_arch as jmeta
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig
from audio_visual_deepfake_detection_tpu_torch.models import losses as tlosses
from audio_visual_deepfake_detection_tpu_torch.models import meta_arch as tmeta

TOL = dict(rtol=1e-6, atol=1e-6)
ARCH = dict(input_dim=24, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_sigmoid_focal_loss_matches_jax(rng, alpha):
    x = (4 * rng.standard_normal((3, 50, 2))).astype(np.float32)
    y = rng.uniform(0, 1, (3, 50, 2)).astype(np.float32)
    ref = jlosses.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(y), alpha=alpha)
    got = tlosses.sigmoid_focal_loss(_t(x), _t(y), alpha=alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ctr_diou_loss_matches_jax(rng):
    a = rng.uniform(0, 5, (4, 30, 2)).astype(np.float32)
    b = rng.uniform(0, 5, (4, 30, 2)).astype(np.float32)
    a[0, :3] = 0.0      # empty prediction: the eps clamps decide
    ref = jlosses.ctr_diou_loss_1d(jnp.asarray(a), jnp.asarray(b))
    got = tlosses.ctr_diou_loss_1d(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _gt(rng, b=4, n=5):
    """Padded GT: varied counts, one sample without any, one pair of
    segments of equal length around the same points (a tie within 1e-3)."""
    seg = np.zeros((b, n, 2), np.float32)
    valid = np.zeros((b, n), bool)
    labels = rng.integers(0, 2, (b, n)).astype(np.int64)
    for i, cnt in enumerate([3, 0, 5, 2][:b]):
        start = rng.uniform(0, 70, cnt)
        seg[i, :cnt, 0] = start
        seg[i, :cnt, 1] = start + rng.uniform(2, 25, cnt)
        valid[i, :cnt] = True
    seg[3, 0] = (20.0, 30.0)
    seg[3, 1] = (20.5, 30.5004)
    return seg, labels, valid


@pytest.mark.parametrize("center_sample", ["radius", "none"])
def test_label_points_matches_jax(rng, center_sample):
    cfg = ArchConfig(**ARCH)
    jpoints = jmeta.model_points(jmeta.ArchConfig(**ARCH))
    tpoints = tmeta.model_points(cfg)
    np.testing.assert_array_equal(tpoints.numpy(), np.asarray(jpoints))
    seg, labels, valid = _gt(rng)
    ref_cls, ref_off = jmeta.label_points(jpoints, jnp.asarray(seg), jnp.asarray(labels),
                                          jnp.asarray(valid), 2, center_sample, 1.5)
    got_cls, got_off = tmeta.label_points(tpoints, _t(seg), _t(labels), _t(valid), 2,
                                          center_sample, 1.5)
    assert float(np.asarray(ref_cls).sum()) > 0
    np.testing.assert_array_equal(got_cls.numpy(), np.asarray(ref_cls))
    np.testing.assert_allclose(got_off.numpy(), np.asarray(ref_off), **TOL)


def _outputs(rng, cfg, b):
    outs = {"out_cls": [], "out_offsets": [], "fpn_masks": []}
    for t in cfg.fpn_lens:
        outs["out_cls"].append(rng.standard_normal((b, t, 1)).astype(np.float32))
        outs["out_offsets"].append(rng.uniform(0, 6, (b, t, 2)).astype(np.float32))
        m = np.ones((b, t), bool)
        m[1, (2 * t) // 3:] = False
        m[b - 1] = False                                # a padding row
        outs["fpn_masks"].append(m)
    outs["cls_scores"] = rng.standard_normal((b, 1)).astype(np.float32)
    return outs


@pytest.mark.parametrize("loss_weight,with_row_valid", [(2.0, True), (-1.0, True),
                                                        (1.0, False)])
def test_compute_losses_matches_jax(rng, loss_weight, with_row_valid):
    cfg = ArchConfig(**ARCH)
    b = 4
    outs = _outputs(rng, cfg, b)
    seg, labels, valid = _gt(rng, b)
    valid[b - 1] = False
    labels[:] = 0
    points = tmeta.model_points(cfg)
    gt_cls, gt_off = tmeta.label_points(points, _t(seg), _t(labels), _t(valid), 1)
    has_gt = valid.any(1)
    row_valid = np.arange(b) < b - 1 if with_row_valid else None
    kw = dict(num_classes=1, loss_weight=loss_weight, label_smoothing=0.1)

    jouts = {k: [jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v)
             for k, v in outs.items()}
    ref, ref_pos = jmeta.compute_losses(
        jouts, jnp.asarray(gt_cls.numpy()), jnp.asarray(gt_off.numpy()), jnp.asarray(has_gt),
        jnp.asarray(200.0), row_valid=None if row_valid is None else jnp.asarray(row_valid),
        **kw)
    touts = {k: [_t(a) for a in v] if isinstance(v, list) else _t(v) for k, v in outs.items()}
    got, got_pos = tmeta.compute_losses(
        touts, gt_cls, gt_off, _t(has_gt), torch.tensor(200.0),
        row_valid=None if row_valid is None else _t(row_valid), **kw)
    assert int(got_pos) == int(ref_pos) > 0
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-6, err_msg=key)
    # the normalizer is updated before the division
    norm = tmeta.update_loss_normalizer(torch.tensor(200.0), got_pos)
    np.testing.assert_allclose(float(norm), 0.9 * 200 + 0.1 * int(got_pos), rtol=1e-6)
    np.testing.assert_allclose(
        float(norm), float(jmeta.update_loss_normalizer(jnp.asarray(200.0), ref_pos)),
        rtol=1e-6)

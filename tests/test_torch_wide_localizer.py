"""PyTorch port, the legacy ``plain`` localizer at the block shapes beyond
the production one, against the JAX package on the CPU.

The structure of ActionFormer's THUMOS14 configuration (the ConvTransformer
backbone, arch (2, 2, 5), windows of 19 at every level, the identity neck,
no position encoding, 20 classes, ``max_buffer_len_factor`` 6) narrowed to
C = 128 with 4 heads of 32 and an input of 64, at T = 576 (the least length
that windows of 19 at strides up to 32 divide, as inference pads to): every
block is a K1 call at w = 9 (plain on the CPU); outputs (1e-4), detections
with multi-class soft-NMS (scores 1e-4, segments 1e-3, labels exactly),
``compute_losses`` over 20-class labels (rtol 1e-5), and a 4-step training
trajectory at T = 384 (tests/test_torch_train_step.py's rule: losses rtol
1e-4, the parameters within 2.5e-2 of the distance moved). Weights are
drawn on the JAX package's parameter shapes and carried across by
``tools/convert_jax.py``.

``scale_factor`` 3 and 4, read as the JAX package reads it: the pure-conv
localizer at 3 (levels of 216, 72 and 24 rows) and the ConvTransformer at 4
(levels of 256, 64 and 16 rows, its stride-4 blocks unfused with banded
attention through K7's entry) match it (outputs, detections, one step's
losses); a transformer block of stride 3 has depthwise convs of kernel 4,
which both packages' masked convs refuse.

Windows of 0, 1 and below -1: the JAX block runs them unfused with dense
attention, and so does the port's (no K1 call): one block at each, and the
ConvTransformer localizer at windows (1, 1, 1) (outputs, detections, one
step's losses)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu import train as jtrain
from audio_visual_deepfake_detection_tpu.infer.decode import TestConfig as JTestConfig
from audio_visual_deepfake_detection_tpu.infer.runner import (
    build_inference_fn as j_build_inference_fn)
from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.models import AVLocalizer as JAVLocalizer
from audio_visual_deepfake_detection_tpu.models import compute_losses as j_compute_losses
from audio_visual_deepfake_detection_tpu.models import label_points as j_label_points
from audio_visual_deepfake_detection_tpu.models import model_points as j_model_points
from audio_visual_deepfake_detection_tpu.models.blocks import TransformerBlock as JBlock
from audio_visual_deepfake_detection_tpu_torch import train as ttrain
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig, TestConfig
from audio_visual_deepfake_detection_tpu_torch.infer import build_inference_fn
from audio_visual_deepfake_detection_tpu_torch.models import AVLocalizer, build_localizer
from audio_visual_deepfake_detection_tpu_torch.models.blocks import TransformerBlock
from audio_visual_deepfake_detection_tpu_torch.models.meta_arch import compute_losses
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as tfb
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    block_state_dict_from_flax, state_dict_from_flax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_step import ITERS, OPT_CFG, TRAIN_CFG, flax_state_np, l2  # noqa: E402
from test_torch_variants import (  # noqa: E402
    TEST, TRAJECTORY, assert_close, localizer_params, ragged, random_tree)

# the ActionFormer THUMOS14 structure, narrowed
SLICE = dict(variant="plain", backbone_type="convTransformer", fpn_type="identity",
             input_dim=64, num_classes=20, max_seq_len=576, arch=(2, 2, 5), embd_dim=128,
             fpn_dim=128, head_dim=128, n_head=4, mha_win_size=(19,) * 6, use_abs_pe=False,
             droppath=0.1, max_buffer_len_factor=6.0)
SLICE_TRAIN = dict(SLICE, max_seq_len=384)   # the last level 12 rows: w = 9 fits
MULTICLASS = dict(TEST, multiclass_nms=True)
# scale_factor 3: strides 1, 3, 9 (max_div_factor 12; 216 = 24 x 9)
SCALE3 = dict(variant="plain", backbone_type="conv", fpn_type="fpn", input_dim=24,
              num_classes=1, max_seq_len=216, arch=(1, 1, 2), embd_dim=32, fpn_dim=32,
              head_dim=32, n_head=2, mha_win_size=(5, 5, -1), scale_factor=3,
              regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
# scale_factor 4 on the ConvTransformer: stride-4 branch blocks (depthwise
# kernels of 5) take the unfused path with banded attention at w = 4; strides
# 1, 4, 16 (max_div_factor 128; 256 = 2 x 128)
SCALE4 = dict(SCALE3, backbone_type="convTransformer", scale_factor=4, max_seq_len=256,
              mha_win_size=(9, 9, 9))
# windows of 1 at every level: strides 1, 2, 4 (max_div_factor 4)
WINDOW1 = dict(SCALE3, backbone_type="convTransformer", scale_factor=2, max_seq_len=64,
               mha_win_size=(1, 1, 1))
LOSS_KEYS = ("cls_loss", "reg_loss", "final_loss", "num_pos", "grad_norm")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def slice_models():
    jcfg = JArchConfig(**SLICE)
    p = localizer_params(jcfg, 15)
    ours = AVLocalizer(ArchConfig(**SLICE)).eval()
    ours.load_state_dict(state_dict_from_flax(p), strict=True)
    return jcfg, p, ours


def test_slice_localizer_outputs_match_jax(slice_models, monkeypatch):
    """7 blocks, all banded at w = 9, K1's entry for each: out_cls (20
    classes) and out_offsets at 1e-4, the masks exactly."""
    jcfg, p, ours = slice_models
    x, mask = ragged(np.random.default_rng(5), 2, 576, 64, lens=[576, 401])
    ref = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply({"params": p}, x, m))(
        jnp.asarray(x), jnp.asarray(mask))
    calls = []
    orig = tfb.fused_transformer_block
    monkeypatch.setattr(tfb, "fused_transformer_block",
                        lambda *a, **k: (calls.append(k["w_overlap"]), orig(*a, **k))[1])
    with torch.no_grad():
        got = ours(_t(x), _t(mask))
    assert calls == [9] * 7
    assert [g.shape[-1] for g in got["out_cls"]] == [20] * 6
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(got[key], ref[key]):
            assert_close(g, r, atol=1e-4, rtol=1e-4, msg=key)
    for g, r in zip(got["fpn_masks"], ref["fpn_masks"]):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_slice_detections_match_jax_with_multiclass_nms(slice_models):
    jcfg, p, ours = slice_models
    x, mask = ragged(np.random.default_rng(6), 2, 576, 64, lens=[576, 333])
    meta = (np.full(2, 25.0, np.float32), np.array([23.04, 13.32], np.float32),
            np.full(2, 0.3, np.float32), np.full(2, 0.3, np.float32))
    j_out = [np.asarray(a) for a in j_build_inference_fn(jcfg, JTestConfig(**MULTICLASS))(
        {"params": p}, jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, meta))]
    segs, scores, labels, valid, _ = [a.numpy() for a in build_inference_fn(
        ArchConfig(**SLICE), TestConfig(**MULTICLASS))(ours, x, mask, *meta)]
    j_segs, j_scores, j_labels, j_valid, _ = j_out
    for i in range(2):
        k = int(valid[i].sum())
        assert k == int(j_valid[i].sum()) and k > 0
        np.testing.assert_allclose(scores[i][:k], j_scores[i][:k], atol=1e-4)
        np.testing.assert_allclose(segs[i][:k], j_segs[i][:k], atol=1e-3)
        assert np.array_equal(labels[i][:k], j_labels[i][:k])
    assert len(np.unique(labels[valid])) > 1            # detections of several classes


def labelled_batch(seed, b=8, t=576, c=64, max_gt=3, classes=20):
    """``b`` rows, the first full length, with 1-3 segments of random
    classes; rows 2 and 3 without a segment; a padding row last."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    mask = np.arange(t)[None, :] < lens[:, None]
    feats = rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None]
    seg = np.zeros((b, max_gt, 2), np.float32)
    labels = np.zeros((b, max_gt), np.int64)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b - 1):
        if i in (2, 3):
            continue
        n = int(rng.integers(1, max_gt + 1))
        start = rng.uniform(0, lens[i] / 2, n)
        seg[i, :n, 0] = start
        seg[i, :n, 1] = start + rng.uniform(4, lens[i] / 2, n)
        labels[i, :n] = rng.integers(0, classes, n)
        valid[i, :n] = True
    row_valid = np.ones((b,), bool)
    row_valid[-1] = False
    feats[-1] = 0.0
    mask[-1] = False
    return {"feats": feats, "mask": mask, "gt_segments": seg, "gt_labels": labels,
            "gt_valid": valid, "has_gt": valid.any(1), "row_valid": row_valid}


def test_slice_losses_match_jax(slice_models):
    """compute_losses over the 20-class outputs and labels (rtol 1e-5)."""
    jcfg, p, ours = slice_models
    batch = labelled_batch(3, b=4)
    ref_out = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply({"params": p}, x, m))(
        jnp.asarray(batch["feats"]), jnp.asarray(batch["mask"]))
    with torch.no_grad():
        out = ours(_t(batch["feats"]), _t(batch["mask"]))
    gt_cls, gt_off = j_label_points(j_model_points(jcfg), jnp.asarray(batch["gt_segments"]),
                                    jnp.asarray(batch["gt_labels"]),
                                    jnp.asarray(batch["gt_valid"]), 20)
    kw = dict(num_classes=20, loss_weight=2.0, label_smoothing=0.1, variant="plain")
    want, want_pos = j_compute_losses(ref_out, gt_cls, gt_off, jnp.asarray(batch["has_gt"]),
                                      jnp.float32(200.0), row_valid=jnp.asarray(batch["row_valid"]),
                                      **kw)
    got, got_pos = compute_losses(out, _t(np.asarray(gt_cls)), _t(np.asarray(gt_off)),
                                  _t(batch["has_gt"]), torch.tensor(200.0),
                                  row_valid=_t(batch["row_valid"]), **kw)
    assert int(got_pos) == int(want_pos) > 0
    assert np.asarray(gt_cls)[..., 1:].any()            # positives beyond class 0
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


def jax_steps(arch, n, batches):
    """The JAX package's ``n`` deterministic-forward steps from seeded
    weights: the states (numpy) and each step's losses."""
    cfg = JArchConfig(**arch)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, localizer_params(cfg, 9))}
    tx, _ = jtrain.make_optimizer(params, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = jtrain.TrainState.create(params, tx, TRAIN_CFG["init_loss_norm"],
                                     jax.random.PRNGKey(0))
    step = jax.jit(jtrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True))
    states, losses = [flax_state_np(state)], []
    for i in range(n):
        state, out = step(state, batches[i])
        states.append(flax_state_np(state))
        losses.append({k: float(out[k]) for k in LOSS_KEYS})
    return states, losses


def port_steps(arch, states, n, batches):
    cfg = ArchConfig(**arch)
    model, gen = ttrain.init_model(cfg, 0, device="cpu")
    tx, _ = ttrain.make_optimizer(model, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = ttrain.TrainState.create(model, tx, TRAIN_CFG["init_loss_norm"], gen)
    state.model.load_state_dict(state_dict_from_flax(states[0]["params"]), strict=True)
    for name, prm in state.model.named_parameters():
        state.ema_params[name].copy_(prm.detach())
    step = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)
    start = {name: prm.detach().clone() for name, prm in state.model.named_parameters()}
    losses = []
    for i in range(n):
        state, out = step(state, batches[i])
        losses.append(out)
    return state, start, losses


def test_slice_four_step_trajectory_matches_jax():
    """4 steps at B = 8 over 20-class batches of 384 rows: the losses at rtol
    1e-4 (grad_norm 2e-3 after the first update), the parameters and their
    EMA within 2.5e-2 of the distance moved."""
    batches = [labelled_batch(i, t=384) for i in range(4)]
    states, want = jax_steps(SLICE_TRAIN, 4, batches)
    state, start, got = port_steps(SLICE_TRAIN, states, 4, batches)
    for i in range(4):
        for key in LOSS_KEYS:
            rtol = 2e-3 if key == "grad_norm" and i >= 2 else 1e-4
            np.testing.assert_allclose(float(got[i][key]), want[i][key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
    assert want[0]["num_pos"] > 0
    for tree, now in (("params", {n: p.detach() for n, p in state.model.named_parameters()}),
                      ("ema_params", state.ema_params)):
        ref = state_dict_from_flax(states[4][tree])
        moved = l2(ref, start)
        assert moved > 0.0
        assert l2({n: now[n] for n in ref}, ref) < TRAJECTORY * moved, tree


# ------------------------------------------------------ scale_factor 3 and 4

def check_scale_factor_localizer(arch, strides, lens):
    """The localizer at ``arch`` (its scale_factor) against the JAX package:
    the fpn strides and padding factor, outputs at 1e-4, detections, one
    step's losses. Returns the port's model and the input batch."""
    jcfg = JArchConfig(**arch)
    cfg = ArchConfig(**arch)
    t = arch["max_seq_len"]
    assert cfg.fpn_strides == jcfg.fpn_strides == strides
    assert cfg.max_div_factor == jcfg.max_div_factor
    p = localizer_params(jcfg, 4)
    ours = AVLocalizer(cfg).eval()
    ours.load_state_dict(state_dict_from_flax(p), strict=True)
    x, mask = ragged(np.random.default_rng(8), 3, t, 24, lens=lens)
    ref = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply({"params": p}, x, m))(
        jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = ours(_t(x), _t(mask))
    assert [g.shape[1] for g in got["out_cls"]] == [t // s for s in strides]
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(got[key], ref[key]):
            assert_close(g, r, atol=1e-4, rtol=1e-4, msg=key)
    meta = (np.full(3, 25.0, np.float32), np.full(3, t / 25.0, np.float32),
            np.full(3, 0.3, np.float32), np.full(3, 0.3, np.float32))
    j_out = [np.asarray(a) for a in j_build_inference_fn(jcfg, JTestConfig(**TEST))(
        {"params": p}, jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, meta))]
    segs, scores, _, valid, _ = [a.numpy() for a in build_inference_fn(
        cfg, TestConfig(**TEST))(ours, x, mask, *meta)]
    for i in range(3):
        k = int(valid[i].sum())
        assert k == int(j_out[3][i].sum()) and k > 0
        np.testing.assert_allclose(scores[i][:k], j_out[1][i][:k], atol=1e-4)
        np.testing.assert_allclose(segs[i][:k], j_out[0][i][:k], atol=1e-3)
    batches = [labelled_batch(11, t=t, c=24, classes=1)]
    states, want = jax_steps(arch, 1, batches)
    _, _, got = port_steps(arch, states, 1, batches)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(got[0][key]), want[0][key], rtol=1e-4, err_msg=key)
    return ours, x, mask


def test_scale_factor_3_conv_localizer_matches_jax():
    """The pure-conv localizer at scale_factor 3 (levels of 216, 72 and 24
    rows): outputs at 1e-4, detections, and one step's losses."""
    check_scale_factor_localizer(SCALE3, (1, 3, 9), [216, 150, 77])


def test_scale_factor_4_conv_transformer_localizer_matches_jax(monkeypatch):
    """The ConvTransformer localizer at scale_factor 4 (levels of 256, 64 and
    16 rows): outputs at 1e-4, detections, and one step's losses against the
    JAX package. Its stem block is fused (K1's entry, w = 4); its two
    stride-4 branch blocks take the unfused path, as the JAX dispatch sends
    them, with banded attention through K7's entry at w = 4."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as tk7

    ours, x, mask = check_scale_factor_localizer(SCALE4, (1, 4, 16), [256, 180, 61])
    assert [blk.uses_unfused(False) for blk in ours.backbone.branch] == [True, True]
    calls = {"K1": [], "K7": []}
    k1, k7 = tfb.fused_transformer_block, tk7.band_attention_fused
    monkeypatch.setattr(tfb, "fused_transformer_block",
                        lambda *a, **k: (calls["K1"].append(k["w_overlap"]), k1(*a, **k))[1])
    monkeypatch.setattr(tk7, "band_attention_fused",
                        lambda *a: (calls["K7"].append(a[4]), k7(*a))[1])
    with torch.no_grad():
        ours(_t(x), _t(mask))
    assert calls == {"K1": [4], "K7": [4, 4]}


def test_scale_factor_3_transformer_block_refused_as_in_jax():
    """A stride-3 transformer block has depthwise convs of kernel 4: both
    packages' masked convs refuse an even kernel, the JAX block at init, the
    port's at construction, so the ConvTransformer localizer at scale_factor
    3 builds in neither. The config itself is taken, and the port's stride-2
    block keeps its fused path."""
    arch = dict(SCALE3, backbone_type="convTransformer")
    cfg = ArchConfig(**arch)
    assert cfg.fpn_strides == JArchConfig(**arch).fpn_strides == (1, 3, 9)
    with pytest.raises(AssertionError, match="kernel must be odd"):
        JBlock(n_embd=32, n_head=2, ds_stride=3, window_size=5).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 216, 32)), jnp.ones((1, 216), bool))
    with pytest.raises(AssertionError, match="kernel must be odd"):
        TransformerBlock(32, 2, ds_stride=3, window_size=5)
    with pytest.raises(AssertionError, match="kernel must be odd"):
        build_localizer(cfg, seed=0, device="cpu")
    assert TransformerBlock(32, 2, ds_stride=2, window_size=5).uses_unfused(False) is False


# ------------------------------------------------------ windows <= 1

@pytest.mark.parametrize("window", [0, 1, -3])
def test_window_at_most_one_block_runs_dense_as_in_jax(window, monkeypatch):
    """A block of window 0, 1 or -3 against the JAX block on the same weights
    (f32, 1e-5; the masks exactly): both run it unfused with dense
    attention, the port without a K1 call; its training dispatch is
    unfused too."""
    c, heads, t = 64, 2, 40
    rng = np.random.default_rng(31 + window)
    mask = np.arange(t)[None, :] < np.array([t, 27])[:, None]
    x = rng.standard_normal((2, t, c)).astype(np.float32) * mask[..., None]

    def make():
        return JBlock(n_embd=c, n_head=heads, window_size=window)

    shapes = jax.eval_shape(lambda: make().init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                jnp.asarray(mask)))["params"]
    p = random_tree(shapes, rng)
    ref, ref_mask = jax.jit(lambda prm, xv, mv: make().apply({"params": prm}, xv, mv))(
        p, jnp.asarray(x), jnp.asarray(mask))
    ours = TransformerBlock(c, heads, window_size=window)
    ours.load_state_dict(block_state_dict_from_flax(p), strict=True)
    assert ours.uses_unfused(False) and ours.uses_unfused(True)
    calls = []
    k1 = tfb.fused_transformer_block
    monkeypatch.setattr(tfb, "fused_transformer_block",
                        lambda *a, **k: (calls.append(k["w_overlap"]), k1(*a, **k))[1])
    with torch.no_grad():
        got, got_mask = ours(_t(x), _t(mask))
    assert calls == []
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert np.array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_window_one_conv_transformer_localizer_matches_jax(monkeypatch):
    """The ConvTransformer localizer at windows (1, 1, 1), as
    ``n_mha_win_size: 1`` builds it: outputs at 1e-4, detections and one
    step's losses against the JAX package; every block unfused, no K1 call."""
    assert ArchConfig(**WINDOW1).max_div_factor == JArchConfig(**WINDOW1).max_div_factor == 4
    ours, x, mask = check_scale_factor_localizer(WINDOW1, (1, 2, 4), [64, 40, 23])
    assert all(blk.uses_unfused(False) for blk in ours.modules()
               if isinstance(blk, TransformerBlock))
    calls = []
    k1 = tfb.fused_transformer_block
    monkeypatch.setattr(tfb, "fused_transformer_block",
                        lambda *a, **k: (calls.append(k["w_overlap"]), k1(*a, **k))[1])
    with torch.no_grad():
        ours(_t(x), _t(mask))
    assert calls == []

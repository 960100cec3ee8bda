"""PyTorch port, the reconstruction and THE localizers against the JAX
package on the CPU: ``av_recovery`` (``configs_train/deepfake_exp5.yaml``:
the DeepInterpolator's expansion reconstructs the inputs, the
reconstruction is the backbone's k-stream and the target of an L1 loss) and
``av_recovery_the`` (``deepfake_exp13.yaml``: ``SegmentAndCls`` gives frame
logits, whose focal loss is logged and kept out of ``final_loss``).

Inputs are seeded with numpy; the JAX weights are drawn as numpy values on
the JAX package's parameter shapes (O(1) layer scales and LN affines, so
every attention path matters) and carried across by
``tools/convert_jax.py``. Sizes: the modules and the localizer at T = 192,
C = 32, 4 heads, windows (7, 7, 7, 7, 7, -1), input 64 (the sizes of
``tests/test_parity.py:95-99``); the train steps and the data-parallel
step at T = 192, C = 32, arch (1, 1, 2), windows (5, 5, -1), input 24,
whose JAX train step compiles in half a minute (at T = 96 the contraction
ends at 3 rows, and the instance norm over them makes the gradient into
it ill-conditioned: the JAX package's own 8-device mesh step then differs
from its one-device step by 2% there); the converter and the CLIs at the
tiny localizer of ``tests/test_torch_train_cli.py`` (T = 96).

Tolerances: the modules f32 atol 1e-5 with equal masks (the
reconstruction 5e-5 against the JAX package, and no further from its f64
value than the JAX package's f32 one: both lie ~1.5e-5 from it); the localizer rtol
= atol = 1e-4 (``tests/test_torch_localizer.py``), detections scores 1e-4,
segments 1e-3, logit 2e-4; ``compute_losses`` rtol 1e-5; the train steps at
``tests/test_torch_train_step.py``'s rule (losses rtol 1e-4, a step from the
same state: parameters and EMA atol 2e-5; a trajectory: 2.5e-2 of the
distance moved, ``expansion.up_*`` on its own too); the two Gloo processes
at ``tests/test_torch_parallel.py``'s (a step from the same state)."""

import copy
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audio_visual_deepfake_detection_tpu import train as jtrain
from audio_visual_deepfake_detection_tpu.core import config as jconfig
from audio_visual_deepfake_detection_tpu.infer.decode import TestConfig as JTestConfig
from audio_visual_deepfake_detection_tpu.infer.runner import (
    build_inference_fn as j_build_inference_fn)
from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.models import AVLocalizer as JAVLocalizer
from audio_visual_deepfake_detection_tpu.models import compute_losses as j_compute_losses
from audio_visual_deepfake_detection_tpu.models import label_points as j_label_points
from audio_visual_deepfake_detection_tpu.models import model_points as j_model_points
from audio_visual_deepfake_detection_tpu.models.blocks import (
    DeepInterpolator as JDeepInterpolator, SegmentAndCls as JSegmentAndCls, UpBlock as JUpBlock)
from audio_visual_deepfake_detection_tpu.ops.conv import (
    MaskedConvTranspose1D as JMaskedConvTranspose1D)
from audio_visual_deepfake_detection_tpu.parallel import mesh as jmesh
from audio_visual_deepfake_detection_tpu.tools.convert_torch import convert_state_dict
from audio_visual_deepfake_detection_tpu_torch import train as ttrain
from audio_visual_deepfake_detection_tpu_torch.cli import convert_checkpoint as convert_cli
from audio_visual_deepfake_detection_tpu_torch.cli import train as train_cli
from audio_visual_deepfake_detection_tpu_torch.cli import validate as validate_cli
from audio_visual_deepfake_detection_tpu_torch.core import config as tconfig
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig, TestConfig
from audio_visual_deepfake_detection_tpu_torch.infer import build_inference_fn
from audio_visual_deepfake_detection_tpu_torch.models import AVLocalizer
from audio_visual_deepfake_detection_tpu_torch.models.blocks import (
    DeepInterpolator, SegmentAndCls, UpBlock)
from audio_visual_deepfake_detection_tpu_torch.models.meta_arch import compute_losses
from audio_visual_deepfake_detection_tpu_torch.ops.conv import MaskedConvTranspose1D
from audio_visual_deepfake_detection_tpu_torch.tools import synth_cache
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    state_dict_from_flax, train_state_from_flax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import two_process_step  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    ITERS, LOSS_KEYS, OPT_CFG, TRAIN_CFG, flax_state_np, l2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("av_recovery", "av_recovery_the")
ARCH = dict(input_dim=64, num_classes=1, max_seq_len=192, embd_dim=32, fpn_dim=32,
            head_dim=32, n_head=4, mha_win_size=(7, 7, 7, 7, 7, -1), use_abs_pe=True,
            droppath=0.1)
TRAIN_ARCH = dict(input_dim=24, max_seq_len=192, embd_dim=32, fpn_dim=32, head_dim=32,
                  n_head=2, arch=(1, 1, 2), mha_win_size=(5, 5, -1),
                  regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
TEST = dict(pre_nms_thresh=0.001, pre_nms_topk=2000, iou_threshold=0.1,
            min_score=0.001, max_seg_num=10, nms_method="soft", nms_sigma=0.75,
            duration_thresh=0.001, multiclass_nms=False, voting_thresh=0.9)
EXTRA_LOSS = {"av_recovery": "reco_loss", "av_recovery_the": "reco_seg_loss"}
GLOBAL_B = 8            # the JAX mesh's 8 CPU devices, one row each
TRAJECTORY = 2.5e-2     # l2 of the difference / l2 moved (tests/test_torch_train_step.py)
UP = ".expansion.up_"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_tree(shapes, rng):
    """Numpy values for a tree of ``jax.ShapeDtypeStruct``: kernels
    U(+-1/sqrt(fan_in)), LN weights 1 + 0.3 N, layer scales N(0, 1) (O(1),
    not the 1e-4 init), regression scales 1 + 0.1 N, biases 0.1 N."""
    def leaf(path, s):
        names = [getattr(k, "key", str(k)) for k in path]
        last, parent = names[-1], names[-2] if len(names) > 1 else ""
        if parent.startswith("drop_path"):
            v = rng.standard_normal(s.shape)
        elif last == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.uniform(-bound, bound, s.shape)
        elif last == "weight":
            v = 1.0 + 0.3 * rng.standard_normal(s.shape)
        elif last == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def module_params(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    return random_tree(shapes, np.random.default_rng(seed))


def localizer_params(jcfg, seed):
    t = jcfg.max_seq_len
    return module_params(JAVLocalizer(jcfg), seed, jnp.zeros((1, t, jcfg.input_dim)),
                         jnp.ones((1, t), bool))


def ragged(rng, b, t, c, lens=None):
    """(x, mask): row 0 full, the others valid to ``lens``; x zero past it."""
    lens = lens if lens is not None else [t] + [int(v) for v in rng.integers(t // 2, t, b - 1)]
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    x = rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None]
    return x, mask


def carried(tree, module, head):
    """``tree`` (the flax subtree of the recovery module) into the port's
    ``module`` through ``state_dict_from_flax``, its names under ``head``."""
    sd = state_dict_from_flax({"interpolator": tree})
    module.load_state_dict({n[len(head):]: v for n, v in sd.items()}, strict=True)
    return module


def assert_close(got, want, atol=1e-5, rtol=0.0, msg=""):
    if isinstance(want, torch.Tensor):
        want = want.detach()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


# ------------------------------------------------------------ config

@pytest.mark.parametrize("variant", ("av_recovery_norecon",) + VARIANTS)
def test_max_div_factor_follows_the_jax_rule(variant):
    """Lifted to a multiple of 32 for the two variants with a contraction,
    not for THE (strides 1, 2, 4 x window span 4: 8)."""
    arch = dict(TRAIN_ARCH, variant=variant)
    ours, ref = ArchConfig(**arch), JArchConfig(**arch)
    assert ours.max_div_factor == ref.max_div_factor == (8 if variant == VARIANTS[1] else 32)
    assert ours.fpn_strides == ref.fpn_strides and ours.fpn_lens == ref.fpn_lens


# ------------------------------------------------------------ modules

@pytest.mark.parametrize("t", [13, 16])
def test_masked_conv_transpose_matches_jax(t):
    """torch's ConvTranspose1d(3, stride 2, padding 1, output_padding 1) on
    the JAX kernel carried over without a flip, at odd and even lengths
    with ragged masks; and the reference's module itself on the same
    weights."""
    rng = np.random.default_rng(t)
    x, mask = ragged(rng, 3, t, 6)
    jmod = JMaskedConvTranspose1D(5, 3, stride=2, output_padding=1)
    p = module_params(jmod, t, jnp.zeros((1, t, 6)), jnp.ones((1, t), bool))
    want, want_mask = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    ours = carried({"up_1": {"conv": p}}, MaskedConvTranspose1D(6, 5),
                   "interpolator.expansion.up_1.conv_transpose.")
    got, got_mask = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (3, 2 * t, 5)
    assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_close(got, want)
    direct = ours.conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert_close(got, direct * got_mask[..., None])


def test_up_block_matches_jax():
    rng = np.random.default_rng(1)
    x, mask = ragged(rng, 3, 12, 16)
    jmod = JUpBlock(8)
    p = module_params(jmod, 1, jnp.zeros((1, 12, 16)), jnp.ones((1, 12), bool))
    want, want_mask = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    ours = carried({"up_2": p}, UpBlock(16, 8), "interpolator.expansion.up_2.")
    got, got_mask = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_close(got, want)
    assert float(got.detach().min()) < 0.0       # LeakyReLU on the last stage too, not Tanh


def test_deep_interpolator_with_reconstruction_matches_jax():
    """Contraction 192 -> 6 rows, expansion back to 192 rows and 64
    channels: the inputs without gradient, the reconstruction, the logit."""
    rng = np.random.default_rng(2)
    t, c = ARCH["max_seq_len"], ARCH["input_dim"]
    x, mask = ragged(rng, 3, t, c, lens=[t, 150, 77])
    jmod = JDeepInterpolator(hidden=32, num_classes=1, with_reconstruction=True)
    p = module_params(jmod, 2, jnp.zeros((1, t, c)), jnp.ones((1, t), bool))
    norm_x, reco, cls = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    ours = carried(p, DeepInterpolator(c, 32, 1, with_reconstruction=True), "interpolator.")
    xt = torch.from_numpy(x).requires_grad_(True)
    g_norm, g_reco, g_cls = ours(xt, torch.from_numpy(mask))
    assert not g_norm.requires_grad and torch.equal(g_norm, xt.detach())
    assert g_reco.shape == (3, t, c)
    assert_close(g_cls, cls)
    # ten conv stages at up to 2048 channels, each through an instance norm:
    # either package's f32 reconstruction lies ~1.5e-5 from the f64 one, so
    # the two are held to each other at 5e-5 and the port's f32 error to
    # that of the JAX package
    assert_close(g_reco, reco, atol=5e-5)
    with torch.no_grad():
        exact = copy.deepcopy(ours).double()(xt.detach().double(), torch.from_numpy(mask))[1]
    port_err = float((g_reco.detach().double() - exact).abs().max())
    jax_err = float(np.abs(np.asarray(reco, np.float64) - exact.numpy()).max())
    assert port_err <= max(2 * jax_err, 1e-5), (port_err, jax_err)
    assert_close(g_norm, norm_x, atol=0.0)
    plain = DeepInterpolator(c, 32, 1)
    assert not hasattr(plain, "expansion") and plain(xt, torch.from_numpy(mask))[1] is None


def test_segment_and_cls_matches_jax():
    rng = np.random.default_rng(3)
    t, c = ARCH["max_seq_len"], ARCH["input_dim"]
    x, mask = ragged(rng, 3, t, c, lens=[t, 150, 77])
    jmod = JSegmentAndCls(num_classes=1)
    p = module_params(jmod, 3, jnp.zeros((1, t, c)), jnp.ones((1, t), bool))
    norm_x, seg, cls = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    ours = carried(p, SegmentAndCls(c), "segmentandCls.")
    g_norm, g_seg, g_cls = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert g_seg.shape == (3, t) and g_cls.shape == (3, 1)
    assert_close(g_seg, seg)
    assert_close(g_cls, cls)
    assert_close(g_norm, norm_x, atol=0.0)


# ------------------------------------------------------------ the localizer

@pytest.fixture(scope="module", params=VARIANTS)
def models(request):
    arch = dict(ARCH, variant=request.param)
    jcfg = JArchConfig(**arch)
    p = localizer_params(jcfg, 4)
    ours = AVLocalizer(ArchConfig(**arch)).eval()
    ours.load_state_dict(state_dict_from_flax(p), strict=True)
    return arch, jcfg, p, ours


def test_the_recovery_module_keeps_the_reference_names(models):
    arch, _, _, ours = models
    names = set(ours.state_dict())
    if arch["variant"] == "av_recovery_the":
        assert not hasattr(ours, "interpolator")
        assert {"segmentandCls.seg_linear.weight", "segmentandCls.cls_linear1.bias",
                "segmentandCls.conv0.0.weight",
                "segmentandCls.contraction.down_5.conv_block.conv.weight"} <= names
    else:
        for i in range(1, 6):
            assert f"interpolator.expansion.up_{i}.conv_transpose.conv.weight" in names
        assert ours.interpolator.expansion.up_1.conv_transpose.conv.weight.shape == (32, 2048, 3)


def test_localizer_outputs_match_jax(models):
    arch, jcfg, p, ours = models
    x, mask = ragged(np.random.default_rng(5), 3, 192, 64, lens=[192, 150, 77])
    ref = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply({"params": p}, x, m))(
        jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
    keys = {"av_recovery": ("reco", "norm_inputs"), "av_recovery_the": ("seg_scores",)}
    assert set(got) == {"out_cls", "out_offsets", "fpn_masks", "cls_scores",
                        *keys[arch["variant"]]}
    tol = dict(rtol=1e-4, atol=1e-4)
    for key in ("cls_scores",) + keys[arch["variant"]]:
        assert got[key].dtype == torch.float32
        assert_close(got[key], ref[key], msg=key, **tol)
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(got[key], ref[key]):
            assert_close(g, r, msg=key, **tol)
    for g, r in zip(got["fpn_masks"], ref["fpn_masks"]):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_inference_fn_detections_match_jax(models):
    arch, jcfg, p, ours = models
    x, mask = ragged(np.random.default_rng(6), 3, 192, 64, lens=[192, 150, 77])
    meta = (np.full(3, 25.0, np.float32), np.full(3, 7.7, np.float32),
            np.full(3, 0.3, np.float32), np.full(3, 0.3, np.float32))
    j_out = [np.asarray(a) for a in j_build_inference_fn(jcfg, JTestConfig(**TEST))(
        {"params": p}, jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, meta))]
    segs, scores, _, valid, video_cls = [a.numpy() for a in build_inference_fn(
        ArchConfig(**arch), TestConfig(**TEST))(ours, x, mask, *meta)]
    j_segs, j_scores, _, j_valid, j_video_cls = j_out
    for i in range(3):
        k = int(valid[i].sum())
        assert k == int(j_valid[i].sum()) and k > 0
        np.testing.assert_allclose(scores[i][:k], j_scores[i][:k], atol=1e-4)
        np.testing.assert_allclose(segs[i][:k], j_segs[i][:k], atol=1e-3)
    np.testing.assert_allclose(video_cls, j_video_cls, atol=2e-4)


# ------------------------------------------------------------ losses

@pytest.mark.parametrize("variant", VARIANTS)
def test_compute_losses_match_jax(variant):
    """Random outputs of the variant's shapes, GT with real (no-segment)
    rows and a padding row: every loss at rtol 1e-5; ``reco_loss`` is in
    ``final_loss``, ``reco_seg_loss`` is not."""
    cfg = ArchConfig(**dict(TRAIN_ARCH, variant=variant))
    rng = np.random.default_rng(7)
    b, t, c = 5, cfg.max_seq_len, cfg.input_dim
    lens = [t, 80, 60, 90, 0]
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    fpn_masks = [mask[:, ::s] for s in cfg.fpn_strides]
    out = {"out_cls": [rng.standard_normal((b, n, 1)).astype(np.float32) for n in cfg.fpn_lens],
           "out_offsets": [np.abs(rng.standard_normal((b, n, 2))).astype(np.float32)
                           for n in cfg.fpn_lens],
           "fpn_masks": fpn_masks,
           "cls_scores": rng.standard_normal((b, 1)).astype(np.float32)}
    if variant == "av_recovery":
        out["reco"] = rng.standard_normal((b, t, c)).astype(np.float32)
        out["norm_inputs"] = rng.standard_normal((b, t, c)).astype(np.float32)
    else:
        out["seg_scores"] = rng.standard_normal((b, t)).astype(np.float32)
    seg = np.zeros((b, 2, 2), np.float32)
    seg[0] = [[10.0, 30.0], [52.5, 61.0]]
    seg[3, 0] = [5.0, 40.0]
    valid = np.asarray([[True, True], [False, False], [False, False], [True, False],
                        [False, False]])
    has_gt = valid.any(1)
    row_valid = np.asarray([True, True, True, True, False])
    frame_gt = np.zeros((b, t), np.float32)
    frame_gt[0, 10:30] = frame_gt[3, 5:40] = 1.0
    gt_cls, gt_off = j_label_points(j_model_points(JArchConfig(**dict(TRAIN_ARCH))),
                                    jnp.asarray(seg), jnp.zeros((b, 2), jnp.int32),
                                    jnp.asarray(valid), 1)
    kw = dict(num_classes=1, loss_weight=2.0, label_smoothing=0.1, variant=variant)
    want, want_pos = j_compute_losses(
        jax.tree_util.tree_map(jnp.asarray, out), gt_cls, gt_off, jnp.asarray(has_gt),
        jnp.float32(200.0), frame_gt=jnp.asarray(frame_gt), row_valid=jnp.asarray(row_valid),
        **kw)
    t_out = {k: [torch.from_numpy(a) for a in v] if isinstance(v, list) else torch.from_numpy(v)
             for k, v in out.items()}
    got, got_pos = compute_losses(
        t_out, torch.from_numpy(np.asarray(gt_cls)), torch.from_numpy(np.asarray(gt_off)),
        torch.from_numpy(has_gt), torch.tensor(200.0), frame_gt=torch.from_numpy(frame_gt),
        row_valid=torch.from_numpy(row_valid), **kw)
    assert set(got) == set(want) == {"cls_loss", "reg_loss", "reco_cls_loss", "final_loss",
                                     EXTRA_LOSS[variant]}
    assert int(got_pos) == int(want_pos) > 0
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    parts = got["cls_loss"] + 2.0 * got["reg_loss"] + 0.1 * got["reco_cls_loss"]
    if variant == "av_recovery":
        assert float(got["reco_loss"]) > 0.0
        parts = parts + got["reco_loss"]
    else:
        assert float(got["reco_seg_loss"]) > 0.0
    np.testing.assert_allclose(float(got["final_loss"]), float(parts), rtol=1e-6)
    # without frame labels the THE variant computes no frame loss, as the JAX one
    t_out.pop("reco", None)
    bare, _ = compute_losses(t_out, torch.from_numpy(np.asarray(gt_cls)),
                             torch.from_numpy(np.asarray(gt_off)), torch.from_numpy(has_gt),
                             torch.tensor(200.0), **dict(kw, variant="av_recovery_the"))
    assert set(bare) == {"cls_loss", "reg_loss", "reco_cls_loss", "final_loss"}


# ------------------------------------------------------------ training

def make_batch(seed, variant, b=GLOBAL_B, t=192, c=24, max_gt=3):
    """``b`` rows: full length and ragged with 1-3 segments, rows 2 and 3
    real (no segment; one on each of two strided processes) and a padding
    row last; the THE variant's frame labels from the segments."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    mask = np.arange(t)[None, :] < lens[:, None]
    feats = rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None]
    seg = np.zeros((b, max_gt, 2), np.float32)
    valid = np.zeros((b, max_gt), bool)
    frames = np.zeros((b, t), np.float32)
    for i in range(b - 1):
        if i in (2, 3):
            continue
        n = int(rng.integers(1, max_gt + 1))
        start = rng.uniform(0, lens[i] - 60, n)
        seg[i, :n, 0] = start
        seg[i, :n, 1] = start + rng.uniform(4, 56, n)
        valid[i, :n] = True
        for s, e in seg[i, :n]:
            frames[i, int(s):int(e)] = 1.0
    row_valid = np.ones((b,), bool)
    row_valid[-1] = False
    feats[-1] = 0.0
    mask[-1] = False
    batch = {"feats": feats, "mask": mask, "gt_segments": seg,
             "gt_labels": np.zeros((b, max_gt), np.int64), "gt_valid": valid,
             "has_gt": valid.any(1), "row_valid": row_valid}
    if variant == "av_recovery_the":
        batch["frame_labels"] = frames
    return batch


def loss_keys(variant):
    return LOSS_KEYS + (EXTRA_LOSS[variant],)


@pytest.fixture(scope="module", params=VARIANTS)
def jax_run(request):
    """The JAX package's 4 deterministic-forward steps over global batches
    of 8 on one device: the state (numpy) before and after each, each step's
    losses, and the JAX state after the first step."""
    variant = request.param
    arch = dict(TRAIN_ARCH, variant=variant)
    cfg = JArchConfig(**arch)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, localizer_params(cfg, 9))}
    tx, _ = jtrain.make_optimizer(params, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = jtrain.TrainState.create(params, tx, TRAIN_CFG["init_loss_norm"],
                                     jax.random.PRNGKey(0))
    step = jax.jit(jtrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True))
    states, losses = [flax_state_np(state)], []
    for i in range(4):
        state, out = step(state, make_batch(i, variant))
        states.append(flax_state_np(state))
        losses.append({k: float(out[k]) for k in loss_keys(variant)})
        first = state if i == 0 else first
    return arch, states, losses, first


def port_state(arch, flax_state=None):
    cfg = ArchConfig(**arch)
    model, gen = ttrain.init_model(cfg, 0, device="cpu")
    tx, _ = ttrain.make_optimizer(model, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = ttrain.TrainState.create(model, tx, TRAIN_CFG["init_loss_norm"], gen)
    if flax_state is not None:
        state = train_state_from_flax(state, flax_state)
    return cfg, state


def test_four_step_trajectory_matches_jax(jax_run):
    arch, states, losses, _ = jax_run
    cfg, state = port_state(arch)
    state.model.load_state_dict(state_dict_from_flax(states[0]["params"]), strict=True)
    for n, p in state.model.named_parameters():
        state.ema_params[n].copy_(p.detach())
    step = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for i in range(4):
        state, out = step(state, make_batch(i, arch["variant"]))
        for key in loss_keys(arch["variant"]):
            rtol = 2e-3 if key == "grad_norm" and i >= 2 else 1e-4
            np.testing.assert_allclose(float(out[key]), losses[i][key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
    for tree, got in (("params", {n: p.detach() for n, p in state.model.named_parameters()}),
                      ("ema_params", state.ema_params)):
        ref = state_dict_from_flax(states[4][tree])
        assert set(ref) == set(got)
        subsets = [ref]
        if arch["variant"] == "av_recovery":
            subsets.append({n: v for n, v in ref.items() if UP in n})
            assert len(subsets[1]) == 10
        for sub in subsets:
            moved = l2(sub, start)
            assert moved > 0.0
            assert l2({n: got[n] for n in sub}, sub) < TRAJECTORY * moved, (tree, len(sub))
    assert losses[0]["num_pos"] > 0 and losses[0][EXTRA_LOSS[arch["variant"]]] > 0


def test_step_continued_from_a_converted_jax_state(jax_run):
    """From the JAX state after 2 steps: the third step's losses and every
    parameter and its EMA, ``expansion.up_*`` included."""
    arch, states, losses, _ = jax_run
    cfg, state = port_state(arch, states[2])
    state, out = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)(
        state, make_batch(2, arch["variant"]))
    for key in loss_keys(arch["variant"]):
        np.testing.assert_allclose(float(out[key]), losses[2][key], rtol=1e-4, err_msg=key)
    moved = 0
    for tree, got in (("params", dict(state.model.named_parameters())),
                      ("ema_params", state.ema_params)):
        ref = state_dict_from_flax(states[3][tree])
        assert set(ref) == set(got)
        for name, value in got.items():
            np.testing.assert_allclose(value.detach().numpy(), ref[name].numpy(), rtol=0,
                                       atol=2e-5, err_msg=f"{tree} {name}")
            if UP in name and tree == "params":
                moved += not torch.equal(value.detach(),
                                         state_dict_from_flax(states[2][tree])[name])
    assert moved == (10 if arch["variant"] == "av_recovery" else 0)


@pytest.mark.parametrize("jax_run", ["av_recovery"], indirect=True)
def test_two_process_step_equals_the_jax_mesh_step(jax_run, tmp_path):
    """``av_recovery`` at two Gloo processes (rows 0, 2, 4, 6 and 1, 3, 5,
    7, one real row each) from the JAX state after one step against the JAX
    package's step of the whole batch on its 8-device CPU mesh.
    ``reco_loss`` divides by the global count of real rows: a count of each
    process's own would weigh each real row alone."""
    arch, states, losses, first = jax_run
    batch = make_batch(1, arch["variant"])
    real = ~batch["has_gt"] & batch["row_valid"]
    assert real[0::2].sum() == real[1::2].sum() == 1
    cfg = JArchConfig(**arch)
    mesh = jmesh.make_mesh(devices=jax.devices("cpu"))
    assert mesh.devices.size == GLOBAL_B
    step = jax.jit(jtrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True))
    state, out = step(jmesh.replicate_tree(mesh, first), jmesh.shard_batch(mesh, batch))
    want = dict(flax_state_np(state), losses={k: float(out[k]) for k in loss_keys(arch["variant"])})
    for key in want["losses"]:      # the mesh's step is the one-device step of the trajectory
        np.testing.assert_allclose(want["losses"][key], losses[1][key], rtol=1e-4, err_msg=key)
    got = two_process_step(tmp_path, arch, TRAIN_CFG, states[1], batch, deterministic=True)
    for rank, g in enumerate(got):
        for key in want["losses"]:
            np.testing.assert_allclose(g["losses"][key], want["losses"][key], rtol=1e-4,
                                       err_msg=f"rank {rank} {key}")
        for tree in ("params", "ema_params"):
            ref = state_dict_from_flax(want[tree])
            assert set(ref) == set(g[tree])
            for name, value in g[tree].items():
                np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=0, atol=2e-5,
                                           err_msg=f"rank {rank} {tree} {name}")
        np.testing.assert_allclose(g["loss_normalizer"], want["loss_normalizer"], rtol=1e-6)


def test_padded_batch_losses_equal_the_unpadded_ones(jax_run):
    """JAX ``tests/test_train.py:190-207`` for the port: 7 real rows, then
    the same rows padded to 10 by ``pad_batch_to`` (frame labels with 0):
    ``reco_loss`` / ``reco_seg_loss`` and ``final_loss`` unchanged."""
    arch, states, _, _ = jax_run
    full = make_batch(3, arch["variant"])
    rows = {k: v[:7] for k, v in full.items() if k != "row_valid"}
    padded = ttrain.pad_batch_to(dict(rows), 10)
    padded.pop("_real_rows")
    assert padded["row_valid"].tolist() == [True] * 7 + [False] * 3
    if "frame_labels" in rows:
        assert not padded["frame_labels"][7:].any() and padded["frame_labels"][:7].any()
    out = []
    for batch in (rows, padded):
        cfg, state = port_state(arch, states[1])
        out.append(ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)(
            state, batch)[1])
    for key in (EXTRA_LOSS[arch["variant"]], "final_loss"):
        np.testing.assert_allclose(float(out[1][key]), float(out[0][key]), rtol=1e-6,
                                   err_msg=key)


# ------------------------------------------------------------ conversion and the CLIs

TINY = {
    "init_rand_seed": 11,
    "dataset": {"max_seq_len": 96, "crop_ratio": None},
    "model": {"backbone_arch": [1, 1, 2], "n_mha_win_size": [5, 5, -1],
              "regression_range": [[0, 4], [4, 8], [8, 10000]], "n_head": 2,
              "embd_dim": 32, "fpn_dim": 32, "head_dim": 32},
    "opt": {"early_stop_epochs": 1},
    "loader": {"batch_size": 4, "num_workers": 2},
    "test_cfg": {"min_score": 0.001, "max_seg_num": 20},
}
# each shipped config with its streams, at the tiny widths
CONFIGS = {
    "deepfake_exp5": (("video", "emotion"), (8, 4), {"video_input_dim": 8, "audio_input_dim": 4}),
    "deepfake_exp13": (("video", "byola", "emotion"), (8, 12, 4),
                       {"video_input_dim": 8, "audio_input_dim": 16}),
    "deepfake_exp10": (("video", "byola", "emotion"), (8, 12, 4),
                       {"video_input_dim": 8, "audio_input_dim": 16}),
}


def tiny_yaml(name, path, cache=None, output=""):
    """``configs_train/<name>.yaml`` cut to the tiny localizer, pointed at
    ``cache`` when given."""
    base = os.path.join(REPO, "configs_train", f"{name}.yaml")
    tree = synth_cache.merge(copy.deepcopy(TINY), {"dataset": CONFIGS[name][2]})
    if cache is not None:
        return synth_cache.write_config(base, path, cache, output, tree)
    with open(base) as f:
        config = synth_cache.merge(yaml.safe_load(f), tree)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


@pytest.mark.parametrize("name,names_of", [("deepfake_exp5", "av_recovery"),
                                           ("deepfake_exp13", "av_recovery_the"),
                                           ("deepfake_exp10", "av_recovery")])
def test_reference_checkpoint_converts_into_both_packages(tmp_path, name, names_of):
    """One random state dict under the reference's names of ``names_of``
    (``module.`` prefixes, raw and EMA): ``cli/convert_checkpoint.py`` into
    the port and JAX ``convert_state_dict`` into the JAX package give the
    same parameters and the same outputs. The no-recon config (exp10) reads
    a dict that carries the reconstruction's expansion, as the reference's
    no-recon model does, and leaves it out, as the JAX converter does."""
    cfg_path = tiny_yaml(name, str(tmp_path / "c.yaml"))
    config = tconfig.load_config(cfg_path)
    cfg = tconfig.arch_config_from(config)
    names = AVLocalizer(dataclasses.replace(cfg, variant=names_of)).state_dict()
    rng = np.random.default_rng(12)
    blob = {"epoch": 3}
    for key in ("state_dict", "state_dict_ema"):
        blob[key] = {f"module.{n}": torch.from_numpy(np.asarray(
            0.05 * rng.standard_normal(tuple(v.shape)), np.float32))
            for n, v in names.items()}
    ref = str(tmp_path / "epoch_003.pth.tar")
    torch.save(blob, ref)
    path = convert_cli.main([cfg_path, ref, "--output", str(tmp_path / "out")])
    got = torch.load(path, map_location="cpu", weights_only=True)
    jcfg = jconfig.arch_config_from(jconfig.load_config(cfg_path))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: JAVLocalizer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 96, cfg.input_dim)),
                                        jnp.ones((1, 96), bool)))["params"])
    jparams = {}
    for key, src in (("params", "state_dict"), ("ema_params", "state_dict_ema")):
        jparams[key] = convert_state_dict(blob[src], template)
        want = state_dict_from_flax(jparams[key])
        assert set(got[key]) == set(want) == set(AVLocalizer(cfg).state_dict())
        assert all(torch.equal(got[key][n], want[n]) for n in want), key
    if names_of != cfg.variant:
        assert not any(UP in n for n in got["params"])
        return
    model = AVLocalizer(cfg).eval()
    model.load_state_dict(got["ema_params"], strict=True)
    x, mask = ragged(np.random.default_rng(13), 2, 96, cfg.input_dim)
    want = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply(
        {"params": jparams["ema_params"]}, x, m))(jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(mask))
    for key in ("cls_scores", "reco", "seg_scores"):
        if key in out:
            assert_close(out[key], want[key], rtol=1e-4, atol=1e-4, msg=key)
    for g, r in zip(out["out_cls"], want["out_cls"]):
        assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["deepfake_exp5", "deepfake_exp13"])
def test_train_and_validate_clis_run_the_shipped_config(tmp_path, capsys, name):
    """``cli/train.py`` 1 epoch of 3 iterations, then ``cli/validate.py``
    with its checkpoint over 6 labelled dev videos, on seeded caches of the
    config's own streams (exp5: video + emotion, two folders): finite losses, the variant's own
    loss printed and logged, ``final_loss`` the sum without
    ``reco_seg_loss``, and a finite mAP."""
    streams, dims, _ = CONFIGS[name]
    cache = synth_cache.write_feature_cache(str(tmp_path / "cache"), 12, seed=5, dims=dims,
                                            n_labelled=12, split="train", streams=streams)
    assert sorted(os.listdir(tmp_path / "cache")) == sorted(
        set(streams) | {"metadata", "test_folder", "labelled.txt"})
    for stream, c in zip(streams, dims):
        rel = cache["records"][0]["rel"] + ".npy"
        assert np.load(os.path.join(cache["folders"][stream], rel)).shape[1] == c
    cfg_path = tiny_yaml(name, str(tmp_path / "c.yaml"), cache, str(tmp_path / "runs"))
    summary = train_cli.main([cfg_path, "--device", "cpu", "--output", "t", "-p", "1",
                              "--ckpt-iter-freq", "0"])
    printed = capsys.readouterr().out
    extra = EXTRA_LOSS[tconfig.arch_config_from(tconfig.load_config(cfg_path)).variant]
    assert [st["iters"] for st in summary["epochs"]] == [3]
    losses = summary["epochs"][0]["losses"]
    assert all(np.isfinite(v) for v in losses.values()) and losses[extra] > 0
    parts = losses["cls_loss"] + 2.0 * losses["reg_loss"] + 0.1 * losses["reco_cls_loss"]
    parts += losses["reco_loss"] if extra == "reco_loss" else 0.0
    np.testing.assert_allclose(losses["final_loss"], parts, rtol=1e-5)
    assert f"\t{extra} " in printed
    with open(os.path.join(summary["out_folder"], "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert logged and all(f"train/{extra}" in rec for rec in logged if "train/final_loss" in rec)
    ckpt = os.path.join(summary["out_folder"], "epoch_001.pt")
    dev = synth_cache.write_feature_cache(str(tmp_path / "dev"), 6, seed=6, dims=dims,
                                          n_labelled=6, streams=streams)
    dev_path = tiny_yaml(name, str(tmp_path / "dev.yaml"), dev, str(tmp_path / "runs"))
    result = validate_cli.main([dev_path, "--ckpt", ckpt, "--device", "cpu",
                                "--batch-size", "4", "--output", str(tmp_path / "ev.json")])
    assert len(result["gt_records"]) == 6
    assert result["mAP"] is not None and np.isfinite(result["mAP"])

"""PyTorch port, the legacy localizer family against the JAX package on the
CPU: the ``plain`` variant (``AVLocPointTransformer`` /
``LocPointTransformer``) with the ``convTransformer`` (ActionFormer) or
``conv`` backbone, the ``fpn`` or ``identity`` neck, relative position
bias and time weighting, and the per-stream input projections.

Inputs are seeded with numpy; the JAX weights are drawn as numpy values on
the JAX package's parameter shapes (``tests/test_torch_variants.py::
random_tree``: O(1) layer scales and LN affines, biases and the relative
position bias 0.1 N, so every path matters) and carried across by
``tools/convert_jax.py``. Sizes: the modules and the localizer at T = 192,
C = 32, 4 heads, windows (7, 7, 7, 7, 7, -1), input 64 (the sizes of
``tests/test_parity.py:95-99``); the train steps at T = 192, C = 32, arch
(1, 1, 2), windows (5, 5, -1), input 24; the CLIs at the tiny localizer
of ``tests/test_torch_train_cli.py``.

Tolerances are the JAX package's own (``tests/test_parity.py``): the
modules and the whole forward f32 atol 1e-4 (rtol 1e-4 for the forward),
detections scores 1e-4 and segments 1e-3, ``compute_losses`` rtol 1e-5,
the train steps at ``tests/test_torch_train_step.py``'s rule (losses rtol
1e-4; a trajectory 2.5e-2 of the distance moved)."""

import copy
import dataclasses
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
from audio_visual_deepfake_detection_tpu.models.backbones import (
    ConvBackbone as JConvBackbone, ConvBlock as JConvBlock,
    ConvTransformerBackbone as JConvTransformerBackbone)
from audio_visual_deepfake_detection_tpu.models.necks import FPNIdentity as JFPNIdentity
from audio_visual_deepfake_detection_tpu.ops import attention as jattn
from audio_visual_deepfake_detection_tpu.tools.convert_torch import convert_state_dict
from audio_visual_deepfake_detection_tpu.train.optim import decay_mask
from audio_visual_deepfake_detection_tpu_torch import train as ttrain
from audio_visual_deepfake_detection_tpu_torch.cli import convert_checkpoint as convert_cli
from audio_visual_deepfake_detection_tpu_torch.cli import train as train_cli
from audio_visual_deepfake_detection_tpu_torch.cli import validate as validate_cli
from audio_visual_deepfake_detection_tpu_torch.core import config as tconfig
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig, TestConfig
from audio_visual_deepfake_detection_tpu_torch.infer import (
    LocalizerService, build_inference_fn, build_online_inference_fn)
from audio_visual_deepfake_detection_tpu_torch.models import AVLocalizer, build_localizer
from audio_visual_deepfake_detection_tpu_torch.models.backbones import (
    ConvBackbone, ConvTransformerBackbone)
from audio_visual_deepfake_detection_tpu_torch.models.blocks import ConvBlock
from audio_visual_deepfake_detection_tpu_torch.models.meta_arch import compute_losses
from audio_visual_deepfake_detection_tpu_torch.models.necks import FPNIdentity
from audio_visual_deepfake_detection_tpu_torch.ops import attention as tattn
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as tband
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block
from audio_visual_deepfake_detection_tpu_torch.tools import synth_cache
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import state_dict_from_flax
from audio_visual_deepfake_detection_tpu_torch.train.optim import decay_names

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_step import (  # noqa: E402
    ITERS, OPT_CFG, TRAIN_CFG, flax_state_np, l2)
from test_torch_variants import (  # noqa: E402
    TEST, TRAJECTORY, assert_close, localizer_params, make_batch, module_params, ragged)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(variant="plain", input_dim=64, num_classes=1, max_seq_len=192, embd_dim=32,
            fpn_dim=32, head_dim=32, n_head=4, mha_win_size=(7, 7, 7, 7, 7, -1),
            use_abs_pe=True, droppath=0.1)
TRAIN_ARCH = dict(variant="plain", input_dim=24, max_seq_len=192, embd_dim=32, fpn_dim=32,
                  head_dim=32, n_head=2, arch=(1, 1, 2), mha_win_size=(5, 5, -1),
                  regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
# (backbone, neck, rel-PE and time weighting)
LEGACY = [(bb, neck, rel) for bb in ("convTransformer", "conv") for neck in ("fpn", "identity")
          for rel in (False, True)]
LOSS_KEYS = ("cls_loss", "reg_loss", "final_loss", "num_pos", "grad_norm")
TOL = dict(rtol=1e-4, atol=1e-4)
KERNELS = (("fused_block", "fused_transformer_block", "K1"),
           ("fused_block", "fused_transformer_block_train", "K6"),
           ("tband", "band_attention_fused", "K7"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def legacy_arch(base, bb, neck, rel):
    return dict(base, backbone_type=bb, fpn_type=neck, use_rel_pe=rel, use_time_weight=rel)


def carried(tree, module, head):
    """``tree`` (a flax subtree under ``head``'s first part) into ``module``
    through ``state_dict_from_flax``, its names under ``head``."""
    sd = state_dict_from_flax({head.split(".")[0]: tree})
    module.load_state_dict({n[len(head):]: v for n, v in sd.items()}, strict=True)
    return module


def count_kernels(monkeypatch):
    """Calls of the K1 / K6 / K7 entry points, whatever the device."""
    calls = []
    mods = {"fused_block": fused_block, "tband": tband}
    for mod, name, tag in KERNELS:
        fn = getattr(mods[mod], name)
        monkeypatch.setattr(mods[mod], name,
                            lambda *a, _fn=fn, _tag=tag, **kw: (calls.append(_tag),
                                                                _fn(*a, **kw))[1])
    return calls


# ------------------------------------------------------------ attention and modules

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_attention_with_rel_pe_and_time_weight_matches_jax(dtype):
    """``band_attention_xla`` with both, a partial mask, a fully masked
    sample and T < 2w + 1 (f32 1e-4, bf16 2e-2), and ``band_attention``
    reaching it without launching K7."""
    rng = np.random.default_rng(0)
    for t, lens in ((24, (24, 13, 0)), (5, (5, 3, 1))):
        q, k, v = ((rng.standard_normal((3, 4, t, 8)) * s).astype(np.float32)
                   for s in (8 ** -0.5, 1, 1))
        valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
        rel = (0.5 * rng.standard_normal((4, 7))).astype(np.float32)
        tw = (1 + 0.5 * rng.standard_normal((4, 7))).astype(np.float32)
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        want = jattn.band_attention_xla(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                        jnp.asarray(valid), 3, jnp.asarray(rel, jdt),
                                        jnp.asarray(tw, jdt))
        args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
        got = tattn.band_attention_xla(*args, torch.from_numpy(valid), 3,
                                       torch.from_numpy(rel).to(tdt), torch.from_numpy(tw).to(tdt))
        tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
        tband.reset_launches()
        routed = tattn.band_attention(*args, torch.from_numpy(valid), 3,
                                      torch.from_numpy(rel).to(tdt), torch.from_numpy(tw).to(tdt))
        assert torch.equal(routed, got) and tband.LAUNCHES == 0


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_block_matches_jax(stride):
    rng = np.random.default_rng(stride)
    x, mask = ragged(rng, 3, 48, 16, lens=[48, 31, 10])
    jmod = JConvBlock(16, 3, ds_stride=stride)
    p = module_params(jmod, stride, jnp.zeros((1, 48, 16)), jnp.ones((1, 48), bool))
    want, want_mask = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    ours = ConvBlock(16, 3, ds_stride=stride)
    names = set(ours.state_dict())
    assert ("downsample.conv.weight" in names) == (stride == 2)
    assert {"conv1.conv.weight", "conv2.conv.bias"} <= names
    carried({"stem_0": p}, ours, "backbone.stem.0.")
    got, got_mask = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (3, 48 // stride, 16)
    assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_close(got, want, atol=1e-4)


@pytest.mark.parametrize("kind,streams,rel", [("convTransformer", False, False),
                                              ("convTransformer", True, True),
                                              ("conv", False, False), ("conv", True, False)])
def test_backbone_matches_jax(kind, streams, rel):
    """Every pyramid level and mask; with ``streams`` the input is three
    streams (8 + 40 + 16 channels) each projected by its own 1x1 conv
    (to 8 + 16 + 8) before the concat."""
    rng = np.random.default_rng(3)
    t = ARCH["max_seq_len"]
    x, mask = ragged(rng, 3, t, 64, lens=[t, 150, 77])
    n_in, n_embd = ((8, 40, 16), (8, 16, 8)) if streams else (64, 32)
    if kind == "conv":
        jmod = JConvBackbone(n_in, n_embd, arch=(2, 2, 5))
        ours = ConvBackbone(n_in, n_embd, arch=(2, 2, 5))
    else:
        kw = dict(n_head=4, max_len=t, arch=(2, 2, 5), mha_win_size=ARCH["mha_win_size"],
                  use_abs_pe=True, use_rel_pe=rel, use_time_weight=rel)
        jmod = JConvTransformerBackbone(n_in, n_embd, **kw)
        ours = ConvTransformerBackbone(n_in, n_embd, **kw)
    p = module_params(jmod, 4, jnp.zeros((1, t, 64)), jnp.ones((1, t), bool))
    assert ("proj_0" in p["embed"]) == streams
    want_f, want_m = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    carried(p, ours, "backbone.")
    if streams:
        assert ours.proj[1].conv.weight.shape == (16, 40, 1)
    with torch.no_grad():
        got_f, got_m = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert len(got_f) == len(want_f) == 6
    for g, w, gm, wm in zip(got_f, want_f, got_m, want_m):
        assert g.shape == (3, gm.shape[1], 32)
        assert np.array_equal(gm.numpy(), np.asarray(wm))
        assert_close(g, w, atol=1e-4)


def test_fpn_identity_matches_jax():
    rng = np.random.default_rng(5)
    lens = [(48, 40, 9), (24, 20, 5), (12, 10, 3)]
    feats = [ragged(rng, 3, n[0], 16, lens=list(n)) for n in lens]
    xs, ms = [f[0] for f in feats], [f[1] for f in feats]
    jmod = JFPNIdentity(16, start_level=1)
    p = module_params(jmod, 5, [jnp.asarray(a) for a in xs], [jnp.asarray(m) for m in ms])
    want_f, want_m = jmod.apply({"params": p}, [jnp.asarray(a) for a in xs],
                                [jnp.asarray(m) for m in ms])
    ours = carried(p, FPNIdentity(16, 16, 3, start_level=1), "neck.")
    assert set(ours.state_dict()) == {f"fpn_norms.{i}.{w}" for i in (0, 1)
                                      for w in ("weight", "bias")}
    got_f, got_m = ours([torch.from_numpy(a) for a in xs], [torch.from_numpy(m) for m in ms])
    assert len(got_f) == 2
    for g, w, gm, wm in zip(got_f, want_f, got_m, want_m):
        assert_close(g, w, atol=1e-4)
        assert np.array_equal(gm.numpy(), np.asarray(wm))
    with pytest.raises(ValueError, match="identity neck"):
        FPNIdentity(16, 32, 3)


# ------------------------------------------------------------ the localizer

@pytest.fixture(scope="module", params=LEGACY, ids=["-".join(map(str, c)) for c in LEGACY])
def models(request):
    arch = legacy_arch(ARCH, *request.param)
    jcfg = JArchConfig(**arch)
    p = localizer_params(jcfg, 4)
    ours = AVLocalizer(ArchConfig(**arch)).eval()
    ours.load_state_dict(state_dict_from_flax(p), strict=True)
    return arch, jcfg, p, ours


def test_converter_round_trip_is_exact(models):
    """The reference's names and shapes (relative position bias (1, 1, H, W),
    time weighting (1, H, W)), and back through JAX ``convert_state_dict``
    bit for bit."""
    arch, _, p, ours = models
    sd = state_dict_from_flax(p)
    names = set(sd)
    assert not any(n.startswith(("interpolator.", "segmentandCls.")) for n in names)
    rel = [n for n in names if n.endswith("attn.rel_pe")]
    tw = [n for n in names if n.endswith("attn.time_weighting")]
    if arch["use_rel_pe"] and arch["backbone_type"] == "convTransformer":
        assert len(rel) == len(tw) == 7 - 1           # every banded block, no dense one
        assert sd[rel[0]].shape == (1, 1, 4, 7) and sd[tw[0]].shape == (1, 4, 7)
    else:
        assert not rel and not tw
    if arch["backbone_type"] == "conv":
        assert "backbone.branch.0.downsample.conv.weight" in names
    if arch["fpn_type"] == "identity":
        assert not any(n.startswith("neck.fpn_convs") for n in names)
    back = convert_state_dict(sd, p)
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(flat_b[path], leaf), path


def test_localizer_outputs_match_jax(models):
    """No video logit; with rel-PE / time weighting, setting them to 0 / 1
    moves the output (they are used, not dropped by a fused path)."""
    arch, jcfg, p, ours = models
    x, mask = ragged(np.random.default_rng(5), 3, 192, 64, lens=[192, 150, 77])
    ref = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply({"params": p}, x, m))(
        jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
    assert set(got) == set(ref) == {"out_cls", "out_offsets", "fpn_masks"}
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(got[key], ref[key]):
            assert g.dtype == torch.float32
            assert_close(g, r, msg=key, **TOL)
    for g, r in zip(got["fpn_masks"], ref["fpn_masks"]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    if arch["use_rel_pe"] and arch["backbone_type"] == "convTransformer":
        for leaf in ("rel_pe", "time_weighting"):
            flat = copy.deepcopy(ours)
            with torch.no_grad():
                for n, prm in flat.named_parameters():
                    if n.endswith(leaf):
                        prm.fill_(0.0 if leaf == "rel_pe" else 1.0)
                moved = flat(torch.from_numpy(x), torch.from_numpy(mask))["out_cls"][0]
            assert (moved - got["out_cls"][0]).abs().max() > 1e-3, leaf


def test_inference_fn_detections_match_jax(models):
    """The decoded detections; the video logit is zeros (B, 1), as the JAX
    runner gives for a model without a video classifier."""
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
    assert video_cls.dtype == np.float32 and video_cls.shape == (3, 1)
    assert np.array_equal(video_cls, j_video_cls) and not video_cls.any()


# ------------------------------------------------------------ dispatch and the runner

@pytest.mark.parametrize("rel", [False, True])
def test_rel_pe_config_takes_no_kernel(monkeypatch, rel):
    """The ConvTransformer's blocks (arch (1, 1, 2): 3) take K1 in eval and
    K6 in a training forward, as the production blocks do; with rel-PE and
    time weighting every block is unfused in both, banded attention the
    plain formulation: K1, K6 and K7 are never called (JAX ``fused_mode``
    and ``fused_train_eligible``). With ``dropout > 0`` the unfused training
    block calls K7 unless rel-PE is on."""
    calls = count_kernels(monkeypatch)
    arch = legacy_arch(TRAIN_ARCH, "convTransformer", "identity", rel)
    x, mask = (torch.from_numpy(a) for a in ragged(np.random.default_rng(1), 2, 192, 24))
    model = build_localizer(ArchConfig(**arch), seed=2, device="cpu")
    with torch.no_grad():
        model(x, mask)
    assert calls == ([] if rel else ["K1"] * 3)
    calls.clear()
    model.train()
    model(x, mask, train=True, generator=torch.Generator().manual_seed(0))
    assert calls == ([] if rel else ["K6"] * 3)
    calls.clear()
    drop = build_localizer(ArchConfig(**dict(arch, dropout=0.1)), seed=2, device="cpu")
    drop(x, mask, train=True, generator=torch.Generator().manual_seed(0))
    assert calls == ([] if rel else ["K7"] * 2)      # the two banded blocks


def test_runner_gives_zero_video_cls_without_a_classifier():
    """Both inference functions and the service give a plain model's video
    logit as zeros (B, 1) f32; a recovery model's stays its own."""
    cfg = ArchConfig(**legacy_arch(TRAIN_ARCH, "conv", "fpn", False))
    model = build_localizer(cfg, seed=1, device="cpu")
    tcfg = TestConfig(**TEST)
    rng = np.random.default_rng(2)
    x, mask = ragged(rng, 2, 192, 24)
    meta = (np.full(2, 25.0, np.float32), np.full(2, 3.8, np.float32),
            np.full(2, 1.0, np.float32), np.full(2, 1.0, np.float32))
    cls = build_inference_fn(cfg, tcfg)(model, x, mask, *meta)[4]
    assert cls.dtype == torch.float32 and cls.shape == (2, 1) and not cls.any()
    streams = (rng.standard_normal((2, 50, 8)).astype(np.float32),
               rng.standard_normal((2, 20, 16)).astype(np.float32))
    rows = (np.array([50, 31]), np.array([20, 12]))
    online = build_online_inference_fn(cfg, tcfg, 1.0, 1.0)(model, streams, rows,
                                                            np.array([2.0, 1.24], np.float32))
    assert online[4].shape == (2, 1) and not online[4].any()
    service = LocalizerService(cfg, tcfg, model, batch_size=2, max_wait_ms=5,
                               batch_buckets=[2], warmup=True)
    try:
        res = service.submit(x[0, :150], 25.0, 6.0, 1.0).result(timeout=300)
    finally:
        assert service.stop() is True
    assert res.video_cls == 0.0 and len(res.scores) > 0
    recovery = build_localizer(ArchConfig(**dict(TRAIN_ARCH, variant="av_recovery_norecon")),
                               seed=1, device="cpu")
    assert build_inference_fn(cfg, tcfg)(recovery, x, mask, *meta)[4].abs().sum() > 0


# ------------------------------------------------------------ losses and training

def test_compute_losses_without_cls_scores():
    """A plain model's outputs (no ``cls_scores``): the JAX losses at rtol
    1e-5, no ``reco_cls_loss``, ``final_loss`` = cls + 2 reg."""
    cfg = ArchConfig(**TRAIN_ARCH)
    rng = np.random.default_rng(7)
    b, t = 4, cfg.max_seq_len
    lens = [t, 80, 60, 0]
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    out = {"out_cls": [rng.standard_normal((b, n, 1)).astype(np.float32) for n in cfg.fpn_lens],
           "out_offsets": [np.abs(rng.standard_normal((b, n, 2))).astype(np.float32)
                           for n in cfg.fpn_lens],
           "fpn_masks": [mask[:, ::s] for s in cfg.fpn_strides]}
    seg = np.zeros((b, 2, 2), np.float32)
    seg[0] = [[10.0, 30.0], [52.5, 61.0]]
    seg[2, 0] = [5.0, 40.0]
    valid = np.asarray([[True, True], [False, False], [True, False], [False, False]])
    has_gt, row_valid = valid.any(1), np.asarray([True, True, True, False])
    gt_cls, gt_off = j_label_points(j_model_points(JArchConfig(**TRAIN_ARCH)), jnp.asarray(seg),
                                    jnp.zeros((b, 2), jnp.int32), jnp.asarray(valid), 1)
    kw = dict(num_classes=1, loss_weight=2.0, label_smoothing=0.1, variant="plain")
    want, want_pos = j_compute_losses(jax.tree_util.tree_map(jnp.asarray, out), gt_cls, gt_off,
                                      jnp.asarray(has_gt), jnp.float32(200.0),
                                      row_valid=jnp.asarray(row_valid), **kw)
    got, got_pos = compute_losses(
        {k: [torch.from_numpy(a) for a in v] for k, v in out.items()},
        torch.from_numpy(np.asarray(gt_cls)), torch.from_numpy(np.asarray(gt_off)),
        torch.from_numpy(has_gt), torch.tensor(200.0), row_valid=torch.from_numpy(row_valid),
        **kw)
    assert set(got) == set(want) == {"cls_loss", "reg_loss", "final_loss"}
    assert int(got_pos) == int(want_pos) > 0
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(got["final_loss"]),
                               float(got["cls_loss"] + 2.0 * got["reg_loss"]), rtol=1e-6)


TRAIN_CASES = [("convTransformer", "fpn", False), ("convTransformer", "identity", True),
               ("conv", "identity", False)]


@pytest.fixture(scope="module", params=TRAIN_CASES, ids=["-".join(map(str, c))
                                                         for c in TRAIN_CASES])
def jax_run(request):
    """The JAX package's 4 deterministic-forward steps over batches of 8:
    the state (numpy) before and after, and each step's losses."""
    arch = legacy_arch(TRAIN_ARCH, *request.param)
    cfg = JArchConfig(**arch)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, localizer_params(cfg, 9))}
    tx, _ = jtrain.make_optimizer(params, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = jtrain.TrainState.create(params, tx, TRAIN_CFG["init_loss_norm"],
                                     jax.random.PRNGKey(0))
    step = jax.jit(jtrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True))
    states, losses = [flax_state_np(state)], []
    for i in range(4):
        state, out = step(state, make_batch(i, "plain"))
        states.append(flax_state_np(state))
        losses.append({k: float(out[k]) for k in LOSS_KEYS})
        assert "reco_cls_loss" not in out
    return arch, states, losses


def test_four_step_trajectory_matches_jax(jax_run):
    arch, states, losses = jax_run
    cfg = ArchConfig(**arch)
    model, gen = ttrain.init_model(cfg, 0, device="cpu")
    tx, _ = ttrain.make_optimizer(model, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = ttrain.TrainState.create(model, tx, TRAIN_CFG["init_loss_norm"], gen)
    state.model.load_state_dict(state_dict_from_flax(states[0]["params"]), strict=True)
    for n, p in state.model.named_parameters():
        state.ema_params[n].copy_(p.detach())
    step = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for i in range(4):
        state, out = step(state, make_batch(i, "plain"))
        assert "reco_cls_loss" not in out
        for key in LOSS_KEYS:
            rtol = 2e-3 if key == "grad_norm" and i >= 2 else 1e-4
            np.testing.assert_allclose(float(out[key]), losses[i][key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
    for tree, got in (("params", {n: p.detach() for n, p in state.model.named_parameters()}),
                      ("ema_params", state.ema_params)):
        ref = state_dict_from_flax(states[4][tree])
        assert set(ref) == set(got)
        moved = l2(ref, start)
        assert moved > 0.0
        assert l2({n: got[n] for n in ref}, ref) < TRAJECTORY * moved, tree
    if arch["use_rel_pe"]:
        rel = [n for n in start if n.endswith("rel_pe")]
        assert rel and all(not torch.equal(state.model.get_parameter(n), start[n]) for n in rel)
    assert losses[0]["num_pos"] > 0


@pytest.mark.parametrize("bb", ["convTransformer", "conv"])
def test_decay_set_matches_jax(bb):
    """Conv and linear weights decay, ConvBlock's convs and the per-level
    projections among them; relative position biases, time weights, biases,
    norms and scales do not: the JAX ``decay_mask`` over the same tree."""
    arch = legacy_arch(TRAIN_ARCH, bb, "identity", True)
    p = localizer_params(JArchConfig(**arch), 1)
    flags = jax.tree_util.tree_map(lambda m, v: np.full(v.shape, float(m), np.float32),
                                   decay_mask(p), p)
    want = {n for n, v in state_dict_from_flax(flags).items() if bool(v.flatten()[0])}
    got = decay_names(AVLocalizer(ArchConfig(**arch)))
    assert got == want
    if bb == "conv":
        assert "backbone.stem.0.conv1.conv.weight" in got
        assert "backbone.branch.1.downsample.conv.weight" in got
    else:
        assert not any(n.endswith(("rel_pe", "time_weighting")) for n in got)
        assert any(n.endswith("attn.rel_pe") for n in state_dict_from_flax(p))


# ------------------------------------------------------------ conversion and the CLIs

TINY = {
    "init_rand_seed": 11,
    "model_name": "AVLocPointTransformer",
    "dataset": {"max_seq_len": 96, "crop_ratio": None, "video_input_dim": 8,
                "audio_input_dim": 16},
    "model": {"backbone_type": "convTransformer", "fpn_type": "identity",
              "backbone_arch": [1, 1, 2], "n_mha_win_size": [5, 5, -1],
              "regression_range": [[0, 4], [4, 8], [8, 10000]], "n_head": 2,
              "embd_dim": 32, "fpn_dim": 32, "head_dim": 32, "use_rel_pe": True},
    "opt": {"early_stop_epochs": 1},
    "loader": {"batch_size": 4, "num_workers": 2},
    "test_cfg": {"min_score": 0.001, "max_seg_num": 20},
}
BASE_YAML = os.path.join(REPO, "configs_train", "deepfake_exp10.yaml")


def plain_yaml(path, cache=None, output="", **model):
    """``configs_train/deepfake_exp10.yaml`` as a tiny legacy localizer."""
    tree = synth_cache.merge(copy.deepcopy(TINY), {"model": model})
    if cache is not None:
        return synth_cache.write_config(BASE_YAML, path, cache, output, tree)
    with open(BASE_YAML) as f:
        config = synth_cache.merge(yaml.safe_load(f), tree)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def test_yaml_gives_the_jax_arch_config(tmp_path):
    for name, bb in (("AVLocPointTransformer", "convTransformer"), ("LocPointTransformer", "conv")):
        path = plain_yaml(str(tmp_path / f"{name}.yaml"), backbone_type=bb)
        with open(path) as f:
            tree = yaml.safe_load(f)
        tree["model_name"] = name
        with open(path, "w") as f:
            yaml.safe_dump(tree, f)
        ours = tconfig.arch_config_from(tconfig.load_config(path))
        ref = jconfig.arch_config_from(jconfig.load_config(path))
        assert ours == ArchConfig(**{k: getattr(ref, k) for k in ArchConfig.__dataclass_fields__})
        assert (ours.variant, ours.backbone_type, ours.fpn_type, ours.use_rel_pe) == \
            ("plain", bb, "identity", True)
        assert not ours.use_time_weight and ours.max_div_factor == ref.max_div_factor == 8


@pytest.mark.parametrize("bb", ["convTransformer", "conv"])
def test_reference_checkpoint_converts_into_both_packages(tmp_path, bb):
    """A random state dict under the reference's names of the plain model
    (``module.`` prefixes, raw and EMA; the relative position bias and time
    weighting in the reference's shapes): ``cli/convert_checkpoint.py`` into
    the port and JAX ``convert_state_dict`` into the JAX package give the
    same parameters and the same outputs."""
    cfg_path = plain_yaml(str(tmp_path / "c.yaml"), backbone_type=bb)
    cfg = tconfig.arch_config_from(tconfig.load_config(cfg_path))
    cfg = dataclasses.replace(cfg, use_time_weight=True)
    names = AVLocalizer(cfg).state_dict()
    rng = np.random.default_rng(12)
    blob = {"epoch": 3}
    for key in ("state_dict", "state_dict_ema"):
        blob[key] = {f"module.{n}": torch.from_numpy(np.asarray(
            0.05 * rng.standard_normal(tuple(v.shape)), np.float32)) for n, v in names.items()}
    ref = str(tmp_path / "epoch_003.pth.tar")
    torch.save(blob, ref)
    path = convert_cli.main([cfg_path, ref, "--output", str(tmp_path / "out")])
    got = torch.load(path, map_location="cpu", weights_only=True)
    jcfg = jconfig.arch_config_from(jconfig.load_config(cfg_path))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: JAVLocalizer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 96, cfg.input_dim)),
                                        jnp.ones((1, 96), bool)))["params"])
    held = set(AVLocalizer(tconfig.arch_config_from(tconfig.load_config(cfg_path))).state_dict())
    assert not any(n.endswith("time_weighting") for n in held)    # no YAML key turns it on
    jparams = {}
    for key, src in (("params", "state_dict"), ("ema_params", "state_dict_ema")):
        jparams[key] = convert_state_dict(blob[src], template)
        want = state_dict_from_flax(jparams[key])
        assert set(got[key]) == set(want) == held
        assert all(torch.equal(got[key][n], want[n]) for n in want), key
    model = AVLocalizer(tconfig.arch_config_from(tconfig.load_config(cfg_path))).eval()
    model.load_state_dict(got["ema_params"], strict=True)
    x, mask = ragged(np.random.default_rng(13), 2, 96, cfg.input_dim)
    want = jax.jit(lambda x, m: JAVLocalizer(jcfg).apply(
        {"params": jparams["ema_params"]}, x, m))(jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(mask))
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(out[key], want[key]):
            assert_close(g, r, **TOL)


def test_train_and_validate_clis_run_a_plain_config(tmp_path, capsys):
    """``cli/train.py`` 1 epoch of 3 iterations of the ConvTransformer with
    the identity neck and rel-PE, then ``cli/validate.py`` with its
    checkpoint over 6 labelled dev videos: finite losses without
    ``reco_cls_loss``, ``final_loss`` = cls + 2 reg, the relative position
    biases trained, a finite mAP."""
    dims = (8, 12, 4)
    cache = synth_cache.write_feature_cache(str(tmp_path / "cache"), 12, seed=5, dims=dims,
                                            n_labelled=12, split="train")
    cfg_path = plain_yaml(str(tmp_path / "c.yaml"), cache, str(tmp_path / "runs"))
    summary = train_cli.main([cfg_path, "--device", "cpu", "--output", "t", "-p", "1",
                              "--ckpt-iter-freq", "0"])
    printed = capsys.readouterr().out
    assert "Model: plain" in printed
    assert [st["iters"] for st in summary["epochs"]] == [3]
    losses = summary["epochs"][0]["losses"]
    assert "reco_cls_loss" not in losses and all(np.isfinite(v) for v in losses.values())
    np.testing.assert_allclose(losses["final_loss"], losses["cls_loss"] + 2.0 * losses["reg_loss"],
                               rtol=1e-5)
    ckpt = os.path.join(summary["out_folder"], "epoch_001.pt")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    rel = [n for n in saved["params"] if n.endswith("attn.rel_pe")]
    # trained: the raw weights left their EMA (which stays near the start)
    assert rel and all(not torch.equal(saved["params"][n], saved["ema_params"][n]) for n in rel)
    dev = synth_cache.write_feature_cache(str(tmp_path / "dev"), 6, seed=6, dims=dims,
                                          n_labelled=6)
    dev_path = plain_yaml(str(tmp_path / "dev.yaml"), dev, str(tmp_path / "runs"))
    result = validate_cli.main([dev_path, "--ckpt", ckpt, "--device", "cpu",
                                "--batch-size", "4", "--output", str(tmp_path / "ev.json")])
    assert len(result["gt_records"]) == 6
    assert result["mAP"] is not None and np.isfinite(result["mAP"])

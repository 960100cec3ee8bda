"""PyTorch port, the whole slice vs the JAX package on the CPU: weights carried
across with ``state_dict_from_flax`` (exact round trip through the JAX
package's ``convert_state_dict``), the AVLocalizer outputs (1e-4), the
features -> detections inference function (the tolerances of
tests/test_parity_e2e.py:96-99), the LocalizerService against a direct call,
the YAML configs, and an import of the port that leaves jax unloaded.
Tiny config of tests/test_service.py:14-19, f32, layer scales and LN affines
perturbed to O(1) so the attention paths matter."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.core.config import (
    arch_config_from as j_arch_config_from, load_config,
    test_config_from as j_test_config_from)
from audio_visual_deepfake_detection_tpu.infer.decode import TestConfig as JTestConfig
from audio_visual_deepfake_detection_tpu.infer.runner import (
    build_inference_fn as j_build_inference_fn)
from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.models import AVLocalizer as JAVLocalizer
from audio_visual_deepfake_detection_tpu.tools.convert_torch import convert_state_dict
from audio_visual_deepfake_detection_tpu.train.state import init_model
from audio_visual_deepfake_detection_tpu_torch.core.config import (
    ArchConfig, TestConfig, arch_config_from)
from audio_visual_deepfake_detection_tpu_torch.core import config as port_config
from audio_visual_deepfake_detection_tpu_torch.infer import (
    LocalizerService, build_inference_fn)
from audio_visual_deepfake_detection_tpu_torch.models import AVLocalizer
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    state_dict_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(variant="av_recovery_norecon", input_dim=24, num_classes=1,
            max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
TEST = dict(pre_nms_thresh=0.001, pre_nms_topk=2000, iou_threshold=0.1,
            min_score=0.001, max_seg_num=10, nms_method="soft", nms_sigma=0.75,
            duration_thresh=0.001, multiclass_nms=False, voting_thresh=0.9)


def _perturb(tree, rng):
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k.startswith("drop_path"):
            v["scale"] = rng.standard_normal(v["scale"].shape).astype(np.float32)
        elif k in ("ln1", "ln2", "lnq", "lnk", "lnv", "query_norm", "key_norm",
                   "value_norm"):
            v["weight"] = (1 + 0.5 * rng.standard_normal(v["weight"].shape)
                           ).astype(np.float32)
            v["bias"] = (0.3 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        else:
            _perturb(v, rng)
    return tree


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    jcfg = JArchConfig(**ARCH)
    params, _ = init_model(jcfg, 2, 0)
    p = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"])), rng)
    ours = AVLocalizer(ArchConfig(**ARCH)).eval()
    ours.load_state_dict(state_dict_from_flax(p), strict=True)
    return jcfg, p, ours


def _inputs(rng, b=3):
    x = rng.standard_normal((b, 96, 24)).astype(np.float32)
    mask = np.ones((b, 96), bool)
    mask[1, 70:] = False
    mask[2, 41:] = False
    return x * mask[..., None], mask


def test_converter_round_trip_is_exact(models):
    _, p, _ = models
    back = convert_state_dict(state_dict_from_flax(p), p)
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(flat_b[path], leaf), path


def test_localizer_outputs_match_jax(models, rng):
    jcfg, p, ours = models
    x, mask = _inputs(rng)
    ref = JAVLocalizer(jcfg).apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                                   train=False)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["cls_scores"].numpy(), np.asarray(ref["cls_scores"]), **tol)
    for key in ("out_cls", "out_offsets"):
        for g, r in zip(got[key], ref[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
    for g, r in zip(got["fpn_masks"], ref["fpn_masks"]):
        assert np.array_equal(g.numpy(), np.asarray(r))


def _meta(b):
    return (np.full(b, 25.0, np.float32), np.full(b, 3.8, np.float32),
            np.full(b, 0.3, np.float32), np.full(b, 0.3, np.float32))


def test_inference_fn_detections_match_jax(models, rng):
    jcfg, p, ours = models
    x, mask = _inputs(rng)
    meta = _meta(3)
    j_out = [np.asarray(a) for a in j_build_inference_fn(jcfg, JTestConfig(**TEST))(
        {"params": p}, jnp.asarray(x), jnp.asarray(mask), *map(jnp.asarray, meta))]
    t_out = [a.numpy() for a in build_inference_fn(ArchConfig(**ARCH), TestConfig(**TEST))(
        ours, x, mask, *meta)]
    segs, scores, _, valid, video_cls = t_out
    j_segs, j_scores, _, j_valid, j_video_cls = j_out
    for i in range(3):
        k = int(valid[i].sum())
        assert k == int(j_valid[i].sum()) and k > 0
        np.testing.assert_allclose(scores[i][:k], j_scores[i][:k], atol=1e-4)
        np.testing.assert_allclose(segs[i][:k], j_segs[i][:k], atol=1e-3)
    np.testing.assert_allclose(video_cls, j_video_cls, atol=2e-4)


def test_service_matches_direct_call(models, rng):
    _, _, ours = models
    cfg, tcfg = ArchConfig(**ARCH), TestConfig(**TEST)
    n = 5
    feats = [rng.standard_normal((int(rng.integers(40, 97)), 24)).astype(np.float32)
             for _ in range(n)]
    service = LocalizerService(cfg, tcfg, ours, batch_size=4, max_wait_ms=20,
                               batch_buckets=[2, 4], warmup=True)
    try:
        futures = [service.submit(f, 25.0, 3.8, 0.3) for f in feats]
        results = [f.result(timeout=300) for f in futures]
    finally:
        assert service.stop() is True
    fn = build_inference_fn(cfg, tcfg)
    for f, res in zip(feats, results):
        x = np.zeros((1, 96, 24), np.float32)
        x[0, :len(f)] = f
        mask = (np.arange(96) < len(f))[None]
        segs, scores, _, valid, video_cls = (a.numpy() for a in fn(ours, x, mask, *_meta(1)))
        k = valid[0]
        assert len(res.scores) == int(k.sum())
        np.testing.assert_allclose(res.segments, segs[0][k], atol=1e-5)
        np.testing.assert_allclose(res.scores, scores[0][k], atol=1e-5)
        np.testing.assert_allclose(res.video_cls, video_cls[0, 0], atol=1e-5)
    with pytest.raises(RuntimeError, match="stopped"):
        service.submit(feats[0], 25.0, 3.8, 0.3)


def test_service_ships_the_model_dtype_from_one_host_buffer(models, rng):
    """bf16: every flush fills the same host buffer in the model's dtype (on
    a card it is pinned and copied without blocking), and the detections
    equal a direct build_inference_fn call on the same bf16 features (the CPU
    rounds f32 to bf16 as the card does)."""
    _, _, ours = models
    cfg, tcfg = ArchConfig(**dict(ARCH, compute_dtype="bfloat16")), TestConfig(**TEST)
    model = AVLocalizer(cfg).eval()
    model.load_state_dict(ours.state_dict(), strict=True)
    service = LocalizerService(cfg, tcfg, model, batch_size=2, max_wait_ms=5,
                               batch_buckets=[2], warmup=True)
    shipped, run = [], service._run

    def recording(feats, *rest):
        shipped.append((feats.dtype, feats.data_ptr()))
        return run(feats, *rest)

    service._run = recording
    feats = [rng.standard_normal((n, 24)).astype(np.float32) for n in (96, 50, 33)]
    try:
        results = [service.submit(f, 25.0, 3.8, 0.3).result(timeout=300) for f in feats]
    finally:
        assert service.stop() is True
    assert len(shipped) == 3 and {s for s in shipped} == {(torch.bfloat16, shipped[0][1])}
    fn = build_inference_fn(cfg, tcfg)
    for f, res in zip(feats, results):
        x = torch.zeros((2, 96, 24), dtype=torch.bfloat16)
        x[0, :len(f)] = torch.from_numpy(f)
        mask = np.zeros((2, 96), bool)
        mask[0, :len(f)] = True
        segs, scores, _, valid, video_cls = (a.numpy() for a in fn(model, x, mask, *_meta(2)))
        k = valid[0]
        assert len(res.scores) == int(k.sum()) > 0
        assert np.array_equal(res.segments, segs[0][k])
        assert np.array_equal(res.scores, scores[0][k])
        assert res.video_cls == video_cls[0, 0]


def test_service_survives_a_failed_flush(models, rng):
    """A flush whose model call raises fails its own request only; the next
    flush refills the same host buffer and answers as a direct call does."""
    _, _, ours = models
    cfg, tcfg = ArchConfig(**ARCH), TestConfig(**TEST)
    service = LocalizerService(cfg, tcfg, ours, batch_size=1, max_wait_ms=1, batch_buckets=[1])
    infer, calls = service._infer_fn, []

    def failing_once(*args):
        calls.append(args[1].data_ptr())
        if len(calls) == 1:
            raise RuntimeError("model failed")
        return infer(*args)

    service._infer_fn = failing_once
    f = rng.standard_normal((50, 24)).astype(np.float32)
    try:
        with pytest.raises(RuntimeError, match="model failed"):
            service.submit(f, 25.0, 3.8, 0.3).result(timeout=300)
        res = service.submit(f, 25.0, 3.8, 0.3).result(timeout=300)
    finally:
        assert service.stop() is True
    assert len(calls) == 2 and len(service._host) == 1
    x = np.zeros((1, 96, 24), np.float32)
    x[0, :50] = f
    segs, scores, _, valid, _ = (a.numpy() for a in build_inference_fn(cfg, tcfg)(
        ours, x, (np.arange(96) < 50)[None], *_meta(1)))
    assert np.array_equal(res.scores, scores[0][valid[0]])
    assert np.array_equal(res.segments, segs[0][valid[0]])


def test_eval_takes_the_eval_kernel_whatever_the_grad_mode(models, rng, monkeypatch):
    """An eval forward whose inputs and parameters require no gradient takes
    K1 (``fused_transformer_block``) with grad mode on, as the JAX block's
    ``train=False`` does; with trainable parameters it is the differentiable
    K6 path."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block

    _, _, ours = models
    model = AVLocalizer(ArchConfig(**ARCH)).eval()
    model.load_state_dict(ours.state_dict(), strict=True)
    calls = []
    for name, tag in (("fused_transformer_block", "K1"),
                      ("fused_transformer_block_train", "K6")):
        fn = getattr(fused_block, name)
        monkeypatch.setattr(fused_block, name,
                            lambda *a, _fn=fn, _tag=tag, **kw: (calls.append(_tag), _fn(*a, **kw))[1])
    x, mask = (torch.from_numpy(a) for a in _inputs(rng))
    assert torch.is_grad_enabled()
    model.requires_grad_(False)
    frozen = model(x, mask)
    assert calls and set(calls) == {"K1"}
    calls.clear()
    model.requires_grad_(True)
    trainable = model(x, mask)
    assert calls and set(calls) == {"K6"}
    torch.testing.assert_close(frozen["cls_scores"], trainable["cls_scores"].detach(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("yaml_path", ["configs_test/deepfake_exp12_test.yaml",
                                       "configs_train/deepfake_exp10.yaml",
                                       "configs_train/deepfake_exp5.yaml",
                                       "configs_train/deepfake_exp13.yaml"])
def test_configs_from_yaml_match_jax(yaml_path):
    config = load_config(os.path.join(REPO, yaml_path))
    ours, ref = arch_config_from(config), j_arch_config_from(config)
    for field in ArchConfig.__dataclass_fields__:
        assert getattr(ours, field) == getattr(ref, field), field
    for prop in ("fpn_strides", "fpn_lens", "max_div_factor"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    t_ours, t_ref = port_config.test_config_from(config), j_test_config_from(config)
    for field in TestConfig.__dataclass_fields__:
        assert getattr(t_ours, field) == getattr(t_ref, field), field
    # the legacy family, once refused, is the JAX package's
    for kw in (dict(variant="plain"), dict(use_rel_pe=True),
               dict(variant="plain", backbone_type="conv", fpn_type="identity",
                    use_time_weight=True)):
        legacy, j_legacy = ArchConfig(**kw), JArchConfig(**kw)
        for field in ArchConfig.__dataclass_fields__:
            assert getattr(legacy, field) == getattr(j_legacy, field), field
        for prop in ("fpn_strides", "fpn_lens", "max_div_factor"):
            assert getattr(legacy, prop) == getattr(j_legacy, prop), prop


def test_build_localizer_defaults_to_the_card():
    """An entry point lands on the card unless the caller asks for the CPU."""
    import inspect

    from audio_visual_deepfake_detection_tpu_torch.models import build_localizer

    assert inspect.signature(build_localizer).parameters["device"].default == "cuda"


def test_build_localizer_on_the_cpu_when_asked():
    from audio_visual_deepfake_detection_tpu_torch.models import build_localizer

    model = build_localizer(ArchConfig(**ARCH), seed=3, device="cpu")
    tensors = list(model.parameters()) + list(model.buffers())
    assert tensors and all(p.device.type == "cpu" for p in tensors)
    assert not model.training
    again = build_localizer(ArchConfig(**ARCH), seed=3, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)                      # the seed decides the weights


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import audio_visual_deepfake_detection_tpu_torch.infer\n"
            "import audio_visual_deepfake_detection_tpu_torch.tools.convert_jax\n"
            "import audio_visual_deepfake_detection_tpu_torch.ops.kernels.build\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'audio_visual_deepfake_detection_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=120)

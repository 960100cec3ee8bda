"""PyTorch port, optimizer and schedule vs the JAX package's optax chain.

The schedule is compared at every step of a short run with ``make_schedule``
(rtol 1e-5 plus 1e-9 absolute: optax evaluates it in f32, where the cosine's
``1 + cos`` cancels near the end). The decay set is compared with
``decay_mask`` through the parameter-name map. One AdamW and one SGD step
with clipping are compared with optax at 1e-6."""

import numpy as np
import pytest
import jax
import optax
import torch
from flax import traverse_util

from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.train import init_model as jinit_model
from audio_visual_deepfake_detection_tpu.train import optim as joptim
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig
from audio_visual_deepfake_detection_tpu_torch.models.meta_arch import AVLocalizer
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    state_dict_from_flax, torch_name)
from audio_visual_deepfake_detection_tpu_torch.train import optim as toptim

ARCH = dict(input_dim=24, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
BASE = {"learning_rate": 1e-3, "weight_decay": 0.05, "epochs": 3, "momentum": 0.9,
        "schedule_steps": [1, 2], "schedule_gamma": 0.1}


@pytest.mark.parametrize("opt", [
    dict(warmup=True, warmup_epochs=2, schedule_type="cosine"),
    dict(warmup=True, warmup_epochs=1, schedule_type="cosine", eta_min=1e-5),
    dict(warmup=False, schedule_type="cosine"),
    dict(warmup=True, warmup_epochs=2, schedule_type="multistep"),
    dict(warmup=False, schedule_type="multistep"),
])
def test_schedule_matches_jax_at_every_step(opt):
    cfg = dict(BASE, **opt)
    iters = 7
    ref = joptim.make_schedule(cfg, iters)
    got = toptim.make_schedule(cfg, iters)
    total = (cfg["epochs"] + cfg.get("warmup_epochs", 0)) * iters + 3
    for count in range(total):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-5, atol=1e-9,
                                   err_msg=f"step {count}")
    if cfg["warmup"]:
        w = cfg["warmup_epochs"] * iters
        assert got(0) == 0.0 and got(w - 1) == pytest.approx(cfg["learning_rate"])


@pytest.fixture(scope="module")
def pair():
    params, _ = jinit_model(JArchConfig(**ARCH), 2, 0)
    p = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    model = AVLocalizer(ArchConfig(**ARCH))
    model.load_state_dict(state_dict_from_flax(p), strict=True)
    return p, model


def test_decay_set_matches_jax_mask(pair):
    p, model = pair
    mask = traverse_util.flatten_dict(joptim.decay_mask(p))
    want = {torch_name(path)[0] for path, decays in mask.items() if decays}
    got = toptim.decay_names(model)
    assert got == want
    last = f"hh_branch.{ARCH['arch'][2] - 1}."
    assert got and not any(last in n for n in got)
    assert any("hh_branch.0." in n for n in got)
    names = {n for n, _ in model.named_parameters()}
    assert got < names
    assert not any(n.endswith(("bias", "scale")) or "norm" in n or ".ln" in n for n in got)


@pytest.mark.parametrize("kind,grad_scale", [("AdamW", 1.0), ("AdamW", 1e-4), ("SGD", 1.0)])
def test_two_optimizer_steps_match_optax(pair, rng, kind, grad_scale):
    """Clipped (norm above 1) and unclipped (below) gradients; the last
    hh_branch block gets none, as in training. Two steps, so that the moments
    and the second step's rate count."""
    p, _ = pair
    model = AVLocalizer(ArchConfig(**ARCH))
    model.load_state_dict(state_dict_from_flax(p), strict=True)
    cfg = dict(BASE, type=kind, warmup=True, warmup_epochs=1, schedule_type="cosine")
    iters = 3
    tx, _ = joptim.make_optimizer(p, cfg, iters, clip_grad_l2norm=1.0)
    ours, _ = toptim.make_optimizer(model, cfg, iters, clip_grad_l2norm=1.0)
    opt_state = tx.init(p)
    jp = p
    last = f"hh_branch_{ARCH['arch'][2] - 1}"
    for count in (0, 1):
        flat = traverse_util.flatten_dict(jp)
        grads = {path: np.zeros_like(v) if last in path else
                 np.asarray(grad_scale * rng.standard_normal(v.shape), np.float32)
                 for path, v in flat.items()}
        jgrads = traverse_util.unflatten_dict(grads)
        updates, opt_state = tx.update(jgrads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tgrads = state_dict_from_flax(jgrads)
        for name, q in model.named_parameters():
            q.grad = None if f"hh_branch.{ARCH['arch'][2] - 1}." in name \
                else tgrads[name].contiguous()
        norm = ours.global_norm()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-6)
        assert (float(norm) > 1.0) == (grad_scale == 1.0)
        ours.update(count, norm)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    start = state_dict_from_flax(p)
    moved = 0.0
    for name, q in model.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        moved = max(moved, float((q.detach() - start[name]).abs().max()))
        if f"hh_branch.{ARCH['arch'][2] - 1}." in name:
            assert torch.equal(q.detach(), start[name]), name      # skipped, decay included
    assert moved > 1e-5

"""PyTorch port, the train step against the JAX package's on the CPU.

A 4-step trajectory with ``deterministic_forward=True`` from converted
weights, and single steps continued from ``train_state_from_flax`` of the JAX
state after 1, 2 and 3 steps. On the CPU the JAX blocks run the standard flax
path and the port's run ``block_math`` through the K6 ``autograd.Function``.

Tolerances. A step taken from the same state agrees closely: every loss,
``num_pos`` and ``grad_norm`` at rtol 1e-4, the parameters and their EMA after
the step at atol 2e-5 (measured 2e-6 .. 1e-5), ``loss_normalizer`` at rtol
1e-6. Along the trajectory the losses stay within rtol 1e-4, but single
parameters do not stay within 2e-5: Adam divides by ``sqrt(v) + 1e-8``, so
where a gradient is rounding noise its update is a rate-sized step of either
sign, and the video head's max over time reroutes its gradient when the
argmax flips (the JAX package's own trajectory test against the reference
says the same). Measured here after 4 steps: largest single difference
1.3e-3 (one rate-sized flip), l2 of the difference 6e-3 of the l2 moved. So
the trajectory holds the parameters and the EMA to 2.5e-2 of the distance
moved (a warmup off-by-one or a misplaced decay measures 8e-2 and more), and
``grad_norm`` of the steps after the first update to rtol 2e-3 (measured
6e-4). Stochastic mode is checked for being a function of the generator's
seed, for descent on a fixed batch, and the device-side resample + crop
against the host-resampled batch."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from audio_visual_deepfake_detection_tpu.models import ArchConfig as JArchConfig
from audio_visual_deepfake_detection_tpu.ops.resample import (
    linear_resample_dynamic as jresample_dynamic)
from audio_visual_deepfake_detection_tpu import train as jtrain
from audio_visual_deepfake_detection_tpu_torch import train as ttrain
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig
from audio_visual_deepfake_detection_tpu_torch.ops.resample import (
    linear_resample_dynamic, linear_resample_time)
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    state_dict_from_flax, train_state_from_flax)

ARCH = dict(input_dim=24, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
TRAIN_CFG = {"center_sample": "radius", "center_sample_radius": 1.5, "loss_weight": 2.0,
             "label_smoothing": 0.1, "init_loss_norm": 200, "clip_grad_l2norm": 1.0}
OPT_CFG = {"type": "AdamW", "learning_rate": 1e-3, "weight_decay": 0.05, "epochs": 2,
           "warmup": True, "warmup_epochs": 1, "schedule_type": "cosine", "momentum": 0.9,
           "schedule_steps": [], "schedule_gamma": 0.1}
ITERS = 4           # per epoch: the warmup ends inside the 4-step trajectory
LOSS_KEYS = ("cls_loss", "reg_loss", "reco_cls_loss", "final_loss", "num_pos", "grad_norm")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small steps run faster on one thread than on eight, and much
    faster when several test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_batch(seed, b=3, t=96, c=24):
    """Three videos: full length with two segments, real (no segment), and
    ragged (valid to row 50) with one segment; then a padding row."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), bool)
    mask[2, 50:] = False
    feats = rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None]
    seg = np.zeros((b, 2, 2), np.float32)
    seg[0] = [[10.0, 30.0], [52.5, 61.0]]
    seg[2, 0] = [5.0 + seed, 21.0 + seed]
    valid = np.asarray([[True, True], [False, False], [True, False]])
    batch = {"feats": feats, "mask": mask, "gt_segments": seg,
             "gt_labels": np.zeros((b, 2), np.int64), "gt_valid": valid,
             "has_gt": valid.any(1)}
    batch = ttrain.pad_batch_to(batch, b + 1)
    batch.pop("_real_rows")
    return batch


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def adam_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def flax_state_np(state):
    adam = adam_state(state.opt_state)
    return {"params": tree_np(state.params)["params"],
            "ema_params": tree_np(state.ema_params)["params"],
            "mu": tree_np(adam.mu)["params"], "nu": tree_np(adam.nu)["params"],
            "count": int(adam.count), "loss_normalizer": float(state.loss_normalizer),
            "step": int(state.step)}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trajectory: the state (as numpy) before step 0 and after each
    of 4 deterministic-forward steps, and each step's losses."""
    cfg = JArchConfig(**ARCH)
    params, rng = jtrain.init_model(cfg, 2, 0)
    tx, _ = jtrain.make_optimizer(params, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = jtrain.TrainState.create(params, tx, TRAIN_CFG["init_loss_norm"], rng)
    step = jax.jit(jtrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True))
    states, losses = [flax_state_np(state)], []
    for i in range(4):
        state, out = step(state, make_batch(i))
        states.append(flax_state_np(state))
        losses.append({k: float(out[k]) for k in LOSS_KEYS})
    return states, losses


def torch_state(params, dropout=0.0, dtype="float32", seed=1, **cfg_kw):
    cfg = ArchConfig(**ARCH, dropout=dropout, compute_dtype=dtype, **cfg_kw)
    model, _ = ttrain.init_model(cfg, 0, device="cpu")
    if params is not None:
        model.load_state_dict(state_dict_from_flax(params), strict=True)
    tx, sched = ttrain.make_optimizer(model, OPT_CFG, ITERS, TRAIN_CFG["clip_grad_l2norm"])
    state = ttrain.TrainState.create(model, tx, TRAIN_CFG["init_loss_norm"],
                                     torch.Generator().manual_seed(seed))
    return cfg, state


def trees(state, want):
    for tree, got in (("params", dict(state.model.named_parameters())),
                      ("ema_params", state.ema_params)):
        ref = state_dict_from_flax(want[tree])
        assert set(ref) == set(got)
        yield tree, {n: v.detach() for n, v in got.items()}, ref


def assert_state_close(state, want, atol=2e-5):
    """After one step from the same state: element by element."""
    for tree, got, ref in trees(state, want):
        for name, value in got.items():
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=0, atol=atol,
                                       err_msg=f"{tree} {name}")
    np.testing.assert_allclose(float(state.loss_normalizer), want["loss_normalizer"], rtol=1e-6)
    assert state.step == want["step"]


def l2(sd, other):
    return float(sum(((sd[n].double() - other[n].double()) ** 2).sum() for n in sd)) ** 0.5


def test_four_step_trajectory_matches_jax(jax_run):
    states, losses = jax_run
    cfg, state = torch_state(states[0]["params"])
    step = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for i in range(4):
        state, out = step(state, make_batch(i))
        for key in LOSS_KEYS:
            rtol = 2e-3 if key == "grad_norm" and i >= 2 else 1e-4
            np.testing.assert_allclose(float(out[key]), losses[i][key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
    for tree, got, ref in trees(state, states[4]):
        moved = l2(ref, start)
        assert moved > (0.5 if tree == "params" else 1e-3)     # the run went somewhere
        assert l2(got, ref) < 2.5e-2 * moved, tree
    np.testing.assert_allclose(float(state.loss_normalizer), states[4]["loss_normalizer"],
                               rtol=1e-6)
    assert state.step == 4
    assert losses[0]["num_pos"] > 0 and losses[0]["grad_norm"] > 1.0      # clipped


@pytest.mark.parametrize("taken", [1, 2, 3])
def test_step_continued_from_a_converted_jax_state(jax_run, taken):
    """Moments, count, EMA, normalizer and step carried over: the next step
    is the JAX package's, at the rate of that step."""
    states, losses = jax_run
    cfg, state = torch_state(None)
    state = train_state_from_flax(state, states[taken])
    assert state.step == taken
    step = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)
    state, out = step(state, make_batch(taken))
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(out[key]), losses[taken][key], rtol=1e-4, err_msg=key)
    assert_state_close(state, states[taken + 1])


def test_losses_come_back_as_f32_scalars_and_parameters_stay_f32(jax_run):
    states, _ = jax_run
    cfg, state = torch_state(states[0]["params"], dtype="bfloat16")
    state, out = ttrain.build_train_step(cfg, TRAIN_CFG)(state, make_batch(0))
    assert set(LOSS_KEYS) <= set(out)
    for key in ("cls_loss", "reg_loss", "reco_cls_loss", "final_loss", "grad_norm"):
        assert out[key].dtype == torch.float32 and out[key].ndim == 0
        assert bool(torch.isfinite(out[key]))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(v.dtype == torch.float32 for v in state.ema_params.values())
    assert state.step == 1


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_stochastic_step_is_a_function_of_the_generator_seed(jax_run, dropout):
    states, _ = jax_run
    out = []
    for seed in (5, 5, 6):
        cfg, state = torch_state(states[0]["params"], dropout=dropout, seed=seed)
        _, losses = ttrain.build_train_step(cfg, TRAIN_CFG)(state, make_batch(0))
        out.append(float(losses["final_loss"]))
    assert out[0] == out[1]
    assert out[0] != out[2]


def test_twelve_steps_on_a_fixed_batch_lower_the_focal_sum():
    """The unnormalized focal sum: the normalizer EMA falls from 200 towards
    num_pos and inflates the normalized loss early on."""
    cfg, state = torch_state(None)
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    batch = make_batch(0)
    raw = []
    for _ in range(12):
        state, losses = step(state, batch)
        raw.append(float(losses["cls_loss"]) * float(state.loss_normalizer))
    assert raw[-1] < raw[0]
    assert state.step == 12


def test_padded_batch_takes_the_same_step_as_the_unpadded_one(jax_run):
    states, _ = jax_run
    padded = make_batch(1)
    plain = {k: v[:3] for k, v in padded.items() if k != "row_valid"}
    got = []
    for batch in (plain, padded):
        cfg, state = torch_state(states[0]["params"])
        step = ttrain.build_train_step(cfg, TRAIN_CFG, deterministic_forward=True)
        state, _ = step(state, batch)              # rate 0: moves the moments only
        state, losses = step(state, batch)
        got.append((losses, state))
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(got[0][0][key]), float(got[1][0][key]), rtol=1e-6,
                                   err_msg=key)
    for (n, a), (_, b) in zip(got[0][1].model.named_parameters(),
                              got[1][1].model.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=2e-5,
                                   err_msg=n)


def test_last_hh_block_gets_no_gradient_and_never_moves(jax_run):
    states, _ = jax_run
    cfg, state = torch_state(states[0]["params"])
    last = f"backbone.hh_branch.{ARCH['arch'][2] - 1}."
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    for i in range(3):
        state, _ = step(state, make_batch(i))
    for name, p in state.model.named_parameters():
        if last in name:
            assert p.grad is None and torch.equal(p.detach(), start[name]), name
            # 0.999 e + 0.001 p of equal e and p, to rounding
            assert torch.allclose(state.ema_params[name], start[name], rtol=1e-6, atol=0), name
        else:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert any(last in n for n in start)


def test_init_model_sets_the_focal_prior_and_returns_a_generator():
    cfg = ArchConfig(**ARCH)
    model, gen = ttrain.init_model(cfg, 3, device="cpu")
    np.testing.assert_allclose(model.cls_head.cls_head.conv.bias.detach().numpy(),
                               -np.log(99.0), rtol=1e-5)
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    other, _ = ttrain.init_model(cfg, 3, device="cpu")
    again, _ = ttrain.init_model(cfg, 4, device="cpu")
    w = lambda m: m.backbone.stem[0].attn.query.weight.detach()  # noqa: E731
    assert torch.equal(w(model), w(other)) and not torch.equal(w(model), w(again))


def test_eval_forward_uses_no_graph_and_the_ema_copy(jax_run):
    states, _ = jax_run
    cfg, state = torch_state(states[0]["params"])
    state, _ = ttrain.build_train_step(cfg, TRAIN_CFG)(state, make_batch(0))
    state, _ = ttrain.build_train_step(cfg, TRAIN_CFG)(state, make_batch(1))
    batch = make_batch(2)
    forward = ttrain.build_eval_forward(cfg)
    raw = forward(state.model, batch["feats"], batch["mask"])
    ema = forward(state.ema_model(), batch["feats"], batch["mask"])
    assert not raw["out_cls"][0].requires_grad
    assert len(raw["out_cls"]) == ARCH["arch"][2] + 1
    assert raw["out_cls"][0].shape == (4, 96, 1) and raw["out_offsets"][0].shape == (4, 96, 2)
    assert not torch.equal(raw["out_cls"][0], ema["out_cls"][0])
    ema_sd = state.ema_model().state_dict()
    assert all(torch.equal(ema_sd[n], v) for n, v in state.ema_params.items())


# ------------------------------------------------- device-side resample + crop

def stream_batch(seed=0, b=3, r=96):
    """Two ragged streams (24 = 16 + 8 channels) with a crop window each."""
    rng = np.random.default_rng(seed)
    caps, dims = (130, 70), (16, 8)
    rows = [np.asarray([130, 47, 96], np.int32), np.asarray([70, 31, 9], np.int32)]
    streams = []
    for cap, dim, n in zip(caps, dims, rows):
        x = np.zeros((b, cap, dim), np.float32)
        for i in range(b):
            x[i, :n[i]] = rng.standard_normal((n[i], dim))
        streams.append(x)
    win_st = np.asarray([7, 0, 30], np.int32)
    win_len = np.asarray([80, 96, 50], np.int32)
    return tuple(streams), tuple(rows), win_st, win_len


def host_resampled(streams, rows, win_st, win_len, r=96):
    """Resample each valid prefix to ``r`` rows, slice the window, zero-pad."""
    b = streams[0].shape[0]
    parts = []
    for x, n in zip(streams, rows):
        out = np.zeros((b, r, x.shape[-1]), np.float32)
        for i in range(b):
            full = linear_resample_time(torch.from_numpy(x[i:i + 1, :n[i]]), r, axis=1)[0]
            sl = full[win_st[i]:win_st[i] + win_len[i]][:r].numpy()
            out[i, :sl.shape[0]] = sl
        parts.append(out)
    return np.concatenate(parts, -1), np.arange(r)[None, :] < win_len[:, None]


def test_fused_crop_matches_host_slicing_and_the_jax_resample():
    streams, rows, win_st, win_len = stream_batch()
    feats, _ = host_resampled(streams, rows, win_st, win_len)
    lo = 0
    for x, n in zip(streams, rows):
        got = linear_resample_dynamic(torch.from_numpy(x), torch.from_numpy(n), 96,
                                      resample_len=96, start=torch.from_numpy(win_st),
                                      out_valid=torch.from_numpy(win_len)).numpy()
        np.testing.assert_array_equal(got, feats[..., lo:lo + x.shape[-1]])
        ref = jresample_dynamic(jnp.asarray(x), jnp.asarray(n), 96, use_matmul=False,
                                resample_len=96, start=jnp.asarray(win_st),
                                out_valid=jnp.asarray(win_len))
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
        lo += x.shape[-1]


def test_online_resample_step_equals_the_host_resampled_batch(jax_run):
    states, _ = jax_run
    streams, rows, win_st, win_len = stream_batch()
    feats, mask = host_resampled(streams, rows, win_st, win_len)
    gt = {k: v[:3] for k, v in make_batch(0).items()
          if k in ("gt_segments", "gt_labels", "gt_valid", "has_gt")}
    host = dict(gt, feats=feats, mask=mask)
    online = dict(gt, streams=streams, rows=rows, win_st=win_st, win_len=win_len)
    out = []
    for batch, flag in ((host, False), (online, True)):
        cfg, state = torch_state(states[0]["params"])
        step = ttrain.build_train_step(cfg, TRAIN_CFG, online_resample=flag,
                                       deterministic_forward=True)
        _, losses = step(state, batch)
        out.append(losses)
    for key in LOSS_KEYS:
        assert float(out[0][key]) == float(out[1][key]), key


def test_remat_takes_the_same_stochastic_step(jax_run):
    """Activation checkpointing of the unfused blocks changes memory, not
    the step: the recompute sees the first run's draws."""
    states, _ = jax_run
    out = []
    for remat in (False, True):
        cfg, state = torch_state(states[0]["params"], dropout=0.1, seed=9, remat=remat)
        step = ttrain.build_train_step(cfg, TRAIN_CFG)
        state, _ = step(state, make_batch(0))
        state, losses = step(state, make_batch(1))
        out.append((losses, state))
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(out[0][0][key]), float(out[1][0][key]), rtol=1e-6,
                                   err_msg=key)
    for (n, a), (_, b) in zip(out[0][1].model.named_parameters(),
                              out[1][1].model.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, err_msg=n)

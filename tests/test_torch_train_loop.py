"""PyTorch port, the epoch loop, checkpoints and preemption on the CPU
(``train/loop.py``, ``train/checkpoint.py``, ``train/preempt.py``,
``train/meters.py``): the behaviour the JAX package's ``tests/test_preempt.py``
holds its loop to, with stochastic steps, so that a resumed run also has to
restore the generator; ``pad_batch_to`` key by key against the JAX
package's."""

import glob
import json
import os
import signal
import time
import types

import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.parallel.mesh import pad_batch_to as jpad_batch_to
from audio_visual_deepfake_detection_tpu_torch import train as ttrain
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig
from audio_visual_deepfake_detection_tpu_torch.train.loop import device_prefetch

ARCH = dict(input_dim=24, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)
TRAIN_CFG = {"center_sample": "radius", "center_sample_radius": 1.5, "loss_weight": 2.0,
             "label_smoothing": 0.1, "init_loss_norm": 200, "clip_grad_l2norm": 1.0}
OPT_CFG = {"type": "AdamW", "learning_rate": 1e-3, "weight_decay": 0.05, "epochs": 2,
           "warmup": True, "warmup_epochs": 1, "schedule_type": "cosine"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small steps run faster on one thread than on eight, and much
    faster when several test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class ListLoader:
    """A loader over fixed batches that records the loop's hooks."""

    def __init__(self, batches, with_skip=False):
        self.batches, self.epochs, self.skipped = batches, [], 0
        if with_skip:
            self.set_skip = self._set_skip

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def _set_skip(self, n):
        self.skipped = n

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches[self.skipped:])


def make_batch(seed, b=2, t=96, c=24):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), bool)
    mask[1, 60:] = False
    return {"feats": rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None],
            "mask": mask,
            "gt_segments": np.tile(np.asarray([[[10.0, 30.0 + seed]]], np.float32), (b, 1, 1)),
            "gt_labels": np.zeros((b, 1), np.int64), "gt_valid": np.ones((b, 1), bool),
            "has_gt": np.ones((b,), bool), "video_ids": [f"v{seed}_{i}" for i in range(b)]}


def make_state(seed=0, iters=6):
    cfg = ArchConfig(**ARCH)
    model, gen = ttrain.init_model(cfg, seed, device="cpu")
    tx, sched = ttrain.make_optimizer(model, OPT_CFG, iters, TRAIN_CFG["clip_grad_l2norm"])
    return cfg, ttrain.TrainState.create(model, tx, TRAIN_CFG["init_loss_norm"], gen), sched


def assert_same_state(a, b):
    assert a.step == b.step
    assert float(a.loss_normalizer) == float(b.loss_normalizer)
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p.detach(), q.detach()), n
        assert torch.equal(a.ema_params[n], b.ema_params[n]), n
    sa, sb = a.tx.state_dict()["state"], b.tx.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for k in sa:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][field], sb[k][field]), (k, field)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def batches():
    return [make_batch(i) for i in range(6)]


@pytest.fixture(scope="module")
def unbroken(batches):
    """One uninterrupted stochastic epoch over the six batches."""
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    return ttrain.train_one_epoch(ListLoader(batches), state, step, 0, print_freq=100)


def test_epoch_runs_every_batch_logs_and_writes_mid_epoch_checkpoints(batches, tmp_path, capsys):
    cfg, state, sched = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    seen = []

    def recording(st, batch):
        assert "video_ids" not in batch and "_real_rows" not in batch
        assert batch["feats"].shape[0] == 3 and batch["row_valid"].tolist() == [True, True, False]
        st, losses = step(st, batch)
        seen.append(float(losses["final_loss"]))
        return st, losses

    loader = ListLoader(batches)
    logger = ttrain.MetricsLogger(str(tmp_path / "log"))
    out = ttrain.train_one_epoch(loader, state, recording, 3, schedule=sched, logger=logger,
                                 print_freq=2, ckpt_every_iters=2,
                                 ckpt_folder=str(tmp_path / "ck"), batch_size=3)
    logger.close()
    assert out is state and state.step == 6 and len(seen) == 6 and np.isfinite(seen).all()
    assert loader.epochs == [3]
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "ck" / "*")))
    assert names == ["epoch_003_iter3.pt", "epoch_003_iter5.pt"]
    lines = [json.loads(s) for s in open(tmp_path / "log" / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [3, 5]
    assert {"train/final_loss", "train/grad_norm", "train/num_pos",
            "train/learning_rate"} <= set(lines[0])
    assert lines[0]["train/learning_rate"] == pytest.approx(sched(3))
    printed = capsys.readouterr().out
    assert "[Train]: Epoch 3 started" in printed and "Epoch: [003][00004/00006]" in printed
    assert "Epoch 3 finished with lr=" in printed


def test_checkpoint_round_trip_restores_everything(batches, tmp_path):
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    for b in batches[:3]:
        state, _ = step(state, {k: v for k, v in b.items() if k != "video_ids"})
    path = ttrain.save_checkpoint(str(tmp_path), 4, state, is_best=True, next_iter=3)
    assert path.endswith("epoch_004.pt") and os.path.exists(tmp_path / "model_best.pt")
    assert not glob.glob(str(tmp_path / "*.tmp*"))
    _, fresh, _ = make_state(seed=7)
    fresh, epoch, next_iter = ttrain.restore_checkpoint(path, fresh)
    assert (epoch, next_iter) == (4, 3)
    assert_same_state(fresh, state)
    # and the two take the same stochastic step from there
    batch = {k: v for k, v in batches[3].items() if k != "video_ids"}
    _, la = step(state, batch)
    _, lb = step(fresh, batch)
    assert float(la["final_loss"]) == float(lb["final_loss"])
    assert_same_state(fresh, state)


def test_restore_params_and_latest_epoch_path(batches, tmp_path):
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    for b in batches[:2]:
        state, _ = step(state, {k: v for k, v in b.items() if k != "video_ids"})
    assert ttrain.latest_epoch_path(str(tmp_path / "none")) is None
    for epoch in (2, 10, 9):
        ttrain.save_checkpoint(str(tmp_path), epoch, state)
    ttrain.save_checkpoint(str(tmp_path), 11, state, tag="epoch_011_iter4", next_iter=4)
    assert os.path.basename(ttrain.latest_epoch_path(str(tmp_path))) == "epoch_010.pt"
    path = ttrain.latest_epoch_path(str(tmp_path))
    ema, raw = ttrain.restore_params(path), ttrain.restore_params(path, use_ema=False)
    name = "backbone.stem.0.attn.query.weight"
    assert torch.equal(ema[name], state.ema_params[name])
    assert torch.equal(raw[name], dict(state.model.named_parameters())[name].detach())
    assert not torch.equal(ema[name], raw[name])
    model = ttrain.init_model(cfg, 5, device="cpu")[0]
    model.load_state_dict(ema, strict=True)
    assert torch.equal(model.state_dict()[name], state.ema_model().state_dict()[name])


def test_restore_refuses_another_model(batches, tmp_path):
    _, state, _ = make_state()
    path = ttrain.save_checkpoint(str(tmp_path), 0, state)
    other_cfg = ArchConfig(**dict(ARCH, arch=(1, 2, 2)))
    model, gen = ttrain.init_model(other_cfg, 0, device="cpu")
    tx, _ = ttrain.make_optimizer(model, OPT_CFG, 6, 1.0)
    other = ttrain.TrainState.create(model, tx, 200, gen)
    with pytest.raises((RuntimeError, ValueError)):
        ttrain.restore_checkpoint(path, other)


@pytest.mark.parametrize("with_skip", [False, True])
def test_run_stopped_at_an_iteration_and_resumed_equals_the_unbroken_run(
        batches, unbroken, tmp_path, with_skip):
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    folder = str(tmp_path / "ck")
    ttrain.train_one_epoch(ListLoader(batches[:4]), state, step, 0, print_freq=100,
                           ckpt_every_iters=3, ckpt_folder=folder)
    ckpt = os.path.join(folder, "epoch_000_iter4.pt")
    assert os.path.exists(ckpt)
    _, fresh, _ = make_state(seed=3)
    fresh, epoch, next_iter = ttrain.restore_checkpoint(ckpt, fresh)
    assert (epoch, next_iter, fresh.step) == (0, 4, 4)
    loader = ListLoader(batches, with_skip=with_skip)
    resumed = ttrain.train_one_epoch(loader, fresh, step, epoch, print_freq=100,
                                     start_iter=next_iter)
    assert loader.skipped == (4 if with_skip else 0)
    assert resumed.step == unbroken.step == 6
    assert_same_state(resumed, unbroken)


def test_preemption_request_writes_a_checkpoint_and_returns(batches, unbroken, tmp_path, capsys):
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    guard = ttrain.PreemptionGuard(signals=())
    calls = []

    def counting(st, batch):
        calls.append(1)
        if len(calls) == 3:
            guard.request()                 # lands during iteration 2
        return step(st, batch)

    folder = str(tmp_path / "ck")
    out = ttrain.train_one_epoch(ListLoader(batches), state, counting, 0, print_freq=100,
                                 ckpt_folder=folder, preempt=guard, preempt_check_every=2)
    # polled every 2 iterations: the loop leaves after iteration 3, 4 of 6 ran
    assert guard.triggered and len(calls) == 4 and out.step == 4
    ckpts = glob.glob(os.path.join(folder, "preempt_epoch_000_iter*"))
    assert [os.path.basename(p) for p in ckpts] == ["preempt_epoch_000_iter4.pt"]
    assert "preemption requested, stopped at epoch 0 after iter 3" in capsys.readouterr().out
    _, fresh, _ = make_state(seed=9)
    fresh, epoch, next_iter = ttrain.restore_checkpoint(ckpts[0], fresh)
    assert (epoch, next_iter) == (0, 4)
    assert_same_state(fresh, out)
    resumed = ttrain.train_one_epoch(ListLoader(batches), fresh, step, epoch, print_freq=100,
                                     start_iter=next_iter)
    assert_same_state(resumed, unbroken)


def test_preemption_is_honoured_at_the_end_of_a_short_epoch(batches, tmp_path):
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    guard = ttrain.PreemptionGuard(signals=())
    guard.request()
    folder = str(tmp_path / "ck")
    ttrain.train_one_epoch(ListLoader(batches[:3]), state, step, 0, print_freq=100,
                           ckpt_folder=folder, preempt=guard, preempt_check_every=100)
    assert guard.triggered and state.step == 3
    path = os.path.join(folder, "preempt_epoch_000_iter3.pt")
    assert os.path.exists(path)
    _, fresh, _ = make_state()
    _, epoch, next_iter = ttrain.restore_checkpoint(path, fresh)
    assert (epoch, next_iter) == (1, 0)         # the epoch was complete


def test_preemption_checkpoint_is_written_by_rank_zero_only(batches, tmp_path, monkeypatch,
                                                            capsys):
    """In a process group only rank 0 writes the preemption checkpoint (the
    JAX loop's process 0); every rank stops and says so."""
    cfg, state, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    guard = types.SimpleNamespace(triggered=False, agreed=lambda: True)
    folder = tmp_path / "ck"
    out = ttrain.train_one_epoch(ListLoader(batches[:3]), state, step, 0, print_freq=100,
                                 ckpt_folder=str(folder), preempt=guard, preempt_check_every=2)
    assert guard.triggered and out is state and state.step == 2
    assert not glob.glob(str(folder / "*"))
    assert "preemption requested, stopped at epoch 0 after iter 1" in capsys.readouterr().out


def test_guard_signal_handler_sets_the_flag_and_is_restored():
    before = signal.getsignal(signal.SIGUSR1)
    guard = ttrain.PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not guard.requested() and not guard.agreed()
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not guard.requested() and time.time() < deadline:
            time.sleep(0.01)
        assert guard.requested() and guard.agreed() and not guard.triggered
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGUSR1) == before


@pytest.mark.parametrize("online", [False, True])
def test_pad_batch_to_matches_the_jax_package(online):
    rng = np.random.default_rng(0)
    b = 3
    batch = {"gt_segments": rng.standard_normal((b, 2, 2)).astype(np.float32),
             "gt_labels": np.zeros((b, 2), np.int64), "gt_valid": np.ones((b, 2), bool),
             "has_gt": np.ones((b,), bool), "fps": np.full((b,), 25.0, np.float32),
             "duration": np.full((b,), 4.0, np.float32),
             "feat_stride": np.full((b,), 0.3, np.float32),
             "feat_num_frames": np.full((b,), 0.3, np.float32), "video_ids": ["a", "b", "c"]}
    if online:
        batch.update(streams=(rng.standard_normal((b, 20, 4)).astype(np.float32),
                              rng.standard_normal((b, 9, 2)).astype(np.float32)),
                     rows=(np.asarray([20, 7, 1], np.int32), np.asarray([9, 3, 2], np.int32)),
                     win_st=np.asarray([1, 0, 2], np.int32),
                     win_len=np.asarray([10, 16, 5], np.int32))
    else:
        batch.update(feats=rng.standard_normal((b, 16, 8)).astype(np.float32),
                     mask=np.ones((b, 16), bool))
    got, want = ttrain.pad_batch_to(dict(batch), 5), jpad_batch_to(dict(batch), 5)
    assert set(got) == set(want) and got["_real_rows"] == want["_real_rows"] == 3
    assert got["row_valid"].tolist() == [True] * 3 + [False] * 2
    for key, value in want.items():
        if key in ("streams", "rows"):
            assert all(a.dtype == w.dtype and np.array_equal(a, w)
                       for a, w in zip(got[key], value)), key
        elif key not in ("video_ids", "_real_rows"):
            assert got[key].dtype == np.asarray(value).dtype, key
            assert np.array_equal(got[key], value), key
    assert got["video_ids"] == ["a", "b", "c"]
    same = ttrain.pad_batch_to(batch, 3)
    assert same is batch and "row_valid" not in same


def test_device_prefetch_keeps_order_and_passes_metadata_through():
    src = [{"feats": np.full((2, 3), i, np.float32), "streams": (np.zeros((2, 1)), np.ones(2)),
            "video_ids": [str(i)], "_real_rows": i} for i in range(5)]
    pulled = []

    def gen():
        for item in src:
            pulled.append(item["_real_rows"])
            yield item

    out = []
    for item in device_prefetch(gen(), "cpu", depth=2):
        out.append(item)
        # two batches are in flight ahead of the one in hand
        assert len(pulled) == min(len(out) + 2, 5)
    assert [int(o["feats"][0, 0]) for o in out] == [0, 1, 2, 3, 4]
    assert all(isinstance(o["feats"], torch.Tensor) for o in out)
    assert isinstance(out[0]["streams"], tuple) and isinstance(out[0]["streams"][1], torch.Tensor)
    assert out[3]["video_ids"] == ["3"] and out[3]["_real_rows"] == 3
    assert list(device_prefetch(iter([]), "cpu")) == []


def test_meters_and_metrics_logger(tmp_path):
    m = ttrain.AverageMeter()
    m.update(2.0)
    m.update(4.0, n=3)
    assert (m.val, m.sum, m.count) == (4.0, 14.0, 4) and m.avg == pytest.approx(3.5)
    quiet = ttrain.MetricsLogger(None)
    quiet.log(1, {"a": 1.0})
    quiet.close()
    logger = ttrain.MetricsLogger(str(tmp_path / "m"))
    logger.log(7, {"train/final_loss": 0.5})
    logger.close()
    logger = ttrain.MetricsLogger(str(tmp_path / "m"))         # appends
    logger.log(8, {"train/final_loss": 0.25})
    logger.close()
    rows = [json.loads(s) for s in open(tmp_path / "m" / "metrics.jsonl")]
    assert [(r["step"], r["train/final_loss"]) for r in rows] == [(7, 0.5), (8, 0.25)]
    assert all("ts" in r for r in rows)


def test_init_model_takes_the_card_unless_the_cpu_is_asked_for():
    """Training runs on the card by default; without one the entry point
    raises instead of settling on the CPU."""
    cfg = ArchConfig(**ARCH)
    if torch.cuda.is_available():
        model, gen = ttrain.init_model(cfg, 0)
        assert next(model.parameters()).device.type == "cuda" and gen.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ttrain.init_model(cfg, 0)
    model, gen = ttrain.init_model(cfg, 0, device="cpu")
    assert next(model.parameters()).device.type == "cpu" and gen.device.type == "cpu"


def test_stage_hook_is_called_in_order_inside_every_step(batches):
    cfg, state, _ = make_state()
    seen = []
    step = ttrain.build_train_step(cfg, TRAIN_CFG, stage_hook=seen.append)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    assert seen == ["begin", "forward", "backward", "update"] * 2
    # the hook changes nothing: the same two steps without it
    _, plain, _ = make_state()
    step = ttrain.build_train_step(cfg, TRAIN_CFG)
    for batch in batches[:2]:
        plain, _ = step(plain, batch)
    assert_same_state(state, plain)


class _NotATensor:
    pass


def test_a_checkpoint_that_carries_an_object_is_refused(tmp_path):
    """Checkpoints are read with ``weights_only=True``: tensors in plain
    containers load, a pickled object does not."""
    cfg, state, _ = make_state()
    path = ttrain.save_checkpoint(str(tmp_path), 0, state)
    assert set(ttrain.restore_params(path)) == set(state.ema_params)
    ckpt = torch.load(path, weights_only=True)
    ckpt["extra"] = _NotATensor()
    bad = str(tmp_path / "bad.pt")
    torch.save(ckpt, bad)
    with pytest.raises(Exception, match="(?i)weights_only|unsupported|unpickl"):
        ttrain.restore_params(bad)

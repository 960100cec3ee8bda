"""PyTorch port, the tooling of the last slice against the JAX package on
the CPU: ``core/profiling.py`` (``StepTimer`` gives the JAX timer's
readings under the same clock; ``trace`` writes a Chrome trace holding the
``annotate`` spans), ``cli/warmup.py`` (the root ``warmup_cache.py``'s
forwards and steps on a tiny localizer, the host libraries built, the card
by default, the kernels' launch counters by name) and
``ops/resample.py::linear_resample_matrix`` (the JAX matrix exactly; as a
product it is ``linear_resample_time``)."""

import glob
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audio_visual_deepfake_detection_tpu.core import profiling as jprof
from audio_visual_deepfake_detection_tpu.ops import resample as jres
from audio_visual_deepfake_detection_tpu_torch.cli import warmup
from audio_visual_deepfake_detection_tpu_torch.core import profiling as tprof
from audio_visual_deepfake_detection_tpu_torch.ops import resample as tres
from audio_visual_deepfake_detection_tpu_torch.runtime import native
from audio_visual_deepfake_detection_tpu_torch.tools import synth_cache

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_infer_cli import TINY  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- profiling

def clock(monkeypatch):
    """``time.perf_counter`` replaced by irregular seeded ticks."""
    ticks = iter(np.cumsum(np.random.default_rng(0).uniform(0.01, 0.5, 64)).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


@pytest.mark.parametrize("sync_every", [1, 3, 20])
def test_step_timer_equals_jax(monkeypatch, sync_every):
    """25 steps, a value to synchronize on every other step (tensors,
    dicts, lists, none): the same readings and total as the JAX timer."""
    values = [None, torch.ones(2), {"a": [torch.zeros(1)]}, (torch.ones(1), 3)]
    runs = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        clock(monkeypatch)
        timer = mod.StepTimer(sync_every=sync_every)
        out = []
        for i in range(25):
            v = values[i % len(values)]
            if name == "jax" and v is not None:
                v = jnp.ones(2)
            out.append(timer.step(v))
        runs[name] = (out, timer.total, timer.count)
    assert runs["port"] == runs["jax"]
    assert sum(r is not None for r in runs["port"][0]) == 25 // sync_every


def test_step_timer_synchronizes_only_card_tensors(monkeypatch):
    """CPU tensors need no synchronization: none is asked for."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    timer = tprof.StepTimer(sync_every=1)
    for v in (torch.ones(3), {"x": torch.ones(1)}, [torch.ones(1)], None):
        assert timer.step(v) is not None
    assert calls == []


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("localizer"):
            y = x @ x
        with tprof.annotate("decode"):
            y.relu_()
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"localizer", "decode"} <= names
    assert any(e.key == "localizer" for e in prof.key_averages())


# ---------------------------------------------------------------- warmup

def test_launch_counters_by_kernel_name(monkeypatch):
    """``ops.kernels.launch_counts`` reads every wrapper's counter under its
    kernel's name (K1 and K6 apart in one module); ``reset_launches`` zeroes
    them all."""
    from audio_visual_deepfake_detection_tpu_torch.ops import kernels
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block, full_attention

    monkeypatch.setattr(fused_block, "LAUNCHES", 18)
    monkeypatch.setattr(fused_block, "TRAIN_LAUNCHES", 36)
    monkeypatch.setattr(full_attention, "LAUNCHES", 12)
    counts = kernels.launch_counts()
    assert tuple(counts) == kernels.KERNELS
    assert counts["fused_transformer_block"] == 18 and counts["full_mha"] == 12
    assert counts["fused_transformer_block_train"] == 36
    assert warmup.launches() == {"fused_transformer_block": 18, "full_mha": 12,
                                 "fused_transformer_block_train": 36}
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0} and warmup.launches() == {}


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    with open(os.path.join(REPO, "configs_test", "deepfake_exp12_test.yaml")) as f:
        tree = yaml.safe_load(f)
    synth_cache.merge(tree, TINY)
    path = str(tmp_path_factory.mktemp("warmup") / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return path


def test_warmup_runs_the_programs_on_the_cpu(tiny_config, capsys):
    summary = warmup.main([tiny_config, "--infer-batch", "2", "--train-batch", "2",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert "inference B=2 ready in" in out and "train B=2 ready in" in out
    assert "kernel library" not in out            # no nvcc on the CPU route
    assert set(summary["infer"]) == set(summary["train"]) == {2}
    assert np.isfinite(summary["train"][2]["final_loss"])
    assert summary["infer"][2]["launches"] == summary["train"][2]["launches"] == {}
    for name, mod in warmup.HOST_LIBRARIES.items():
        rec = summary["host"][name]
        assert f"host library {name}" in out
        if rec["state"] == "unavailable":
            assert name == "media" and rec["reason"]
            continue
        assert rec["state"] in ("found", "built") and os.path.exists(rec["path"])
        assert rec["path"] == str(native.library_path(native.CSRC / f"{name}.cpp", mod.FLAGS,
                                                      getattr(mod, "LINK_FLAGS", ())))


def test_warmup_defaults_to_the_card(tiny_config):
    assert not torch.cuda.is_available()
    args = warmup.build_parser().parse_args([tiny_config])
    assert args.device == "cuda" and args.infer_batch == [64, 512] and args.train_batch == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warmup.run(args)


# ---------------------------------------------------------------- resample

SIZES = [(10, 768), (768, 240), (7, 7), (1, 5), (479, 768), (2000, 768)]


@pytest.mark.parametrize("in_len,out_len", SIZES, ids=[f"{a}to{b}" for a, b in SIZES])
def test_linear_resample_matrix_equals_jax(in_len, out_len):
    got = tres.linear_resample_matrix(in_len, out_len)
    want = np.asarray(jres.linear_resample_matrix(in_len, out_len))
    assert got.dtype == torch.float32 and got.shape == (in_len, out_len)
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.from_numpy(np.random.default_rng(in_len).standard_normal(
        (2, in_len, 6)).astype(np.float32))
    prod = torch.einsum("btc,to->boc", x, got)
    torch.testing.assert_close(prod, tres.linear_resample_time(x, out_len), atol=1e-6, rtol=0)
    got[0, 0] = 5.0                                  # a copy: the cache stays as it was
    assert tres.linear_resample_matrix(in_len, out_len)[0, 0] != 5.0

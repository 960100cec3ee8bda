"""PyTorch port, the offline sweep and its entry points on the CPU against the
JAX package: the inference CLI (``cli/inference.py`` with ``--device cpu``)
over a synthetic shard against the JAX package's ``inference_one_epoch`` on
the same weights (carried across by ``tools/convert_jax.py``; scores 1e-4,
segments 1e-3, logit 2e-4); the flush files of ``inference_one_epoch``
(names and contents, exact, with a fixed model output); preemption and
``--resume`` covering every video once with the uninterrupted run's
detections; the device-resample route; the resume helpers, the collators
and ``submit_streams`` against the JAX service; the validate and
generate_results CLIs; and the entry points' default device, the card."""

import json
import os
import pickle

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.core import config as jconfig
from audio_visual_deepfake_detection_tpu.data import dataset as jds
from audio_visual_deepfake_detection_tpu.data import loader as jloader
from audio_visual_deepfake_detection_tpu.eval import challenge as jch
from audio_visual_deepfake_detection_tpu.infer import resume as jresume
from audio_visual_deepfake_detection_tpu.infer import runner as jrunner
from audio_visual_deepfake_detection_tpu.infer.service import LocalizerService as JService
from audio_visual_deepfake_detection_tpu.parallel import pad_batch_to as j_pad_batch_to
from audio_visual_deepfake_detection_tpu.train.state import init_model as j_init_model
from audio_visual_deepfake_detection_tpu_torch.cli import generate_results as gen_cli
from audio_visual_deepfake_detection_tpu_torch.cli import inference as infer_cli
from audio_visual_deepfake_detection_tpu_torch.cli import validate as validate_cli
from audio_visual_deepfake_detection_tpu_torch.core import config as tconfig
from audio_visual_deepfake_detection_tpu_torch.infer import resume as tresume
from audio_visual_deepfake_detection_tpu_torch.infer import runner as trunner
from audio_visual_deepfake_detection_tpu_torch.infer.service import LocalizerService
from audio_visual_deepfake_detection_tpu_torch.models import build_localizer
from audio_visual_deepfake_detection_tpu_torch.tools import synth_cache
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import state_dict_from_flax
from audio_visual_deepfake_detection_tpu_torch.train.loop import pad_batch_to
from audio_visual_deepfake_detection_tpu_torch.train.preempt import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_YAML = os.path.join(REPO, "configs_test", "deepfake_exp12_test.yaml")
N_VIDEOS = 9            # + one of 30 s: 10 videos, 3 batches of 4
TINY = {
    "dataset": {"video_input_dim": 8, "audio_input_dim": 16, "max_seq_len": 96},
    "model": {"backbone_arch": [1, 1, 2], "n_mha_win_size": [5, 5, -1],
              "regression_range": [[0, 4], [4, 8], [8, 10000]], "n_head": 2,
              "embd_dim": 32, "fpn_dim": 32, "head_dim": 32},
    "test_cfg": {"min_score": 0.001, "max_seg_num": 20},
    "loader": {"num_workers": 2},
}
TOL = dict(scores=1e-4, segments=1e-3, video_cls=2e-4)


def _perturb(tree, rng):
    """O(1) layer scales and LN affines, so every attention path matters."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k.startswith("drop_path"):
            v["scale"] = rng.standard_normal(v["scale"].shape).astype(np.float32)
        elif k in ("ln1", "ln2", "lnq", "lnk", "lnv", "query_norm", "key_norm", "value_norm"):
            v["weight"] = (1 + 0.5 * rng.standard_normal(v["weight"].shape)).astype(np.float32)
            v["bias"] = (0.3 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        else:
            _perturb(v, rng)
    return tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cache, its config, the JAX weights and the port checkpoint whose
    EMA weights are those (its raw weights are another seed's), and the JAX
    package's sweep of shard 1 at batch 4, flushing every 4 videos."""
    root = tmp_path_factory.mktemp("sweep")
    cache = synth_cache.write_feature_cache(str(root), N_VIDEOS, seed=3, dims=(8, 12, 4),
                                            extra_durations=(30.0,), n_labelled=8)
    cfg_path = synth_cache.write_config(BASE_YAML, str(root / "config.yaml"), cache,
                                        str(root / "runs"), TINY)
    jcfg_all = jconfig.load_config(cfg_path)
    jcfg = jconfig.arch_config_from(jcfg_all)
    config = tconfig.load_config(cfg_path)
    cfg = tconfig.arch_config_from(config)
    assert cfg.input_dim == jcfg.input_dim == 24

    params, _ = j_init_model(jcfg, 1, 0)
    p = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"])),
                 np.random.default_rng(3))
    raw = build_localizer(cfg, seed=5, device="cpu")
    ckpt = synth_cache.write_checkpoint(str(root / "ckpt"), raw, config,
                                        ema_state=state_dict_from_flax(p))

    jdataset = jds.DeepfakeInferenceDataset(jcfg_all["dataset_name"], ["test"], 1,
                                            dict(jcfg_all["dataset"]))
    loader = jloader.DataLoader(jdataset, 4, lambda s: jrunner.collate_infer_varlen(
        s, jcfg.max_div_factor, jcfg.max_seq_len), num_workers=2)
    jout = str(root / "jax_out")
    jrunner.inference_one_epoch(
        (j_pad_batch_to(b, 4) for b in loader),
        jrunner.build_inference_fn(jcfg, jconfig.test_config_from(jcfg_all)), {"params": p},
        output_folder=jout, flush_every=4, print_freq=100, prefetch_depth=0,
        collect_items=False)
    return dict(root=root, cache=cache, cfg_path=cfg_path, config=config, cfg=cfg,
                jcfg=jcfg, jconfig=jcfg_all, params=p, ckpt=ckpt, jax_out=jout)


def _cli(setup, *extra, out="runs"):
    """The inference CLI on the CPU over shard 1 at batch 4, output under
    ``<root>/<out>``."""
    cfg_path = setup["cfg_path"]
    if out != "runs":
        cfg_path = synth_cache.write_config(BASE_YAML, str(setup["root"] / f"{out}.yaml"),
                                            setup["cache"], str(setup["root"] / out), TINY)
    return [cfg_path, "1", "--ckpt", os.path.dirname(setup["ckpt"]), "--device", "cpu",
            "--batch-size", "4", "--flush-every", "4", *extra]


def _flushes(folder):
    return {os.path.basename(p): json.load(open(p)) for p in tresume.flush_files(folder)}


def _items(folder):
    return [it for items in _flushes(folder).values() for it in items]


def assert_items_close(got, want, tol=TOL):
    assert [g["video_id"] for g in got] == [w["video_id"] for w in want]
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]) > 0, g["video_id"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=tol["scores"], rtol=0)
        np.testing.assert_allclose(g["segments"], w["segments"], atol=tol["segments"], rtol=0)
        np.testing.assert_allclose(g["video_cls"], w["video_cls"], atol=tol["video_cls"], rtol=0)


@pytest.fixture(scope="module")
def cli_run(setup):
    summary = infer_cli.main(_cli(setup))
    return summary, _flushes(summary["out_folder"])


def test_inference_cli_matches_jax_inference_one_epoch(setup, cli_run):
    summary, flushes = cli_run
    want = _flushes(setup["jax_out"])
    assert list(flushes) == list(want) == ["data_left4.json", "data_left8.json",
                                           "data_left.json"]
    for name in want:
        assert_items_close(flushes[name], want[name])
    assert summary["videos"] == N_VIDEOS + 1 and not summary["preempted"]
    stats = summary["stats"]
    assert stats["batches"] == 3 and stats["videos"] == N_VIDEOS + 1
    assert all(stats[k] >= 0 for k in ("wait_s", "infer_ms", "fetch_s", "flush_s"))


class StopAfter(PreemptionGuard):
    """A preemption request at the ``n``-th poll (one poll a batch)."""

    def __init__(self, n):
        super().__init__(signals=())
        self.n, self.polls = n, 0

    def requested(self):
        self.polls += 1
        return self.polls >= self.n


def test_preemption_and_resume_cover_every_video_once(setup, cli_run):
    """Stopped after the first of 3 batches (the preemption flushes the
    pending 4 videos as a numbered file), then --resume (its 6 videos end in
    the final flush): every video once, each with the uninterrupted run's
    detections; a third run renumbers the final flush and does nothing."""
    args = _cli(setup, "--flush-every", "7", out="preempt")
    first = infer_cli.run(infer_cli.build_parser().parse_args(args), preempt=StopAfter(1))
    assert first["preempted"] and first["videos"] == 4
    assert list(_flushes(first["out_folder"])) == ["data_left4.json"]
    second = infer_cli.main(args + ["--resume"])
    assert not second["preempted"] and second["done_before"] == 4 and second["videos"] == 6
    assert list(_flushes(first["out_folder"])) == ["data_left4.json", "data_left.json"]
    items = _items(first["out_folder"])
    ids = [it["video_id"] for it in items]
    assert sorted(ids) == sorted(set(ids)) and len(ids) == N_VIDEOS + 1
    full = {it["video_id"]: it for flush in cli_run[1].values() for it in flush}
    for it in items:
        assert it == full[it["video_id"]]
    third = infer_cli.main(args + ["--resume"])
    assert third["videos"] == 0 and third["done_before"] == N_VIDEOS + 1
    assert list(_flushes(first["out_folder"])) == ["data_left4.json", "data_left_part0.json"]


def test_device_resample_route_matches_host_route(setup, cli_run):
    summary = infer_cli.main(_cli(setup, "--device-resample", "--stream-caps", "760,380,1500",
                                  out="online"))
    flushes = _flushes(summary["out_folder"])
    assert list(flushes) == list(cli_run[1])
    for name in flushes:
        assert_items_close(flushes[name], cli_run[1][name])
    with pytest.raises(ValueError, match="--stream-caps needs 3"):
        infer_cli.main(_cli(setup, "--device-resample", "--stream-caps", "760,380",
                            out="online2"))


def test_generate_results_cli(setup, cli_run):
    n_txt, n_json = gen_cli.main([str(setup["root"] / "runs"), "--num-shards", "1"])
    assert n_txt == n_json == N_VIDEOS + 1
    lines = (setup["root"] / "runs" / "prediction.txt").read_text().splitlines()
    assert len(lines) == N_VIDEOS + 1 and lines == sorted(lines)
    assert len(json.loads((setup["root"] / "runs" / "prediction.json").read_text())) == \
        N_VIDEOS + 1


class FixedModel(torch.nn.Module):
    """Stands in for the localizer: fixed detections per batch row."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


def _fixed_infer(model_or_params, feats, *rest):
    b = feats.shape[0]
    k = np.arange(5, dtype=np.float32)
    segs = np.stack([np.stack([k + i, k + i + 1.5], -1) for i in range(b)]).astype(np.float32)
    scores = np.tile(np.linspace(0.9, 0.1, 5, dtype=np.float32), (b, 1)) - 0.01 * np.arange(b)[:, None]
    valid = np.arange(5)[None, :] < (np.arange(b)[:, None] % 5)
    cls = np.zeros((b, 5), np.int32)
    vcls = np.linspace(-2, 2, b, dtype=np.float32)[:, None]
    return segs, scores, cls, valid, vcls


@pytest.mark.parametrize("flush_every,preempt_at,offset", [(4, None, 0), (3, 2, 0), (5, None, 7),
                                                            (100, 3, 2)])
def test_flush_files_match_jax(tmp_path, flush_every, preempt_at, offset):
    """Same model outputs -> the same flush names and contents, byte for
    byte: numbered flushes, the final flush, the preemption flush,
    ``seen_offset``, a padded last batch keeping only its real rows."""
    def batches(pad):
        for i in range(4):
            n = 3 if i == 3 else 4
            b = {"feats": np.zeros((n, 8, 2), np.float32), "mask": np.ones((n, 8), bool),
                 **{k: np.ones(n, np.float32) for k in ("fps", "duration", "feat_stride",
                                                       "feat_num_frames")},
                 "video_ids": [f"v{i}_{j}" for j in range(n)]}
            yield pad(b, 4)

    outs = []
    for tag, run, pad, model in (("ours", trunner.inference_one_epoch, pad_batch_to, FixedModel()),
                                 ("ref", jrunner.inference_one_epoch, j_pad_batch_to, None)):
        guard = StopAfter(preempt_at) if preempt_at else None
        kw = dict(prefetch_depth=0) if tag == "ref" else {}
        table, items = run(batches(pad), _fixed_infer, model, output_folder=str(tmp_path / tag),
                           flush_every=flush_every, seen_offset=offset, preempt=guard, **kw)
        names = [os.path.basename(p) for p in tresume.flush_files(str(tmp_path / tag))]
        outs.append((names, [open(p, "rb").read() for p in
                             tresume.flush_files(str(tmp_path / tag))], items))
        if preempt_at:
            assert guard.triggered
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1] and outs[0][2] == outs[1][2]
    assert sum(len(json.loads(b)) for b in outs[0][1]) == (15 if not preempt_at else
                                                          4 * preempt_at)


def test_resume_helpers_match_jax(tmp_path):
    data = [{"id": f"v{i}.mp4", "duration": 4.0 + i} for i in range(11)]
    for tag in ("ours", "ref"):
        d = tmp_path / tag
        d.mkdir()
        for name, ids in (("data_left5000.json", [0, 1]), ("data_left10000.json", [2]),
                          ("data_left_part0.json", [4]), ("data_left.json", [5, 6])):
            (d / name).write_text(json.dumps([{"video_id": f"v{i}.mp4"} for i in ids]))
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert [os.path.basename(p) for p in tresume.flush_files(ours)] == \
        [os.path.basename(p) for p in jresume.flush_files(ref)] == \
        ["data_left5000.json", "data_left10000.json", "data_left_part0.json", "data_left.json"]
    for rank, nprocs, resume in ((0, 1, False), (1, 3, False), (2, 3, True), (0, 1, True)):
        got = tresume.plan_host_share(data, rank, nprocs, ours, resume)
        want = jresume.plan_host_share(data, rank, nprocs, ref, resume)
        assert got == want
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    assert "data_left_part1.json" in os.listdir(ours) and "data_left.json" not in os.listdir(ours)
    tresume.atomic_write_json(os.path.join(ours, "x.json"), [{"a": "é"}])
    jresume.atomic_write_json(os.path.join(ref, "x.json"), [{"a": "é"}])
    assert open(os.path.join(ours, "x.json"), "rb").read() == \
        open(os.path.join(ref, "x.json"), "rb").read()


def test_collators_match_jax():
    rng = np.random.default_rng(0)
    samples = [{"video_id": f"v{i}", "feats": rng.standard_normal((n, 6)).astype(np.float32),
                "fps": 25.0, "duration": n / 25.0, "feat_stride": 1.0, "feat_num_frames": 1.0}
               for i, n in enumerate((40, 97, 12))]
    for dtype, np_dtype in ((torch.float32, np.float32),
                            (torch.bfloat16, np.dtype(ml_dtypes.bfloat16))):
        got = trunner.collate_infer_varlen(samples, 32, 64, dtype)
        want = jrunner.collate_infer_varlen(samples, 32, 64, np_dtype)
        assert set(got) == set(want) and got["feats"].dtype == dtype
        assert got["feats"].shape == want["feats"].shape == (3, 128, 6)
        assert np.array_equal(got["feats"].float().numpy(), want["feats"].astype(np.float32))
        for k in ("mask", "fps", "duration", "feat_stride", "feat_num_frames", "video_ids"):
            assert np.array_equal(got[k], want[k]), k
    batch = trunner.collate_infer_varlen([dict(s, feats=s["feats"][:12]) for s in samples],
                                         4, 12, torch.bfloat16)
    padded = pad_batch_to(batch, 5)
    ref = j_pad_batch_to(jrunner.collate_infer_varlen(
        [dict(s, feats=s["feats"][:12]) for s in samples], 4, 12,
        np.dtype(ml_dtypes.bfloat16)), 5)
    assert padded["feats"].dtype == torch.bfloat16 and padded["feats"].shape == (5, 12, 6)
    assert np.array_equal(padded["feats"].float().numpy(), ref["feats"].astype(np.float32))
    for k in ("mask", "fps", "duration", "row_valid", "_real_rows", "video_ids"):
        assert np.array_equal(padded[k], ref[k]), k
    streams = infer_cli.collate_streams_batch(
        [{"video_id": "a", "duration": 2.0, "streams": [np.ones((3, 2), np.float32)]}], [5],
        torch.bfloat16)
    assert streams["streams"][0].dtype == torch.bfloat16 and streams["rows"][0].tolist() == [3]


def test_submit_streams_matches_jax_service(setup):
    """Raw streams at their native rates through both services: the port's
    native host resample and stride arithmetic against the JAX one's."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    tcfg = tconfig.test_config_from(setup["config"])
    jtcfg = jconfig.test_config_from(setup["jconfig"])
    rng = np.random.default_rng(4)
    videos = []
    for dur in (4.2, 9.6, 13.0):
        rows = (int(25 * dur), int(12.497 * dur - 0.3657), int(50 * dur - 0.817))
        videos.append(([rng.standard_normal((r, c)).astype(np.float32)
                        for r, c in zip(rows, (8, 12, 4))], dur))
    model = build_localizer(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(setup["params"]), strict=True)
    ours = LocalizerService(cfg, tcfg, model, batch_size=2, max_wait_ms=20,
                            ds_feat_stride=1.0, ds_num_frames=1.0)
    ref = JService(jcfg, jtcfg, {"params": setup["params"]}, batch_size=2, max_wait_ms=20,
                   ds_feat_stride=1.0, ds_num_frames=1.0)
    try:
        got = [ours.submit_streams(s, d) for s, d in videos]
        want = [ref.submit_streams(s, d) for s, d in videos]
        got, want = [f.result(timeout=300) for f in got], [f.result(timeout=300) for f in want]
        assert ours.localize_streams(*videos[0]).video_cls == got[0].video_cls
    finally:
        assert ours.stop(timeout=60) and ref.stop(timeout=60)
    for g, w in zip(got, want):
        assert len(g.scores) == len(w.scores) > 0
        np.testing.assert_allclose(g.scores, w.scores, atol=TOL["scores"], rtol=0)
        np.testing.assert_allclose(g.segments, w.segments, atol=TOL["segments"], rtol=0)
        assert abs(g.video_cls - w.video_cls) <= TOL["video_cls"]


def test_validate_cli_matches_jax(setup, tmp_path):
    """The labelled split through the validate CLI on the CPU: its prediction
    table against the JAX package's sweep of the same split, the mAP of the
    JAX evaluator on the port's table, --saveonly and --no-ema."""
    args = [setup["cfg_path"], "--ckpt", setup["ckpt"], "--device", "cpu", "--batch-size", "4"]
    out = validate_cli.main(args + ["--output", str(tmp_path / "ev.json")])
    jc = setup["jconfig"]
    jdataset = jds.DeepfakeDataset(jc["dataset_name"], False, jc["val_split"], jc["dataset"])
    loader = jloader.DataLoader(jdataset, 4, lambda s: jrunner.collate_infer_varlen(
        s, setup["jcfg"].max_div_factor, setup["jcfg"].max_seq_len), num_workers=2)
    _, jitems = jrunner.inference_one_epoch(
        (j_pad_batch_to(b, 4) for b in loader),
        jrunner.build_inference_fn(setup["jcfg"], jconfig.test_config_from(jc)),
        {"params": setup["params"]}, prefetch_depth=0)
    table = out["results"]
    ref = jrunner.items_to_table(jitems)
    assert list(table["video-id"]) == list(ref["video-id"]) and len(table["score"]) > 0
    np.testing.assert_allclose(table["score"], ref["score"], atol=TOL["scores"], rtol=0)
    np.testing.assert_allclose(table["t-start"], ref["t-start"], atol=TOL["segments"], rtol=0)
    assert len(out["gt_records"]) == 8 and sum(r["n_fakes"] for r in out["gt_records"]) > 0
    want, _ = jch.run_evaluation(table, out["gt_records"], str(tmp_path / "jev.json"),
                                 verbose=False)
    assert out["mAP"] == want and np.isfinite(out["mAP"])
    assert out["summary"].startswith("Detection: average-mAP") and \
        out["summary"].count("mAP@") == 4
    saved = validate_cli.main(args + ["--saveonly", "--output", str(tmp_path / "r.pkl")])
    assert saved["mAP"] is None
    with open(tmp_path / "r.pkl", "rb") as f:
        pickled = pickle.load(f)
    assert all(np.array_equal(pickled[k], table[k]) for k in table)
    raw = validate_cli.main(args + ["--no-ema", "--output", str(tmp_path / "raw.json")])
    assert not np.array_equal(raw["results"]["score"][:5], table["score"][:5])


@pytest.mark.parametrize("cli", [infer_cli, validate_cli])
def test_entry_points_default_to_the_card(setup, cli):
    """No --device: the card. On a machine without one the CLI raises and
    runs nothing on the CPU."""
    args = [setup["cfg_path"], "1", "--ckpt", setup["ckpt"]]
    if cli is validate_cli:
        args.remove("1")
    assert cli.build_parser().parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)


def test_checkpoint_resolution(setup, tmp_path):
    folder = os.path.dirname(setup["ckpt"])
    assert infer_cli.resolve_checkpoint(folder) == setup["ckpt"]
    assert infer_cli.resolve_checkpoint(folder, 7).endswith("epoch_007.pt")
    assert infer_cli.resolve_checkpoint(setup["ckpt"]) == setup["ckpt"]
    with pytest.raises(FileNotFoundError):
        infer_cli.resolve_checkpoint(str(tmp_path))

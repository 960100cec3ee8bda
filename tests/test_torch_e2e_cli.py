"""PyTorch port, the media entry points on the CPU against the root scripts:
``cli/extract_features.py`` against ``extract_features.py`` and
``cli/end_to_end.py`` against ``end_to_end.py``, each given the other's
argument list (the port's parser parses it for both, so the flags are the
same) and the same small models of ``tests/test_torch_e2e_media.py`` in
place of the production widths, over cv2-written mp4s, their wavs, a
corrupt mp4 and a metadata tree. The caches agree at the encoders'
tolerances, the skip-existing rule, ``extract_errors.txt`` and the log
lines are the same; the submissions cover the same videos with the same
probabilities and the same mAP; ``--resume`` and a preempted run resumed
give the unbroken run's files; ``--video-encoder c3d`` and
``--video-chunk-bucketing`` run and write their files; and both entry
points run on the card unless asked for the CPU."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from audio_visual_deepfake_detection_tpu.core import runtime as jruntime
from audio_visual_deepfake_detection_tpu_torch.cli import end_to_end as e2e_cli
from audio_visual_deepfake_detection_tpu_torch.cli import extract_features as extract_cli
from audio_visual_deepfake_detection_tpu_torch.core import config as tconfig
from audio_visual_deepfake_detection_tpu_torch.frontends import mvit as tmvit
from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline as tfront
from audio_visual_deepfake_detection_tpu_torch.frontends.mvit import (MViTVideoEncoder,
                                                                      generate_config)
from audio_visual_deepfake_detection_tpu_torch.frontends.pipeline import CACHE_DIR_NAMES
from audio_visual_deepfake_detection_tpu_torch.frontends.video import C3DVideoEncoder
from audio_visual_deepfake_detection_tpu_torch.models import build_localizer
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import state_dict_from_flax
from audio_visual_deepfake_detection_tpu_torch.tools.synth_cache import merge
from audio_visual_deepfake_detection_tpu_torch.train.checkpoint import save_weights

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_e2e_media import (ARCH, BYOLA_D, CHUNK, FEAT_TOL, StopAfter,  # noqa: E402
                                  VIDEO_D, models)
from test_torch_emotion2vec import SMALL  # noqa: E402
from test_torch_media import smooth_frames, write_mp4  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_YAML = os.path.join(REPO, "configs_test", "deepfake_exp12_test.yaml")
CLIPS = {"s1/c1/00001/real": (1.2, []),
         "s1/c1/00002/fake_video_fake_audio": (1.6, [[0.2, 0.9]]),
         "s2/c1/00001/real_video_fake_audio": (1.04, [[0.4, 0.8]])}
assert models                                       # the fixture, imported for its name


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A metadata tree, its mp4s (128x128, cv2 ``mp4v``) and 16-bit wavs, a
    list file with a corrupt mp4 third, and a small config."""
    root = tmp_path_factory.mktemp("e2e_cli")
    rng = np.random.default_rng(31)
    for rel, (dur, fakes) in CLIPS.items():
        for sub, ext in (("metadata", ".json"), ("data", ".mp4"), ("wav", ".wav")):
            os.makedirs(os.path.dirname(root / sub / (rel + ext)), exist_ok=True)
        (root / "metadata" / (rel + ".json")).write_text(json.dumps(
            {"audio_frames": int(round(dur * 16000)), "video_frames": int(round(dur * 25)),
             "fake_segments": fakes, "split": "test"}))
        write_mp4(str(root / "data" / (rel + ".mp4")),
                  smooth_frames(rng, int(round(dur * 25)), 128, 128))
        wavfile.write(str(root / "wav" / (rel + ".wav")), 16000,
                      (rng.standard_normal(int(round(dur * 16000))) * 3000).astype(np.int16))
    (root / "data" / "s3").mkdir()
    (root / "data" / "s3" / "broken.mp4").write_bytes(b"\x00\x01 not a container" * 20)
    rels = [rel + ".mp4" for rel in CLIPS]
    rels.insert(2, "s3/broken.mp4")
    (root / "list.txt").write_text("\n".join(rels) + "\n")
    with open(BASE_YAML) as f:
        config = yaml.safe_load(f)
    merge(config, {
        "dataset": {"video_input_dim": VIDEO_D, "max_seq_len": ARCH["max_seq_len"],
                    "audio_input_dim": BYOLA_D + SMALL["embed_dim"]},
        "model": {"backbone_arch": list(ARCH["arch"]),
                  "n_mha_win_size": list(ARCH["mha_win_size"]),
                  "regression_range": [list(r) for r in ARCH["regression_range"]],
                  "n_head": ARCH["n_head"], "embd_dim": 32, "fpn_dim": 32, "head_dim": 32},
        "test_cfg": {"min_score": 0.001, "max_seg_num": 10},
        "tpu": {"compute_dtype": "float32"},
    })
    with open(root / "config.yaml", "w") as f:
        yaml.safe_dump(config, f)
    assert tconfig.arch_config_from(tconfig.load_config(str(root / "config.yaml"))).input_dim \
        == ARCH["input_dim"]
    return root


def root_script(name):
    """The root script ``name``.py as a module, without its JAX cache set-up
    (the test process keeps its own)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "setup_jax", lambda *a, **kw: None)
        spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                      os.path.join(REPO, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(monkeypatch, models):
    """Both packages' entry points build the small models; each records the
    arguments it was asked for."""
    asked = {"port": [], "root": []}

    def port_build(video_encoder, video_chunk, seed, dtype, device, chunk_buckets=None):
        assert chunk_buckets is None
        asked["port"].append((video_encoder, video_chunk, seed, dtype, device.type))
        return models["tex"]

    def root_build(**kw):
        asked["root"].append((kw["video_chunk"], kw["seed"], str(kw["compute_dtype"])))
        return models["jex"]

    monkeypatch.setattr(extract_cli, "build_extractor", port_build)
    monkeypatch.setattr(e2e_cli, "build_extractor", port_build)
    roots = {name: root_script(name) for name in ("extract_features", "end_to_end")}
    for mod in roots.values():
        monkeypatch.setattr(mod, "FeatureExtractor", root_build)
    monkeypatch.setattr(roots["end_to_end"], "restore_params", lambda path: models["params"])
    return roots, asked


def cache_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_extract_features_matches_the_root_script(tree, small, tmp_path):
    roots, asked = small
    parser = extract_cli.build_parser()
    logs = {}
    for step, extra in (("first", []), ("again", []), ("redo", ["--no-skip-existing"])):
        outs = {}
        for who in ("port", "root"):
            argv = [str(tree / "list.txt"), "--video-root", str(tree / "data"),
                    "--wav-root", str(tree / "wav"), "--output-root", str(tmp_path / who),
                    "--video-chunk", str(CHUNK), "--seed", "3", "--device", "cpu", *extra]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if who == "port":
                    extract_cli.main(argv)
                else:
                    roots["extract_features"].main(parser.parse_args(argv))
            outs[who] = buf.getvalue()
        assert outs["port"] == outs["root"], step
        logs[step] = outs["port"].splitlines()
    assert logs["first"] == ["0/4 done (0 errors, 0 skipped)", "done: 3 ok, 0 skipped, 1 errors"]
    assert logs["again"][-1] == "done: 0 ok, 3 skipped, 1 errors"
    assert logs["redo"][-1] == "done: 3 ok, 0 skipped, 1 errors"
    assert asked["port"] == [("mvit_v2_b", CHUNK, 3, "float32", "cpu")] * 3
    assert asked["root"] == [(CHUNK, 3, "float32")] * 3
    files = cache_files(tmp_path / "port")
    assert files == cache_files(tmp_path / "root") and not any(f.endswith(".tmp") for f in files)
    assert len(files) == 3 * 3 + 1
    errors = (tmp_path / "port" / "extract_errors.txt").read_text()
    assert errors == (tmp_path / "root" / "extract_errors.txt").read_text()
    assert errors.count("s3/broken.mp4\t") == 3
    for f in files:
        if f.endswith(".npy"):
            key = {v: k for k, v in CACHE_DIR_NAMES.items()}[f.split(os.sep)[0]]
            np.testing.assert_allclose(np.load(tmp_path / "port" / f),
                                       np.load(tmp_path / "root" / f), **FEAT_TOL[key])


@pytest.fixture(scope="module")
def ckpt(tree, models):
    """A port checkpoint whose EMA weights are the JAX weights."""
    config = tconfig.load_config(str(tree / "config.yaml"))
    raw = build_localizer(tconfig.arch_config_from(config), seed=5, device="cpu")
    return save_weights(str(tree / "ckpt"), raw, config,
                        ema_state=state_dict_from_flax(models["params"]["params"]))


def e2e_args(tree, out, *extra):
    return [str(tree / "config.yaml"), "--metadata-root", str(tree / "metadata"),
            "--data-root", str(tree / "data"), "--wav-root", str(tree / "wav"),
            "--output", str(out), "--ckpt", str(tree / "ckpt"), "--batch-size", "2",
            "--video-chunk", str(CHUNK), "--device", "cpu", *extra]


def read_txt(path):
    return dict(line.split(";") for line in open(path).read().splitlines())


def test_end_to_end_matches_the_root_script(tree, small, ckpt, tmp_path):
    roots, asked = small
    assert os.path.dirname(ckpt) == str(tree / "ckpt")      # --ckpt names the run folder
    parser = e2e_cli.build_parser()
    outs = {}
    for who in ("port", "root"):
        argv = e2e_args(tree, tmp_path / who)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if who == "port":
                e2e_cli.main(argv)
            else:
                roots["end_to_end"].main(parser.parse_args(argv))
        outs[who] = buf.getvalue()
    assert outs["port"].splitlines()[0] == outs["root"].splitlines()[0] == "3 videos discovered"
    assert asked["port"] == [("mvit_v2_b", CHUNK, 0, "float32", "cpu")]
    assert asked["root"] == [(CHUNK, 0, "float32")]
    port, root = (json.load(open(tmp_path / who / "e2e_summary.json"))
                  for who in ("port", "root"))
    assert set(root) <= set(port) and port["num_videos"] == root["num_videos"] == 3
    assert port["average_mAP"] == pytest.approx(root["average_mAP"], abs=1e-6)
    assert port["decoded_by"]["audio"] == {"wav": 3}
    t_txt, r_txt = (read_txt(tmp_path / who / "prediction.txt") for who in ("port", "root"))
    assert sorted(t_txt) == sorted(r_txt) == sorted(rel + ".mp4" for rel in CLIPS)
    for vid in t_txt:
        assert float(t_txt[vid]) == pytest.approx(float(r_txt[vid]), abs=1e-4)
    t_json, r_json = (json.load(open(tmp_path / who / "prediction.json"))
                      for who in ("port", "root"))
    assert sorted(t_json) == sorted(r_json)
    for vid in t_json:
        np.testing.assert_allclose(t_json[vid], r_json[vid], atol=1e-3)

    # --resume over a finished sweep redoes nothing and writes the same files
    before = {f: (tmp_path / "port" / f).read_bytes() for f in ("prediction.txt",
                                                                "prediction.json")}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = e2e_cli.main(e2e_args(tree, tmp_path / "port", "--resume"))
    assert "Resume: 3 videos already flushed, 0 to go" in buf.getvalue()
    assert summary["num_videos"] == 3
    assert {f: (tmp_path / "port" / f).read_bytes() for f in before} == before


def test_preempted_end_to_end_resumes_to_the_unbroken_files(tree, small, ckpt, tmp_path):
    whole = e2e_cli.main(e2e_args(tree, tmp_path / "whole"))
    out = tmp_path / "stopped"
    stopped = e2e_cli.run(e2e_cli.build_parser().parse_args(e2e_args(tree, out)),
                          preempt=StopAfter(1))
    assert stopped["preempted"] and stopped["videos_done"] == 2
    assert not (out / "e2e_summary.json").exists() and not (out / "prediction.txt").exists()
    resumed = e2e_cli.main(e2e_args(tree, out, "--resume"))
    assert resumed["num_videos"] == whole["num_videos"] == 3
    assert resumed["average_mAP"] == whole["average_mAP"]
    for f in ("prediction.txt", "prediction.json"):
        assert (out / f).read_bytes() == (tmp_path / "whole" / f).read_bytes()


@pytest.mark.parametrize("flag", [["--video-encoder", "c3d"], ["--video-chunk-bucketing"]])
def test_options_not_ported_raise(tree, models, monkeypatch, tmp_path, flag):
    """The two options the port once refused run through both entry points
    and write their files: ``--video-encoder c3d`` builds the seeded C3D,
    ``--video-chunk-bucketing`` the root scripts' buckets of quarters of
    ``--video-chunk`` (here around MViT-v2-b, the default). Small models in
    place of the production widths: C3D (4, 6, 8, 8), a two-stage MViT, the
    small audio models of ``models``."""
    built = []

    def c3d(dtype):
        built.append("c3d")
        return C3DVideoEncoder((4, 6, 8, 8), VIDEO_D, dtype=dtype)

    def mvit_b(out_dim, temporal_size, dtype):
        built.append("mvit_v2_b")
        assert out_dim == 256
        return MViTVideoEncoder(generate_config([1, 1], [1, 2], [8, 16], VIDEO_D),
                                temporal_size=temporal_size, dtype=dtype)

    def extractor(**kw):
        built.append(kw["chunk_buckets"])
        return tfront.FeatureExtractor(byola_model=models["tex"].byola_model,
                                       emotion_model=models["tex"].emotion_model, **kw)

    monkeypatch.setattr(extract_cli, "C3DVideoEncoder", c3d)
    monkeypatch.setattr(tmvit, "mvit_v2_b", mvit_b)
    monkeypatch.setattr(extract_cli, "FeatureExtractor", extractor)
    common = ["--video-chunk", str(CHUNK), "--device", "cpu", *flag]
    summary = extract_cli.main([str(tree / "list.txt"), "--video-root", str(tree / "data"),
                                "--wav-root", str(tree / "wav"),
                                "--output-root", str(tmp_path / "x"), *common])
    assert summary["done"] == 3 and len(summary["errors"]) == 1
    for rel, (dur, _) in CLIPS.items():
        for key, name in CACHE_DIR_NAMES.items():
            arr = np.load(tmp_path / "x" / name / (rel + ".npy"))
            assert np.isfinite(arr).all() and arr.dtype == np.float32
            if key == "video":
                assert arr.shape == (int(round(dur * 25)), VIDEO_D)
    out = e2e_cli.main([str(tree / "config.yaml"), "--metadata-root", str(tree / "metadata"),
                        "--data-root", str(tree / "data"), "--wav-root", str(tree / "wav"),
                        "--output", str(tmp_path / "y"), *common])
    assert out["num_videos"] == 3 and (tmp_path / "y" / "e2e_summary.json").exists()
    encoder = "c3d" if "c3d" in flag else "mvit_v2_b"
    q = CHUNK // 4
    buckets = None if "c3d" in flag else (q, 2 * q, 3 * q, CHUNK)
    assert built == [encoder, buckets] * 2


def test_entry_points_default_to_the_card(tree, tmp_path):
    x_args = [str(tree / "list.txt"), "--video-root", str(tree / "data"),
              "--output-root", str(tmp_path / "x")]
    e_args = [str(tree / "config.yaml"), "--metadata-root", str(tree / "metadata"),
              "--data-root", str(tree / "data"), "--output", str(tmp_path / "y")]
    assert extract_cli.build_parser().parse_args(x_args).device == "cuda"
    assert e2e_cli.build_parser().parse_args(e_args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_cli.main(x_args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            e2e_cli.main(e_args)
    assert not (tmp_path / "x").exists() and not (tmp_path / "y").exists()


def test_build_extractor_takes_the_named_encoder():
    ex = extract_cli.build_extractor("mvit_v2_t", 16, 1, "bfloat16", torch.device("cpu"))
    assert ex.device == torch.device("cpu") and ex.video_chunk == 16
    assert ex.dtype == torch.bfloat16 and ex.video_model.temporal_size == 16
    assert len(ex.video_model.blocks) == 10                 # mvit_v2_t: stages 1, 2, 5, 2
    assert next(ex.video_model.parameters()).dtype == torch.float32

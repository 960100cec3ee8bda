"""PyTorch port, the native host helpers on the CPU: the g++-built resample +
concat equals the port's numpy version and the JAX package's bit for bit;
the native greedy matcher equals the Python matcher of both packages; a
failed build raises with the compiler's message, from the helper and from
the dataset and the evaluator that asked for it, and nothing falls back to
numpy or Python."""

import numpy as np
import pytest

from audio_visual_deepfake_detection_tpu.data import dataset as jds
from audio_visual_deepfake_detection_tpu.eval import detection as jdet
from audio_visual_deepfake_detection_tpu_torch.data import dataset as tds
from audio_visual_deepfake_detection_tpu_torch.eval import detection as tdet
from audio_visual_deepfake_detection_tpu_torch.runtime import host_match, host_resample, native


def _streams(rng, rows, widths=(256, 2048, 768)):
    return [rng.standard_normal((r, c)).astype(np.float32) for r, c in zip(rows, widths)]


@pytest.mark.parametrize("rows,out_len", [
    ((250, 124, 499), 768), ((768, 383, 1500), 768), ((960, 400, 1520), 768),
    ((25, 12, 49), 96), ((1, 1, 1), 96), ((96, 96, 96), 96), ((100,), 40),
])
def test_native_resample_is_bit_equal(rows, out_len):
    rng = np.random.default_rng(sum(rows))
    streams = _streams(rng, rows)
    native_out = host_resample.resample_concat(streams, out_len)
    team = host_resample.resample_concat(streams, out_len, threads=0)
    plain = tds.resample_concat_np(streams, out_len)
    ref = jds.resample_concat_np(streams, out_len)
    assert native_out.dtype == plain.dtype == ref.dtype == np.float32
    assert np.array_equal(native_out, plain) and np.array_equal(team, plain)
    assert np.array_equal(plain, ref)
    buf = np.empty_like(plain)
    assert host_resample.resample_concat(streams, out_len, out=buf) is buf
    assert np.array_equal(buf, plain)


def test_native_resample_rejects_bad_arguments():
    rng = np.random.default_rng(0)
    streams = _streams(rng, (10, 5), (4, 3))
    with pytest.raises(ValueError, match="non-empty"):
        host_resample.resample_concat([streams[0], np.zeros((0, 3), np.float32)], 8)
    with pytest.raises(ValueError, match="C-contiguous"):
        host_resample.resample_concat(streams, 8, out=np.empty((8, 6), np.float32))
    with pytest.raises(ValueError, match="C-contiguous"):
        host_resample.resample_concat(streams, 8, out=np.empty((7, 8), np.float32)[:, :7].T)


def _tables(rng, n_vid=40, max_pred=30, max_gt=4):
    pred = {"video-id": [], "t-start": [], "t-end": [], "score": []}
    gt = {"video-id": [], "t-start": [], "t-end": []}
    for v in range(n_vid):
        vid = f"v{v:03d}"
        for _ in range(int(rng.integers(0, max_gt + 1))):
            s = rng.uniform(0, 20)
            gt["video-id"].append(vid)
            gt["t-start"].append(s)
            gt["t-end"].append(s + rng.uniform(0.2, 4))
        for _ in range(int(rng.integers(0, max_pred))):
            s = rng.uniform(0, 20)
            pred["video-id"].append(vid)
            pred["t-start"].append(s)
            pred["t-end"].append(s + rng.uniform(0.1, 4))
            # quantized scores: ties in the score order, as real tables have
            pred["score"].append(round(float(rng.uniform()), 2))
    # an exact duplicate of a GT (IoU 1) and a tie of two GTs
    pred["video-id"] += [gt["video-id"][0]] * 2
    pred["t-start"] += [gt["t-start"][0]] * 2
    pred["t-end"] += [gt["t-end"][0]] * 2
    pred["score"] += [0.99, 0.99]
    return ({k: np.asarray(v) for k, v in pred.items()},
            {k: np.asarray(v) for k, v in gt.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matcher_equals_python_matcher(seed):
    rng = np.random.default_rng(seed)
    pred, gt = _tables(rng)
    tious = np.array([0.1, 0.5, 0.75, 0.9, 0.95])
    native_ap = tdet.average_precision(gt, pred, tious)
    python_ap = tdet.average_precision(gt, pred, tious, native=False)
    ref_native = jdet.average_precision(gt, pred, tious, n_jobs=-1)
    ref_python = jdet.average_precision(gt, pred, tious, n_jobs=0)
    assert native_ap.tolist() == python_ap.tolist() == ref_native.tolist() == ref_python.tolist()
    assert (native_ap > 0).any()


def test_native_matcher_flags_match_python():
    rng = np.random.default_rng(7)
    pred, gt = _tables(rng, n_vid=12)
    order = np.argsort(pred["score"])[::-1]
    p_seg = np.stack([pred["t-start"][order], pred["t-end"][order]], 1)
    g_seg = np.stack([gt["t-start"], gt["t-end"]], 1)
    codes = tdet._factorize_ids(np.concatenate([pred["video-id"], gt["video-id"]]))
    n = len(pred["score"])
    tious = np.array([0.3, 0.7])
    got = tdet._match_all_native(p_seg, codes[:n][order], g_seg, codes[n:], tious, 2)
    want = tdet._match_all_python(p_seg, codes[:n][order], g_seg, codes[n:], tious)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="offset"):
        host_match.host_match_tp(p_seg, np.array([0, 1]), g_seg, np.array([0, 1, 2]), tious)


def test_library_is_built_under_build_and_keyed_by_source_and_flags():
    src = native.CSRC / "resample.cpp"
    path = native.library_path(src, host_resample.FLAGS)
    assert path.parent == native.BUILD_DIR and native.BUILD_DIR.name == "host"
    assert native.BUILD_DIR.parent.name == "build"
    assert path != native.library_path(src, ("-O2",))
    host_resample.load()
    assert path.exists()


@pytest.fixture
def broken_csrc(tmp_path, monkeypatch):
    """Both helpers' sources replaced by ones g++ rejects."""
    for name in ("resample", "match"):
        (tmp_path / f"{name}.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    return tmp_path


def test_failed_build_raises_with_compiler_message(broken_csrc):
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*resample\.cpp") as info:
        host_resample.load()
    assert "error" in str(info.value)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*match\.cpp"):
        host_match.load()


def test_no_silent_fallback_on_a_failed_build(broken_csrc, tmp_path):
    """The dataset that asked for the native resample and the evaluator
    that asked for the native matcher raise; neither goes on in numpy."""
    cfg = {"video_feat_folder": str(tmp_path), "audio_byola_feat_folder": str(tmp_path),
           "audio_emo_feat_folder": str(tmp_path), "test_folder": str(tmp_path),
           "feat_stride": 1, "num_frames": 1, "max_seq_len": 96}
    (tmp_path / "deepfake_test_sub1.txt").write_text("a.mp4,4.0")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tds.DeepfakeInferenceDataset("deepfake_video_audioEmoBYOLA_inference", ["test"], 1,
                                     cfg)
    assert len(tds.DeepfakeInferenceDataset("deepfake_video_audioEmoBYOLA_inference",
                                            ["test"], 1, cfg, native_resample=False)) == 1
    pred, gt = _tables(np.random.default_rng(0), n_vid=3)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tdet.average_precision(gt, pred, np.array([0.5]))
    assert tdet.average_precision(gt, pred, np.array([0.5]), native=False).shape == (1,)

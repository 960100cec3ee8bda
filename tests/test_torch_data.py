"""PyTorch port, the host data layer vs the JAX package on the CPU, exactly:
metadata and shard lists, the truncation windows of one seed, every dataset
sample (training and validation, the three stride branches, both
``force_upsampling`` branches, device-resample samples, the THE frame
labels, the neighbour that stands in for a corrupt file), ``collate_batch``,
``collate_train_streams`` and the loader's batches under shuffle, shards and
``set_skip``. The caches are written by ``tools/synth_cache.py`` at stream
widths 8 / 12 / 4."""

import os

import numpy as np
import pytest

from audio_visual_deepfake_detection_tpu.data import dataset as jds
from audio_visual_deepfake_detection_tpu.data import loader as jloader
from audio_visual_deepfake_detection_tpu.data import metadata as jmd
from audio_visual_deepfake_detection_tpu.data import truncate as jtr
from audio_visual_deepfake_detection_tpu_torch.data import dataset as tds
from audio_visual_deepfake_detection_tpu_torch.data import loader as tloader
from audio_visual_deepfake_detection_tpu_torch.data import metadata as tmd
from audio_visual_deepfake_detection_tpu_torch.data import truncate as ttr
from audio_visual_deepfake_detection_tpu_torch.tools.synth_cache import write_feature_cache

N_VIDEOS = 10


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cache"))
    return write_feature_cache(root, N_VIDEOS, seed=1, dims=(8, 12, 4), n_labelled=N_VIDEOS,
                               extra_durations=(2.5,))


def dataset_cfg(cache, **kw):
    cfg = {
        "video_feat_folder": cache["folders"]["video"],
        "audio_byola_feat_folder": cache["folders"]["byola"],
        "audio_emo_feat_folder": cache["folders"]["emotion"],
        "train_txt": cache["labelled_txt"], "json_folder": cache["json_folder"],
        "test_folder": cache["test_folder"],
        "feat_stride": 1, "num_frames": 1, "default_fps": None, "downsample_rate": 0,
        "max_seq_len": 96, "trunc_thresh": 0.5, "crop_ratio": [0.9, 1.0],
        "num_classes": 1, "force_upsampling": True,
    }
    cfg.update(kw)
    return cfg


def assert_same(got, want, path="sample"):
    """Exact equality of nested samples: same keys, types, dtypes, values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_metadata_matches_jax(cache):
    rels = tmd.read_list_file(cache["labelled_txt"])
    assert rels == jmd.read_list_file(cache["labelled_txt"]) and len(rels) == N_VIDEOS
    for rel in rels:
        for fps in (None, 30.0):
            got = tmd.load_video_meta(cache["json_folder"], rel, fps)
            want = jmd.load_video_meta(cache["json_folder"], rel, fps)
            assert_same(got.__dict__, want.__dict__)
    assert any(tmd.load_video_meta(cache["json_folder"], r, None).segments is None
               for r in rels)
    for name in ("a/real.json", "b/fake_video_real_audio.json", "fake_video_fake_audio.json",
                 "real_video_fake_audio.json", "other.json"):
        assert tmd.av_labels_from_name(name) == jmd.av_labels_from_name(name)
    assert tmd.read_test_shard(cache["test_folder"], 1) == \
        jmd.read_test_shard(cache["test_folder"], 1)
    for d in (2.5, 9.6, 30.0):
        assert tmd.byola_trunc_rows(d) == jmd.byola_trunc_rows(d)
        assert tmd.emotion_trunc_rows(d) == jmd.emotion_trunc_rows(d)


@pytest.mark.parametrize("feat_len,crop_ratio,mode", [
    (96, None, "has_action"), (96, (0.5, 0.9), "has_action"), (300, None, "has_action"),
    (300, (0.9, 1.0), "no_trunc"), (300, None, "any"), (40, (1.0, 1.0), "has_action"),
])
def test_truncate_windows_match_jax(feat_len, crop_ratio, mode):
    rng = np.random.default_rng(5)
    segs = np.sort(rng.uniform(0, feat_len, (4, 2)), axis=1).astype(np.float32)
    labels = np.zeros(4, np.int64)
    kw = dict(has_action=mode != "any", no_trunc=mode == "no_trunc")
    feats = rng.standard_normal((feat_len, 3)).astype(np.float32)
    for seed in range(6):
        got = ttr.draw_truncate_window(feat_len, segs, labels, 96, 0.5, 0.5,
                                       np.random.default_rng(seed), crop_ratio, **kw)
        want = jtr.draw_truncate_window(feat_len, segs, labels, 96, 0.5, 0.5,
                                        np.random.default_rng(seed), crop_ratio, **kw)
        assert_same(list(got), list(want))
        got = ttr.truncate_feats(feats, segs, labels, 96, 0.5, 0.5,
                                 np.random.default_rng(seed), crop_ratio, **kw)
        want = jtr.truncate_feats(feats, segs, labels, 96, 0.5, 0.5,
                                  np.random.default_rng(seed), crop_ratio, **kw)
        assert_same(list(got), list(want))


@pytest.mark.parametrize("in_len,out_len", [(250, 768), (768, 768), (1000, 768), (7, 96),
                                            (1, 96), (96, 40)])
def test_linear_resample_np_matches_jax(in_len, out_len):
    x = np.random.default_rng(in_len).standard_normal((in_len, 5)).astype(np.float32)
    got, want = tds.linear_resample_np(x, out_len), jds.linear_resample_np(x, out_len)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    streams = [x, x[: max(1, in_len // 2), :3]]
    assert np.array_equal(tds.resample_concat_np(streams, out_len),
                          jds.resample_concat_np(streams, out_len))


# (dataset name, is_training, dataset config changes)
TRAIN_CASES = [
    ("deepfake_video_audioEmoBYOLA", True, {}),
    ("deepfake_video_audioEmoBYOLA", False, {}),
    ("deepfake_video_audioEmoBYOLA_inference", True, {"crop_ratio": None}),
    ("deepfake_video_audioEmoBYOLA", True, {"feat_stride": 0}),          # stride from fps
    ("deepfake_video_audioEmoBYOLA", True, {"device_resample": True}),
    ("deepfake_video_audioEmoBYOLA_THE", True, {}),
    ("deepfake_video_audio", True, {"default_fps": 25.0}),
    ("deepfake_video_audioBYOLA", False, {}),
    ("deepfake_audio", True, {"force_upsampling": False, "feat_stride": 4, "num_frames": 8}),
    ("deepfake_audio", True, {"force_upsampling": False, "downsample_rate": 2,
                              "crop_ratio": None}),
    ("deepfake_audio", False, {"force_upsampling": False}),
]


@pytest.mark.parametrize("name,is_training,changes", TRAIN_CASES,
                         ids=[f"{n}-{t}-{'-'.join(c)}" for n, t, c in TRAIN_CASES])
def test_dataset_samples_match_jax(cache, name, is_training, changes):
    cfg = dataset_cfg(cache, **changes)
    ours = tds.DeepfakeDataset(name, is_training, ["dev"], cfg)
    ref = jds.DeepfakeDataset(name, is_training, ["dev"], cfg)
    assert len(ours) == len(ref) == N_VIDEOS and ours.streams == ref.streams
    for i in range(len(ours)):
        got = ours.__getitem__(i, np.random.default_rng(100 + i))
        want = ref.__getitem__(i, np.random.default_rng(100 + i))
        assert_same(got, want, f"{name}[{i}]")


def test_native_resample_dataset_equals_numpy(cache):
    cfg = dataset_cfg(cache)
    native = tds.DeepfakeDataset("deepfake_video_audioEmoBYOLA", True, ["dev"], cfg)
    plain = tds.DeepfakeDataset("deepfake_video_audioEmoBYOLA", True, ["dev"], cfg,
                                native_resample=False)
    for i in range(len(plain)):
        assert_same(native.__getitem__(i, np.random.default_rng(i)),
                    plain.__getitem__(i, np.random.default_rng(i)))
    shard = [tds.DeepfakeInferenceDataset("deepfake_video_audioEmoBYOLA_inference", ["test"], 1,
                                          cfg, native_resample=flag) for flag in (True, False)]
    for i in range(len(shard[0])):
        assert_same(shard[0][i], shard[1][i])


@pytest.mark.parametrize("name,changes", [
    ("deepfake_video_audioEmoBYOLA_inference", {}),
    ("deepfake_video_audioEmoBYOLA_inference", {"device_resample": True}),
    ("deepfake_video_audio_inference", {"feat_stride": 2, "num_frames": 4}),
    ("deepfake_audio_inference", {"force_upsampling": False}),
])
def test_inference_samples_match_jax(cache, name, changes):
    cfg = dataset_cfg(cache, **changes)
    ours = tds.DeepfakeInferenceDataset(name, ["test"], 1, cfg)
    ref = jds.DeepfakeInferenceDataset(name, ["test"], 1, cfg)
    assert len(ours) == len(ref) == N_VIDEOS + 1
    for i in range(len(ours)):
        assert_same(ours[i], ref[i], f"{name}[{i}]")


def test_corrupt_file_takes_the_neighbour(cache, tmp_path):
    """An unreadable cache file: the next video stands in, in both packages;
    a missing metadata file (a logic error) is raised, not replaced."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(os.path.dirname(cache["labelled_txt"]), root)
    rels = tmd.read_list_file(cache["labelled_txt"])
    bad = root / "byola" / rels[3].replace(".json", ".npy")
    bad.write_bytes(b"not a numpy file")
    cfg = {k: (v.replace(os.path.dirname(cache["labelled_txt"]), str(root))
               if isinstance(v, str) else v) for k, v in dataset_cfg(cache).items()}
    ours = tds.DeepfakeDataset("deepfake_video_audioEmoBYOLA", True, ["dev"], cfg)
    ref = jds.DeepfakeDataset("deepfake_video_audioEmoBYOLA", True, ["dev"], cfg)
    got = ours.__getitem__(3, np.random.default_rng(0))
    assert got["video_id"] == rels[4].replace(".json", ".mp4")
    assert_same(got, ref.__getitem__(3, np.random.default_rng(0)))
    os.remove(root / "metadata" / rels[5])
    with pytest.raises(FileNotFoundError):
        ours.__getitem__(5, np.random.default_rng(0))


def test_collate_batch_matches_jax(cache):
    cfg = dataset_cfg(cache)
    ds = tds.DeepfakeDataset("deepfake_video_audioEmoBYOLA_THE", True, ["dev"], cfg)
    samples = [ds.__getitem__(i, np.random.default_rng(i)) for i in range(len(ds))]
    for frame_labels in (False, True):
        for max_gt in (32, 2):
            assert_same(tds.collate_batch(samples, 96, max_gt, frame_labels),
                        jds.collate_batch(samples, 96, max_gt, frame_labels))
    short = dict(samples[0], feats=samples[0]["feats"][:50])
    assert_same(tds.collate_batch([short] + samples[1:3], 96),
                jds.collate_batch([short] + samples[1:3], 96))


def test_collate_train_streams_matches_jax(cache):
    cfg = dataset_cfg(cache, device_resample=True)
    ds = tds.DeepfakeDataset("deepfake_video_audioEmoBYOLA_THE", True, ["dev"], cfg)
    samples = [ds.__getitem__(i, np.random.default_rng(i)) for i in range(len(ds))]
    caps = [max(s["streams"][k].shape[0] for s in samples) + 3 for k in range(3)]
    for frame_labels in (False, True):
        assert_same(tds.collate_train_streams(samples, caps, 96, 32, frame_labels),
                    jds.collate_train_streams(samples, caps, 96, 32, frame_labels))
    with pytest.raises(ValueError, match="cap"):
        tds.collate_train_streams(samples, [1, 1, 1], 96)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False), dict(shuffle=True, seed=3), dict(shuffle=True, drop_last=True),
    dict(shuffle=True, shard_rank=1, num_shards=3),
    dict(shuffle=True, shard_rank=2, num_shards=3, equal_shards=True),
    dict(shuffle=False, shard_rank=0, num_shards=2),
])
@pytest.mark.parametrize("skip", [0, 2])
def test_loader_batches_match_jax(cache, kw, skip):
    """The same batches in the same order, per-sample draws included, under
    shuffling, sharding, drop_last, epochs and a set_skip resume."""
    cfg = dataset_cfg(cache)
    name = "deepfake_video_audioEmoBYOLA"
    ours = tloader.DataLoader(tds.DeepfakeDataset(name, True, ["dev"], cfg), 3,
                              lambda s: tds.collate_batch(s, 96), num_workers=2, **kw)
    ref = jloader.DataLoader(jds.DeepfakeDataset(name, True, ["dev"], cfg), 3,
                             lambda s: jds.collate_batch(s, 96), num_workers=2, **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        ours.set_skip(skip)
        ref.set_skip(skip)
        got, want = list(ours), list(ref)
        assert len(ours) == len(ref) and len(got) == len(want) == max(len(ref) - skip, 0)
        assert_same(got, want)
    # set_skip is one-shot; the skipped batches' draws were consumed
    ours.set_epoch(1)
    full = list(ours)
    assert_same(full[skip:], got)


def test_loader_propagates_errors_and_releases_an_abandoned_producer(cache):
    import threading
    import time

    ds = tds.DeepfakeDataset("deepfake_video_audioEmoBYOLA", False, ["dev"], dataset_cfg(cache))

    def bad(samples):
        raise ValueError("collate failed")

    with pytest.raises(ValueError, match="collate failed"):
        list(tloader.DataLoader(ds, 2, bad, num_workers=2))
    before = threading.active_count()
    it = iter(tloader.DataLoader(ds, 1, lambda s: s, num_workers=2, prefetch=1))
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before

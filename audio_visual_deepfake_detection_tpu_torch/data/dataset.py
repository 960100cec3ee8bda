"""Datasets over precomputed feature caches (JAX ``data/dataset.py``).

One ``DeepfakeDataset`` takes the tuple of feature streams its reference
dataset name maps to (``DATASET_STREAMS``):

    deepfake_video_audio            -> (video, emotion)
    deepfake_video_audioBYOLA       -> (video, byola)
    deepfake_video_audioEmoBYOLA    -> (video, byola, emotion)
    deepfake_video_audioEmoBYOLA_THE-> the same + per-frame GT labels
    deepfake_audio (legacy)         -> (byola,)
    *_inference                     -> the same streams, from a shard list

Per sample:
- BYOL-A rows truncated to int(12.497 * dur - 0.3657), Emotion2Vec to
  int(50 * dur - 0.817),
- feat_stride = ((T_v - 1) * stride + num_frames) / max_seq_len under
  force_upsampling, feat_offset = 0.5 * num_frames / feat_stride,
- every stream linearly resampled (align_corners=False) to max_seq_len and
  the channels concatenated,
- segments (seconds) -> grid: seg * fps / feat_stride - feat_offset, with the
  out-of-window filtering at trunc_thresh,
- an unreadable feature file is replaced by the neighbouring sample.

The resample runs in the native host function (``runtime/host_resample.py``;
its build runs when the dataset is made and raises if it fails) or, when
the dataset is built with ``native_resample=False``, in its numpy twin
(``resample_concat_np``), which gives the same bits. Samples are (T, C)
time-major numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.resample import _linear_coords_cached
from . import metadata as md
from .truncate import draw_truncate_window, truncate_feats


def linear_resample_np(x: np.ndarray, out_len: int) -> np.ndarray:
    """Linear resample of ``x`` along axis 0 to ``out_len`` rows, with the
    float32 coordinates of ``ops/resample.py``."""
    in_len = x.shape[0]
    if in_len == out_len:
        return x
    idx0, idx1, frac = _linear_coords_cached(in_len, out_len)
    frac = frac[:, None]
    return x[idx0] * (1.0 - frac) + x[idx1] * frac


def resample_concat_np(streams: List[np.ndarray], out_len: int) -> np.ndarray:
    """Each stream resampled to ``out_len`` rows, the channels concatenated."""
    return np.concatenate([linear_resample_np(s, out_len) for s in streams], axis=1)


def _resampler(native_resample: bool):
    if not native_resample:
        return resample_concat_np
    from ..runtime import host_resample

    host_resample.load()          # build now: a failure raises here, with g++'s message
    return host_resample.resample_concat


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    name: str                  # video | byola | emotion
    folder_key: str            # config key holding the feature folder
    dim: int


DATASET_STREAMS: Dict[str, Tuple[str, ...]] = {
    "deepfake_video_audio": ("video", "emotion"),
    "deepfake_video_audioBYOLA": ("video", "byola"),
    "deepfake_video_audioEmoBYOLA": ("video", "byola", "emotion"),
    "deepfake_video_audioEmoBYOLA_THE": ("video", "byola", "emotion"),
    "deepfake_audio": ("byola",),
}

STREAM_FOLDER_KEYS = {
    "video": "video_feat_folder",
    "byola": "audio_byola_feat_folder",
    "emotion": "audio_emo_feat_folder",
}

# legacy datasets name the folder of their single audio stream audio_feat_folder
LEGACY_AUDIO_KEY = "audio_feat_folder"


class CorruptFeatureError(RuntimeError):
    """An unreadable feature .npy (a truncated or corrupt cache file)."""


def _stream_folders(streams, dataset_cfg) -> Dict[str, str]:
    """Per-stream feature folders. The legacy ``audio_feat_folder`` stands
    in for audio streams only: a config without video_feat_folder fails here
    instead of feeding audio features in as the video stream."""
    folders = {}
    for s in streams:
        folder = dataset_cfg.get(STREAM_FOLDER_KEYS[s])
        if not folder and s != "video":
            folder = dataset_cfg.get(LEGACY_AUDIO_KEY)
        if not folder:
            raise KeyError(
                f"dataset config is missing {STREAM_FOLDER_KEYS[s]!r} for the "
                f"{s!r} stream")
        folders[s] = folder
    return folders


def _trunc_rows(stream: str, duration: float) -> Optional[int]:
    if stream == "byola":
        return md.byola_trunc_rows(duration)
    if stream == "emotion":
        return md.emotion_trunc_rows(duration)
    return None


class DeepfakeDataset:
    """Training / validation dataset over precomputed feature caches."""

    def __init__(
        self,
        dataset_name: str,
        is_training: bool,
        split: Sequence[str],
        dataset_cfg: Dict,
        with_frame_labels: Optional[bool] = None,
        native_resample: bool = True,
    ):
        base = dataset_name.replace("_inference", "")
        if base not in DATASET_STREAMS:
            raise ValueError(f"unknown dataset {dataset_name}")
        self.streams = DATASET_STREAMS[base]
        self.folders = _stream_folders(self.streams, dataset_cfg)
        self.is_training = is_training
        self.split = tuple(split)
        self.json_folder = dataset_cfg["json_folder"]
        self.feat_stride = dataset_cfg["feat_stride"]
        self.num_frames = dataset_cfg["num_frames"]
        self.default_fps = dataset_cfg.get("default_fps")
        self.downsample_rate = dataset_cfg.get("downsample_rate", 0)
        self.max_seq_len = dataset_cfg["max_seq_len"]
        self.trunc_thresh = dataset_cfg["trunc_thresh"]
        self.crop_ratio = dataset_cfg.get("crop_ratio")
        self.force_upsampling = dataset_cfg.get("force_upsampling", True)
        self.num_classes = dataset_cfg["num_classes"]
        self.with_frame_labels = (
            with_frame_labels if with_frame_labels is not None
            else dataset_name.endswith("_THE"))
        if self.num_classes != 1:
            raise ValueError(f"num_classes must be 1, got {self.num_classes}")
        # device_resample: the raw ragged streams and the host-drawn crop
        # window go to the device, which resamples
        self.device_resample = bool(dataset_cfg.get("device_resample", False))
        if self.device_resample and not self.force_upsampling:
            raise ValueError("device_resample requires force_upsampling")
        if not self.force_upsampling and len(self.streams) > 1:
            # streams on different time grids cannot be concatenated row by
            # row; the reference's own non-upsampled branch fails there too
            raise ValueError(
                f"{dataset_name}: force_upsampling=False is unsupported for "
                f"multi-stream datasets (streams live on different time "
                f"grids); the reference has the same constraint")
        self.data_list = md.read_list_file(dataset_cfg["train_txt"])
        self.attrs = {
            "dataset_name": "DeepFake_Audio",
            "tiou_thresholds": np.linspace(0.5, 0.95, 10),
            "empty_label_ids": [],
        }
        self._resample = _resampler(native_resample)

    def __len__(self) -> int:
        return len(self.data_list)

    def _load_streams(self, rel_npy: str, duration: float) -> List[np.ndarray]:
        feats = []
        for s in self.streams:
            try:
                arr = np.load(os.path.join(self.folders[s], rel_npy))
            except (ValueError, OSError) as e:
                # tagged, so that only an unreadable file is replaced by a
                # neighbour, never a logic error
                raise CorruptFeatureError(f"{self.folders[s]}/{rel_npy}: {e}") from e
            rows = _trunc_rows(s, duration)
            if rows is not None:
                arr = arr[:rows]
            feats.append(np.asarray(arr, dtype=np.float32))
        return feats

    def _stride_info(self, video_rows: int, duration: float, fps: float):
        """(feat_stride, num_frames) under the reference's three branches."""
        if self.feat_stride > 0 and not self.force_upsampling:
            return float(self.feat_stride), float(self.num_frames)
        if self.feat_stride > 0 and self.force_upsampling:
            stride = float((video_rows - 1) * self.feat_stride + self.num_frames) \
                / self.max_seq_len
            return stride, stride
        stride = duration * fps / self.max_seq_len
        return stride, stride

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        rel_json = self.data_list[idx]
        try:
            return self._get_one(rel_json, rng)
        except CorruptFeatureError:
            # the next sample stands in for an unreadable one
            alt = (idx + 1) % len(self.data_list)
            return self._get_one(self.data_list[alt], rng)

    def _get_one(self, rel_json: str, rng: np.random.Generator):
        meta = md.load_video_meta(self.json_folder, rel_json, self.default_fps)
        rel_npy = rel_json.replace(".json", ".npy")
        streams = self._load_streams(rel_npy, meta.duration)

        video_rows = streams[0].shape[0]
        feat_stride, num_frames = self._stride_info(video_rows, meta.duration, meta.fps)
        feat_offset = 0.5 * num_frames / feat_stride

        if self.downsample_rate > 1 and not self.force_upsampling:
            streams[0] = streams[0][::self.downsample_rate]
            feat_stride *= self.downsample_rate

        if self.device_resample:
            # only the GT arithmetic and the window draw (same rng calls as
            # the host path, so the same window) stay on the host
            feats = None
            feat_len = self.max_seq_len
        elif self.force_upsampling:
            feats = self._resample(streams, self.max_seq_len)  # (T, C)
            feat_len = feats.shape[0]
        else:
            feats = np.concatenate(streams, axis=1)  # (T, C)
            feat_len = feats.shape[0]

        segments = labels = None
        if meta.segments is not None:
            segments = meta.segments * meta.fps / feat_stride - feat_offset
            labels = meta.labels
            if self.is_training:
                # drop segments (mostly) outside the feature window
                vid_len = feat_len + feat_offset
                keep_segs, keep_labels = [], []
                for seg, lab in zip(segments, labels):
                    if seg[0] >= vid_len:
                        continue
                    ratio = (min(seg[1], vid_len) - seg[0]) / (seg[1] - seg[0])
                    if ratio >= self.trunc_thresh:
                        keep_segs.append(np.clip(seg, None, vid_len))
                        keep_labels.append(lab)
                segments = np.stack(keep_segs).astype(np.float32) if keep_segs else None
                labels = np.asarray(keep_labels, dtype=np.int64) if keep_labels else None

        win_st, win_len = 0, feat_len
        if self.is_training and segments is not None:
            if self.device_resample:
                win_st, win_len, segments, labels = draw_truncate_window(
                    feat_len, segments, labels, self.max_seq_len,
                    self.trunc_thresh, feat_offset, rng, self.crop_ratio)
            else:
                feats, segments, labels = truncate_feats(
                    feats, segments, labels, self.max_seq_len, self.trunc_thresh,
                    feat_offset, rng, self.crop_ratio)

        sample = {
            "video_id": meta.video_id,
            "feats": feats,
            "segments": segments,
            "labels": labels,
            "n_fakes": 0 if segments is None else segments.shape[0],
            "av_labels": np.asarray(meta.av_labels, np.int64),
            "fps": meta.fps,
            "duration": meta.duration,
            "feat_stride": feat_stride,
            "feat_num_frames": num_frames,
            "split": meta.split,
            "segments_time": meta.segments,
        }
        if self.device_resample:
            sample["streams"] = streams
            sample["win_st"] = win_st
            sample["win_len"] = win_len
        if self.with_frame_labels and self.is_training and segments is not None:
            sample["gt_frame_labels"] = frame_labels_from_segments(
                meta.duration, segments, meta.av_labels, self.max_seq_len)
        return sample


def frame_labels_from_segments(duration, segments, av_labels, t_len=768):
    """Per-frame 0/1 fake mask of the THE variant, with the reference's unit
    mix: the segments are in feature-grid units but divided by duration / 768
    (seconds), and the mask is set only when a modality is real
    (av_labels > 0)."""
    labels = np.zeros((t_len,), np.float32)
    seg_len = duration / t_len
    for start, end in segments:
        if av_labels[0] > 0 or av_labels[1] > 0:
            s = int(start / seg_len)
            e = int(end / seg_len)
            labels[s:e] = 1.0
    return labels


class DeepfakeInferenceDataset:
    """The sharded test set: ``deepfake_test_sub{i}.txt`` lines (id,
    duration), no labels; fps is the video feature length over the
    duration."""

    def __init__(self, dataset_name: str, split, sub_index: int, dataset_cfg: Dict,
                 native_resample: bool = True):
        base = dataset_name.replace("_inference", "")
        self.streams = DATASET_STREAMS[base]
        self.folders = _stream_folders(self.streams, dataset_cfg)
        self.feat_stride = dataset_cfg["feat_stride"]
        self.num_frames = dataset_cfg["num_frames"]
        self.max_seq_len = dataset_cfg["max_seq_len"]
        self.force_upsampling = dataset_cfg.get("force_upsampling", True)
        # device_resample: samples carry the raw ragged streams (for
        # infer.runner.build_online_inference_fn) instead of resampled features
        self.device_resample = bool(dataset_cfg.get("device_resample", False))
        self.data_list = md.read_test_shard(dataset_cfg["test_folder"], sub_index)
        self._resample = _resampler(native_resample)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx: int, rng=None):
        item = self.data_list[idx]
        rel_npy = item["id"].replace(".mp4", ".npy")
        duration = item["duration"]

        streams = []
        for s in self.streams:
            arr = np.load(os.path.join(self.folders[s], rel_npy)).astype(np.float32)
            rows = _trunc_rows(s, duration)
            if rows is not None:
                arr = arr[:rows]
            streams.append(arr)

        if self.device_resample:
            return {"video_id": item["id"], "streams": streams, "duration": duration}

        video_rows = streams[0].shape[0]
        fps = video_rows / duration
        if self.feat_stride <= 0:
            raise ValueError("fixed-length features (feat_stride <= 0) are not supported")
        if self.force_upsampling:
            feat_stride = float((video_rows - 1) * self.feat_stride + self.num_frames) \
                / self.max_seq_len
            num_frames = feat_stride
            feats = self._resample(streams, self.max_seq_len)
        else:
            # variable length: the features keep the leading stream's grid,
            # stride and num_frames the config's; other streams are resampled
            # onto that grid; the collator pads to a multiple of
            # max_div_factor (collate_infer_varlen)
            feat_stride = float(self.feat_stride)
            num_frames = float(self.num_frames)
            feats = self._resample(streams, video_rows)
        return {
            "video_id": item["id"],
            "feats": feats,
            "fps": fps,
            "duration": duration,
            "feat_stride": feat_stride,
            "feat_num_frames": num_frames,
        }


def collate_train_streams(samples: List[dict], caps: Sequence[int],
                          max_seq_len: int, max_gt: int = 32,
                          with_frame_labels: bool = False) -> Dict[str, np.ndarray]:
    """Batch device-resample training samples: the raw ragged streams
    zero-padded to static caps, their row counts and the host-drawn crop
    windows, plus the GT arrays of :func:`collate_batch`."""
    b = len(samples)
    n_streams = len(samples[0]["streams"])
    if len(caps) != n_streams:
        raise ValueError(f"{len(caps)} caps for {n_streams} streams")
    streams, rows = [], []
    for s in range(n_streams):
        c = samples[0]["streams"][s].shape[1]
        arr = np.zeros((b, caps[s], c), np.float32)
        cnt = np.zeros((b,), np.int32)
        for i, item in enumerate(samples):
            x = item["streams"][s]
            if x.shape[0] > caps[s]:
                raise ValueError(f"stream {s}: {x.shape[0]} rows > cap {caps[s]}")
            arr[i, :x.shape[0]] = x
            cnt[i] = x.shape[0]
        streams.append(arr)
        rows.append(cnt)

    gt_segments = np.zeros((b, max_gt, 2), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int64)
    gt_valid = np.zeros((b, max_gt), bool)
    frame_labels = np.zeros((b, max_seq_len), np.float32)
    win_st = np.zeros((b,), np.int32)
    win_len = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        segs = s.get("segments")
        if segs is not None and len(segs) > 0:
            n = min(len(segs), max_gt)
            gt_segments[i, :n] = segs[:n]
            gt_labels[i, :n] = s["labels"][:n]
            gt_valid[i, :n] = True
        if with_frame_labels and s.get("gt_frame_labels") is not None:
            frame_labels[i] = s["gt_frame_labels"]
        win_st[i] = s["win_st"]
        win_len[i] = s["win_len"]

    batch = {
        "streams": tuple(streams), "rows": tuple(rows),
        "win_st": win_st, "win_len": win_len,
        "gt_segments": gt_segments, "gt_labels": gt_labels, "gt_valid": gt_valid,
        "has_gt": gt_valid.any(axis=1),
        "video_ids": [s["video_id"] for s in samples],
    }
    if with_frame_labels:
        batch["frame_labels"] = frame_labels
    return batch


def collate_batch(samples: List[dict], max_seq_len: int, max_gt: int = 32,
                  with_frame_labels: bool = False) -> Dict[str, np.ndarray]:
    """Batch samples into fixed-shape arrays (the reference model's own
    input preprocessing, moved into the data pipeline)."""
    b = len(samples)
    c = samples[0]["feats"].shape[1]
    feats = np.zeros((b, max_seq_len, c), np.float32)
    mask = np.zeros((b, max_seq_len), bool)
    gt_segments = np.zeros((b, max_gt, 2), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int64)
    gt_valid = np.zeros((b, max_gt), bool)
    frame_labels = np.zeros((b, max_seq_len), np.float32)
    fps = np.zeros((b,), np.float32)
    duration = np.zeros((b,), np.float32)
    feat_stride = np.zeros((b,), np.float32)
    feat_num_frames = np.zeros((b,), np.float32)
    video_ids = []

    for i, s in enumerate(samples):
        t = s["feats"].shape[0]
        if t > max_seq_len:
            raise ValueError(f"{s['video_id']}: {t} rows > max_seq_len {max_seq_len}")
        feats[i, :t] = s["feats"]
        mask[i, :t] = True
        segs = s.get("segments")
        if segs is not None and len(segs) > 0:
            n = min(len(segs), max_gt)
            gt_segments[i, :n] = segs[:n]
            gt_labels[i, :n] = s["labels"][:n]
            gt_valid[i, :n] = True
        if with_frame_labels and s.get("gt_frame_labels") is not None:
            frame_labels[i] = s["gt_frame_labels"]
        fps[i] = s["fps"]
        duration[i] = s["duration"]
        feat_stride[i] = s["feat_stride"]
        feat_num_frames[i] = s["feat_num_frames"]
        video_ids.append(s["video_id"])

    batch = {
        "feats": feats, "mask": mask,
        "gt_segments": gt_segments, "gt_labels": gt_labels, "gt_valid": gt_valid,
        "has_gt": gt_valid.any(axis=1),
        "fps": fps, "duration": duration,
        "feat_stride": feat_stride, "feat_num_frames": feat_num_frames,
        "video_ids": video_ids,
    }
    if with_frame_labels:
        batch["frame_labels"] = frame_labels
    return batch

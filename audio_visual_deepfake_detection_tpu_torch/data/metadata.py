"""Metadata of AV-Deepfake1M-style annotation JSONs and shard lists (JAX
``data/metadata.py``), and the row counts the dataset keeps from the audio
feature streams.

- duration = audio_frames / 16000,
- fps = the explicit ``fps`` field, else video_frames / duration,
- segments / labels from ``fake_segments`` (class 0 = "Fake"), None if empty,
- per-modality AV labels from the JSON's file name (real = 1 / fake = 0 per
  modality; unknown names give (-1, -1)).

Each audio feature file is truncated to the rows its video's duration
accounts for: ``int(rate * duration - offset)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

AUDIO_SAMPLE_RATE = 16000

BYOLA_FPS = 12.497
EMOTION_FPS = 50.0
BYOLA_TRUNC_OFFSET = 0.3657
EMOTION_TRUNC_OFFSET = 0.817


@dataclasses.dataclass
class VideoMeta:
    video_id: str
    fps: float
    duration: float
    split: str
    segments: Optional[np.ndarray]   # (N, 2) seconds, or None
    labels: Optional[np.ndarray]     # (N,) int64, or None
    av_labels: Tuple[int, int]


def av_labels_from_name(json_filename: str) -> Tuple[int, int]:
    name = os.path.basename(json_filename)
    table = {
        "fake_video_real_audio.json": (0, 1),
        "fake_video_fake_audio.json": (0, 0),
        "real_video_fake_audio.json": (1, 0),
        "real.json": (1, 1),
    }
    return table.get(name, (-1, -1))


def load_video_meta(json_folder: str, rel_path: str,
                    default_fps: Optional[float] = None) -> VideoMeta:
    with open(os.path.join(json_folder, rel_path), "r") as f:
        value = json.load(f)

    duration = value["audio_frames"] / AUDIO_SAMPLE_RATE
    if default_fps is not None:
        fps = default_fps
    elif "fps" in value:
        fps = value["fps"]
    elif "video_frames" in value:
        fps = value["video_frames"] / duration
    else:
        raise ValueError(f"unknown fps for {rel_path}")

    segments = labels = None
    fake_segments = value.get("fake_segments") or []
    if len(fake_segments) > 0:
        segments = np.asarray(fake_segments, dtype=np.float32).reshape(-1, 2)
        labels = np.zeros((segments.shape[0],), dtype=np.int64)

    return VideoMeta(
        video_id=rel_path.replace(".json", ".mp4"),
        fps=float(fps),
        duration=float(duration),
        split=str(value.get("split", "")).lower(),
        segments=segments,
        labels=labels,
        av_labels=av_labels_from_name(rel_path),
    )


def byola_trunc_rows(duration: float) -> int:
    """Rows kept from a BYOL-A feature file."""
    return int(BYOLA_FPS * duration - BYOLA_TRUNC_OFFSET)


def emotion_trunc_rows(duration: float) -> int:
    """Rows kept from an Emotion2Vec feature file."""
    return int(EMOTION_FPS * duration - EMOTION_TRUNC_OFFSET)


def read_list_file(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def read_test_shard(test_folder: str, sub_index: int) -> List[dict]:
    """The lines ``id.mp4,duration`` of ``deepfake_test_sub{i}.txt``."""
    path = os.path.join(test_folder, f"deepfake_test_sub{sub_index}.txt")
    items = []
    for line in read_list_file(path):
        vid, dur = line.split(",")
        items.append({"id": vid, "duration": float(dur)})
    return items

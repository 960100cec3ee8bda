"""A seeded synthetic feature cache for driving the offline path without
media: per-video ``.npy`` caches of the three streams at their native rates
and widths, a shard list ``deepfake_test_sub<i>.txt``, metadata JSONs of a
labelled split (schema of ``data/metadata.py::load_video_meta``) with its
list file, a config that points at them, and a localizer checkpoint in the
trainer's format. The tests and ``chip_smoke.py`` use it; so can a user
checking an installation.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import yaml

from ..data import metadata as md

AV_NAMES = ("fake_video_fake_audio", "fake_video_real_audio", "real_video_fake_audio")
VIDEO_FPS = 25.0


def write_feature_cache(root: str, n_videos: int, seed: int = 0,
                        dims: Sequence[int] = (256, 2048, 768),
                        duration_range=(4.0, 16.0), extra_durations: Sequence[float] = (),
                        n_labelled: int = 0, split: str = "dev",
                        sub_index: int = 1) -> Dict:
    """Write ``n_videos`` videos of durations uniform in ``duration_range``
    and then one of each of ``extra_durations`` (seconds, on the 16 kHz
    audio grid). Streams: video 25 rows/s, BYOL-A ``byola_trunc_rows`` + 3
    rows (a cache runs a few rows past the truncation), Emotion2Vec 50
    rows/s, standard-normal float32 of widths ``dims``. The first
    ``n_labelled`` videos get metadata JSONs with 0-3 fake segments each,
    listed in ``labelled.txt``; a video without one is named ``real``.
    Returns the paths and the per-video records."""
    rng = np.random.default_rng(seed)
    durs = list(rng.uniform(*duration_range, n_videos)) + list(extra_durations)
    folders = {s: os.path.join(root, s) for s in ("video", "byola", "emotion")}
    test_folder = os.path.join(root, "test_folder")
    json_folder = os.path.join(root, "metadata")
    os.makedirs(test_folder, exist_ok=True)
    records: List[Dict] = []
    for i, dur in enumerate(durs):
        audio_frames = int(round(dur * md.AUDIO_SAMPLE_RATE))
        dur = audio_frames / md.AUDIO_SAMPLE_RATE
        n_seg = int(rng.integers(0, 4)) if i < n_labelled else 0
        name = AV_NAMES[i % len(AV_NAMES)] if n_seg else "real"
        rel = f"{split}/id{i:05d}/{name}"
        rows = (int(round(VIDEO_FPS * dur)), md.byola_trunc_rows(dur) + 3,
                int(md.EMOTION_FPS * dur))
        for folder, n, c in zip(folders.values(), rows, dims):
            os.makedirs(os.path.join(folder, os.path.dirname(rel)), exist_ok=True)
            np.save(os.path.join(folder, rel + ".npy"),
                    rng.standard_normal((n, c), dtype=np.float32))
        segments = []
        for _ in range(n_seg):
            start = float(rng.uniform(0.0, dur - 1.0))
            segments.append([round(start, 3),
                             round(start + float(rng.uniform(0.2, min(3.0, dur - start))), 3)])
        rec = {"rel": rel, "id": rel + ".mp4", "duration": dur, "video_rows": rows[0],
               "fake_segments": segments}
        if i < n_labelled:
            path = os.path.join(json_folder, rel + ".json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({"audio_frames": audio_frames, "video_frames": rows[0],
                           "fake_segments": segments, "split": split}, f)
        records.append(rec)
    write_shard_list(test_folder, sub_index, records)
    labelled_txt = os.path.join(root, "labelled.txt")
    with open(labelled_txt, "w") as f:
        f.write("\n".join(r["rel"] + ".json" for r in records[:n_labelled]))
    return {"folders": folders, "test_folder": test_folder, "json_folder": json_folder,
            "labelled_txt": labelled_txt, "records": records}


def write_shard_list(test_folder: str, sub_index: int, records: Sequence[Dict]) -> str:
    """``deepfake_test_sub<sub_index>.txt`` over the videos of ``records``."""
    path = os.path.join(test_folder, f"deepfake_test_sub{sub_index}.txt")
    with open(path, "w") as f:
        f.write("\n".join(f"{r['id']},{r['duration']!r}" for r in records))
    return path


def merge(dst: Dict, src: Dict) -> Dict:
    """``src`` merged into ``dst`` key by key, nested mappings recursively;
    returns ``dst``."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def write_config(base_yaml: str, out_path: str, cache: Dict, output_folder: str,
                 overrides: Optional[Dict] = None) -> str:
    """``base_yaml`` with its dataset pointed at ``cache`` (the return of
    :func:`write_feature_cache`) and its output at ``output_folder``, then
    ``overrides`` merged in. Returns ``out_path``."""
    with open(base_yaml) as f:
        config = yaml.safe_load(f)
    merge(config, {
        "dataset": {
            "video_feat_folder": cache["folders"]["video"],
            "audio_byola_feat_folder": cache["folders"]["byola"],
            "audio_emo_feat_folder": cache["folders"]["emotion"],
            "test_folder": cache["test_folder"],
            "json_folder": cache["json_folder"],
            "train_txt": cache["labelled_txt"],
        },
        "output_folder": output_folder,
    })
    merge(config, overrides or {})
    with open(out_path, "w") as f:
        yaml.safe_dump(config, f)
    return out_path


def write_checkpoint(folder: str, model, config: Dict, ema_state: Optional[Dict] = None,
                     epoch: int = 1) -> str:
    """Save ``model`` through the trainer's ``save_checkpoint`` (a fresh
    optimizer from ``config['opt']``), with ``ema_state`` as its EMA weights
    (default: the model's own). Returns the file written."""
    from ..train import TrainState, make_optimizer, save_checkpoint

    tx, _ = make_optimizer(model, config["opt"], 1, config["train_cfg"]["clip_grad_l2norm"])
    device = next(model.parameters()).device
    state = TrainState.create(model, tx, config["train_cfg"]["init_loss_norm"],
                              torch.Generator(device=device).manual_seed(0))
    if ema_state is not None:
        with torch.no_grad():
            for name, value in ema_state.items():
                state.ema_params[name].copy_(value)
    return save_checkpoint(folder, epoch, state)

"""Shard merge and the submission files (JAX ``infer/results.py``).

- ``write_video_predictions`` -> prediction.txt: per video the sigmoid of
  its logit, 1.0 above 0.9, one line per id, sorted,
- ``write_segment_predictions`` -> prediction.json: {vid: [[score, s, e],
  ...]} with the segments of score > 0.2, else the [[0, 0, 0]] sentinel.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List

import numpy as np

SCORE_FILTER = 0.2
PROB_CLAMP = 0.9


def _sigmoid(x: float) -> float:
    return float(1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64))))


def iter_shard_items(base_folder: str, num_shards: int = 7) -> Iterable[dict]:
    """Result items of ``<base>/<i>/[host<k>/]data*.json`` over the shards
    (the ``host<k>`` level holds a multi-host run's per-host folders)."""
    for subi in range(1, num_shards + 1):
        shard_dir = os.path.join(base_folder, str(subi))
        json_files = sorted(glob.glob(os.path.join(shard_dir, "*.json"))) + \
            sorted(glob.glob(os.path.join(shard_dir, "host*", "*.json")))
        for json_file in json_files:
            with open(json_file, "r", encoding="utf-8") as f:
                for item in json.load(f):
                    yield item


def write_video_predictions(items: Iterable[dict], out_path: str) -> int:
    """prediction.txt: '<video_id>;<prob>' lines."""
    seen = set()
    rows: List[List[str]] = []
    for item in items:
        vid = item["video_id"]
        if vid in seen:
            continue
        seen.add(vid)
        raw = item["video_cls"]
        val = raw[0] if isinstance(raw, (list, tuple)) else raw
        prob = _sigmoid(val)
        if prob > PROB_CLAMP:
            prob = 1.0
        rows.append([vid, str(prob)])
    rows.sort(key=lambda r: r[0])
    with open(out_path, "w") as f:
        f.write("\n".join(";".join(r) for r in rows))
    return len(rows)


def write_segment_predictions(items: Iterable[dict], out_path: str,
                              score_filter: float = SCORE_FILTER) -> int:
    """prediction.json: {vid: [[score, start, end], ...]} with the > 0.2
    filter and the [[0, 0, 0]] sentinel of a video with none left."""
    result: Dict[str, list] = {}
    seen = set()
    for item in items:
        vid = item["video_id"]
        if vid in seen:
            continue
        seen.add(vid)
        keep = []
        for score, seg in zip(item["scores"], item["segments"]):
            if score > score_filter:
                keep.append([score, seg[0], seg[1]])
        if not keep:
            keep.append([0, 0, 0])
        result[vid] = keep
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(result, f, sort_keys=True, ensure_ascii=False, indent=4)
    return len(result)


def generate_results(base_folder: str, num_shards: int = 7):
    """Merge the shards' outputs and write both submission files."""
    items = list(iter_shard_items(base_folder, num_shards))
    n_txt = write_video_predictions(items, os.path.join(base_folder, "prediction.txt"))
    n_json = write_segment_predictions(items, os.path.join(base_folder, "prediction.json"))
    return n_txt, n_json

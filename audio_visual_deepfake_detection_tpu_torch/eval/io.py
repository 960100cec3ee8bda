"""File-based evaluator IO (JAX ``eval/io.py``): ANet-format GT and
prediction JSONs -> flat tables."""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from .detection import remove_duplicate_annotations


def load_gt_seg_from_json(json_file: str, split: Optional[str] = None,
                          label: str = "label_id", label_offset: int = 0
                          ) -> Dict[str, np.ndarray]:
    """ANet-format GT: {'database': {vid: {subset, annotations: [{segment,
    label_id}]}}} -> flat table."""
    with open(json_file) as f:
        data = json.load(f)
    db = data["database"]
    vids, ts, te, labels = [], [], [], []
    for vid, value in db.items():
        if split is not None and value.get("subset", "").lower() != split.lower():
            continue
        ants = remove_duplicate_annotations(value.get("annotations", []))
        for ev in ants:
            vids.append(vid)
            ts.append(float(ev["segment"][0]))
            te.append(float(ev["segment"][1]))
            labels.append(int(ev[label]) + label_offset)
    return {"video-id": np.asarray(vids), "t-start": np.asarray(ts),
            "t-end": np.asarray(te), "label": np.asarray(labels, np.int64)}


def load_pred_seg_from_json(json_file: str, label: str = "label_id",
                            label_offset: int = 0) -> Dict[str, np.ndarray]:
    """ANet-format predictions: {'results': {vid: [{segment, label, score}]}}."""
    with open(json_file) as f:
        data = json.load(f)
    results = data.get("results", data)
    vids, ts, te, labels, scores = [], [], [], [], []
    for vid, props in results.items():
        for p in props:
            vids.append(vid)
            ts.append(float(p["segment"][0]))
            te.append(float(p["segment"][1]))
            lab = p.get(label, p.get("label", 0))
            labels.append(int(lab) + label_offset if not isinstance(lab, str) else 0)
            scores.append(float(p["score"]))
    return {"video-id": np.asarray(vids), "t-start": np.asarray(ts),
            "t-end": np.asarray(te), "label": np.asarray(labels, np.int64),
            "score": np.asarray(scores)}

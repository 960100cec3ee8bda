"""Challenge-format evaluation (JAX ``eval/challenge.py``).

``run_evaluation`` takes the flat prediction table + in-memory GT records,
builds the ANet-style proposal JSON (per-video top-100, score multiplied by
the best external video-cls score when provided), evaluates mAP at the pinned
tIoU thresholds {0.5, 0.75, 0.9, 0.95}, and writes the JSON + a .txt summary.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .detection import ANETdetection, CHALLENGE_TIOUS


def build_proposal_json(
    preds: Dict[str, np.ndarray],
    cls_scores: Optional[Dict[str, Sequence[float]]] = None,
    top_per_video: int = 100,
) -> Dict:
    """Per-video proposal lists (eval.py:103-145).

    NOTE: like the reference (`detection_thread`, eval.py:110 `range(min(100,
    len(df)))`), this keeps each video's FIRST ``top_per_video`` rows in
    table order, not the top-scoring ones — the internal pipeline feeds it
    score-descending NMS output, for which the two are identical. Sort your
    table per video by score first if it comes from anywhere else."""
    by_vid: Dict[str, List] = {}
    vids = np.asarray(preds["video-id"])
    for i, vid in enumerate(vids):
        by_vid.setdefault(vid, []).append(i)

    results = {}
    for vid, idxs in by_vid.items():
        best = 1.0
        if cls_scores is not None and vid in cls_scores:
            best = float(np.max(np.asarray(cls_scores[vid])))
        props = []
        for i in idxs[:top_per_video]:
            props.append({
                "label": "Fake",
                "score": float(preds["score"][i]) * best,
                "segment": [max(0.0, float(preds["t-start"][i])),
                            float(preds["t-end"][i])],
            })
        results[vid] = props
    return {"version": "ANET v1.3, Lavdf", "results": results, "external_data": {}}


def evaluation_proposal(preds, gt_records, tiou_thre=None, max_avg_nr_proposal=100):
    """AR@{10,20,50,100} summary (reference Evaluation/eval.py:62-84)."""
    from .detection import average_recall_vs_nr_proposals

    tious = tiou_thre if tiou_thre is not None else np.linspace(0.5, 0.95, 10)
    gt = {"video-id": [], "t-start": [], "t-end": []}
    for rec in gt_records:
        if rec.get("n_fakes", 0) == 0 or rec.get("segments_time") is None:
            continue
        for seg in np.asarray(rec["segments_time"]).reshape(-1, 2):
            gt["video-id"].append(rec["video_id"].strip())
            gt["t-start"].append(float(seg[0]))
            gt["t-end"].append(float(seg[1]))
    gt = {k: np.asarray(v) for k, v in gt.items()}
    recall, _, _ = average_recall_vs_nr_proposals(
        gt, preds, tious, max_avg_nr_proposal)
    ar = {n: float(np.mean(recall[:, n - 1])) for n in (10, 20, 50, 100)
          if n <= recall.shape[1]}
    return ar


def run_evaluation(
    preds: Dict[str, np.ndarray],
    gt_records: Sequence[dict],
    proposal_file: str,
    tiou_thre: np.ndarray = CHALLENGE_TIOUS,
    cls_score_file: Optional[str] = None,
    verbose: bool = True,
):
    """Returns (mAP*100, 0.1) like the reference (eval.py:147-164)."""
    cls_scores = None
    if cls_score_file is not None:
        with open(cls_score_file) as f:
            cls_scores = json.load(f)

    proposal = build_proposal_json(preds, cls_scores)
    os.makedirs(os.path.dirname(os.path.abspath(proposal_file)), exist_ok=True)
    with open(proposal_file, "w") as f:
        json.dump(proposal, f)

    evaluator = ANETdetection(gt_records, tiou_thresholds=tiou_thre)
    flat = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
    for vid, props in proposal["results"].items():
        for p in props:
            flat["video-id"].append(vid)
            flat["t-start"].append(p["segment"][0])
            flat["t-end"].append(p["segment"][1])
            flat["label"].append(0)
            flat["score"].append(p["score"])
    flat = {k: np.asarray(v) for k, v in flat.items()}
    _, mAP, avg = evaluator.evaluate(flat, verbose=verbose)

    summary = (f"Detection: average-mAP {avg * 100:.3f} " +
               " ".join(f"mAP@{t:.2f} {m * 100:.3f}"
                        for t, m in zip(evaluator.tiou_thresholds, mAP)))
    with open(proposal_file.replace(".json", ".txt"), "a") as f:
        f.write(summary + "\n")
    return float(np.mean(mAP)) * 100, 0.1

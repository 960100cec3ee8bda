"""Temporal detection metrics: interpolated AP / mAP and AR@N (JAX
``eval/detection.py``).

Vectorized numpy versions of the reference's two evaluators:
- the challenge evaluator, tIoU thresholds pinned to {0.5, 0.75, 0.9, 0.95},
- the EPIC-style ANETdetection with configurable thresholds and top-k
  recall.

Both take the VOC-2011 interpolated AP over greedy score-ordered matching.
The matching runs in the native OpenMP matcher (``runtime/host_match.py``),
or in its serial Python twin when the caller passes ``native=False``; a
failed native build raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

CHALLENGE_TIOUS = np.array([0.5, 0.75, 0.9, 0.95])


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """IoU of one (2,) segment against (N, 2) candidates."""
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(tt2 - tt1, 0, None)
    union = (candidates[:, 1] - candidates[:, 0]) + (target[1] - target[0]) - inter
    return inter.astype(np.float64) / union


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """VOC-2011 interpolated AP (vectorized: the reference's right-to-left
    running max, Evaluation/utils.py:34-43, is a reversed cummax)."""
    mprec = np.concatenate([[0], prec, [0]])
    mrec = np.concatenate([[0], rec, [1]])
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def _match_one_video(args):
    """Greedy TP/FP match flags for one video's predictions (already in
    descending score order). Matching only interacts with other predictions of
    the SAME video through the GT locks, so videos are independent units —
    this is what makes the evaluator parallelizable at 343k-video scale
    (the reference parallelizes per class via joblib, eval_detection.py)."""
    p_seg, g_seg, tious_thr = args
    npred = len(p_seg)
    tp = np.zeros((len(tious_thr), npred), dtype=np.float64)
    if len(g_seg) == 0:
        return tp
    lock = -np.ones((len(tious_thr), len(g_seg)))
    for idx in range(npred):
        tious = segment_iou(p_seg[idx], g_seg)
        # deterministic tie rule (earlier GT index wins) shared with the
        # native matcher (runtime/csrc/match.cpp); the reference's
        # `argsort()[::-1]` leaves ties to quicksort's whim
        srt = np.argsort(-tious, kind="stable")
        for tidx, thr in enumerate(tious_thr):
            for j in srt:
                if tious[j] < thr:
                    break
                if lock[tidx, j] >= 0:
                    continue
                tp[tidx, idx] = 1
                lock[tidx, j] = idx
                break
    return tp


def _factorize_ids(ids: np.ndarray) -> np.ndarray:
    """Factorize an array of ids to int64 codes (first-unique-wins order is
    NOT guaranteed — codes are arbitrary but consistent). For numpy unicode /
    bytes dtypes, sorts the ids as packed uint64 words (radix-friendly) —
    ~10x faster than np.unique on the strings at 34M rows."""
    ids = np.asarray(ids)
    if ids.dtype.kind == "U":
        try:
            ids = ids.astype(f"S{ids.dtype.itemsize // 4}")
        except UnicodeEncodeError:  # non-ASCII ids
            ids = np.char.encode(ids, "utf-8")
    if ids.dtype.kind != "S":  # object arrays etc. — generic fallback
        _, codes = np.unique(ids, return_inverse=True)
        return codes.astype(np.int64)
    nwords = max(-(-ids.dtype.itemsize // 8), 1)
    padded = ids.astype(f"S{nwords * 8}", copy=False)
    words = padded.view(np.uint64).reshape(len(ids), nwords)
    idx = np.lexsort(words.T[::-1])
    srows = words[idx]
    boundary = np.any(srows[1:] != srows[:-1], axis=1)
    codes_sorted = np.concatenate([[0], np.cumsum(boundary, dtype=np.int64)])
    codes = np.empty(len(ids), np.int64)
    codes[idx] = codes_sorted
    return codes


def _match_all_python(p_seg, p_code, g_seg, g_code, tiou_thresholds):
    """Per-video greedy matching in Python (the native matcher's twin).
    ``*_code`` are factorized video indices; ``p_seg`` rows are in
    descending score order."""
    gt_by_vid: Dict[int, List[int]] = {}
    for i, v in enumerate(g_code):
        gt_by_vid.setdefault(int(v), []).append(i)
    pred_by_vid: Dict[int, List[int]] = {}
    for i, v in enumerate(p_code):
        pred_by_vid.setdefault(int(v), []).append(i)

    tasks = []
    index_map = []
    for vid, p_idx in pred_by_vid.items():
        g_idx = gt_by_vid.get(vid, [])
        tasks.append((p_seg[np.asarray(p_idx)],
                      g_seg[np.asarray(g_idx)] if g_idx else np.zeros((0, 2)),
                      np.asarray(tiou_thresholds)))
        index_map.append(np.asarray(p_idx))

    results = [_match_one_video(t) for t in tasks]

    tp = np.zeros((len(tiou_thresholds), len(p_code)))
    for p_idx, flags in zip(index_map, results):
        tp[:, p_idx] = flags
    return tp


def _match_all_native(p_seg, p_code, g_seg, g_code, tiou_thresholds, n_threads):
    """Group by video (stable, preserving score order) and run the OpenMP
    matcher; returns TP flags back in score order."""
    from ..runtime.host_match import host_match_tp

    nvid = int(max(p_code.max(initial=-1), g_code.max(initial=-1))) + 1
    grp = np.argsort(p_code, kind="stable")
    p_off = np.zeros(nvid + 1, np.int64)
    np.cumsum(np.bincount(p_code, minlength=nvid), out=p_off[1:])
    g_grp = np.argsort(g_code, kind="stable")
    g_off = np.zeros(nvid + 1, np.int64)
    np.cumsum(np.bincount(g_code, minlength=nvid), out=g_off[1:])

    tp_grouped = host_match_tp(p_seg[grp], p_off, g_seg[g_grp], g_off,
                               np.asarray(tiou_thresholds),
                               n_threads=max(n_threads, 0))
    tp = np.zeros((len(tiou_thresholds), len(p_code)))
    tp[:, grp] = tp_grouped
    return tp


def average_precision(
    gt: Dict[str, np.ndarray],
    pred: Dict[str, np.ndarray],
    tiou_thresholds: np.ndarray,
    native: bool = True,
) -> np.ndarray:
    """AP per tIoU threshold for one class.

    gt: {'video-id': array str, 't-start', 't-end'}
    pred: same plus 'score'. Matching: predictions in descending score order,
    each grabs the highest-IoU unclaimed GT above the threshold.

    ``native`` (default) takes the OpenMP matcher
    (``runtime/csrc/match.cpp``: seconds at the 343k-video challenge scale;
    its build raises if g++ fails); ``native=False`` the serial Python
    matcher, its reference.
    """
    ap = np.zeros(len(tiou_thresholds))
    npred = len(pred["score"])
    npos = len(gt["t-start"])
    if npred == 0 or npos == 0:
        return ap

    order = np.argsort(pred["score"])[::-1]
    p_seg = np.stack([np.asarray(pred["t-start"], np.float64)[order],
                      np.asarray(pred["t-end"], np.float64)[order]], axis=1)
    g_vid = np.asarray(gt["video-id"])
    g_seg = np.stack([np.asarray(gt["t-start"], np.float64),
                      np.asarray(gt["t-end"], np.float64)], axis=1)

    # factorize video ids once: string comparisons are the slow part at 34M
    # rows (np.unique on shuffled '<U17' measured 173s; pd.factorize 52s —
    # pandas round-trips through object dtype), so sort fixed-width BYTES
    # viewed as uint64 words instead, and gather int codes through the score
    # order rather than gathering strings
    all_vid = np.concatenate([np.asarray(pred["video-id"]), g_vid])
    codes = _factorize_ids(all_vid)
    p_code = codes[:npred][order]
    g_code = codes[npred:]

    if native:
        tp = _match_all_native(p_seg, p_code, g_seg, g_code,
                               tiou_thresholds, n_threads=0)
    else:
        tp = _match_all_python(p_seg, p_code, g_seg, g_code, tiou_thresholds)
    # every prediction is TP or FP, so tp_cs + fp_cs == 1..npred identically —
    # no need to materialize fp (1.1 GB at challenge scale)
    tp_cs = np.cumsum(tp, axis=1)
    rec = tp_cs / npos
    prec = tp_cs / np.arange(1, npred + 1, dtype=np.float64)
    for tidx in range(len(tiou_thresholds)):
        ap[tidx] = interpolated_prec_rec(prec[tidx], rec[tidx])
    return ap


class ANETdetection:
    """mAP evaluator over in-memory GT/prediction tables.

    GT entries follow the reference's in-memory format
    (Evaluation/eval_detection.py:87-115): a list of dicts with ``video_id``,
    ``n_fakes`` and ``segments_time`` (seconds); videos with n_fakes == 0 are
    skipped.
    """

    def __init__(self, gt_records: Sequence[dict],
                 tiou_thresholds: np.ndarray = CHALLENGE_TIOUS,
                 num_classes: int = 1, native: bool = True):
        self.tiou_thresholds = np.asarray(tiou_thresholds, dtype=np.float64)
        self.num_classes = num_classes
        self.native = native
        vids, ts, te, lab = [], [], [], []
        for rec in gt_records:
            if rec.get("n_fakes", 0) == 0 or rec.get("segments_time") is None:
                continue
            for seg in np.asarray(rec["segments_time"]).reshape(-1, 2):
                vids.append(rec["video_id"].strip())
                ts.append(float(seg[0]))
                te.append(float(seg[1]))
                lab.append(0)
        self.gt = {
            "video-id": np.asarray(vids),
            "t-start": np.asarray(ts, np.float64),
            "t-end": np.asarray(te, np.float64),
            "label": np.asarray(lab, np.int64),
        }

    def evaluate(self, preds: Dict[str, np.ndarray], verbose: bool = False,
                 top_k: Sequence[int] = ()):
        """preds: {'video-id','t-start','t-end','label','score'} arrays.
        Returns (ap (T, C), mAP per tIoU, average mAP). Pass ``top_k``
        (e.g. (1, 5)) to also populate ``self.recall`` with top-kx recall
        (the EPIC-style evaluator's extra metric, metrics.py:179-253)."""
        labels = np.asarray(preds.get("label", np.zeros(len(preds["score"]))))
        ap = np.zeros((len(self.tiou_thresholds), self.num_classes))
        self.recall = (np.zeros((len(self.tiou_thresholds), len(top_k),
                                 self.num_classes)) if top_k else None)
        for c in range(self.num_classes):
            sel = labels == c
            gt_sel = self.gt["label"] == c
            if self.num_classes == 1 and sel.all() and gt_sel.all():
                # single-class challenge path: skip the per-class copies
                # (a 34M-row string gather costs ~10s at challenge scale)
                gt_c = {k: np.asarray(self.gt[k]) for k in
                        ("video-id", "t-start", "t-end")}
                pred_c = {k: np.asarray(preds[k]) for k in
                          ("video-id", "t-start", "t-end", "score")}
            else:
                gt_c = {k: np.asarray(self.gt[k])[gt_sel] for k in
                        ("video-id", "t-start", "t-end")}
                pred_c = {k: np.asarray(preds[k])[sel] for k in
                          ("video-id", "t-start", "t-end", "score")}
            ap[:, c] = average_precision(gt_c, pred_c, self.tiou_thresholds,
                                         native=self.native)
            if top_k:
                self.recall[..., c] = topkx_recall(
                    gt_c, pred_c, self.tiou_thresholds, top_k)
        mAP = ap.mean(axis=1)
        avg = float(mAP.mean())
        if verbose:
            per = " ".join(f"mAP@{t:.2f} {m * 100:.3f}"
                           for t, m in zip(self.tiou_thresholds, mAP))
            print(f"Detection: average-mAP {avg * 100:.3f} {per}")
        return ap, mAP, avg


def topkx_recall(
    gt: Dict[str, np.ndarray],
    pred: Dict[str, np.ndarray],
    tiou_thresholds: np.ndarray,
    top_k: Sequence[int] = (1, 5),
) -> np.ndarray:
    """Top-kx recall (libs/utils/metrics.py:338-401): per video keep the
    k * n_gt highest-scoring predictions; a GT counts as recalled if any kept
    prediction reaches the tIoU threshold. Returns (T, K)."""
    tp = np.zeros((len(tiou_thresholds), len(top_k)))
    if len(pred["score"]) == 0 or len(gt["t-start"]) == 0:
        return tp

    gt_by_vid: Dict[str, list] = {}
    for i, v in enumerate(np.asarray(gt["video-id"])):
        gt_by_vid.setdefault(v, []).append(i)
    pred_by_vid: Dict[str, list] = {}
    for i, v in enumerate(np.asarray(pred["video-id"])):
        pred_by_vid.setdefault(v, []).append(i)

    g_seg = np.stack([np.asarray(gt["t-start"]), np.asarray(gt["t-end"])], axis=1)
    p_seg = np.stack([np.asarray(pred["t-start"]), np.asarray(pred["t-end"])], axis=1)
    scores = np.asarray(pred["score"])

    n_gts = 0
    for vid, g_idx in gt_by_vid.items():
        n_gts += len(g_idx)
        p_idx = pred_by_vid.get(vid)
        if not p_idx:
            continue
        p_idx = np.asarray(p_idx)
        order = np.argsort(scores[p_idx])[::-1]
        kept = p_idx[order][: max(top_k) * len(g_idx)]
        # (n_kept, n_gt) IoU matrix
        ious = np.stack([segment_iou(p_seg[j], g_seg[np.asarray(g_idx)])
                         for j in kept]) if len(kept) else np.zeros((0, len(g_idx)))
        for tidx, thr in enumerate(tiou_thresholds):
            for kidx, k in enumerate(top_k):
                sub = ious[: k * len(g_idx)]
                if sub.size:
                    tp[tidx, kidx] += ((sub >= thr).sum(axis=0) > 0).sum()
    return tp / max(n_gts, 1)


def average_recall_vs_nr_proposals(
    gt: Dict[str, np.ndarray],
    proposals: Dict[str, np.ndarray],
    tiou_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10),
    max_avg_nr_proposals: int = 100,
):
    """AR@AN following Evaluation/eval_proposal.py:235-346: per-video proposal
    budgets are a *ratio* of each video's retrieved proposals (so the average
    across videos hits the requested budget), recall counts GTs matched by any
    kept proposal. Returns (recall (T, N), avg_recall (N,),
    proposals_per_video (N,))."""
    by_vid_gt: Dict[str, list] = {}
    for i, v in enumerate(np.asarray(gt["video-id"])):
        by_vid_gt.setdefault(v, []).append([gt["t-start"][i], gt["t-end"][i]])
    by_vid_prop: Dict[str, list] = {}
    order = np.argsort(np.asarray(proposals["score"]))[::-1]
    vid_arr = np.asarray(proposals["video-id"])
    for i in order:
        by_vid_prop.setdefault(vid_arr[i], []).append(
            [proposals["t-start"][i], proposals["t-end"][i]])

    n_videos = max(len(by_vid_gt), 1)
    total_props = max(len(proposals["score"]), 1)
    ratio = max_avg_nr_proposals * float(n_videos) / total_props

    score_lst = []
    total_kept = 0
    for v, gts in by_vid_gt.items():
        gts = np.asarray(gts, np.float64)
        props = np.asarray(by_vid_prop.get(v, []), np.float64).reshape(-1, 2)
        if len(props) == 0:
            score_lst.append(np.zeros((len(gts), 1)))
            continue
        keep = min(int(len(props) * ratio), len(props))
        total_kept += keep
        props = props[:keep]
        score_lst.append(np.stack([segment_iou(g, props) for g in gts]))

    total_kept = max(total_kept, 1)
    pcn_lst = (np.arange(1, max_avg_nr_proposals + 1) / float(max_avg_nr_proposals)
               * (max_avg_nr_proposals * float(n_videos) / total_kept))
    positives = np.asarray([s.shape[0] for s in score_lst], np.float64)
    recall = np.empty((len(tiou_thresholds), len(pcn_lst)))
    matches = np.empty((len(score_lst), len(pcn_lst)))
    for ridx, thr in enumerate(tiou_thresholds):
        for i, score in enumerate(score_lst):
            tp = score >= thr
            pcn_props = np.minimum((score.shape[1] * pcn_lst).astype(np.int64),
                                   score.shape[1])
            for j, k in enumerate(pcn_props):
                matches[i, j] = np.count_nonzero(tp[:, :k].sum(axis=1))
        recall[ridx, :] = matches.sum(axis=0) / positives.sum()

    avg_recall = recall.mean(axis=0)
    proposals_per_video = pcn_lst * (float(total_kept) / n_videos)
    return recall, avg_recall, proposals_per_video


def remove_duplicate_annotations(ants: Sequence[dict], tol: float = 1e-3) -> List[dict]:
    """Drop zero-length and duplicate events (metrics.py:13-31)."""
    valid: List[dict] = []
    for ev in ants:
        s, e = ev["segment"][0], ev["segment"][1]
        lab = ev["label_id"]
        ok = (e - s) >= tol
        for p in valid:
            if (abs(s - p["segment"][0]) <= tol and abs(e - p["segment"][1]) <= tol
                    and lab == p["label_id"]):
                ok = False
                break
        if ok:
            valid.append(ev)
    return valid


def results_to_array(preds: Dict[str, np.ndarray], num_pred: int = 200
                     ) -> Dict[str, dict]:
    """Flat prediction table -> per-video arrays sorted by score desc and
    truncated to ``num_pred`` (libs/utils/postprocessing.py:56-95) — the
    input format of :func:`postprocess_results_with_cls`."""
    out: Dict[str, dict] = {}
    vids = np.asarray(preds["video-id"])
    for vid in sorted(set(vids.tolist())):
        idx = np.nonzero(vids == vid)[0]
        score = np.asarray(preds["score"], np.float64)[idx]
        order = np.argsort(score)[::-1][:num_pred]
        keep = idx[order]
        out[vid] = {
            "label": np.asarray(preds["label"])[keep],
            "score": score[order],
            "segment": np.stack([np.asarray(preds["t-start"], np.float64)[keep],
                                 np.asarray(preds["t-end"], np.float64)[keep]],
                                axis=1),
        }
    return out


def postprocess_results_with_cls(
    results: Dict[str, dict], cls_scores: Dict[str, Sequence[float]],
    num_pred: int = 200, topk: int = 2,
) -> Dict[str, np.ndarray]:
    """External classification fusion (libs/utils/postprocessing.py:97-155):
    duplicate each segment across the top-k external classes with score
    sqrt(cls_score * seg_score)."""
    out = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
    for vid, result in results.items():
        cls = np.asarray(cls_scores[vid])
        top_idx = np.argsort(cls)[::-1][:topk]
        top_score = cls[top_idx]
        # a video may carry fewer external classes than topk — every column
        # must use the ACTUAL k or the parallel arrays diverge in length
        k = len(top_idx)
        score = np.asarray(result["score"])[:num_pred]
        seg = np.asarray(result["segment"])[:num_pred]
        n = len(score)
        out["video-id"].extend([vid] * n * k)
        out["t-start"].append(np.tile(seg[:, 0], k))
        out["t-end"].append(np.tile(seg[:, 1], k))
        out["label"].append(np.repeat(top_idx, n))
        out["score"].append(np.sqrt(top_score[:, None] * score[None, :]).flatten())
    for key in ("t-start", "t-end", "label", "score"):
        out[key] = np.concatenate(out[key]) if out[key] else np.zeros((0,))
    out["video-id"] = np.asarray(out["video-id"])
    return out

"""Batched 1-D soft-NMS / NMS / segment voting with static shapes
(JAX ``ops/nms.py``).

Every function takes a leading batch dimension where the JAX package used
``vmap``. ``soft_nms`` runs the fixed ``max_out`` trips with no host sync
per trip: once no candidate is alive a trip writes an empty slot, which is
what the JAX early-exit loop leaves there, so the outputs are identical.
``argmax`` returns the first maximum, as in JAX.
"""

from __future__ import annotations

import torch

AREA_EPS = 1e-6  # the reference adds 1e-6 to segment areas


def _iou_1d(seg: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """IoU of (B, 2) picks against (B, N, 2) segments, reference epsilon."""
    x1 = torch.maximum(seg[:, None, 0], segs[..., 0])
    x2 = torch.minimum(seg[:, None, 1], segs[..., 1])
    inter = torch.clamp(x2 - x1, min=0.0)
    area_i = seg[:, 1] - seg[:, 0] + AREA_EPS
    areas = segs[..., 1] - segs[..., 0] + AREA_EPS
    return inter / (area_i[:, None] + areas - inter)


def soft_nms(segs: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             max_out: int, iou_threshold: float = 0.1, sigma: float = 0.5,
             min_score: float = 0.001, method: str = "gaussian"):
    """Greedy (soft-)NMS over (B, N) candidates. Returns (segs (B, K, 2),
    scores (B, K), valid (B, K)) in selection order."""
    b, n = scores.shape
    cur = torch.where(valid, scores, torch.full_like(scores, -1.0))
    alive = valid.clone()
    out_segs = segs.new_zeros((b, max_out, 2))
    out_scores = scores.new_zeros((b, max_out))
    out_valid = torch.zeros((b, max_out), dtype=torch.bool, device=scores.device)
    rows = torch.arange(b, device=scores.device)
    neg = torch.full_like(cur, -1.0)
    for s in range(max_out):
        j = torch.argmax(torch.where(alive, cur, neg), dim=1)
        picked_ok = alive[rows, j]
        pick = segs[rows, j]
        out_segs[:, s] = torch.where(picked_ok[:, None], pick, 0.0)
        out_scores[:, s] = torch.where(picked_ok, cur[rows, j], 0.0)
        out_valid[:, s] = picked_ok
        alive[rows, j] = False
        ovr = _iou_1d(pick, segs)
        if method == "hard":
            # vanilla NMS: suppression removes, scores stay untouched
            alive = alive & torch.where(picked_ok[:, None], ovr < iou_threshold, True)
            continue
        if method == "gaussian":
            weight = torch.exp(-(ovr * ovr) / sigma)
        else:  # linear
            weight = torch.where(ovr >= iou_threshold, 1.0 - ovr, 1.0)
        cur = torch.where(alive & picked_ok[:, None], cur * weight, cur)
        alive = alive & (cur >= min_score)
    return out_segs, out_scores, out_valid


def seg_voting(nms_segs: torch.Tensor, nms_valid: torch.Tensor,
               all_segs: torch.Tensor, all_scores: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Each survivor (B, K, 2) becomes the score*iou-weighted mean of all
    candidates (B, N, 2) with IoU >= threshold."""
    left = torch.maximum(nms_segs[:, :, None, 0], all_segs[:, None, :, 0])
    right = torch.minimum(nms_segs[:, :, None, 1], all_segs[:, None, :, 1])
    inter = torch.clamp(right - left, min=0.0)
    len_n = nms_segs[..., 1] - nms_segs[..., 0]
    len_a = all_segs[..., 1] - all_segs[..., 0]
    iou = inter / (len_n[:, :, None] + len_a[:, None, :] - inter)
    w = (iou >= iou_threshold).to(all_scores.dtype) * all_scores[:, None, :] * iou
    denom = w.sum(-1, keepdim=True)
    refined = torch.bmm(w, all_segs) / torch.clamp(denom, min=1e-12)
    return torch.where(nms_valid[..., None], refined, nms_segs)


def batched_nms(segs, scores, cls_idxs, valid, *, num_classes: int,
                iou_threshold: float, min_score: float, max_seg_num: int,
                use_soft_nms: bool = True, multiclass: bool = True,
                sigma: float = 0.5, voting_thresh: float = 0.75):
    """Fixed-shape NMS + voting + final sort over (B, N) candidates.
    Returns (segs (B, K, 2), scores (B, K), cls (B, K), valid (B, K))."""
    method = "gaussian" if use_soft_nms else "hard"
    b = segs.shape[0]

    def run_one(sel_valid):
        if not use_soft_nms:
            sel_valid = sel_valid & (scores > min_score)
        return soft_nms(segs, scores, sel_valid, max_seg_num, iou_threshold,
                        sigma, min_score, method)

    if multiclass and num_classes > 1:
        parts = [run_one(valid & (cls_idxs == c)) for c in range(num_classes)]
        o_segs = torch.cat([p[0] for p in parts], 1)
        o_scores = torch.cat([p[1] for p in parts], 1)
        o_valid = torch.cat([p[2] for p in parts], 1)
        o_cls = torch.cat([torch.full((b, max_seg_num), c, dtype=cls_idxs.dtype,
                                      device=segs.device)
                           for c in range(num_classes)], 1)
    else:
        o_segs, o_scores, o_valid = run_one(valid)
        o_cls = torch.zeros((b, max_seg_num), dtype=cls_idxs.dtype, device=segs.device)
        if voting_thresh > 0:
            o_segs = seg_voting(o_segs, o_valid, segs,
                                torch.where(valid, scores, 0.0), voting_thresh)

    # final sort: JAX's stable ascending argsort, reversed
    key = torch.where(o_valid, o_scores, -1.0)
    order = torch.argsort(key, dim=1, stable=True).flip(1)[:, :max_seg_num]
    take = lambda a: torch.gather(a, 1, order)  # noqa: E731
    return (torch.gather(o_segs, 1, order[..., None].expand(-1, -1, 2)),
            take(o_scores), take(o_cls), take(o_valid))

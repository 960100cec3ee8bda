"""Prediction decode + postprocess on the model's device (JAX
``infer/decode.py``): per-level sigmoid, pre-NMS threshold and top-k as
validity flags, offset decode, duration filter, batched soft-NMS + voting,
grid -> seconds and the [0, duration] clamp. Static shapes throughout."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..core.config import TestConfig
from ..ops.nms import batched_nms


def decode_candidates(out_cls: Sequence[torch.Tensor],
                      out_offsets: Sequence[torch.Tensor],
                      fpn_masks: Sequence[torch.Tensor],
                      points: Sequence[torch.Tensor], cfg: TestConfig,
                      num_classes: int):
    """Returns (segs (B, N, 2) feature grid, scores (B, N), cls (B, N),
    valid (B, N)) with N = sum_i T_i * C."""
    segs_all, scores_all, cls_all, valid_all = [], [], [], []
    for logits, offsets, mask, pts in zip(out_cls, out_offsets, fpn_masks, points):
        b, t_i, c = logits.shape
        prob = torch.sigmoid(logits) * mask[..., None].to(logits.dtype)
        flat = prob.reshape(b, t_i * c)
        keep = flat > cfg.pre_nms_thresh
        if t_i * c > cfg.pre_nms_topk:
            kth = torch.topk(flat, cfg.pre_nms_topk, dim=1).values[:, -1]
            keep = keep & (flat >= kth[:, None])
        left = pts[None, :, 0] - offsets[..., 0] * pts[None, :, 3]
        right = pts[None, :, 0] + offsets[..., 1] * pts[None, :, 3]
        keep = keep & torch.repeat_interleave(right - left > cfg.duration_thresh, c, dim=1)
        segs = torch.stack([left, right], dim=-1)
        segs_all.append(torch.repeat_interleave(segs, c, dim=1))
        scores_all.append(flat)
        cls_all.append(torch.arange(c, dtype=torch.int32, device=flat.device
                                    ).repeat(b, t_i))
        valid_all.append(keep)
    return (torch.cat(segs_all, 1), torch.cat(scores_all, 1),
            torch.cat(cls_all, 1), torch.cat(valid_all, 1))


def postprocess_batch(segs, scores, cls_idxs, valid, fps, duration, feat_stride,
                      feat_num_frames, cfg: TestConfig, num_classes: int):
    """NMS + voting + grid -> seconds over the batch; per-video metadata are
    (B,) tensors."""
    if 0 < cfg.nms_pre_topk < segs.shape[1]:
        # lax.top_k's order: descending, the lower index first among ties
        # (torch.topk promises no order among equal scores)
        idx = torch.argsort(torch.where(valid, scores, -torch.inf), dim=1, descending=True,
                            stable=True)[:, :cfg.nms_pre_topk]
        segs = torch.gather(segs, 1, idx[..., None].expand(-1, -1, 2))
        scores, cls_idxs, valid = (torch.gather(a, 1, idx)
                                   for a in (scores, cls_idxs, valid))
    if cfg.nms_method != "none":
        segs, scores, cls_idxs, valid = batched_nms(
            segs, scores, cls_idxs, valid, num_classes=num_classes,
            iou_threshold=cfg.iou_threshold, min_score=cfg.min_score,
            max_seg_num=cfg.max_seg_num, use_soft_nms=cfg.nms_method == "soft",
            multiclass=cfg.multiclass_nms, sigma=cfg.nms_sigma,
            voting_thresh=cfg.voting_thresh)
    else:
        key = torch.where(valid, scores, -1.0)
        order = torch.argsort(key, dim=1, stable=True).flip(1)[:, :cfg.max_seg_num]
        segs = torch.gather(segs, 1, order[..., None].expand(-1, -1, 2))
        scores, cls_idxs, valid = (torch.gather(a, 1, order)
                                   for a in (scores, cls_idxs, valid))
    s = (segs * feat_stride[:, None, None] + 0.5 * feat_num_frames[:, None, None]) \
        / fps[:, None, None]
    s = torch.where(s <= 0.0, 0.0, s)
    dur = duration[:, None, None].expand_as(s)
    s = torch.where(s >= dur, dur, s)
    return s, scores, cls_idxs, valid


def decode_and_postprocess(outputs: Dict, points, fps, duration, feat_stride,
                           feat_num_frames, cfg: TestConfig, num_classes: int):
    segs, scores, cls_idxs, valid = decode_candidates(
        outputs["out_cls"], outputs["out_offsets"], outputs["fpn_masks"],
        points, cfg, num_classes)
    return postprocess_batch(segs, scores, cls_idxs, valid, fps, duration,
                             feat_stride, feat_num_frames, cfg, num_classes)

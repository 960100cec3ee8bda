"""Batched inference: forward + decode + soft-NMS on the model's device
(JAX ``infer/runner.py:31-60, 156-171``)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.config import ArchConfig, TestConfig
from ..models.points import generate_points
from .decode import decode_and_postprocess


def _as_tensor(a, device, dtype=None):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype, non_blocking=True)


def build_inference_fn(cfg: ArchConfig, test_cfg: TestConfig):
    """Returns fn(model, feats, mask, fps, duration, feat_stride,
    feat_num_frames) -> (segs, scores, cls, valid, video_cls), all tensors on
    the model's device. Inputs may be numpy arrays or tensors; ``feats`` is
    (B, T, C) with T a multiple of ``cfg.max_div_factor`` and at least
    ``max_seq_len`` (the point table follows T, the abs-PE re-interpolates
    above ``max_seq_len``)."""

    @torch.inference_mode()
    def fn(model, feats, mask, fps, duration, feat_stride, feat_num_frames):
        dev = next(model.parameters()).device
        t = feats.shape[1]
        assert t % cfg.max_div_factor == 0 and t >= cfg.max_seq_len, (
            f"eval T={t} must be >= max_seq_len and divisible by "
            f"max_div_factor={cfg.max_div_factor}")
        feats = _as_tensor(feats, dev)
        mask = _as_tensor(mask, dev, torch.bool)
        fps, duration, feat_stride, feat_num_frames = (
            _as_tensor(a, dev, torch.float32)
            for a in (fps, duration, feat_stride, feat_num_frames))
        points = generate_points([t // s for s in cfg.fpn_strides],
                                 cfg.fpn_strides, cfg.regression_range, device=dev)
        out = model(feats, mask)
        segs, scores, cls_idxs, valid = decode_and_postprocess(
            out, points, fps, duration, feat_stride, feat_num_frames,
            test_cfg, cfg.num_classes)
        return segs, scores, cls_idxs, valid, out["cls_scores"]

    return fn


def results_to_items(video_ids: List[str], segs, scores, valid, video_cls,
                     n_real: Optional[int] = None) -> List[dict]:
    """Device outputs -> the reference JSON item schema."""
    segs, scores, valid, video_cls = (
        a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        for a in (segs, scores, valid, video_cls))
    items = []
    for i in range(n_real if n_real is not None else len(video_ids)):
        v = valid[i]
        items.append({
            "video_id": video_ids[i],
            "video_cls": video_cls[i].tolist(),
            "scores": scores[i][v].tolist(),
            "segments": segs[i][v].tolist(),
        })
    return items

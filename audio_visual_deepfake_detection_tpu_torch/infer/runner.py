"""Batched inference: forward + decode + soft-NMS on the model's device
(JAX ``infer/runner.py:31-171``)."""

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


def build_online_inference_fn(cfg: ArchConfig, test_cfg: TestConfig,
                              ds_feat_stride: float, ds_num_frames: float):
    """Inference with the per-stream linear resample on the device (JAX
    ``build_online_inference_fn``): the input carries the raw ragged streams
    zero-padded to a cap plus their row counts; resample to ``max_seq_len``,
    concat and the stride arithmetic run on the model's device.

    Returns fn(model, streams, rows, duration) -> (segs, scores, cls, valid,
    video_cls); ``streams`` is a tuple of (B, T_cap_s, C_s) arrays or
    tensors, ``rows`` a matching tuple of (B,) valid row counts; stream 0 is
    the video stream (fps = video_rows / duration)."""
    from ..ops.resample import linear_resample_dynamic

    @torch.inference_mode()
    def fn(model, streams, rows, duration):
        dev = next(model.parameters()).device
        rows = [_as_tensor(r, dev) for r in rows]
        parts = [linear_resample_dynamic(_as_tensor(s, dev, torch.float32), r,
                                         cfg.max_seq_len)
                 for s, r in zip(streams, rows)]
        feats = torch.cat(parts, dim=-1)
        mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=dev)
        duration = _as_tensor(duration, dev, torch.float32)
        video_rows = rows[0].float()
        fps = video_rows / duration
        feat_stride = ((video_rows - 1.0) * ds_feat_stride + ds_num_frames) \
            / cfg.max_seq_len
        points = generate_points(cfg.fpn_lens, cfg.fpn_strides, cfg.regression_range,
                                 device=dev)
        out = model(feats, mask)
        segs, scores, cls_idxs, valid = decode_and_postprocess(
            out, points, fps, duration, feat_stride, feat_stride,
            test_cfg, cfg.num_classes)
        return segs, scores, cls_idxs, valid, out["cls_scores"]

    return fn


def collate_streams(samples: List[dict], caps: List[int]):
    """Batch raw per-stream arrays into zero-padded fixed-cap arrays and row
    counts for ``build_online_inference_fn``."""
    b = len(samples)
    streams, rows = [], []
    for s in range(len(samples[0]["streams"])):
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
    duration = np.asarray([s["duration"] for s in samples], np.float32)
    video_ids = [s["video_id"] for s in samples]
    return tuple(streams), tuple(rows), duration, video_ids


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

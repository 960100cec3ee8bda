"""Batched inference (JAX ``infer/runner.py``): forward + decode + soft-NMS
on the model's device, the collators of the offline sweep, and the sweep
itself (``inference_one_epoch``), which streams the detections to numbered
JSON flushes that survive a preemption and ``--resume``."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import ArchConfig, TestConfig
from ..models.points import generate_points
from .decode import decode_and_postprocess
from .resume import atomic_write_json


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


def host_feats(arrays: Sequence[np.ndarray], t: int, dtype=torch.float32,
               pin: bool = False) -> torch.Tensor:
    """(B, t, C) host tensor in ``dtype`` (pinned when ``pin``) holding the
    (n_i, C) float32 arrays zero-padded to ``t`` rows. A bf16 tensor is
    rounded to nearest even here, as the model's own cast would round it,
    and crosses to the card at half the bytes."""
    out = torch.empty((len(arrays), t, arrays[0].shape[1]), dtype=dtype, pin_memory=pin)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        out[i, a.shape[0]:].zero_()
    return out


def collate_infer_varlen(samples: List[dict], max_div_factor: int, min_len: int,
                         dtype=torch.float32, pin: bool = False):
    """Batch eval samples: features padded to the batch's longest, rounded
    up to a multiple of ``max_div_factor`` and at least ``min_len`` (=
    max_seq_len), with per-sample validity masks. Upsampled samples all have
    max_seq_len rows, which max_div_factor divides: their batch is
    max_seq_len long and its mask all True."""
    lens = [s["feats"].shape[0] for s in samples]
    t = max(max(lens), min_len)
    t = (t + max_div_factor - 1) // max_div_factor * max_div_factor
    mask = np.zeros((len(samples), t), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    return {
        "feats": host_feats([s["feats"] for s in samples], t, dtype, pin),
        "mask": mask,
        "fps": np.asarray([s["fps"] for s in samples], np.float32),
        "duration": np.asarray([s["duration"] for s in samples], np.float32),
        "feat_stride": np.asarray([s["feat_stride"] for s in samples], np.float32),
        "feat_num_frames": np.asarray([s["feat_num_frames"] for s in samples],
                                      np.float32),
        "video_ids": [s["video_id"] for s in samples],
    }


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


def items_to_table(result_items: List[dict]) -> Dict[str, np.ndarray]:
    """Result items -> the flat prediction table the evaluators read
    ({'video-id', 't-start', 't-end', 'label', 'score'} of parallel arrays)."""
    results = {"video-id": [], "t-start": [], "t-end": [], "label": [],
               "score": []}
    for it in result_items:
        scores = np.asarray(it["scores"], np.float64)
        if len(scores) == 0:
            continue
        segs = np.asarray(it["segments"], np.float64).reshape(-1, 2)
        results["video-id"].extend([it["video_id"]] * len(scores))
        results["t-start"].append(segs[:, 0])
        results["t-end"].append(segs[:, 1])
        results["label"].append(np.zeros(len(scores), np.int64))
        results["score"].append(scores)
    for key in ("t-start", "t-end", "label", "score"):
        results[key] = (np.concatenate(results[key])
                        if results[key] else np.zeros((0,)))
    return results


def inference_one_epoch(
    loader_batches,
    infer_fn,
    model,
    output_folder: Optional[str] = None,
    flush_every: int = 5000,
    print_freq: int = 20,
    seen_offset: int = 0,
    preempt=None,
    collect_items: bool = True,
    prefetch_depth: int = 2,
    stats: Optional[Dict[str, float]] = None,
):
    """Stream detections; returns the flat prediction table for evaluation
    and all result items.

    ``loader_batches`` yields collated batches with ``video_ids``: a
    ``streams`` batch goes through ``build_online_inference_fn``'s signature,
    any other through ``build_inference_fn``'s; a batch padded by
    ``pad_batch_to`` keeps only its ``len(video_ids)`` real items.
    ``seen_offset`` shifts the numbered flush names (``data_left<N>.json``),
    so that a resumed shard never overwrites an earlier run's flushes.
    ``preempt`` (a ``train.preempt.PreemptionGuard``): once it is requested,
    the pending results are flushed as a numbered file and the sweep stops
    after the current batch; ``--resume`` then loses no video.

    ``collect_items=False`` returns ``(None, None)`` and keeps nothing
    between flushes: a whole shard's items would grow host memory without
    bound.

    ``prefetch_depth``: batches copied to the model's device ahead of use
    (``train.loop.device_prefetch``, from pinned memory without blocking on
    a card). The copies are queued on the compute stream, so on the card
    batch N+1's copy runs after batch N's compute; what it overlaps is host
    work (the loader, the fetch, the flushes). 0 hands the batches to
    ``infer_fn`` as they come.

    ``stats``, if given, is filled with the sweep's own breakdown: batches,
    videos, seconds, ``wait_s`` (waiting on the loader and the prefetch),
    ``infer_ms`` (``infer_fn`` on the device: CUDA events on a card, the host
    clock elsewhere), ``fetch_s`` (the detections to the host, as items) and
    ``flush_s`` (the JSON writes); and the first batch's share, which holds
    the pipeline's fill: ``first_s`` (the start to its items), ``first_wait_s``
    and ``first_videos``."""
    from ..train.loop import device_prefetch

    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
    device = next(model.parameters()).device
    if prefetch_depth > 0:
        loader_batches = device_prefetch(loader_batches, device, depth=prefetch_depth)
    cuda = device.type == "cuda"
    timing = stats is not None
    events = []
    clock = dict(wait_s=0.0, fetch_s=0.0, flush_s=0.0, host_infer_s=0.0)
    first = dict(first_s=0.0, first_wait_s=0.0, first_videos=0)
    batch_results: List[dict] = []
    all_items: List[dict] = []
    seen = 0
    flushed = 0
    n_batches = 0
    start = time.time()

    def flush(name):
        t0 = time.perf_counter()
        atomic_write_json(os.path.join(output_folder, name), batch_results)
        clock["flush_s"] += time.perf_counter() - t0

    batches = iter(loader_batches)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        clock["wait_s"] += t1 - t0
        video_ids = batch["video_ids"]
        if timing and cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        if "streams" in batch:  # online path (build_online_inference_fn)
            out = infer_fn(model, batch["streams"], batch["rows"], batch["duration"])
        else:
            out = infer_fn(model, batch["feats"], batch["mask"], batch["fps"],
                           batch["duration"], batch["feat_stride"], batch["feat_num_frames"])
        if timing and cuda:
            ev[1].record()
            events.append(ev)
        t2 = time.perf_counter()
        segs, scores, cls_idxs, valid, video_cls = out
        items = results_to_items(video_ids, segs, scores, valid, video_cls,
                                 n_real=len(video_ids))
        t3 = time.perf_counter()
        clock["host_infer_s"] += t2 - t1
        clock["fetch_s"] += t3 - t2
        n_batches += 1
        batch_results.extend(items)
        if collect_items:
            all_items.extend(items)
        seen += len(items)
        if n_batches == 1:
            first = dict(first_s=time.time() - start, first_wait_s=clock["wait_s"],
                         first_videos=seen)

        if output_folder and seen - flushed >= flush_every:
            flush(f"data_left{seen_offset + seen}.json")
            batch_results = []
            flushed = seen
        if (n_batches - 1) % print_freq == 0:
            rate = seen / max(time.time() - start, 1e-6)
            print(f"Infer: {seen} videos, {rate:.1f} videos/s")

        # preemption: flush what is pending as a numbered file (a --resume
        # counts numbered flushes) and stop; hosts share no collectives, so
        # none has to agree
        if preempt is not None and preempt.requested():
            if output_folder and batch_results:
                flush(f"data_left{seen_offset + seen}.json")
                batch_results = []
            preempt.triggered = True
            print(f"Infer: preemption requested, stopped after {seen} "
                  f"videos (resume with --resume)")
            break

    if output_folder and batch_results:
        flush("data_left.json")

    if timing:
        host_infer_s = clock.pop("host_infer_s")
        if cuda:
            torch.cuda.synchronize(device)
            infer_ms = sum(a.elapsed_time(b) for a, b in events)
        else:
            infer_ms = 1e3 * host_infer_s
        stats.update(clock, **first, batches=n_batches, videos=seen,
                     seconds=time.time() - start, infer_ms=infer_ms)
    if not collect_items:
        return None, None
    return items_to_table(all_items), all_items

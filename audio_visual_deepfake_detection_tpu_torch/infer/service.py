"""Dynamic-batching localizer service (JAX ``infer/service.py:46-211``).

Callers submit single videos; a worker thread coalesces up to
``batch_size`` requests (waiting at most ``max_wait_ms`` for stragglers),
pads the batch to the smallest bucket tier that holds it, runs the
inference function on the model's device and resolves one future per
request. ``submit`` takes one video's (T, C) features; ``submit_streams``
takes its raw per-stream features at their native rates and resamples them
to ``max_seq_len`` on the host (the native ``runtime/host_resample.py``),
deriving fps and the feature stride as the dataset does. Both ship the batch
from the same pinned host buffers in the model's dtype.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.config import ArchConfig, TestConfig
from .runner import build_inference_fn


@dataclass
class _Request:
    feats: np.ndarray         # (T, C)
    mask: np.ndarray          # (T,)
    fps: float
    duration: float
    feat_stride: float
    feat_num_frames: float
    future: Future


@dataclass
class Detections:
    segments: np.ndarray      # (K, 2) seconds
    scores: np.ndarray        # (K,)
    labels: np.ndarray        # (K,)
    video_cls: float          # video-level logit


class LocalizerService:
    def __init__(self, cfg: ArchConfig, test_cfg: TestConfig, model,
                 batch_size: int = 16, max_wait_ms: float = 5.0,
                 ds_feat_stride: float = 1.0, ds_num_frames: float = 1.0,
                 batch_buckets: Optional[List[int]] = None,
                 warmup: bool = False):
        """``model``: an eval-mode ``AVLocalizer`` on its serving device.
        ``ds_feat_stride`` / ``ds_num_frames``: the dataset config's
        ``feat_stride`` / ``num_frames``, from which ``submit_streams``
        derives a video's feature stride. ``batch_buckets``: ascending batch
        tiers; a flush pads to the smallest tier >= the coalesced request
        count. Default [batch_size]."""
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.buckets = sorted(batch_buckets or [batch_size])
        assert self.buckets[-1] >= batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.ds_feat_stride = ds_feat_stride
        self.ds_num_frames = ds_num_frames
        self._infer_fn = build_inference_fn(cfg, test_cfg)
        self._device = next(model.parameters()).device
        self._dtype = model.compute_dtype
        # one host buffer per bucket tier in the model's dtype, pinned for a
        # card, reused by every flush: half the bytes of f32 in bf16 (the
        # JAX service's half-width infeed), copied without blocking
        self._host = {}
        self.forwards = 0   # batches run through the model (warmup included)
        if warmup:
            # run every bucket tier once so no live request pays first-use
            # costs (kernel build, cuDNN algorithm choice, allocator growth)
            for bk in self.buckets:
                self._run(self._host_feats(bk).zero_(), np.ones((bk, cfg.max_seq_len), bool),
                          *([np.ones(bk, np.float32)] * 4))
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        # serializes submit's closed-check + enqueue against stop()'s sentinel
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, feats: np.ndarray, fps: float, duration: float,
               feat_stride: float, feat_num_frames: Optional[float] = None,
               mask: Optional[np.ndarray] = None) -> Future:
        """Queue one video's (T, C) features; returns a Future[Detections].
        Shapes are validated here, in the caller's thread."""
        t = self.cfg.max_seq_len
        feats = np.asarray(feats)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.input_dim:
            raise ValueError(
                f"feats must be (T, {self.cfg.input_dim}); got {feats.shape}")
        if feats.shape[0] > t:
            raise ValueError(f"sequence length {feats.shape[0]} > max_seq_len {t}")
        if mask is None:
            mask = np.arange(t) < feats.shape[0]
        else:
            mask = np.asarray(mask, bool)
            if mask.shape not in ((feats.shape[0],), (t,)):
                raise ValueError(
                    f"mask must be ({feats.shape[0]},) or ({t},); got {mask.shape}")
            if mask.shape[0] < t:
                mask = np.concatenate([mask, np.zeros(t - mask.shape[0], bool)])
        if feats.shape[0] < t:
            feats = np.concatenate(
                [feats, np.zeros((t - feats.shape[0],) + feats.shape[1:], feats.dtype)])
        fut: Future = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("LocalizerService is stopped")
            self._queue.put(_Request(feats, mask, fps, duration, feat_stride,
                                     feat_num_frames or feat_stride, fut))
        return fut

    def submit_streams(self, streams: List[np.ndarray], duration: float) -> Future:
        """Queue one video as raw per-stream features (the video stream
        first, each (rows_s, C_s) at its native rate); returns a
        Future[Detections]. The streams are resampled to ``max_seq_len`` and
        concatenated in the caller's thread, and fps / feat_stride derived
        as ``DeepfakeInferenceDataset`` derives them."""
        from ..runtime.host_resample import resample_concat

        feats = resample_concat(streams, self.cfg.max_seq_len)
        video_rows = streams[0].shape[0]
        fps = video_rows / duration
        stride = ((video_rows - 1) * self.ds_feat_stride
                  + self.ds_num_frames) / self.cfg.max_seq_len
        return self.submit(feats, fps, duration, stride, stride)

    def localize(self, *args, **kwargs) -> Detections:
        return self.submit(*args, **kwargs).result()

    def localize_streams(self, *args, **kwargs) -> Detections:
        return self.submit_streams(*args, **kwargs).result()

    def _host_feats(self, b: int) -> torch.Tensor:
        """The (b, T, C) host buffer of bucket tier ``b``."""
        buf = self._host.get(b)
        if buf is None:
            buf = torch.empty((b, self.cfg.max_seq_len, self.cfg.input_dim), dtype=self._dtype,
                              pin_memory=self._device.type == "cuda")
            self._host[b] = buf
        return buf

    def _run(self, feats: torch.Tensor, mask, fps, dur, stride, nframes):
        """``feats``: a host buffer of ``_host_feats``. It is free to be
        filled again when this returns, also when the model raises: the
        copy out of it has finished by then."""
        x = feats.to(self._device, non_blocking=True)
        copied = None
        if x.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(x.device))
        try:
            self.forwards += 1
            out = self._infer_fn(self.model, x, mask, fps, dur, stride, nframes)
            return [o.cpu().numpy() for o in out]
        finally:
            if copied is not None:
                copied.synchronize()

    def _worker(self):
        while True:
            req = self._queue.get()
            if req is None:
                return
            batch: List[_Request] = [req]
            while len(batch) < self.batch_size:
                try:
                    nxt = self._queue.get(timeout=self.max_wait)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: List[_Request]):
        n = len(batch)
        try:  # any failure resolves the waiters; the worker thread survives
            b = next(bk for bk in self.buckets if bk >= n)
            feats = self._host_feats(b)
            feats[n:].zero_()
            mask = np.zeros((b, self.cfg.max_seq_len), bool)
            meta = np.ones((4, b), np.float32)
            for i, r in enumerate(batch):
                feats[i] = torch.from_numpy(r.feats)     # rounded to the model's dtype here
                mask[i] = r.mask
                meta[:, i] = (r.fps, r.duration, r.feat_stride, r.feat_num_frames)
            segs, scores, cls_idxs, valid, video_cls = self._run(feats, mask, *meta)
            for i, r in enumerate(batch):
                k = valid[i]
                r.future.set_result(Detections(
                    segments=segs[i][k], scores=scores[i][k],
                    labels=cls_idxs[i][k], video_cls=float(video_cls[i, 0])))
        except Exception as e:  # propagate failures to every waiter
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    def stop(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: queued requests are still answered, new submits
        raise. Returns True once drained. Idempotent."""
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._queue.put(None)   # FIFO: lands after every accepted request
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

"""Online feature extraction, the video stream (JAX ``frontends/pipeline.py``).

``FeatureExtractor`` turns raw frames into the per-frame visual features the
localizer's video stream reads: frames are chunked into zero-padded
``video_chunk``-frame blocks, normalized, resized to 96x96 when they are not
already, and encoded by MViT-v2 through ``hybrid_apply``. Its outputs are
row-compatible with the JAX package's ``.npy`` caches.

The audio streams (BYOL-A, Emotion2Vec) are not ported yet (ROADMAP queue 1
item 5): their methods raise. The opt-in tail-chunk bucketing is not ported
either (queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mvit import MViTVideoEncoder, hybrid_apply, init_mvit, mvit_v2_b
from .video import bilinear_resize_video, chunk_video

# Chunks run in groups of this many (the tail group zero-padded): the front
# stages (patch embed + blocks[:split]) batched across the group, then the
# back stages batched across it too. The group bounds peak device memory for
# long videos: MViT-v2-b in bf16 peaks at 14.1 GiB with groups of 32 chunks
# on an H100 80GB (chip_smoke.py, 64 chunks). The back stages always run
# batched: on an H100 (700 W), MViT-v2-b bf16, 64 chunks, chip_smoke.py
# measured 91.85 chunks/s batched against 31.43 one chunk at a time (the
# per-chunk launches leave the card idle). The JAX default (per chunk) was a
# TPU measurement.
FRONT_CHUNK_GROUP = 32

CACHE_DIR_NAMES = {"video": "align_video", "byola": "content_audio",
                   "emotion": "emotion_audio"}

_AUDIO_TODO = ("the audio frontends are not ported yet (ROADMAP.md queue 1 "
               "item 5); use the JAX package's FeatureExtractor for {}")


class FeatureExtractor:
    """Video features on the port's device. ``video_model`` defaults to a
    seeded MViT-v2-b in ``compute_dtype`` (the JAX extractor's default is
    C3D, which is not ported: ROADMAP queue 1 item 10); its parameters stay
    f32 and outputs are f32."""

    def __init__(self, video_model: Optional[MViTVideoEncoder] = None,
                 video_chunk: int = 512, seed: int = 0,
                 compute_dtype: str = "float32", device=None):
        dtype = getattr(torch, compute_dtype)
        if video_model is None:
            video_model = init_mvit(mvit_v2_b(dtype=dtype), seed, perturb=False)
        self.device = torch.device(device) if device is not None else \
            next(video_model.parameters()).device
        self.video_model = video_model.to(self.device).eval()
        self.video_chunk = video_chunk

    def video_features(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) -> (T, D). uint8 frames are normalized /255, float
        frames are taken as already in [0, 1]."""
        norm = (frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8
                else np.asarray(frames, np.float32))
        chunks, t = chunk_video(norm, self.video_chunk)
        feats = self.video_chunks_features(chunks)
        return feats.reshape(-1, feats.shape[-1])[:t]

    @torch.no_grad()
    def video_chunks_features(self, chunks) -> np.ndarray:
        """(N, chunk, H, W, 3) float [0, 1] or uint8 -> (N, chunk, D) f32.
        uint8 chunks are copied as they are and normalized on the device;
        chunks already at 96x96 skip the resize."""
        return self.video_chunks_features_device(chunks).cpu().numpy()

    @torch.no_grad()
    def video_chunks_features_device(self, chunks) -> torch.Tensor:
        """As ``video_chunks_features``, leaving the features on the device."""
        x = torch.as_tensor(chunks).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() * np.float32(1.0 / 255.0)
        x = x.float()
        if tuple(x.shape[2:4]) != (96, 96):
            x = bilinear_resize_video(x, (96, 96))
        return hybrid_apply(self.video_model, x, front_group=FRONT_CHUNK_GROUP,
                            batched_back=True)

    def byola_features(self, wav):
        raise NotImplementedError(_AUDIO_TODO.format("BYOL-A"))

    def emotion_features(self, wav):
        raise NotImplementedError(_AUDIO_TODO.format("Emotion2Vec"))

    def byola_features_batch(self, wavs):
        raise NotImplementedError(_AUDIO_TODO.format("BYOL-A"))

    def emotion_features_batch(self, wavs):
        raise NotImplementedError(_AUDIO_TODO.format("Emotion2Vec"))

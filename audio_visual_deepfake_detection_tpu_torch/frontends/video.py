"""Video input pipeline helpers (JAX ``frontends/video.py:127-144``).

``chunk_video`` zero-pads and chunks frames on the host (numpy).
``bilinear_resize_video`` matches ``jax.image.resize(..., "bilinear")``:
a triangle kernel that is widened by the scale factor when downscaling
(antialiasing), which ``F.interpolate(mode="bilinear")`` does not do.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def chunk_video(frames: np.ndarray, chunk: int = 512) -> Tuple[np.ndarray, int]:
    """Zero-pad and chunk (T, H, W, C) frames into (N, chunk, H, W, C)."""
    t = frames.shape[0]
    n = max(1, int(np.ceil(t / chunk)))
    pad = n * chunk - t
    if pad:
        frames = np.concatenate(
            [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)], axis=0)
    return frames.reshape(n, chunk, *frames.shape[1:]), t


@functools.lru_cache(maxsize=32)
def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) resampling weights of jax.image.scale_and_translate with the
    triangle kernel, antialiased, in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def bilinear_resize_video(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) float frames -> (..., h, w, C), as jax.image.resize
    bilinear (antialiased when downscaling), f32."""
    h, w = frames.shape[-3:-1]
    x = frames.float()
    dev = x.device
    if h != size[0]:
        x = torch.einsum("...hwc,hy->...ywc", x,
                         torch.from_numpy(_weight_mat(h, size[0])).to(dev))
    if w != size[1]:
        x = torch.einsum("...ywc,wx->...yxc", x,
                         torch.from_numpy(_weight_mat(w, size[1])).to(dev))
    return x

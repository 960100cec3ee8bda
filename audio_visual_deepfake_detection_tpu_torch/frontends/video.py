"""The C3D video encoder and the video input helpers (JAX
``frontends/video.py``).

``C3DVideoEncoder`` is the LAVDF / BA-TFD+ C3D stack (the reference's
``video_encoder.py:12-62``), the JAX ``FeatureExtractor``'s default video
model: (B, T, 96, 96, 3) frames in [0, 1] -> (B, T, 256) per-frame
features, the temporal axis never pooled. It has no kernel of its own in
either package: the JAX package computes it with flax ``nn.Conv`` (XLA),
the port with ``F.conv3d`` (cuDNN on the card).

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
import torch.nn.functional as F
from torch import nn


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


class _ConvLReLU(nn.Module):
    """A conv + LeakyReLU(0.01) wrapper whose raw conv is its ``conv`` child
    (the reference's tensorneko ``Conv3d`` / ``Conv1d`` with
    ``build_activation=LeakyReLU``); the encoder applies both in its compute
    dtype."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


def _conv3d(cin: int, cout: int) -> _ConvLReLU:
    return _ConvLReLU(nn.Conv3d(cin, cout, 3, padding=1))


class C3DVideoEncoder(nn.Module):
    """(B, T, 96, 96, 3) -> (B, T, out_dim) f32. Per block Conv3d (k3, pad
    1) + LeakyReLU(0.01); max pools (1, 3, 3), then (1, 2, 2) four times
    (96 -> 32 -> 16 -> 8 -> 4 -> 2), never over time; the last map
    flattened per frame in (c, h, w) row-major order (the reference's
    ``Rearrange("b c t h w -> b (c h w) t")``), then a 1x1 Conv1d projection
    + LeakyReLU. Modules carry the reference's names: ``block{0,1,2}.{0,1}``,
    ``block3.0``, ``block3.2`` and the projection ``block3.5``, each holding
    its raw conv as ``conv``, so the JAX ``convert_c3d_torch`` reads this
    state dict as it is. Parameters stay f32; ``dtype`` is the compute
    dtype, as in the JAX module."""

    def __init__(self, n_features=(64, 96, 128, 128), out_dim: int = 256,
                 dtype=torch.float32):
        super().__init__()
        d0, d1, d2, d3 = n_features
        self.dtype, self.out_dim = dtype, out_dim
        self.block0 = nn.ModuleList([_conv3d(3, d0), _conv3d(d0, d0)])
        self.block1 = nn.ModuleList([_conv3d(d0, d1), _conv3d(d1, d1)])
        self.block2 = nn.ModuleList([_conv3d(d1, d2), _conv3d(d2, d2)])
        # the reference's block3: conv, pool, conv, pool, rearrange, projection
        self.block3 = nn.ModuleList([_conv3d(d2, d3), nn.Identity(), _conv3d(d3, d3),
                                     nn.Identity(), nn.Identity(),
                                     _ConvLReLU(nn.Conv1d(d3 * 4, out_dim, 1))])

    def _conv(self, wrapper: _ConvLReLU, x: torch.Tensor) -> torch.Tensor:
        c = wrapper.conv
        y = F.conv3d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), padding=1)
        return F.leaky_relu(y, 0.01)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        # NDHWC frames viewed as NCDHW: the conv input keeps channels-last strides
        x = video.to(self.dtype).permute(0, 4, 1, 2, 3)
        for block, pool in ((self.block0, 3), (self.block1, 2), (self.block2, 2)):
            x = self._conv(block[1], self._conv(block[0], x))
            x = F.max_pool3d(x, (1, pool, pool))
        x = F.max_pool3d(self._conv(self.block3[0], x), (1, 2, 2))
        x = F.max_pool3d(self._conv(self.block3[2], x), (1, 2, 2))
        b, c, t, h, w = x.shape
        x = x.permute(0, 2, 1, 3, 4).reshape(b, t, c * h * w)
        proj = self.block3[5].conv
        y = F.linear(x, proj.weight[..., 0].to(x.dtype), proj.bias.to(x.dtype))
        return F.leaky_relu(y, 0.01).float()


def init_c3d(model: C3DVideoEncoder, seed: int = 0, perturb: bool = True):
    """Seeded random weights: conv weights normal with std 1/sqrt(fan_in)
    (flax's default), biases zero. ``perturb`` draws the biases normal
    (std 0.1) too, so that a wrong bias shows in the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                val = torch.randn(p.shape, generator=g) * 0.1 if perturb \
                    else torch.zeros_like(p)
            else:
                val = torch.randn(p.shape, generator=g) * p[0].numel() ** -0.5
            p.copy_(val.to(p.device))
    return model.eval()

"""Normalizations in (B, T, C) layout (JAX ``ops/norm.py``).

Statistics run in float32 with biased variance; the affine is applied in
float32 before the cast back to the input dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn


def channel_layer_norm(x: torch.Tensor, weight=None, bias=None,
                       eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last (channel) axis."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    res = xf - mu
    sigma = (res * res).mean(-1, keepdim=True)
    out = res * torch.rsqrt(sigma + eps)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def instance_norm_time(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm1d default (no affine) over the time axis of
    (B, T, C): every (sample, channel) series, padded rows included."""
    xf = x.float()
    mu = xf.mean(-2, keepdim=True)
    res = xf - mu
    sigma = (res * res).mean(-2, keepdim=True)
    return (res * torch.rsqrt(sigma + eps)).to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """Affine channel LayerNorm; parameters ``weight``/``bias`` of shape (C,)."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layer_norm(x, self.weight, self.bias, self.eps)

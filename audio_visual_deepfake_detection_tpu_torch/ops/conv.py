"""Masked 1-D convolutions, transposed convolutions and dense layers,
(B, T, C) layout (JAX ``ops/conv.py:34-150``).

Invariants kept from the JAX package: odd kernel with padding k//2, stride > 1
downsamples the mask by nearest neighbour, the output is multiplied by the
mask, the bias is added in the activation dtype after the product.
Parameters use torch layouts: Conv1d ``(out, in/g, k)``, ConvTranspose1d
``(in, out, k)``, Linear ``(out, in)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resample import downsample_mask


class MaskedConv1D(nn.Module):
    """Holds ``conv.weight`` / ``conv.bias`` under the reference's names."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__()
        assert kernel_size % 2 == 1, "kernel must be odd"
        self.stride = stride
        self.groups = groups
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              groups=groups, bias=bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        t = x.shape[1]
        assert t % self.stride == 0, "input length must be divisible by stride"
        w = self.conv.weight
        y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, self.stride,
                     w.shape[-1] // 2, 1, self.groups).transpose(1, 2)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(y.dtype)
        out_mask = downsample_mask(mask, y.shape[1]) if self.stride > 1 else mask
        return y * out_mask.to(y.dtype)[..., None], out_mask


class MaskedConvTranspose1D(nn.Module):
    """torch ``ConvTranspose1d(k, stride, padding=k // 2, output_padding)``
    over (B, T, C): ``out[o] += x[i] * w[i, :, j]`` for ``o = i * stride -
    k // 2 + j``, so k=3, stride 2, output_padding 1 doubles the length.
    The mask is resized to the new length by nearest neighbour and
    multiplied in. Holds ``conv.weight`` ``(in, out, k)`` / ``conv.bias``
    under the reference's names. The JAX package stores ``(k, in, out)``
    and correlates the *flipped* kernel with the stride-dilated input,
    which is this same product: ``w[i, o, j] = kernel[j, i, o]``, no flip."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, output_padding: int = 1, bias: bool = True):
        super().__init__()
        assert kernel_size % 2 == 1, "kernel must be odd"
        self.stride, self.output_padding = stride, output_padding
        self.conv = nn.ConvTranspose1d(in_channels, out_channels, kernel_size,
                                       stride=stride, padding=kernel_size // 2,
                                       output_padding=output_padding, bias=bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        t = x.shape[1]
        w = self.conv.weight
        y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), None, self.stride,
                               w.shape[-1] // 2, self.output_padding).transpose(1, 2)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(y.dtype)
        out_mask = downsample_mask(mask, y.shape[1]) if y.shape[1] != t else mask
        return y * out_mask.to(y.dtype)[..., None], out_mask


def dense(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ W`` for a torch-layout weight ``(out, in)`` or 1x1-conv weight
    ``(out, in, 1)``, in the activation dtype, then the bias in that dtype."""
    if weight.ndim == 3:
        weight = weight[..., 0]
    y = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class Dense(nn.Linear):
    """nn.Linear whose forward follows the JAX ``Dense`` dtype rules."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


def max_pool_skip(x: torch.Tensor, stride: int) -> torch.Tensor:
    """MaxPool1d(kernel=stride + 1, stride, padding=(stride + 1) // 2) over
    the time axis of (B, T, C), padded with -inf: the skip path of the
    downsampling transformer block (JAX ``ops/conv.py::max_pool_skip``)."""
    y = F.max_pool1d(x.transpose(1, 2), stride + 1, stride, (stride + 1) // 2)
    return y.transpose(1, 2)

"""Classification / regression heads over the pyramid (JAX
``models/heads.py``): convs shared across levels, the classifier bias set to
the focal prior ``-log((1 - p) / p)``, per-level scales on the offsets."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.conv import MaskedConv1D
from ..ops.norm import ChannelLayerNorm
from .blocks import Scale


class _Head(nn.Module):
    def __init__(self, in_dim: int, feat_dim: int, num_layers: int,
                 kernel_size: int, with_ln: bool):
        super().__init__()
        self.head = nn.ModuleList(
            MaskedConv1D(in_dim if i == 0 else feat_dim, feat_dim, kernel_size,
                         bias=not with_ln) for i in range(num_layers - 1))
        self.norm = nn.ModuleList(
            ChannelLayerNorm(feat_dim) if with_ln else nn.Identity()
            for _ in range(num_layers - 1))

    def trunk(self, h, mask):
        for conv, norm in zip(self.head, self.norm):
            h, _ = conv(h, mask)
            h = torch.relu(norm(h))
        return h


class ClsHead(_Head):
    def __init__(self, in_dim: int, num_classes: int, feat_dim: int = 256,
                 num_layers: int = 3, kernel_size: int = 3, with_ln: bool = True):
        super().__init__(in_dim, feat_dim, num_layers, kernel_size, with_ln)
        self.cls_head = MaskedConv1D(feat_dim, num_classes, kernel_size)

    def forward(self, feats: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
        return [self.cls_head(self.trunk(f, m), m)[0] for f, m in zip(feats, masks)]


def init_cls_prior(head: ClsHead, prior_prob: float, empty_cls: Sequence[int] = ()):
    """Focal-prior classifier bias (JAX ``heads.py:56-71``)."""
    with torch.no_grad():
        bias = head.cls_head.conv.bias
        bias.fill_(-math.log((1 - prior_prob) / prior_prob))
        for idx in empty_cls:
            bias[idx] = -math.log((1 - 1e-6) / 1e-6)


class RegHead(_Head):
    def __init__(self, in_dim: int, fpn_levels: int, feat_dim: int = 256,
                 num_layers: int = 3, kernel_size: int = 3, with_ln: bool = True):
        super().__init__(in_dim, feat_dim, num_layers, kernel_size, with_ln)
        self.offset_head = MaskedConv1D(feat_dim, 2, kernel_size)
        self.scale = nn.ModuleList(Scale() for _ in range(fpn_levels))

    def forward(self, feats: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
        assert len(feats) == len(self.scale)
        return [torch.relu(self.scale[l](self.offset_head(self.trunk(f, m), m)[0]))
                for l, (f, m) in enumerate(zip(feats, masks))]

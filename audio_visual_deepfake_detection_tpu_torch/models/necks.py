"""1-D feature pyramid neck (JAX ``models/necks.py::FPN1D``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.conv import MaskedConv1D
from ..ops.norm import ChannelLayerNorm
from ..ops.resample import nearest_resample_time


class FPN1D(nn.Module):
    """1x1 laterals, nearest top-down adds, depthwise k3 conv + LN per level."""

    def __init__(self, in_channels: int, out_channel: int, n_levels: int,
                 with_ln: bool = True, start_level: int = 0):
        super().__init__()
        self.start_level = start_level
        n = n_levels - start_level
        self.lateral_convs = nn.ModuleList(
            MaskedConv1D(in_channels, out_channel, 1, bias=not with_ln) for _ in range(n))
        self.fpn_convs = nn.ModuleList(
            MaskedConv1D(out_channel, out_channel, 3, groups=out_channel,
                         bias=not with_ln) for _ in range(n))
        self.fpn_norms = nn.ModuleList(
            ChannelLayerNorm(out_channel) if with_ln else nn.Identity() for _ in range(n))

    def forward(self, inputs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
        s = self.start_level
        n = len(self.lateral_convs)
        laterals = [conv(inputs[i + s], masks[i + s])[0]
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_resample_time(
                laterals[i], laterals[i - 1].shape[1], axis=1)
        feats, out_masks = [], []
        for i in range(n):
            x, m = self.fpn_convs[i](laterals[i], masks[i + s])
            feats.append(self.fpn_norms[i](x))
            out_masks.append(m)
        return feats, out_masks

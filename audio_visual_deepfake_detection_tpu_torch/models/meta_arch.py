"""The production localizer ``av_recovery_norecon`` (JAX
``models/meta_arch.py:111-203``): DeepInterpolator video classifier, HRLR
backbone, FPN neck, classification and regression heads. Eval only."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.config import ArchConfig
from .backbones import HRLRBackbone
from .blocks import AffineDropPath, DeepInterpolator, Scale
from .heads import ClsHead, RegHead, init_cls_prior
from .necks import FPN1D
from ..ops.norm import ChannelLayerNorm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AVLocalizer(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.interpolator = DeepInterpolator(cfg.input_dim, cfg.embd_dim,
                                             cfg.num_classes)
        self.backbone = HRLRBackbone(
            cfg.input_dim, cfg.embd_dim, cfg.n_head, cfg.embd_kernel_size,
            cfg.max_seq_len, cfg.arch, cfg.mha_win_size, cfg.scale_factor,
            cfg.embd_with_ln, cfg.use_abs_pe)
        n_levels = cfg.arch[2] + 1
        self.neck = FPN1D(cfg.embd_dim, cfg.fpn_dim, n_levels, cfg.fpn_with_ln,
                          cfg.fpn_start_level)
        self.cls_head = ClsHead(cfg.fpn_dim, cfg.num_classes, cfg.head_dim,
                                cfg.head_num_layers, cfg.head_kernel_size,
                                cfg.head_with_ln)
        self.reg_head = RegHead(cfg.fpn_dim, len(cfg.fpn_strides), cfg.head_dim,
                                cfg.head_num_layers, cfg.head_kernel_size,
                                cfg.head_with_ln)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.compute_dtype]

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> Dict[str, Any]:
        feats = feats.to(self.compute_dtype)
        _, _, cls_scores = self.interpolator(feats, mask)
        bb_feats, bb_masks = self.backbone(feats, mask)
        fpn_feats, fpn_masks = self.neck(bb_feats, bb_masks)
        out_cls = self.cls_head(fpn_feats, fpn_masks)
        out_offsets = self.reg_head(fpn_feats, fpn_masks)
        return {
            "cls_scores": cls_scores.float(),
            "out_cls": [o.float() for o in out_cls],
            "out_offsets": [o.float() for o in out_offsets],
            "fpn_masks": fpn_masks,
        }


@torch.no_grad()
def init_localizer(model: AVLocalizer, generator: Optional[torch.Generator] = None):
    """Seeded fresh init with the JAX package's rules: conv / linear weights
    Uniform(+-1/sqrt(fan_in)) (the torch default), zero biases, LN affines
    1/0, layer scales 1e-4, head scales 1, focal-prior classifier bias."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            bound = 1.0 / float(m.weight[0].numel()) ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ChannelLayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, AffineDropPath):
            m.scale.fill_(1e-4)
        elif isinstance(m, Scale):
            m.scale.fill_(1.0)
    init_cls_prior(model.cls_head, model.cfg.cls_prior_prob, model.cfg.head_empty_cls)
    return model


def build_localizer(cfg: ArchConfig, seed: int = 0, device=None) -> AVLocalizer:
    """A seeded, randomly initialised localizer in eval mode on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    model = init_localizer(AVLocalizer(cfg), gen)
    return model.to(device).eval()

"""Losses: sigmoid focal and centre-DIoU (JAX ``models/losses.py``). Both are
elementwise in f32; weighting, masking and the reduction are the caller's."""

from __future__ import annotations

import torch


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss on logits."""
    inputs, targets = inputs.float(), targets.float()
    p = torch.sigmoid(inputs)
    # binary cross entropy with logits, numerically stable
    ce = torch.clamp(inputs, min=0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def ctr_diou_loss_1d(input_offsets: torch.Tensor, target_offsets: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """Elementwise 1-D distance-IoU loss on (left, right) offsets that share
    a centre. Shapes (..., 2) -> (...)."""
    inp, tgt = input_offsets.float(), target_offsets.float()
    lp, rp = inp[..., 0], inp[..., 1]
    lg, rg = tgt[..., 0], tgt[..., 1]
    intsct = torch.minimum(rp, rg) + torch.minimum(lp, lg)
    union = (lp + rp) + (lg + rg) - intsct
    iou = intsct / torch.clamp(union, min=eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    return 1.0 - iou + torch.square(rho / torch.clamp(len_c, min=eps))

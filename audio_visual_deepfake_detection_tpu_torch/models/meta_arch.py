"""The production localizer ``av_recovery_norecon`` (JAX
``models/meta_arch.py:111-203``): DeepInterpolator video classifier, HRLR
backbone, FPN neck, classification and regression heads; and what training
adds around it (``meta_arch.py:210-351``): the batched label assignment
``label_points``, ``compute_losses`` with its loss-normalizer EMA, and the
point table ``model_points``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import ArchConfig
from .backbones import HRLRBackbone
from .blocks import AffineDropPath, DeepInterpolator, Scale
from .heads import ClsHead, RegHead, init_cls_prior
from .losses import ctr_diou_loss_1d, sigmoid_focal_loss
from .necks import FPN1D
from .points import generate_points
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
            cfg.embd_with_ln, cfg.use_abs_pe, proj_pdrop=cfg.dropout,
            path_pdrop=cfg.droppath, remat=cfg.remat)
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

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``train`` turns stochastic depth and dropout on (drawn from
        ``generator``, which lives on the tensors' device). Parameters stay
        f32, activations run in ``compute_dtype``, the outputs are f32.

        The transformer blocks take the eval kernel K1 unless autograd would
        record them: with ``train`` False it is taken under ``no_grad`` /
        ``inference_mode`` and, whatever the grad mode, once the inputs and
        parameters require no gradient (``model.requires_grad_(False)``).
        Grad mode on with trainable parameters means the differentiable
        path: the K6 ``autograd.Function``, its parameters packed anew on
        every call."""
        feats = feats.to(self.compute_dtype)
        _, _, cls_scores = self.interpolator(feats, mask, train, generator)
        bb_feats, bb_masks = self.backbone(feats, mask, train, generator)
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


def build_localizer(cfg: ArchConfig, seed: int = 0, device="cuda") -> AVLocalizer:
    """A seeded, randomly initialised localizer in eval mode on ``device``:
    the card unless the caller asks for ``device="cpu"``. The weights are
    drawn on the CPU from ``seed``, so both devices hold the same values."""
    gen = torch.Generator().manual_seed(seed)
    model = init_localizer(AVLocalizer(cfg), gen)
    return model.to(device).eval()


# ------------------------------------------------- label assignment, losses

def label_points(points: torch.Tensor, gt_segments: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, num_classes: int, center_sample: str = "radius",
                 center_sample_radius: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched label assignment. ``points`` (P, 4) rows (t, reg_min, reg_max,
    stride); ``gt_segments`` (B, N, 2) on the feature grid, padded;
    ``gt_labels`` (B, N) int; ``gt_valid`` (B, N) bool. Returns
    (gt_cls (B, P, C), gt_offsets (B, P, 2)): each point takes the shortest
    segment it lies in (within its level's regression range), ties within
    1e-3 share the class target."""
    t = points[None, :, 0:1]                                   # (1, P, 1)
    stride = points[None, :, 3:4]
    start, end = gt_segments[:, None, :, 0], gt_segments[:, None, :, 1]   # (B, 1, N)
    lens = end - start
    left, right = t - start, end - t                           # (B, P, N)
    if center_sample == "radius":
        center = 0.5 * (start + end)
        cb_l = t - torch.maximum(center - stride * center_sample_radius, start)
        cb_r = torch.minimum(center + stride * center_sample_radius, end) - t
        inside = torch.minimum(cb_l, cb_r) > 0
    else:
        inside = torch.minimum(left, right) > 0
    max_dist = torch.maximum(left, right)
    in_range = (max_dist >= points[None, :, 1:2]) & (max_dist <= points[None, :, 2:3])
    inf = torch.tensor(float("inf"), dtype=lens.dtype, device=lens.device)
    lens_g = torch.where(inside & in_range & gt_valid[:, None, :], lens, inf)
    min_len, min_idx = lens_g.min(dim=2)                       # (B, P)
    min_mask = ((lens_g <= min_len[..., None] + 1e-3) & torch.isfinite(lens_g)).float()
    onehot = torch.nn.functional.one_hot(gt_labels.long(), num_classes).float()   # (B, N, C)
    cls = torch.clamp(min_mask @ onehot, 0.0, 1.0)             # (B, P, C)
    idx = min_idx[..., None]
    reg = torch.cat([left.gather(2, idx), right.gather(2, idx)], dim=-1) / stride
    return cls, reg


def update_loss_normalizer(normalizer, num_pos, momentum: float = 0.9):
    return momentum * normalizer + (1.0 - momentum) * torch.clamp(num_pos.float(), min=1.0)


def compute_losses(outputs: Dict[str, Any], gt_cls: torch.Tensor, gt_offsets: torch.Tensor,
                   has_gt: torch.Tensor, loss_normalizer: torch.Tensor, *,
                   num_classes: int, loss_weight: float = 2.0,
                   label_smoothing: float = 0.1,
                   row_valid: Optional[torch.Tensor] = None):
    """Returns (loss dict incl. ``final_loss``, ``num_pos``). The normalizer
    EMA is updated BEFORE dividing, as the reference does, so the losses are
    normalized by the updated value and the train step stores
    ``update_loss_normalizer(loss_normalizer, num_pos)`` as the new state.
    ``row_valid`` (B,) bool takes padding rows of the batch out of the
    video-level loss; their point-level losses vanish through the all-False
    masks of such rows. All in f32."""
    valid_mask = torch.cat(outputs["fpn_masks"], dim=1)                 # (B, P)
    logits = torch.cat(outputs["out_cls"], dim=1)                       # (B, P, C)
    pred_off = torch.cat(outputs["out_offsets"], dim=1)                 # (B, P, 2)
    if row_valid is None:
        row_valid = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
    row_f32 = row_valid.float()

    include = valid_mask & has_gt[:, None]
    pos_mask = (gt_cls.sum(-1) > 0) & include
    num_pos = pos_mask.sum()
    normalizer = update_loss_normalizer(loss_normalizer, num_pos)

    gt_target = gt_cls * (1.0 - label_smoothing) + label_smoothing / (num_classes + 1)
    cls_loss = (sigmoid_focal_loss(logits, gt_target) * include[..., None]).sum() / normalizer
    reg_loss = (ctr_diou_loss_1d(pred_off, gt_offsets) * pos_mask).sum() / normalizer
    losses = {"cls_loss": cls_loss, "reg_loss": reg_loss}
    if loss_weight > 0:
        weight = loss_weight
    else:   # auto-balancing: the detached cls / reg ratio
        weight = (cls_loss / torch.clamp(reg_loss, min=0.01)).detach()
    final = cls_loss + reg_loss * weight

    video_gt = has_gt.float()[:, None]
    reco_cls = (sigmoid_focal_loss(outputs["cls_scores"], video_gt) * row_f32[:, None]).sum()
    losses["reco_cls_loss"] = reco_cls
    losses["final_loss"] = final + 0.1 * reco_cls
    return losses, num_pos


def model_points(cfg: ArchConfig, device=None) -> torch.Tensor:
    """(P, 4) concatenated point table of ``cfg``'s pyramid at max_seq_len."""
    return torch.cat(generate_points(cfg.fpn_lens, cfg.fpn_strides, cfg.regression_range,
                                     device=device), dim=0)

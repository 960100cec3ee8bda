"""The localizers (JAX ``models/meta_arch.py:111-203``): the three recovery
variants with the HRLR backbone and the FPN neck, ``av_recovery_norecon``
(production) and ``av_recovery`` holding the DeepInterpolator video
classifier, ``av_recovery`` also its expansion, whose reconstruction is the
backbone's k-stream and the target of an L1 loss; ``av_recovery_the``
holding ``SegmentAndCls`` (frame logits and a video logit) under the
reference's name ``segmentandCls``; and the legacy ``plain`` ActionFormer
(``AVLocPointTransformer`` / ``LocPointTransformer``): no recovery module
and no video logit, the ``convTransformer`` or ``conv`` backbone and the
``fpn`` or ``identity`` neck. Each ends in the classification and
regression heads. And what training adds around them
(``meta_arch.py:210-351``): the batched label assignment ``label_points``,
``compute_losses`` with its loss-normalizer EMA, and the point table
``model_points``."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.config import ArchConfig
from .backbones import ConvBackbone, ConvTransformerBackbone, HRLRBackbone
from .blocks import AffineDropPath, ConvAttention, DeepInterpolator, Scale, SegmentAndCls, \
    init_rel_pe
from .heads import ClsHead, RegHead, init_cls_prior
from .losses import ctr_diou_loss_1d, sigmoid_focal_loss
from .necks import FPN1D, FPNIdentity
from .points import generate_points
from ..ops.norm import ChannelLayerNorm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AVLocalizer(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.variant == "av_recovery_the":
            # the reference's attribute name, so the state-dict names stay its own
            self.segmentandCls = SegmentAndCls(cfg.input_dim, num_classes=cfg.num_classes)
        elif cfg.variant != "plain":
            self.interpolator = DeepInterpolator(
                cfg.input_dim, cfg.embd_dim, cfg.num_classes,
                with_reconstruction=cfg.variant == "av_recovery")
        blocks = dict(proj_pdrop=cfg.dropout, path_pdrop=cfg.droppath,
                      use_rel_pe=cfg.use_rel_pe, use_time_weight=cfg.use_time_weight)
        if cfg.variant != "plain":
            self.backbone = HRLRBackbone(
                cfg.input_dim, cfg.embd_dim, cfg.n_head, cfg.embd_kernel_size,
                cfg.max_seq_len, cfg.arch, cfg.mha_win_size, cfg.scale_factor,
                cfg.embd_with_ln, cfg.use_abs_pe, remat=cfg.remat, **blocks)
        elif cfg.backbone_type == "conv":
            self.backbone = ConvBackbone(cfg.input_dim, cfg.embd_dim, cfg.embd_kernel_size,
                                         cfg.arch, cfg.scale_factor, cfg.embd_with_ln)
        else:
            self.backbone = ConvTransformerBackbone(
                cfg.input_dim, cfg.embd_dim, cfg.n_head, cfg.embd_kernel_size,
                cfg.max_seq_len, cfg.arch, cfg.mha_win_size, cfg.scale_factor,
                cfg.embd_with_ln, cfg.use_abs_pe, **blocks)
        neck = FPN1D if cfg.fpn_type == "fpn" else FPNIdentity
        self.neck = neck(cfg.embd_dim, cfg.fpn_dim, cfg.arch[2] + 1, cfg.fpn_with_ln,
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
        every call.

        Outputs: ``out_cls``, ``out_offsets``, ``fpn_masks``; every variant
        but ``plain`` adds the video logit ``cls_scores``; ``av_recovery``
        adds ``reco`` and ``norm_inputs`` (the inputs without gradient),
        ``av_recovery_the`` adds ``seg_scores`` (B, T)."""
        feats = feats.to(self.compute_dtype)
        out: Dict[str, Any] = {}
        variant = self.cfg.variant
        if variant == "plain":
            bb_feats, bb_masks = self.backbone(feats, mask, train, generator)
        else:
            reco = None
            if variant == "av_recovery_the":
                _, seg_scores, cls_scores = self.segmentandCls(feats, mask, train, generator)
                out["seg_scores"] = seg_scores.float()
            else:
                norm_x, reco, cls_scores = self.interpolator(feats, mask, train, generator)
                if reco is not None:
                    out["reco"], out["norm_inputs"] = reco.float(), norm_x.float()
            out["cls_scores"] = cls_scores.float()
            bb_feats, bb_masks = self.backbone(feats, mask, train, generator, reco_x=reco)
        fpn_feats, fpn_masks = self.neck(bb_feats, bb_masks)
        out_cls = self.cls_head(fpn_feats, fpn_masks)
        out_offsets = self.reg_head(fpn_feats, fpn_masks)
        out.update(out_cls=[o.float() for o in out_cls],
                   out_offsets=[o.float() for o in out_offsets],
                   fpn_masks=fpn_masks)
        return out


@torch.no_grad()
def init_localizer(model: AVLocalizer, generator: Optional[torch.Generator] = None):
    """Seeded fresh init with the JAX package's rules: conv / linear weights
    Uniform(+-1/sqrt(fan_in)) (the torch default), zero biases, LN affines
    1/0, layer scales 1e-4, head scales 1, focal-prior classifier bias,
    relative position biases truncated normal (std sqrt(2 / C)), time
    weights 1. A transposed conv's bound is torch's default too, from its
    ``(in, out, k)`` weight's fan-in ``out * k``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear, nn.ConvTranspose1d)):
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
        elif isinstance(m, ConvAttention):
            if m.rel_pe is not None:
                init_rel_pe(m.rel_pe, m.query.weight.shape[0], generator)
            if m.time_weighting is not None:
                m.time_weighting.fill_(1.0)
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
                   variant: str = "av_recovery_norecon",
                   frame_gt: Optional[torch.Tensor] = None,
                   row_valid: Optional[torch.Tensor] = None,
                   reduce: Optional[Callable[[List[torch.Tensor]], None]] = None):
    """Returns (loss dict incl. ``final_loss``, ``num_pos``). The normalizer
    EMA is updated BEFORE dividing, as the reference does, so the losses are
    normalized by the updated value and the train step stores
    ``update_loss_normalizer(loss_normalizer, num_pos)`` as the new state.
    ``row_valid`` (B,) bool takes padding rows of the batch out of the
    video-level loss; their point-level losses vanish through the all-False
    masks of such rows. All in f32. The video-level ``reco_cls_loss`` (its
    ``0.1 *`` in ``final_loss``) needs ``cls_scores``: a ``plain`` model has
    none, and so no such loss.

    ``variant="av_recovery"`` adds ``reco_loss``, the mean |reco -
    norm_inputs| of each real (no-GT) row averaged over those rows, to
    ``final_loss``. ``variant="av_recovery_the"`` with ``frame_gt`` (B, T)
    computes ``reco_seg_loss``, the frame-level focal over ``seg_scores``
    divided by ``normalizer * 10``, and keeps it out of ``final_loss``, as
    the reference does.

    ``reduce`` (data parallel: sums tensors over the processes in place,
    ``parallel.all_reduce_sum``): the outputs are this process's rows of a
    global batch. ``num_pos`` is then the global count before the normalizer
    takes it, and the auto-balancing weight (``loss_weight <= 0``) is the
    global ratio, and ``reco_loss`` divides by the global count of real
    rows, so each loss is this process's share of the global loss and the
    shares sum to it over the processes."""
    valid_mask = torch.cat(outputs["fpn_masks"], dim=1)                 # (B, P)
    logits = torch.cat(outputs["out_cls"], dim=1)                       # (B, P, C)
    pred_off = torch.cat(outputs["out_offsets"], dim=1)                 # (B, P, 2)
    if row_valid is None:
        row_valid = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
    row_f32 = row_valid.float()

    include = valid_mask & has_gt[:, None]
    pos_mask = (gt_cls.sum(-1) > 0) & include
    num_pos = pos_mask.sum()
    if reduce is not None:
        reduce([num_pos])
    normalizer = update_loss_normalizer(loss_normalizer, num_pos)

    gt_target = gt_cls * (1.0 - label_smoothing) + label_smoothing / (num_classes + 1)
    cls_loss = (sigmoid_focal_loss(logits, gt_target) * include[..., None]).sum() / normalizer
    reg_loss = (ctr_diou_loss_1d(pred_off, gt_offsets) * pos_mask).sum() / normalizer
    losses = {"cls_loss": cls_loss, "reg_loss": reg_loss}
    if loss_weight > 0:
        weight = loss_weight
    else:   # auto-balancing: the detached cls / reg ratio
        terms = torch.stack([cls_loss.detach(), reg_loss.detach()])
        if reduce is not None:
            reduce([terms])
        weight = terms[0] / torch.clamp(terms[1], min=0.01)
    final = cls_loss + reg_loss * weight

    if "cls_scores" in outputs:      # every variant but plain
        video_gt = has_gt.float()[:, None]
        reco_cls = (sigmoid_focal_loss(outputs["cls_scores"], video_gt)
                    * row_f32[:, None]).sum()
        losses["reco_cls_loss"] = reco_cls
        final = final + 0.1 * reco_cls

    if variant == "av_recovery" and outputs.get("reco") is not None:
        real = (~has_gt).float() * row_f32
        per_sample = (outputs["reco"] - outputs["norm_inputs"]).abs().mean(dim=(1, 2))
        n_real = real.sum()
        if reduce is not None:
            reduce([n_real])
        reco_loss = (per_sample * real).sum() / torch.clamp(n_real, min=1.0)
        losses["reco_loss"] = reco_loss
        final = final + reco_loss

    if variant == "av_recovery_the" and frame_gt is not None:
        seg = sigmoid_focal_loss(outputs["seg_scores"], frame_gt) * row_f32[:, None]
        losses["reco_seg_loss"] = seg.sum() / (normalizer * 10.0)

    losses["final_loss"] = final
    return losses, num_pos


def model_points(cfg: ArchConfig, device=None) -> torch.Tensor:
    """(P, 4) concatenated point table of ``cfg``'s pyramid at max_seq_len."""
    return torch.cat(generate_points(cfg.fpn_lens, cfg.fpn_strides, cfg.regression_range,
                                     device=device), dim=0)

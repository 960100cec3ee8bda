"""Train state and the train / eval steps (JAX ``train/state.py``).

One step is the reference's iteration: zero_grad -> forward -> backward ->
clip -> optimizer step at the scheduled rate -> EMA of the parameters
(decay 0.999) -> EMA of the loss normalizer. PyTorch runs it eagerly; the
state is updated in place and handed back.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.config import ArchConfig
from ..models.meta_arch import (
    AVLocalizer, compute_losses, init_localizer, label_points, model_points,
    update_loss_normalizer)
from ..ops.resample import linear_resample_dynamic
from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: AVLocalizer
    ema_params: Dict[str, torch.Tensor]      # name -> EMA copy of the parameter
    tx: Optimizer
    loss_normalizer: torch.Tensor            # f32 scalar on the model's device
    generator: torch.Generator               # on the model's device

    @classmethod
    def create(cls, model: AVLocalizer, tx: Optimizer, init_loss_norm: float,
               generator: torch.Generator) -> "TrainState":
        device = next(model.parameters()).device
        return cls(
            step=0, model=model,
            ema_params={n: p.detach().clone() for n, p in model.named_parameters()},
            tx=tx,
            loss_normalizer=torch.tensor(float(init_loss_norm), device=device),
            generator=generator)

    def ema_model(self) -> AVLocalizer:
        """A copy of the model that holds the EMA parameters (inference)."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(self.ema_params, strict=True)
        return model


def _to_device(value, device):
    if isinstance(value, (tuple, list)):
        return tuple(_to_device(v, device) for v in value)
    return torch.as_tensor(value).to(device, non_blocking=True)


def build_train_step(cfg: ArchConfig, train_cfg: Dict, ema_decay: float = 0.999,
                     online_resample: bool = False, deterministic_forward: bool = False,
                     stage_hook: Optional[Callable[[str], None]] = None
                     ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns ``train_step(state, batch) -> (state, losses)``; ``batch`` in
    ``collate_batch``'s format (numpy arrays or tensors), ``losses`` 0-dim
    tensors on the model's device incl. ``num_pos`` and ``grad_norm``.

    ``online_resample``: the batch carries raw ragged ``streams`` / ``rows``
    and the host-drawn crop window (``win_st`` / ``win_len``) instead of
    ``feats`` / ``mask``; the per-stream linear resample and the crop run on
    the device and equal the host path bit for bit when the streams are f32.

    ``deterministic_forward``: the forward runs without dropout and
    stochastic depth while the optimizer / EMA / normalizer chain stays whole
    (step-for-step comparison across frameworks and devices).

    ``stage_hook(name)``, if given, is called inside every step at "begin"
    and after "forward" (label assignment, forward, losses), "backward" and
    "update" (clip, optimizer, EMA, normalizer): a place to record CUDA
    events, so that a step's stages are timed on the step itself.
    """
    mark = stage_hook or (lambda name: None)
    points_cpu = model_points(cfg)
    points_on: Dict[torch.device, torch.Tensor] = {}
    seq = cfg.max_seq_len

    def batch_feats(batch, device):
        if not online_resample:
            return batch["feats"], batch["mask"]
        parts = [linear_resample_dynamic(s, r, seq, resample_len=seq, start=batch["win_st"],
                                         out_valid=batch["win_len"])
                 for s, r in zip(batch["streams"], batch["rows"])]
        mask = torch.arange(seq, device=device)[None, :] < batch["win_len"][:, None]
        return torch.cat(parts, dim=-1), mask

    def train_step(state: TrainState, batch: Dict):
        mark("begin")
        model = state.model
        device = next(model.parameters()).device
        if device not in points_on:
            points_on[device] = points_cpu.to(device)
        batch = {k: _to_device(v, device) for k, v in batch.items()
                 if k != "video_ids" and not k.startswith("_")}
        gt_cls, gt_off = label_points(
            points_on[device], batch["gt_segments"], batch["gt_labels"], batch["gt_valid"],
            cfg.num_classes, train_cfg["center_sample"], train_cfg["center_sample_radius"])
        feats, mask = batch_feats(batch, device)

        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = model(feats, mask, train=not deterministic_forward,
                        generator=state.generator)
            losses, num_pos = compute_losses(
                out, gt_cls, gt_off, batch["has_gt"], state.loss_normalizer,
                num_classes=cfg.num_classes, loss_weight=train_cfg["loss_weight"],
                label_smoothing=train_cfg["label_smoothing"],
                row_valid=batch.get("row_valid"))
            mark("forward")
            losses["final_loss"].backward()
            mark("backward")

        with torch.no_grad():
            grad_norm = state.tx.global_norm()
            state.tx.update(state.step, grad_norm)
            names, params = zip(*model.named_parameters())
            ema = [state.ema_params[n] for n in names]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - ema_decay)
            state.loss_normalizer = update_loss_normalizer(state.loss_normalizer, num_pos)
        state.step += 1
        mark("update")
        losses = {k: v.detach() for k, v in losses.items()}
        losses["num_pos"] = num_pos
        losses["grad_norm"] = grad_norm
        return state, losses

    return train_step


def build_eval_forward(cfg: ArchConfig):
    """Returns ``forward(model, feats, mask)`` -> model outputs in eval mode,
    without gradients. Passing the raw or the EMA model is the caller's
    choice (``TrainState.ema_model``, ``restore_params(use_ema=...)``)."""

    def forward(model: AVLocalizer, feats, mask):
        device = next(model.parameters()).device
        with torch.no_grad():
            return model(_to_device(feats, device), _to_device(mask, device), train=False)

    return forward


def init_model(cfg: ArchConfig, seed: int, device="cuda"
               ) -> Tuple[AVLocalizer, torch.Generator]:
    """A freshly initialised model (with the focal-prior classifier bias) on
    ``device`` and the generator of its training randomness. Training runs
    on the card: a run on the CPU is asked for with ``device="cpu"``, never
    fallen back to. The weights are drawn on the CPU either way, so a seed
    gives the same model on both."""
    device = torch.device(device)
    model = init_localizer(AVLocalizer(cfg), torch.Generator().manual_seed(seed))
    model = model.to(device)
    return model, torch.Generator(device=device).manual_seed(seed + 1)

"""Checkpoint and resume with ``torch.save`` (JAX ``train/checkpoint.py``,
which uses orbax). A checkpoint holds {params, ema_params, opt_state, step,
loss_normalizer, rng, epoch, next_iter}; inference loads the EMA weights,
resume restores everything. The payload is tensors in plain containers, so
it is read with ``weights_only=True``: a checkpoint file cannot run code.
Layout: ``<folder>/epoch_<N>.pt`` files, tagged
mid-epoch and preemption files, and a ``model_best.pt`` copy.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

EXT = ".pt"


def _payload(epoch, state, next_iter):
    return {
        "epoch": epoch,
        "next_iter": next_iter,
        "step": state.step,
        "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "ema_params": {k: v.detach().cpu() for k, v in state.ema_params.items()},
        "opt_state": state.tx.state_dict(),
        "loss_normalizer": state.loss_normalizer.detach().cpu(),
        "rng": state.generator.get_state(),
    }


def _write(path: str, payload) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)       # a reader never sees a half-written file


def save_checkpoint(folder: str, epoch: int, state, is_best: bool = False,
                    tag: Optional[str] = None, next_iter: int = 0) -> str:
    """``epoch`` / ``next_iter``: where training resumes, the epoch to run
    next and the first iteration index within it (0 = epoch start; a
    mid-epoch or preemption checkpoint saves the epoch in progress and the
    next iteration, so no data is skipped or redone on resume). Returns the
    path written."""
    os.makedirs(folder, exist_ok=True)
    payload = _payload(epoch, state, next_iter)
    path = os.path.abspath(os.path.join(folder, (tag or f"epoch_{epoch:03d}") + EXT))
    _write(path, payload)
    if is_best:
        _write(os.path.abspath(os.path.join(folder, "model_best" + EXT)), payload)
    return path


def restore_checkpoint(path: str, state):
    """Restore into an existing TrainState (same model and optimizer
    layout), in place. Returns (state, epoch, next_iter): resume at that
    epoch, skipping its first ``next_iter`` iterations."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["params"], strict=True)
    if set(ckpt["ema_params"]) != set(state.ema_params):
        raise ValueError("checkpoint / model structure mismatch (EMA parameters)")
    with torch.no_grad():
        for name, value in ckpt["ema_params"].items():
            state.ema_params[name].copy_(value)
    state.tx.load_state_dict(ckpt["opt_state"])
    state.step = int(ckpt["step"])
    state.loss_normalizer = ckpt["loss_normalizer"].to(device)
    state.generator.set_state(ckpt["rng"])
    return state, int(ckpt["epoch"]), int(ckpt.get("next_iter", 0))


def restore_params(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Only the (EMA) parameters, as a state dict for ``load_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["ema_params" if use_ema and "ema_params" in ckpt else "params"]


def latest_epoch_path(folder: str) -> Optional[str]:
    """The newest ``epoch_<N>`` checkpoint of a folder, or None."""
    if not os.path.isdir(folder):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(folder):
        m = re.fullmatch(r"epoch_(\d+)" + re.escape(EXT), name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(folder, name)
    return best

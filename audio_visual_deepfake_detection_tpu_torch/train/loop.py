"""Epoch loop (JAX ``train/loop.py``).

``train_one_epoch`` drives the train step over the loader with loss meters,
periodic console / metrics logging and mid-epoch checkpoints.

Resume: a mid-epoch checkpoint stores (epoch in progress, next_iter);
``start_iter`` skips exactly that many leading iterations of the same
deterministic loader order (seeded by epoch), so a resumed run continues
with the batch the stopped run would have trained next.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .checkpoint import save_checkpoint
from .meters import AverageMeter, MetricsLogger


def pad_batch_to(batch: dict, target: int) -> dict:
    """Pad the leading axis of a numpy batch to ``target`` (one batch shape
    for the last partial batch). Padded rows get mask = False and has_gt =
    False, which zeroes the point-level losses; the batch-summed video-level
    loss needs the emitted ``row_valid`` mask, which ``compute_losses``
    takes: with it a padded batch's losses equal the unpadded batch's.
    A host tensor (the inference collators' features in the model's dtype)
    is padded as a tensor of its dtype, pinned if it was."""
    b = (batch["streams"][0] if "streams" in batch else batch["feats"]).shape[0]
    if b == target:
        return batch
    pad = target - b

    def pad_one(value, fill=0):
        if isinstance(value, torch.Tensor):
            out = torch.empty((target,) + tuple(value.shape[1:]), dtype=value.dtype,
                              pin_memory=value.is_pinned())
            out[:b].copy_(value)
            out[b:].fill_(fill)
            return out
        value = np.asarray(value)
        filler = np.full((pad,) + value.shape[1:], fill, value.dtype)
        return np.concatenate([value, filler], axis=0)

    out = {}
    for key, value in batch.items():
        if key == "video_ids":
            out[key] = value
        elif key == "streams":      # online path: tuple of (B, T_cap, C)
            out[key] = tuple(pad_one(v) for v in value)
        elif key == "rows":         # 1 row, not 0: the resample divides by it
            out[key] = tuple(pad_one(v, 1) for v in value)
        elif key in ("fps", "duration", "feat_stride", "feat_num_frames"):
            out[key] = pad_one(value, 1)     # the decode divides by these
        else:
            out[key] = pad_one(value)
    out["row_valid"] = np.arange(target) < b
    out["_real_rows"] = b
    return out


def device_prefetch(batch_iter, device, depth: int = 2):
    """Overlap host -> device transfer with device compute: up to ``depth``
    batches are in flight ahead of consumption, copied from pinned memory
    without blocking when the device is a CUDA card."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put_one(value):
        if isinstance(value, (tuple, list)):
            return tuple(put_one(v) for v in value)
        t = torch.as_tensor(value)
        return t.pin_memory().to(device, non_blocking=True) if cuda else t

    def put(batch):
        return {k: v if k == "video_ids" or k.startswith("_") else put_one(v)
                for k, v in batch.items()}

    buf = collections.deque()
    it = iter(batch_iter)
    try:
        for _ in range(depth):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield nxt


def is_writer() -> bool:
    """True on the process that writes checkpoints: rank 0 of an initialised
    process group, or the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def train_one_epoch(loader, state, train_step: Callable, curr_epoch: int,
                    schedule=None, logger: Optional[MetricsLogger] = None,
                    print_freq: int = 20, ckpt_every_iters: int = 0,
                    ckpt_folder: Optional[str] = None, batch_size: Optional[int] = None,
                    preempt=None, preempt_check_every: int = 20, start_iter: int = 0):
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(curr_epoch)
    num_iters = len(loader)
    device = next(state.model.parameters()).device
    batch_time = AverageMeter()
    trackers: Dict[str, AverageMeter] = {}
    print(f"\n[Train]: Epoch {curr_epoch:d} started"
          + (f" at iter {start_iter:d}" if start_iter else ""))
    start = time.time()

    # resume skip: the loader's index-level skip where it has one (no
    # feature IO for the skipped batches), else consume and discard
    skip = start_iter
    if start_iter and hasattr(loader, "set_skip"):
        loader.set_skip(start_iter)
        skip = 0

    def host_batches():
        for i, batch in enumerate(loader):
            if i < skip:
                continue
            if batch_size is not None:
                batch = pad_batch_to(batch, batch_size)
            yield {k: v for k, v in batch.items() if k not in ("_real_rows", "video_ids")}

    def save_preempt(next_iter: int):
        # one writer, as the JAX loop's process 0; every process stops
        if ckpt_folder and is_writer():
            save_checkpoint(
                ckpt_folder,
                curr_epoch + 1 if next_iter >= num_iters else curr_epoch,
                state,
                tag=f"preempt_epoch_{curr_epoch:03d}_iter{next_iter}",
                next_iter=0 if next_iter >= num_iters else next_iter)
        preempt.triggered = True
        print(f"[Train]: preemption requested, stopped at epoch "
              f"{curr_epoch:d} after iter {next_iter - 1:d}"
              + (f", checkpoint in {ckpt_folder}" if ckpt_folder else ""))

    for iter_idx, batch in enumerate(device_prefetch(host_batches(), device),
                                     start=start_iter):
        state, losses = train_step(state, batch)

        if iter_idx != 0 and iter_idx % print_freq == 0:
            scalars = {f"train/{key}": float(value) for key, value in losses.items()}
            batch_time.update((time.time() - start) / print_freq)   # float() synchronised
            start = time.time()
            for key, value in scalars.items():
                trackers.setdefault(key[6:], AverageMeter()).update(value)
            if schedule is not None:
                scalars["train/learning_rate"] = float(schedule(state.step))
            if logger is not None:
                logger.log(state.step, scalars)
            fl = trackers["final_loss"]
            parts = [
                f"Epoch: [{curr_epoch:03d}][{iter_idx:05d}/{num_iters:05d}]",
                f"Time {batch_time.val:.2f} ({batch_time.avg:.2f})",
                f"Loss {fl.val:.2f} ({fl.avg:.2f})",
            ]
            parts += [f"{k} {m.val:.2f} ({m.avg:.2f})"
                      for k, m in trackers.items() if k != "final_loss"]
            print("\t".join(parts))

        if ckpt_every_iters > 0 and iter_idx > 0 and iter_idx % ckpt_every_iters == 0 \
                and ckpt_folder:
            # the tag names the epoch in progress and the next iteration,
            # as the payload (and the preempt_* tags) do
            save_checkpoint(ckpt_folder, curr_epoch, state,
                            tag=f"epoch_{curr_epoch:03d}_iter{iter_idx + 1}",
                            next_iter=iter_idx + 1)

        # preemption poll on a fixed cadence: every process reaches the same
        # iteration index, which agreed() needs when it is a collective
        if preempt is not None and (iter_idx + 1) % preempt_check_every == 0 \
                and preempt.agreed():
            save_preempt(iter_idx + 1)
            return state

    # end-of-epoch poll: a signal that landed after the cadence last fired
    if preempt is not None and not preempt.triggered and preempt.agreed():
        save_preempt(num_iters)
        return state

    if schedule is not None:
        print(f"[Train]: Epoch {curr_epoch:d} finished with "
              f"lr={float(schedule(state.step)):.8f}\n")
    return state

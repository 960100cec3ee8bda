"""Sharded test inference: a shard list of feature caches -> numbered JSON
flushes of detections (the port's counterpart of the root ``inference.py``).

    python -m audio_visual_deepfake_detection_tpu_torch.cli.inference \\
        CONFIG SUB_INDEX --ckpt RUN_FOLDER_OR_FILE [--device cuda|cpu]

Reads ``deepfake_test_sub{SUB_INDEX}.txt`` from the config's
``dataset.test_folder``, loads each video's three feature caches, truncates
the audio rows, resamples every stream to ``max_seq_len`` on the host (the
native ``runtime/host_resample.py``; ``--device-resample`` ships the raw
streams, zero-padded to ``--stream-caps``, and resamples on the device),
batches, runs the localizer with the checkpoint's EMA weights and streams
the detections to ``<output_folder>/<SUB_INDEX>/data_left<N>.json``.
Features cross to the device in the model's dtype, from pinned host memory
on a card. SIGTERM flushes what is pending and stops after the current
batch; ``--resume`` then skips the videos the folder's flushes hold.

The run is on the card unless ``--device cpu`` asks for the CPU. It runs as
process 0 of 1 (data parallelism is not ported) and still takes its share
of the shard through ``plan_host_share``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import torch

from ..core.config import arch_config_from, load_config, test_config_from
from ..core.runtime import entry_device
from ..data import DataLoader, DeepfakeInferenceDataset
from ..infer.resume import plan_host_share
from ..infer.runner import (
    build_inference_fn, build_online_inference_fn, collate_infer_varlen, collate_streams,
    inference_one_epoch)
from ..models.meta_arch import DTYPES, AVLocalizer
from ..train.checkpoint import latest_epoch_path, restore_params
from ..train.loop import pad_batch_to
from ..train.preempt import PreemptionGuard


def resolve_checkpoint(ckpt: str, epoch: int = -1) -> str:
    """A checkpoint file, or a run folder: its ``epoch_<epoch>`` file, else
    its newest ``epoch_<N>``."""
    if not os.path.isdir(ckpt):
        return ckpt
    if epoch > 0:
        return os.path.join(ckpt, f"epoch_{epoch:03d}.pt")
    path = latest_epoch_path(ckpt)
    if path is None:
        raise FileNotFoundError(f"no epoch_<N>.pt checkpoint in {ckpt}")
    return path


def load_localizer(cfg, ckpt: str, device: torch.device, use_ema: bool = True) -> AVLocalizer:
    """The localizer of ``cfg`` with the checkpoint's (EMA) weights, in eval
    mode on ``device``."""
    model = AVLocalizer(cfg)
    model.load_state_dict(restore_params(ckpt, use_ema=use_ema), strict=True)
    return model.to(device).eval()


def collate_streams_batch(samples: List[dict], caps: List[int], dtype=torch.float32,
                          pin: bool = False) -> Dict:
    """Batch raw streams for ``--device-resample``: each stream zero-padded
    to its cap in a (pinned) host tensor of the model's dtype."""
    streams, rows, duration, video_ids = collate_streams(samples, caps)
    out = []
    for s in streams:
        t = torch.empty(s.shape, dtype=dtype, pin_memory=pin)
        t.copy_(torch.from_numpy(s))
        out.append(t)
    return {"streams": tuple(out), "rows": rows, "duration": duration,
            "video_ids": video_ids}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Sharded inference")
    parser.add_argument("config", type=str)
    parser.add_argument("sub_index", type=int, help="test shard index (1..7)")
    parser.add_argument("--ckpt", type=str, required=True,
                        help="checkpoint file or run folder")
    parser.add_argument("--epoch", type=int, default=-1)
    parser.add_argument("--topk", type=int, default=-1, help="override max_seg_num")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")
    parser.add_argument("--device-resample", action="store_true",
                        help="ship the raw ragged streams and resample + concatenate "
                             "them on the device instead of on the host")
    parser.add_argument("--stream-caps", type=str, default="960,400,1520",
                        help="comma-separated per-stream row caps for "
                             "--device-resample (the dataset's stream order: "
                             "video, byola, emotion)")
    parser.add_argument("--flush-every", type=int, default=5000)
    parser.add_argument("--resume", action="store_true",
                        help="skip the videos already in this shard's data*.json "
                             "flushes (restart after a crash or a preemption)")
    parser.add_argument("-p", "--print-freq", type=int, default=20)
    return parser


def run(args: argparse.Namespace, preempt: Optional[PreemptionGuard] = None) -> Dict:
    """One shard. ``preempt``: the guard to poll (default: one installed on
    SIGTERM for the run). Returns a summary: videos done, seconds, whether
    the run was preempted, the output folder, the videos found done by
    ``--resume``, and the sweep's own breakdown (``inference_one_epoch``'s
    ``stats``)."""
    device = entry_device(args.device)
    config = load_config(args.config)
    cfg = arch_config_from(config)
    test_cfg = test_config_from(config)
    if args.topk > 0:
        test_cfg = dataclasses.replace(test_cfg, max_seg_num=args.topk)
    ckpt = resolve_checkpoint(args.ckpt, args.epoch)

    dataset_cfg = dict(config["dataset"])
    if args.device_resample:
        dataset_cfg["device_resample"] = True
    dataset = DeepfakeInferenceDataset(config["dataset_name"], config["test_split"],
                                       args.sub_index, dataset_cfg)
    dtype, pin = DTYPES[cfg.compute_dtype], device.type == "cuda"
    if args.device_resample:
        caps = [int(c) for c in args.stream_caps.split(",")]
        if len(caps) != len(dataset.streams):
            raise ValueError(f"--stream-caps needs {len(dataset.streams)} values "
                             f"(streams: {dataset.streams})")

        def collate(samples):
            return collate_streams_batch(samples, caps, dtype, pin)
    else:
        def collate(samples):
            return collate_infer_varlen(samples, cfg.max_div_factor, cfg.max_seq_len,
                                        dtype, pin)

    model = load_localizer(cfg, ckpt, device)
    if args.device_resample:
        infer_fn = build_online_inference_fn(
            cfg, test_cfg, float(config["dataset"]["feat_stride"]),
            float(config["dataset"]["num_frames"]))
    else:
        infer_fn = build_inference_fn(cfg, test_cfg)

    out_folder = os.path.join(config["output_folder"], str(args.sub_index))
    os.makedirs(out_folder, exist_ok=True)
    # the process's share first, then (resuming) less what its folder holds
    before = len(dataset)
    dataset.data_list, done = plan_host_share(dataset.data_list, 0, 1, out_folder,
                                              args.resume)
    if args.resume:
        print(f"Resume: {before - len(dataset)}/{before} videos already flushed, "
              f"{len(dataset)} to go")
    loader = DataLoader(dataset, args.batch_size, collate, shuffle=False, drop_last=False,
                        num_workers=config["loader"]["num_workers"])

    def batches():
        for batch in loader:
            yield pad_batch_to(batch, args.batch_size)

    guard = preempt if preempt is not None else PreemptionGuard()
    stats: Dict[str, float] = {}
    start = time.time()
    try:
        inference_one_epoch(batches(), infer_fn, model, output_folder=out_folder,
                            flush_every=args.flush_every, print_freq=args.print_freq,
                            seen_offset=len(done), preempt=guard, collect_items=False,
                            stats=stats)
    finally:
        if preempt is None:
            guard.restore()
    total = time.time() - start
    if guard.triggered:
        print(f"Shard {args.sub_index}: preempted after {stats['videos']} videos, "
              f"{total:.1f}s -> {out_folder} (restart with --resume)")
    else:
        print(f"Shard {args.sub_index}: {stats['videos']} videos in {total:.1f}s "
              f"({stats['videos'] / max(total, 1e-9):.1f} videos/s) -> {out_folder}")
    return {"videos": stats["videos"], "seconds": total, "preempted": guard.triggered,
            "out_folder": out_folder, "done_before": len(done), "stats": stats}


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

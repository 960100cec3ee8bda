"""Raw media -> submission files and mAP in one command (the port's
counterpart of the root ``end_to_end.py``, with its arguments):

    python -m audio_visual_deepfake_detection_tpu_torch.cli.end_to_end CONFIG \\
        --metadata-root DIR --data-root DIR [--wav-root DIR] [--ckpt CKPT] \\
        [--output runs/e2e] [--resume] [--device cuda|cpu]

Walks the metadata tree (``pipeline.discover_media``), decodes each video
on ``--decode-workers`` host threads, runs the three frontends and the
config's localizer on the card (``pipeline.MediaPipeline``), and writes
``prediction.txt``, ``prediction.json``, ``eval_proposals.json``, the mAP
and ``e2e_summary.json`` to ``--output``. The frontends run in the config's
``tpu.compute_dtype`` unless ``--frontend-dtype`` says otherwise; their
weights are random from ``--seed``, and so are the localizer's unless
``--ckpt`` names a port checkpoint or run folder (a reference ``.pth.tar``
converts with ``cli/convert_checkpoint.py``). SIGTERM finishes the batch in
flight, flushes and exits 0; ``--resume`` then goes on with no video redone.

The run is on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from ..core.config import arch_config_from, load_config, test_config_from
from ..core.runtime import entry_device
from ..models.meta_arch import build_localizer
from ..pipeline import MediaPipeline, discover_media, run_media_pipeline
from ..train.preempt import PreemptionGuard
from .extract_features import VIDEO_ENCODERS, build_extractor, video_chunk_buckets
from .inference import load_localizer, resolve_checkpoint


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Raw media -> submission + mAP")
    parser.add_argument("config")
    parser.add_argument("--metadata-root", required=True)
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--wav-root", default="",
                        help="pre-extracted 16 kHz wavs (else each file's own track; "
                             "synthetic audio where the host has no audio decoder)")
    parser.add_argument("--ckpt", default="",
                        help="port checkpoint file or run folder; random weights when "
                             "omitted")
    parser.add_argument("--output", default="runs/e2e")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--flush-every", type=int, default=5000)
    parser.add_argument("--resume", action="store_true",
                        help="skip videos already present in the output folder's data*.json "
                             "flushes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--video-encoder", default="mvit_v2_b", choices=VIDEO_ENCODERS,
                        help="the reference checkpoint's production encoder is mvit_b "
                             "(video_encoder.py:192)")
    parser.add_argument("--video-chunk-bucketing", action="store_true",
                        help="tail chunks at the smallest quarter-of---video-chunk bucket "
                             ">= their length (off by default: a measured mAP cost)")
    parser.add_argument("--video-chunk", type=int, default=512)
    parser.add_argument("--decode-workers", type=int, default=4,
                        help="host video / audio decode threads")
    parser.add_argument("--frontend-dtype", default="", choices=["", "float32", "bfloat16"],
                        help="frontend compute dtype (default: the config's "
                             "tpu.compute_dtype)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")
    return parser


def run(args: argparse.Namespace, preempt: Optional[PreemptionGuard] = None) -> Dict:
    """One sweep. ``preempt``: the guard to poll (default: one installed on
    SIGTERM for the run). Returns the summary that ``e2e_summary.json``
    holds (a preempted run writes no file)."""
    device = entry_device(args.device)
    config = load_config(args.config)
    cfg = arch_config_from(config)
    test_cfg = test_config_from(config)

    items, gt_records = discover_media(args.metadata_root, args.data_root,
                                       args.wav_root or None, limit=args.limit or None)
    print(f"{len(items)} videos discovered")

    fdtype = args.frontend_dtype or config.get("tpu", {}).get("compute_dtype", "float32")
    extractor = build_extractor(
        args.video_encoder, args.video_chunk, args.seed, fdtype, device,
        chunk_buckets=video_chunk_buckets(args.video_chunk, args.video_chunk_bucketing))
    if args.ckpt:
        model = load_localizer(cfg, resolve_checkpoint(args.ckpt), device)
    else:
        model = build_localizer(cfg, seed=args.seed, device=device)

    ds = config["dataset"]
    pipeline = MediaPipeline(
        extractor, cfg, test_cfg, model,
        ds_feat_stride=float(ds.get("feat_stride", 1)),
        ds_num_frames=float(ds.get("num_frames", 1)),
        batch_size=args.batch_size,
        decode_workers=args.decode_workers)
    guard = preempt if preempt is not None else PreemptionGuard()
    try:
        summary, _ = run_media_pipeline(items, pipeline, args.output, gt_records=gt_records,
                                        resume=args.resume, preempt=guard,
                                        flush_every=args.flush_every)
    finally:
        if preempt is None:
            guard.restore()
    print(json.dumps(summary))
    if summary.get("preempted"):
        print(f"Preempted after {summary['videos_done']} videos (restart with --resume)")
        return summary
    with open(os.path.join(args.output, "e2e_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

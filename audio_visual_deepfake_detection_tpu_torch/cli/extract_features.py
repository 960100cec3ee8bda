"""Feature caches from media files (the port's counterpart of the root
``extract_features.py``, with its arguments):

    python -m audio_visual_deepfake_detection_tpu_torch.cli.extract_features \\
        LIST --video-root DIR --output-root DIR [--wav-root DIR] [--device cuda|cpu]

``LIST`` holds media paths relative to ``--video-root``, one a line. Each
file is decoded on the host (``preprocess/``: native libav*, else cv2, else
ffmpeg), its audio read from ``--wav-root``'s wav of the same relative path
or decoded from its own track, and its three streams (the
``--video-encoder``'s video features: MViT-v2-b by default, as the root
script, or another MViT-v2 size, or C3D; BYOL-A; Emotion2Vec) written as
float32 ``.npy`` files under
``<output-root>/{align_video,content_audio,emotion_audio}/`` at the file's
relative path: the caches ``cli/inference.py`` and ``cli/train.py`` read.
A file whose three caches exist is skipped (``--no-skip-existing`` redoes
it); a file that fails is logged to ``<output-root>/extract_errors.txt`` and
the run goes on. Weights are random from ``--seed``.
``--video-chunk-bucketing`` runs each video's tail chunk at the smallest of
``(q, 2q, 3q, video_chunk)``, ``q = video_chunk // 4``, at least its length
(``FeatureExtractor(chunk_buckets=...)``; off by default for its measured
mAP cost).

The run is on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import torch

from ..core.runtime import entry_device
from ..frontends import mvit
from ..frontends.pipeline import CACHE_DIR_NAMES, FeatureExtractor
from ..frontends.video import C3DVideoEncoder, init_c3d

VIDEO_ENCODERS = ("c3d", "mvit_v2_t", "mvit_v2_s", "mvit_v2_b")


def video_chunk_buckets(video_chunk: int, bucketing: bool) -> Optional[Tuple[int, ...]]:
    """The root scripts' tail-chunk buckets: quarters of ``video_chunk``."""
    if not bucketing:
        return None
    q = max(video_chunk // 4, 1)
    return (q, 2 * q, 3 * q, video_chunk)


def build_extractor(video_encoder: str, video_chunk: int, seed: int, dtype: str,
                    device: torch.device, chunk_buckets=None) -> FeatureExtractor:
    """The three frontends with seeded weights in ``dtype``: the named
    video encoder (C3D, or an MViT-v2 over ``video_chunk``-frame chunks),
    ``AudioNTT2020()`` and Emotion2Vec base."""
    cdtype = getattr(torch, dtype)
    if video_encoder == "c3d":
        video = init_c3d(C3DVideoEncoder(dtype=cdtype), seed, perturb=False)
    else:
        video = mvit.init_mvit(getattr(mvit, video_encoder)(
            out_dim=256, temporal_size=video_chunk, dtype=cdtype), seed, perturb=False)
    return FeatureExtractor(video_model=video, video_chunk=video_chunk, seed=seed,
                            compute_dtype=dtype, device=device, chunk_buckets=chunk_buckets)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Extract feature caches from media files")
    parser.add_argument("file_list", help="txt of relative mp4 paths")
    parser.add_argument("--video-root", required=True)
    parser.add_argument("--wav-root", default="")
    parser.add_argument("--output-root", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-skip-existing", action="store_true",
                        help="re-extract even when all three stream caches already exist "
                             "for a clip")
    parser.add_argument("--video-encoder", default="mvit_v2_b", choices=VIDEO_ENCODERS,
                        help="visual backbone; the reference's production extractor is "
                             "MViT-v2 (video_encoder.py:65-170)")
    parser.add_argument("--video-chunk-bucketing", action="store_true",
                        help="run tail video chunks at the smallest quarter-of---video-chunk "
                             "bucket >= their length (512 -> 128/256/384/512) instead of "
                             "zero-padding to --video-chunk; C3D features are the same, "
                             "MViT features differ from the reference's padded-512 quirk; "
                             "off by default for parity")
    parser.add_argument("--video-chunk", type=int, default=512,
                        help="frames per chunk (reference uses 512)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="frontend compute dtype (parameters, norm statistics and "
                             "softmax stay f32; outputs are f32)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")
    return parser


def run(args: argparse.Namespace) -> Dict:
    """The whole list. Returns the counts of files done, skipped and failed,
    and the failures."""
    device = entry_device(args.device)
    with open(args.file_list) as f:
        rels = [line.strip() for line in f if line.strip()]
    extractor = build_extractor(
        args.video_encoder, args.video_chunk, args.seed, args.dtype, device,
        chunk_buckets=video_chunk_buckets(args.video_chunk, args.video_chunk_bucketing))
    errors = []
    skipped = 0
    cache_names = tuple(CACHE_DIR_NAMES.values())
    for i, rel in enumerate(rels):
        mp4 = os.path.join(args.video_root, rel)
        wav = os.path.join(args.wav_root, rel.replace(".mp4", ".wav")) \
            if args.wav_root else None
        rel_npy = rel.replace(".mp4", ".npy")
        # a killed sweep run again picks up where it stopped: a clip whose
        # three caches exist has nothing left to do
        if not args.no_skip_existing and all(
                os.path.exists(os.path.join(args.output_root, n, rel_npy))
                for n in cache_names):
            skipped += 1
            continue
        try:
            extractor.extract_to_cache(mp4, wav, args.output_root, rel_npy)
        except Exception as e:  # corrupt media: log it and go on
            errors.append((rel, str(e)))
        if i % 50 == 0:
            print(f"{i}/{len(rels)} done ({len(errors)} errors, {skipped} skipped)")
    if errors:
        with open(os.path.join(args.output_root, "extract_errors.txt"), "a") as f:
            for rel, err in errors:
                f.write(f"{rel}\t{err}\n")
    done = len(rels) - len(errors) - skipped
    print(f"done: {done} ok, {skipped} skipped, {len(errors)} errors")
    return {"done": done, "skipped": skipped, "errors": errors}


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

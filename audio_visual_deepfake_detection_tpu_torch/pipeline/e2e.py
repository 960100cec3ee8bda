"""Raw media -> submission as one pipeline (JAX ``pipeline/e2e.py``).

The reference runs this as four programs that meet in ``.npy`` farms and
notebook steps: the video extractor (``extract_video_features.py:99-167``),
the two audio extractors, ``inference.py:22-136`` and
``generate_results.ipynb``. Here one driver overlaps the host's decode with
the card's compute:

  decode on ``decode_workers`` host threads (native libav*, cv2 or ffmpeg
  frames resized to 96x96 on the host; the audio track, a wav file or an
  array)
    -> the three frontends on the card, batched over the batch's videos
       (``FeatureExtractor``: MViT-v2-b over every video's zero-padded
       512-frame chunks in one call, BYOL-A and Emotion2Vec over the
       zero-padded wavs)
    -> the dataset's row truncation (``deepfake_video_audio.py:2077-2078``)
    -> ``build_online_inference_fn``: per-stream resample to
       ``max_seq_len``, the localizer, decode and soft-NMS on the card
    -> result items -> ``prediction.txt`` / ``prediction.json``
    -> the challenge mAP (``Evaluation/eval.py:147-164``) given ground truth.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import ArchConfig, TestConfig
from ..data.metadata import byola_trunc_rows, emotion_trunc_rows, load_video_meta
from ..frontends.pipeline import FeatureExtractor
from ..frontends.video import chunk_video
from ..infer.runner import (build_online_inference_fn, collate_streams, inference_one_epoch,
                            items_to_table)
from ..models.meta_arch import AVLocalizer
from ..preprocess.video_io import read_video_frames, video_backend
from ..preprocess.wav import audio_backend, decode_audio, have_audio_decode, load_wav


@dataclasses.dataclass
class MediaItem:
    """One video to run: ``mp4_path`` or ``frames``. The audio is ``wav``,
    else the ``wav_path`` file, else the media file's own track; only where
    the host has no audio decoder at all, a seeded synthetic signal."""

    video_id: str
    duration: float
    mp4_path: Optional[str] = None
    wav_path: Optional[str] = None
    frames: Optional[np.ndarray] = None   # (T, H, W, 3) uint8
    wav: Optional[np.ndarray] = None      # (L,) float32 at 16 kHz


def synth_wav(video_id: str, duration: float, sample_rate: int = 16000) -> np.ndarray:
    """Seeded pseudo-audio, by the video id, for hosts with no audio decoder
    (no libav*, no ffmpeg): reproducible runs, meaningless audio features."""
    seed = int.from_bytes(hashlib.sha1(video_id.encode()).digest()[:4], "little")
    n = int(round(duration * sample_rate))
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.1


def discover_media(metadata_root: str, data_root: Optional[str] = None,
                   wav_root: Optional[str] = None, limit: Optional[int] = None,
                   ) -> Tuple[List[MediaItem], List[dict]]:
    """Walk a metadata tree ``<spk>/<clip>/<n>/<type>.json`` (its media at the
    same relative paths under ``data_root``, ``.mp4``, and ``wav_root``,
    ``.wav``). Returns (media items, challenge ground-truth records)."""
    items, gt_records = [], []
    rels = sorted(os.path.relpath(p, metadata_root)
                  for p in glob.glob(os.path.join(metadata_root, "**", "*.json"),
                                     recursive=True))
    if limit:
        rels = rels[:limit]
    for rel in rels:
        meta = load_video_meta(metadata_root, rel)
        rel_mp4 = rel.replace(".json", ".mp4")
        mp4 = os.path.join(data_root, rel_mp4) if data_root else None
        wav = os.path.join(wav_root, rel.replace(".json", ".wav")) if wav_root else None
        items.append(MediaItem(video_id=rel_mp4, duration=meta.duration, mp4_path=mp4,
                               wav_path=wav if wav and os.path.exists(wav) else None))
        gt_records.append({
            "video_id": rel_mp4,
            "segments_time": None if meta.segments is None else meta.segments.tolist(),
            "n_fakes": 0 if meta.segments is None else len(meta.segments),
        })
    return items, gt_records


class MediaPipeline:
    """Host decode, card compute. ``caps`` are the localizer infeed's
    per-stream row caps (video, BYOL-A, Emotion2Vec); by default they are
    sized from the run's longest duration, so every batch has one shape.

    ``stats`` after ``run``: ``wall_s`` and ``videos_per_s`` (host clock),
    ``decoded_by`` (how many videos each source gave frames and audio:
    ``memory``, ``native``, ``cv2``, ``ffmpeg``, ``wav``, ``synthetic``,
    ``blank``), the host seconds spent waiting on the decode threads, padding
    the chunks, in the frontends (the chunks' copy to the card included,
    synchronized by the features' fetch) and collating; and
    ``inference_one_epoch``'s breakdown (``infer_ms``: ``infer_fn``'s device
    span)."""

    def __init__(
        self,
        extractor: FeatureExtractor,
        cfg: ArchConfig,
        test_cfg: TestConfig,
        model: AVLocalizer,
        ds_feat_stride: float = 1.0,
        ds_num_frames: float = 1.0,
        batch_size: int = 4,
        prefetch_batches: int = 2,
        caps: Optional[Sequence[int]] = None,
        max_fps: float = 31.0,
        use_audio: bool = True,
        host_resize: Optional[Tuple[int, int]] = (96, 96),
        decode_workers: int = 4,
    ):
        self.extractor = extractor
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.prefetch_batches = prefetch_batches
        self.caps = tuple(caps) if caps is not None else None
        self.max_fps = max_fps
        self.use_audio = use_audio
        self.host_resize = host_resize
        # the reference's DataLoader(bs=10) extraction workers and Pool(16)
        # wav extraction: N threads, each in one decode call that releases
        # the interpreter lock. pool.map keeps item order, so the worker
        # count changes no output.
        self.decode_workers = max(1, int(decode_workers))
        self._infer_fn = build_online_inference_fn(cfg, test_cfg, ds_feat_stride,
                                                   ds_num_frames)
        self._lock = threading.Lock()        # guards stats, filled from the decode threads
        self.stats: Dict = self._new_stats()

    _warned_synth = False                 # one warning a process, not one a video
    _warn_lock = threading.Lock()

    # ---------------- host side ----------------

    @staticmethod
    def _new_stats() -> Dict:
        return {"decoded_by": {"video": collections.Counter(), "audio": collections.Counter()},
                "decode_thread_s": 0.0}

    def _decode(self, item: MediaItem) -> MediaItem:
        t0 = time.perf_counter()
        frames, wav = item.frames, item.wav
        video_source = audio_source = "memory"
        if frames is None:
            video_source = video_backend()
            try:
                # resized to the encoder's input on the host, shipped as uint8
                # (the native decoder resizes inside its decode loop)
                frames, _ = read_video_frames(item.mp4_path, size=self.host_resize)
            except Exception as e:  # a corrupt container or truncated stream
                # the submission covers every video id: substitute and go on,
                # as the reference's extractors log a failed file and go on
                # (extract_wav.py:23-26, deepfake_video_audio.py:908-917)
                h, w = self.host_resize or (96, 96)
                n = max(1, int(round(item.duration * 25.0)))
                print(f"video decode failed for {item.video_id}: {e}; "
                      "substituting blank frames")
                frames = np.zeros((n, h, w, 3), np.uint8)
                video_source = "blank"
        if wav is None and self.use_audio:
            if item.wav_path is not None:
                audio_source = "wav"
                try:
                    wav = load_wav(item.wav_path)
                except Exception as e:  # a truncated or wrong-rate wav in the farm
                    print(f"wav load failed for {item.video_id}: {e}; "
                          "substituting synthetic audio")
                    wav = synth_wav(item.video_id, item.duration)
                    audio_source = "synthetic"
            elif item.mp4_path is not None and have_audio_decode():
                audio_source = audio_backend()
                try:
                    # the real track, its trailing encoder padding cut to the
                    # metadata's duration (audio_frames / 16000: the count the
                    # offline caches saw)
                    wav = decode_audio(item.mp4_path)
                    n = int(round(item.duration * 16000))
                    if 0 < n < len(wav):
                        wav = wav[:n]
                except Exception as e:  # a corrupt or audio-less file
                    print(f"audio decode failed for {item.video_id}: {e}; "
                          "substituting synthetic audio")
                    wav = synth_wav(item.video_id, item.duration)
                    audio_source = "synthetic"
            else:
                with MediaPipeline._warn_lock:
                    if not MediaPipeline._warned_synth:
                        MediaPipeline._warned_synth = True
                        print("WARNING: no audio decoder on this host (no libav*, no "
                              "ffmpeg): substituting synthetic audio for EVERY video; "
                              "the audio streams' features will be meaningless")
                wav = synth_wav(item.video_id, item.duration)
                audio_source = "synthetic"
        with self._lock:
            self.stats["decoded_by"]["video"][video_source] += 1
            if self.use_audio:
                self.stats["decoded_by"]["audio"][audio_source] += 1
            self.stats["decode_thread_s"] += time.perf_counter() - t0
        return dataclasses.replace(item, frames=frames, wav=wav)

    def _default_caps(self, items: Sequence[MediaItem]) -> Tuple[int, ...]:
        def up8(n):
            return int(np.ceil(n / 8)) * 8

        dur = max(it.duration for it in items)
        return (up8(dur * self.max_fps + 1),
                up8(byola_trunc_rows(dur) + 2),
                up8(emotion_trunc_rows(dur) + 2))

    def _add(self, key: str, seconds: float) -> None:
        self.stats[key] = self.stats.get(key, 0.0) + seconds

    # ---------------- card side ----------------

    def _extract_batch(self, decoded: List[MediaItem]) -> List[dict]:
        """The three frontends over one batch of videos -> per-video
        localizer samples {video_id, streams, duration}."""
        t0 = time.perf_counter()
        if self.extractor.chunk_buckets:
            # bucketed tail chunks (opt-in): each video on its own, so each
            # tail runs at its own bucket's length (FeatureExtractor)
            video_rows = [self.extractor.video_features(it.frames) for it in decoded]
            samples = self._assemble_samples(decoded, video_rows)
            self._add("frontends_s", time.perf_counter() - t0)
            return samples
        # video: every video's chunks stacked into one encoder call (the
        # reference batches chunks through a bs=10 DataLoader,
        # extract_video_features.py:128-137)
        chunk = self.extractor.video_chunk
        all_chunks, counts, true_t = [], [], []
        for it in decoded:
            # uint8 frames go as they are; the extractor normalizes on the card
            frames = it.frames if it.frames.dtype == np.uint8 \
                else it.frames.astype(np.float32) / 255.0
            chunks, t = chunk_video(frames, chunk)
            all_chunks.append(chunks)
            counts.append(chunks.shape[0])
            true_t.append(t)
        shapes = {c.shape[1:] for c in all_chunks}
        if len(shapes) > 1:
            # reachable only with host_resize=None over media of mixed sizes
            raise ValueError(
                f"mixed frame shapes in one batch {sorted(shapes)} "
                f"(videos {[it.video_id for it in decoded]}); set host_resize "
                "so every video decodes to one size")
        stacked = np.concatenate(all_chunks, axis=0)
        t1 = time.perf_counter()
        vfeats = self.extractor.video_chunks_features(stacked)
        video_rows, ofs = [], 0
        for n, t in zip(counts, true_t):
            video_rows.append(vfeats[ofs:ofs + n].reshape(-1, vfeats.shape[-1])[:t])
            ofs += n
        samples = self._assemble_samples(decoded, video_rows)
        self._add("pad_s", t1 - t0)
        self._add("frontends_s", time.perf_counter() - t1)
        return samples

    def _assemble_samples(self, decoded: List[MediaItem],
                          video_rows: List[np.ndarray]) -> List[dict]:
        if self.use_audio:
            wavs = [it.wav for it in decoded]
            byola = self.extractor.byola_features_batch(wavs)
            emo = self.extractor.emotion_features_batch(wavs)
        samples = []
        for i, it in enumerate(decoded):
            streams = [video_rows[i]]
            if self.use_audio:
                # the row truncation the dataset applies to the offline
                # caches (deepfake_video_audio.py:2077-2078)
                streams.append(byola[i][:byola_trunc_rows(it.duration)])
                streams.append(emo[i][:emotion_trunc_rows(it.duration)])
            samples.append({"video_id": it.video_id, "streams": streams,
                            "duration": it.duration})
        return samples

    def _collate(self, samples: List[dict], caps: Sequence[int]) -> dict:
        # a video track longer than its audio's duration (or above max_fps)
        # can pass the static cap: trim it and say so, rather than stop a
        # sweep of 343k videos at one odd file
        for smp in samples:
            for s, arr in enumerate(smp["streams"]):
                if arr.shape[0] > caps[s]:
                    print(f"{smp['video_id']}: stream {s} rows {arr.shape[0]} > cap "
                          f"{caps[s]}; truncating")
                    smp["streams"][s] = arr[:caps[s]]
        streams, rows, duration, video_ids = collate_streams(samples, list(caps))
        return {"streams": streams, "rows": rows, "duration": duration,
                "video_ids": video_ids}

    # ---------------- the pipeline ----------------

    def batches(self, items: Sequence[MediaItem]):
        """Collated localizer batches, the decode running ahead on the
        threads (up to ``prefetch_batches`` batches beyond the one in use)."""
        if not items:  # a resumed sweep with nothing left
            return
        caps = self.caps or self._default_caps(items)
        groups = [list(items[i:i + self.batch_size])
                  for i in range(0, len(items), self.batch_size)]
        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
            pending = []
            gi = 0
            while gi < len(groups) or pending:
                while gi < len(groups) and len(pending) <= self.prefetch_batches:
                    pending.append(pool.map(self._decode, groups[gi]))
                    gi += 1
                t0 = time.perf_counter()
                decoded = list(pending.pop(0))
                self._add("decode_wait_s", time.perf_counter() - t0)
                samples = self._extract_batch(decoded)
                t0 = time.perf_counter()
                batch = self._collate(samples, caps)
                self._add("collate_s", time.perf_counter() - t0)
                yield batch

    def run(self, items: Sequence[MediaItem], output_folder: Optional[str] = None,
            print_freq: int = 50, flush_every: int = 5000,
            seen_offset: int = 0, preempt=None):
        """The whole sweep. Returns (flat prediction table, result items)."""
        self.stats = self._new_stats()
        sweep: Dict[str, float] = {}
        start = time.time()
        results, all_items = inference_one_epoch(
            self.batches(items), self._infer_fn, self.model,
            output_folder=output_folder, print_freq=print_freq,
            flush_every=flush_every, seen_offset=seen_offset, preempt=preempt, stats=sweep)
        self.stats["wall_s"] = time.time() - start
        # over the videos actually done (a preempted run stops early)
        self.stats["videos_per_s"] = len(all_items) / self.stats["wall_s"]
        self.stats["decoded_by"] = {k: dict(v) for k, v in self.stats["decoded_by"].items()}
        self.stats["sweep"] = sweep
        return results, all_items


def run_media_pipeline(
    items: Sequence[MediaItem],
    pipeline: MediaPipeline,
    out_dir: str,
    gt_records: Optional[Sequence[dict]] = None,
    verbose: bool = True,
    resume: bool = False,
    preempt=None,
    flush_every: int = 5000,
):
    """Items -> submission files, and the mAP given ground truth.

    Writes ``prediction.txt`` / ``prediction.json`` (``generate_results.ipynb``
    cells 1-2: the 0.9 probability clamp, the 0.2 score filter, the
    ``[[0, 0, 0]]`` sentinel) and, with ``gt_records``, ``eval_proposals.json``
    and the challenge's average mAP over tIoU {0.5, 0.75, 0.9, 0.95}.

    The detections flush to ``out_dir`` every ``flush_every`` videos;
    ``resume=True`` skips the videos already flushed and merges their items
    into the submission. ``preempt`` (``train.preempt.PreemptionGuard``)
    stops after the batch in flight: a preempted sweep writes its flushes and
    no submission, which would look complete and not be."""
    import json

    from ..eval.challenge import run_evaluation
    from ..infer.resume import collect_done, flush_files
    from ..infer.results import write_segment_predictions, write_video_predictions

    os.makedirs(out_dir, exist_ok=True)
    done_items: List[dict] = []
    if resume:
        done_ids = collect_done(out_dir)
        if done_ids:
            done_items = []
            for path in flush_files(out_dir):       # the order they were written in
                with open(path, encoding="utf-8") as f:
                    done_items.extend(json.load(f))
            items = [it for it in items if it.video_id not in done_ids]
            if verbose:
                print(f"Resume: {len(done_items)} videos already flushed, "
                      f"{len(items)} to go")

    results, new_items = pipeline.run(items, output_folder=out_dir, flush_every=flush_every,
                                      seen_offset=len(done_items), preempt=preempt)
    result_items = done_items + new_items

    summary = {"num_videos": len(items) + len(done_items), **pipeline.stats}
    if preempt is not None and preempt.triggered:
        summary["preempted"] = True
        summary["videos_done"] = len(result_items)
        return summary, result_items

    write_video_predictions(result_items, os.path.join(out_dir, "prediction.txt"))
    write_segment_predictions(result_items, os.path.join(out_dir, "prediction.json"))

    if done_items:
        results = items_to_table(result_items)
    if gt_records is not None and len(results["video-id"]) > 0:
        flat = {k: np.asarray(v) for k, v in results.items()}
        mAP, _ = run_evaluation(flat, gt_records, os.path.join(out_dir, "eval_proposals.json"),
                                verbose=verbose)
        summary["average_mAP"] = mAP
    return summary, result_items

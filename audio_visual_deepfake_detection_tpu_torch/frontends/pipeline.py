"""Online feature extraction: raw media -> the three feature streams (JAX
``frontends/pipeline.py``).

``FeatureExtractor`` turns raw frames into the per-frame visual features the
localizer's video stream reads (frames chunked into zero-padded
``video_chunk``-frame blocks, normalized, resized to 96x96 when they are not
already, encoded by C3D in groups of chunks or by MViT-v2 through
``hybrid_apply``), and a 16 kHz waveform into the BYOL-A content features
(log-mel, then ``AudioNTT2020``; 12.5 rows per second, 2048-d) and the
Emotion2Vec features (50 rows per second, 768-d). Its outputs are
row-compatible with the JAX package's ``.npy`` caches, which
``extract_to_cache`` writes for one media file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.kernels.patch_embed import normalize_u8
from ..preprocess.video_io import read_video_frames
from ..preprocess.wav import load_wav
from ..runtime import host_media
from .byola import AudioNTT2020, init_byola
from .emotion2vec import Emotion2Vec, Emotion2VecConfig, conv_output_length, init_emotion2vec
from .mel import HOP_LENGTH, byola_log_mel
from .mvit import MViTVideoEncoder, hybrid_apply
from .video import C3DVideoEncoder, bilinear_resize_video, chunk_video, init_c3d

# Chunks run in groups of this many (the tail group zero-padded): the front
# stages (patch embed + blocks[:split]) batched across the group, then the
# back stages batched across it too. The group bounds peak device memory for
# long videos: MViT-v2-b in bf16 peaks at 14.1 GiB with groups of 32 chunks
# on an H100 80GB (chip_smoke.py, 64 chunks). The back stages always run
# batched: on an H100 (700 W), MViT-v2-b bf16, 64 chunks, chip_smoke.py
# measured 91.85 chunks/s batched against 31.43 one chunk at a time (the
# per-chunk launches leave the card idle). The JAX default (per chunk) was a
# TPU measurement.
FRONT_CHUNK_GROUP = 32

# C3D runs its chunks batched (the JAX extractor's one apply over all
# chunks), in groups of this many so that peak device memory does not grow
# with the video's length: one 512-frame chunk holds a 604 MB bf16 activation
# after its first conv. Chunks are independent, so the groups change no result.
C3D_CHUNK_GROUP = 8

CACHE_DIR_NAMES = {"video": "align_video", "byola": "content_audio",
                   "emotion": "emotion_audio"}

AUDIO_BUCKET = 16000     # batch wavs are zero-padded to a multiple of one second


def _encoder_input(x: torch.Tensor) -> torch.Tensor:
    """Chunks as the encoders take them: f32 in [0, 1] at 96x96."""
    x = normalize_u8(x) if x.dtype == torch.uint8 else x.float()
    if tuple(x.shape[2:4]) != (96, 96):
        x = bilinear_resize_video(x, (96, 96))
    return x


class FeatureExtractor:
    """The three feature streams on the port's device. Models default to
    seeded production configurations in ``compute_dtype``, as the JAX
    extractor's do: ``C3DVideoEncoder()``, ``AudioNTT2020()`` and
    ``Emotion2Vec(emotion_cfg)``. Each default model is built at the first
    call that needs it. Parameters stay f32 and outputs are f32. ``device``
    defaults to that of the first model given, else to the card: a run on
    the CPU is asked for with ``device="cpu"``, never fallen back to.

    ``chunk_buckets`` (opt-in, e.g. (128, 256, 384, 512)): a video's full
    ``video_chunk`` blocks run as they are and its tail at the smallest
    bucket at least its length, instead of zero-padded to ``video_chunk``
    (the reference's padding). C3D's features are the same either way to
    rounding only with zero conv biases (a fresh init) and a bucket that
    leaves at least 4 zero frames after the tail: the 8 temporal convs carry
    the tail's last frames into the padding and the bucket's end back, so
    with fewer the tail's last rows move (up to ~1e-2 at 0-2 frames, ~1e-4
    at 3, ``tests/test_torch_c3d.py``), and with nonzero biases a padded
    frame's activations are not zero at all. MViT's differ (its attention
    normalizes over fewer pad tokens).
    Its measured cost on the JAX package (BENCH_NOTES round 5,
    ``tools/bucket_ap.py``): -2.8 avg mAP through a localizer trained on
    padded features, and 7-10 avg mAP below them for one trained on bucketed
    features (2 seeds), so it is off by default."""

    def __init__(self, video_model: Optional[nn.Module] = None,
                 video_chunk: int = 512, seed: int = 0,
                 compute_dtype: str = "float32", device=None,
                 byola_model: Optional[AudioNTT2020] = None,
                 emotion_model: Optional[Emotion2Vec] = None,
                 emotion_cfg: Emotion2VecConfig = Emotion2VecConfig(),
                 chunk_buckets: Optional[Sequence[int]] = None):
        self.dtype = getattr(torch, compute_dtype)
        given = next((m for m in (video_model, byola_model, emotion_model)
                      if m is not None), None)
        if device is not None:
            self.device = torch.device(device)
        elif given is not None:
            self.device = next(given.parameters()).device
        else:
            self.device = torch.device("cuda")
        self._models = {"video": video_model, "byola": byola_model, "emotion": emotion_model}
        self._seed, self._emotion_cfg = seed, emotion_cfg
        self.video_chunk = video_chunk
        self.chunk_buckets = tuple(sorted(chunk_buckets)) if chunk_buckets else None

    def _model(self, which: str):
        """The stream's model on the device, built on first use."""
        if self._models[which] is None:
            self._models[which] = {
                "video": lambda: init_c3d(C3DVideoEncoder(dtype=self.dtype), self._seed,
                                          perturb=False),
                "byola": lambda: init_byola(AudioNTT2020(dtype=self.dtype), self._seed,
                                            perturb=False),
                "emotion": lambda: init_emotion2vec(
                    Emotion2Vec(self._emotion_cfg, dtype=self.dtype), self._seed,
                    perturb=False),
            }[which]()
        model = self._models[which]
        if next(model.parameters()).device != self.device:
            model.to(self.device)
        return model.eval()

    @property
    def video_model(self) -> nn.Module:
        return self._model("video")

    @property
    def byola_model(self) -> AudioNTT2020:
        return self._model("byola")

    @property
    def emotion_model(self) -> Emotion2Vec:
        return self._model("emotion")

    # ---------------------------------------------------------------- video

    def video_features(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) -> (T, D). uint8 frames are normalized /255, float
        frames are taken as already in [0, 1]. With ``chunk_buckets`` the
        tail block runs at its bucket's length (one encoder call a block)."""
        norm = (frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8
                else np.asarray(frames, np.float32))
        if not self.chunk_buckets:
            chunks, t = chunk_video(norm, self.video_chunk)
            feats = self.video_chunks_features(chunks)
            return feats.reshape(-1, feats.shape[-1])[:t]
        out, pos, t = [], 0, frames.shape[0]
        while pos < t:
            rem = t - pos
            size = self.video_chunk if rem >= self.video_chunk else next(
                (b for b in self.chunk_buckets if b >= rem), self.video_chunk)
            n = min(rem, size)
            block = np.zeros((size,) + norm.shape[1:], np.float32)
            block[:n] = norm[pos:pos + n]
            out.append(self.video_chunks_features(block[None])[0, :n])
            pos += n
        return np.concatenate(out, axis=0)

    def video_chunks_features(self, chunks) -> np.ndarray:
        """(N, chunk, H, W, 3) float [0, 1] or uint8 -> (N, chunk, D) f32.
        uint8 chunks are copied as they are. MViT: at 96x96 they go to the
        patch embed as they are, which normalizes them (x 1/255 in f32, as
        the JAX pipeline does before its encoder); other sizes are
        normalized and resized on the device first. C3D: each group of
        ``C3D_CHUNK_GROUP`` chunks is normalized, resized where needed and
        encoded in one batch."""
        return self.video_chunks_features_device(chunks).cpu().numpy()

    @torch.no_grad()
    def video_chunks_features_device(self, chunks) -> torch.Tensor:
        """As ``video_chunks_features``, leaving the features on the device."""
        x = torch.as_tensor(chunks).to(self.device)
        model = self.video_model
        if isinstance(model, MViTVideoEncoder):
            if x.dtype != torch.uint8 or tuple(x.shape[2:4]) != (96, 96):
                x = _encoder_input(x)
            return hybrid_apply(model, x, front_group=FRONT_CHUNK_GROUP, batched_back=True)
        return torch.cat([model(_encoder_input(x[i:i + C3D_CHUNK_GROUP]))
                          for i in range(0, x.shape[0], C3D_CHUNK_GROUP)])

    # ---------------------------------------------------------------- audio

    def byola_features(self, wav: np.ndarray) -> np.ndarray:
        """(L,) 16 kHz -> (~L / 1280, 2048) at 12.5 Hz."""
        return self.byola_features_device(np.asarray(wav)[None])[0].cpu().numpy()

    def emotion_features(self, wav: np.ndarray) -> np.ndarray:
        """(L,) 16 kHz -> (~L / 320, 768) at 50 Hz."""
        return self.emotion_features_device(np.asarray(wav)[None])[0].cpu().numpy()

    @torch.no_grad()
    def byola_features_device(self, wavs, lens=None) -> torch.Tensor:
        """(B, L) wavs -> (B, T / 8, 2048) on the device. With ``lens`` (B,),
        the true sample counts of zero-padded wavs, the normalized log-mel
        frames past ``1 + len // 160`` are zeroed, as the reference's batch
        extraction pads the log-mel."""
        wav = torch.as_tensor(wavs, dtype=torch.float32).to(self.device)
        lms = byola_log_mel(wav)                                  # (B, M, T)
        if lens is not None:
            frames = 1 + torch.as_tensor(lens).to(self.device) // HOP_LENGTH
            valid = torch.arange(lms.shape[-1], device=self.device)[None, :] < frames[:, None]
            lms = lms * valid[:, None, :]
        return self.byola_model(lms.transpose(-1, -2))

    @torch.no_grad()
    def emotion_features_device(self, wavs, lens=None) -> torch.Tensor:
        """(B, L) wavs -> (B, T', 768) on the device. With ``lens`` (B,), the
        true sample counts of zero-padded wavs, the samples past each count
        are masked as padding."""
        wav = torch.as_tensor(wavs, dtype=torch.float32).to(self.device)
        mask = None
        if lens is not None:
            lens = torch.as_tensor(lens).to(self.device)
            mask = torch.arange(wav.shape[1], device=self.device)[None, :] >= lens[:, None]
        return self.emotion_model(wav, mask)

    @staticmethod
    def _pad_bucket(wavs: Sequence[np.ndarray], bucket: int = AUDIO_BUCKET):
        """Zero-pad a list of 1-D wavs to a shared bucketed length."""
        lens = np.asarray([len(w) for w in wavs], np.int32)
        cap = int(np.ceil(lens.max() / bucket) * bucket)
        out = np.zeros((len(wavs), cap), np.float32)
        for i, w in enumerate(wavs):
            out[i, :len(w)] = w
        return out, lens

    def emotion_features_batch(self, wavs) -> List[np.ndarray]:
        """Batched Emotion2Vec extraction with the reference's batch
        semantics: zero-padded wav batch and padding mask into the model,
        each file sliced to its true frame count."""
        batch, lens = self._pad_bucket(wavs)
        out = self.emotion_features_device(batch, lens).cpu().numpy()
        return [out[i, :conv_output_length(int(n))] for i, n in enumerate(lens)]

    def byola_features_batch(self, wavs) -> List[np.ndarray]:
        """Batched BYOL-A extraction: the reference pads the normalized
        log-mel with zeros and keeps the padded-length features (truncation
        happens downstream in the dataset), mirrored here by zeroing the mel
        frames past each file's true frame count."""
        batch, lens = self._pad_bucket(wavs)
        return list(self.byola_features_device(batch, lens).cpu().numpy())

    # ---------------------------------------------------------------- files

    def extract_all(self, mp4_path: str, wav_path: Optional[str] = None
                    ) -> Dict[str, np.ndarray]:
        """The three streams of one media file. The audio comes from
        ``wav_path`` when that file exists (a wav farm), else from the
        file's own track through the native decoder where it is available;
        with neither, only the video stream is returned."""
        frames, _ = read_video_frames(mp4_path)
        out = {"video": self.video_features(frames)}
        wav = None
        if wav_path and os.path.exists(wav_path):
            wav = load_wav(wav_path)
        elif host_media.available():
            wav = host_media.decode_audio(mp4_path)
        if wav is not None:
            out["byola"] = self.byola_features(wav)
            out["emotion"] = self.emotion_features(wav)
        return out

    def extract_to_cache(self, mp4_path: str, wav_path: Optional[str],
                         cache_root: str, rel_npy: str) -> None:
        """``extract_all``'s streams as float32 ``.npy`` files at
        ``cache_root/<CACHE_DIR_NAMES[stream]>/rel_npy``."""
        for key, arr in self.extract_all(mp4_path, wav_path).items():
            path = os.path.join(cache_root, CACHE_DIR_NAMES[key], rel_npy)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # tmp + rename: a kill mid-write must never leave a truncated
            # .npy that a skip-existing rerun would then trust
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, arr.astype(np.float32))
            os.replace(tmp, path)

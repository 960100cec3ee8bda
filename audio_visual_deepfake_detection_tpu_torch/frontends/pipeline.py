"""Online feature extraction: raw media -> the three feature streams (JAX
``frontends/pipeline.py``).

``FeatureExtractor`` turns raw frames into the per-frame visual features the
localizer's video stream reads (frames chunked into zero-padded
``video_chunk``-frame blocks, normalized, resized to 96x96 when they are not
already, encoded by MViT-v2 through ``hybrid_apply``), and a 16 kHz waveform
into the BYOL-A content features (log-mel, then ``AudioNTT2020``; 12.5 rows
per second, 2048-d) and the Emotion2Vec features (50 rows per second,
768-d). Its outputs are row-compatible with the JAX package's ``.npy``
caches.

Not ported: the opt-in tail-chunk bucketing (ROADMAP queue 1 item 10), and
the file-level ``extract_all`` / ``extract_to_cache`` (item 6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.kernels.patch_embed import normalize_u8
from .byola import AudioNTT2020, init_byola
from .emotion2vec import Emotion2Vec, Emotion2VecConfig, conv_output_length, init_emotion2vec
from .mel import HOP_LENGTH, byola_log_mel
from .mvit import MViTVideoEncoder, hybrid_apply, init_mvit, mvit_v2_b
from .video import bilinear_resize_video, chunk_video

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

CACHE_DIR_NAMES = {"video": "align_video", "byola": "content_audio",
                   "emotion": "emotion_audio"}

AUDIO_BUCKET = 16000     # batch wavs are zero-padded to a multiple of one second


class FeatureExtractor:
    """The three feature streams on the port's device. Models default to
    seeded production configurations in ``compute_dtype``: MViT-v2-b (the JAX
    extractor's default is C3D, which is not ported: ROADMAP queue 1 item
    10), ``AudioNTT2020()`` and ``Emotion2Vec(emotion_cfg)``. Each default
    model is built at the first call that needs it. Parameters stay f32 and
    outputs are f32. ``device`` defaults to that of the first model given,
    else to the card: a run on the CPU is asked for with ``device="cpu"``,
    never fallen back to."""

    def __init__(self, video_model: Optional[MViTVideoEncoder] = None,
                 video_chunk: int = 512, seed: int = 0,
                 compute_dtype: str = "float32", device=None,
                 byola_model: Optional[AudioNTT2020] = None,
                 emotion_model: Optional[Emotion2Vec] = None,
                 emotion_cfg: Emotion2VecConfig = Emotion2VecConfig()):
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

    def _model(self, which: str):
        """The stream's model on the device, built on first use."""
        if self._models[which] is None:
            self._models[which] = {
                "video": lambda: init_mvit(mvit_v2_b(dtype=self.dtype), self._seed,
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
    def video_model(self) -> MViTVideoEncoder:
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
        frames are taken as already in [0, 1]."""
        norm = (frames.astype(np.float32) / 255.0 if frames.dtype == np.uint8
                else np.asarray(frames, np.float32))
        chunks, t = chunk_video(norm, self.video_chunk)
        feats = self.video_chunks_features(chunks)
        return feats.reshape(-1, feats.shape[-1])[:t]

    def video_chunks_features(self, chunks) -> np.ndarray:
        """(N, chunk, H, W, 3) float [0, 1] or uint8 -> (N, chunk, D) f32.
        uint8 chunks are copied as they are; at 96x96 they go to the patch
        embed as they are, which normalizes them (x 1/255 in f32, as the JAX
        pipeline does before its encoder); other sizes are normalized and
        resized on the device first."""
        return self.video_chunks_features_device(chunks).cpu().numpy()

    @torch.no_grad()
    def video_chunks_features_device(self, chunks) -> torch.Tensor:
        """As ``video_chunks_features``, leaving the features on the device."""
        x = torch.as_tensor(chunks).to(self.device)
        if x.dtype != torch.uint8 or tuple(x.shape[2:4]) != (96, 96):
            x = normalize_u8(x) if x.dtype == torch.uint8 else x.float()
            if tuple(x.shape[2:4]) != (96, 96):
                x = bilinear_resize_video(x, (96, 96))
        return hybrid_apply(self.video_model, x, front_group=FRONT_CHUNK_GROUP,
                            batched_back=True)

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

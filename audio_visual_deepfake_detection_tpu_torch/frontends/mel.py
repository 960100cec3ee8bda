"""Log-mel spectrogram frontend of BYOL-A (JAX ``frontends/mel.py``).

torchaudio's ``MelSpectrogram(sample_rate=16000, n_fft=1024, win_length=1024,
hop_length=160, n_mels=64, f_min=60, f_max=7800)`` with its defaults (power 2,
center, reflect padding, periodic Hann window, HTK mel scale, no filterbank
norm), then ``log(x + eps)`` and the PrecomputedNorm statistics.

As in the JAX package the STFT is framing plus two matrix products against
windowed cos/sin DFT matrices, followed by the mel projection: plain
``torch.matmul`` in float32 (``set_numerics`` keeps TF32 off). It is not an
FFT call, which would round differently from the reference.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 1024
WIN_LENGTH = 1024
HOP_LENGTH = 160
N_MELS = 64
F_MIN = 60.0
F_MAX = 7800.0
EPS = float(np.finfo(np.float32).eps)
BYOLA_NORM_STATS = (-2.2800865, 3.5897882)


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS,
                   sample_rate: int = SAMPLE_RATE, f_min: float = F_MIN,
                   f_max: float = F_MAX) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK filterbank, no normalization."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_mel_matrices(n_fft: int, n_mels: int, sample_rate: int,
                      f_min: float, f_max: float):
    """Windowed cos/sin DFT matrices (n_fft, n_freqs) and the mel filterbank."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    win = hann_window(n_fft)[:, None].astype(np.float64)
    cos_m = (np.cos(angle) * win).astype(np.float32)
    sin_m = (-np.sin(angle) * win).astype(np.float32)
    return cos_m, sin_m, mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)


def frame_signal(wav: torch.Tensor, n_fft: int = N_FFT,
                 hop: int = HOP_LENGTH) -> torch.Tensor:
    """Center-pad (reflect) and frame: (..., L) -> (..., T, n_fft), a view."""
    pad = n_fft // 2
    if wav.shape[-1] <= pad:
        # reflect padding needs pad < length: a waveform shorter than 32 ms
        # is zero-extended first (torch.stft would raise; a sweep must
        # survive such files)
        wav = F.pad(wav, (0, pad + 1 - wav.shape[-1]))
    lead = wav.shape[:-1]
    x = F.pad(wav.reshape(1, -1, wav.shape[-1]), (pad, pad), mode="reflect")
    return x.reshape(*lead, -1).unfold(-1, n_fft, hop)


def mel_spectrogram(wav: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP_LENGTH,
                    n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE,
                    f_min: float = F_MIN, f_max: float = F_MAX) -> torch.Tensor:
    """(..., L) waveform -> (..., n_mels, T) power mel spectrogram (f32)."""
    cos_m, sin_m, fb = (torch.from_numpy(m).to(wav.device) for m in
                        _dft_mel_matrices(n_fft, n_mels, sample_rate, f_min, f_max))
    frames = frame_signal(wav.float(), n_fft, hop)
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb
    return mel.transpose(-1, -2)


def byola_log_mel(wav: torch.Tensor,
                  stats: Tuple[float, float] = BYOLA_NORM_STATS) -> torch.Tensor:
    """Full BYOL-A frontend: (..., L) -> normalized log-mel (..., n_mels, T)."""
    mean, std = stats
    return (torch.log(mel_spectrogram(wav) + EPS) - mean) / std

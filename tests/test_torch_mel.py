"""PyTorch port: the log-mel frontend vs the JAX package on the CPU, f32.

Framing is index arithmetic (exact); the DFT and mel products sum 1024 and
513 terms in another order than XLA, so the power spectrogram agrees to
rtol 1e-4 and the normalized log-mel to atol 1e-4 (found: 4.8e-7 at most
on these inputs)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.frontends import mel as jmel
from audio_visual_deepfake_detection_tpu_torch.frontends import mel as tmel


def _wav(length, seed=0, b=2):
    return (np.random.default_rng(seed).standard_normal((b, length)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("length", [16000, 200])
def test_frame_signal_exact(length):
    wav = _wav(length)
    want = np.asarray(jmel.frame_signal(jnp.asarray(wav)))
    got = tmel.frame_signal(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_constants_match():
    np.testing.assert_array_equal(tmel.hann_window(1024), jmel.hann_window(1024))
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    for a, b in zip(tmel._dft_mel_matrices(1024, 64, 16000, 60.0, 7800.0),
                    jmel._dft_mel_matrices(1024, 64, 16000, 60.0, 7800.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("length", [16000, 200])
def test_mel_spectrogram_and_log_mel(length):
    wav = _wav(length, seed=1)
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(wav)))
    got = tmel.mel_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 64, 1 + max(length, 513) // 160)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    want = np.asarray(jmel.byola_log_mel(jnp.asarray(wav)))
    got = tmel.byola_log_mel(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_log_mel_of_one_wav_without_batch_axis():
    wav = _wav(4000, seed=2)[0]
    want = np.asarray(jmel.byola_log_mel(jnp.asarray(wav)))
    got = tmel.byola_log_mel(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (64, 26)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

"""Random-window feature truncation (JAX ``data/truncate.py``).

Training-time augmentation: a window of ``max_seq_len`` rows (or a random
``crop_ratio`` fraction of the sequence) is drawn so that at least one fake
segment survives with an intersection ratio >= ``trunc_thresh``. Randomness
comes from a ``numpy.random.Generator``; the calls and their order are the
JAX package's, so one seed gives the same window in both.

:func:`draw_truncate_window` draws the window from the segments alone, so the
device-resample train path can crop on the device with the same window as
the host path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def draw_truncate_window(
    feat_len: int,
    segments: np.ndarray,       # (N, 2) feature-grid coords
    labels: np.ndarray,         # (N,)
    max_seq_len: int,
    trunc_thresh: float,
    offset: float,
    rng: np.random.Generator,
    crop_ratio: Optional[Tuple[float, float]] = None,
    max_num_trials: int = 200,
    has_action: bool = True,
    no_trunc: bool = False,
):
    """Draw the crop window and move the segments into it.

    Returns ``(st, win_len, segments, labels)``: rows ``[st, st + win_len)``
    of the feature grid survive; ``st == 0`` and ``win_len == feat_len`` mean
    no crop."""
    if feat_len <= max_seq_len:
        if crop_ratio is None:
            return 0, feat_len, segments, labels
        max_seq_len = int(rng.integers(
            max(round(crop_ratio[0] * feat_len), 1),
            min(round(crop_ratio[1] * feat_len), feat_len) + 1,
        ))
        if feat_len == max_seq_len:
            return 0, feat_len, segments, labels

    st = 0
    left = right = keep = None
    for _ in range(max_num_trials):
        st = int(rng.integers(0, feat_len - max_seq_len + 1))
        ed = st + max_seq_len
        left = np.maximum(st - offset, segments[:, 0])
        right = np.minimum(ed + offset, segments[:, 1])
        inter = np.clip(right - left, 0.0, None)
        area = np.abs(segments[:, 1] - segments[:, 0])
        ratio = inter / area
        keep = ratio >= trunc_thresh
        if no_trunc:
            trunc_any = (ratio > 0.0) & (ratio < 1.0)
            if keep.sum() > 0 and trunc_any.sum() == 0:
                break
        elif has_action:
            if keep.sum() > 0:
                break
        else:
            break

    new_segments = np.stack([left[keep], right[keep]], axis=1) - st
    return st, max_seq_len, new_segments.astype(np.float32), labels[keep]


def truncate_feats(
    feats: np.ndarray,          # (T, C)
    segments: np.ndarray,       # (N, 2) feature-grid coords
    labels: np.ndarray,         # (N,)
    max_seq_len: int,
    trunc_thresh: float,
    offset: float,
    rng: np.random.Generator,
    crop_ratio: Optional[Tuple[float, float]] = None,
    max_num_trials: int = 200,
    has_action: bool = True,
    no_trunc: bool = False,
):
    """Returns (feats, segments, labels) after the random window crop."""
    st, win_len, segments, labels = draw_truncate_window(
        feats.shape[0], segments, labels, max_seq_len, trunc_thresh, offset,
        rng, crop_ratio, max_num_trials, has_action, no_trunc)
    return feats[st:st + win_len], segments, labels

"""Point tables per pyramid level (JAX ``models/points.py``): rows
``(t * stride [+ stride / 2], reg_min, reg_max, stride)``."""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _points_np(feat_lens: Tuple[int, ...], fpn_strides: Tuple[int, ...],
               regression_range: Tuple[Tuple[float, float], ...], use_offset: bool):
    if not (len(feat_lens) == len(fpn_strides) == len(regression_range)):
        raise ValueError(
            f"fpn levels mismatch: {len(feat_lens)} feat_lens, "
            f"{len(fpn_strides)} fpn_strides, {len(regression_range)} "
            f"regression ranges (must all match)")
    per_level = []
    for t_i, stride, (lo, hi) in zip(feat_lens, fpn_strides, regression_range):
        ts = np.arange(t_i, dtype=np.float32) * stride
        if use_offset:
            ts = ts + 0.5 * stride
        per_level.append(np.stack(
            [ts, np.full(t_i, lo, np.float32), np.full(t_i, hi, np.float32),
             np.full(t_i, stride, np.float32)], axis=1))
    return per_level


def generate_points(feat_lens: Sequence[int], fpn_strides: Sequence[int],
                    regression_range: Sequence[Tuple[float, float]],
                    use_offset: bool = False, device=None):
    """Per-level (T_i, 4) float32 tables."""
    per_level = _points_np(tuple(feat_lens), tuple(fpn_strides),
                           tuple(tuple(r) for r in regression_range), use_offset)
    return [torch.from_numpy(p).to(device) for p in per_level]

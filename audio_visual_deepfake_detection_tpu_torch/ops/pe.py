"""Sinusoid positional table (JAX ``ops/pe.py``): angle(pos, j) =
pos / 10000^(2*(j//2)/C), even channels sin, odd channels cos."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * np.floor(j / 2.0) / d_hid)
    table = np.where((np.arange(d_hid) % 2)[None, :] == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


def sinusoid_encoding(n_position: int, d_hid: int, device=None) -> torch.Tensor:
    """(T, C) float32 table."""
    return torch.from_numpy(_sinusoid_table(n_position, d_hid)).to(device)

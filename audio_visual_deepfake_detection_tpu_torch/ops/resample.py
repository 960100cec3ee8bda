"""Temporal resampling along a time axis (JAX ``ops/resample.py:30-189``).

``nearest_resample_time`` picks source index ``floor(j * in / out)`` (torch
``F.interpolate(mode='nearest')``); ``linear_resample_time`` is
``F.interpolate(mode='linear', align_corners=False)`` with the source
coordinates computed in float32 exactly like the JAX package.
``linear_resample_dynamic`` resamples zero-padded streams of per-sample
length on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _linear_coords(in_len: int, out_len: int):
    scale = np.float32(in_len) / np.float32(out_len)
    coords = (np.arange(out_len, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    coords = np.clip(coords, 0.0, in_len - 1)
    idx0 = np.floor(coords).astype(np.int64)
    idx1 = np.minimum(idx0 + 1, in_len - 1).astype(np.int64)
    frac = (coords - idx0).astype(np.float32)
    return idx0, idx1, frac


_linear_coords_cached = functools.lru_cache(maxsize=256)(_linear_coords)


def linear_resample_time(x: torch.Tensor, out_len: int, axis: int = -2) -> torch.Tensor:
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    idx0, idx1, frac = _linear_coords_cached(in_len, out_len)
    dev = x.device
    x0 = torch.index_select(x, axis, torch.from_numpy(idx0).to(dev))
    x1 = torch.index_select(x, axis, torch.from_numpy(idx1).to(dev))
    shape = [1] * x.ndim
    shape[axis] = out_len
    f = torch.from_numpy(frac).to(dev, x.dtype).reshape(shape)
    return x0 * (1.0 - f) + x1 * f


def linear_resample_dynamic(x: torch.Tensor, in_len: torch.Tensor, out_len: int,
                            resample_len: int | None = None, start=None,
                            out_valid=None) -> torch.Tensor:
    """Per-sample dynamic-length linear resample on the device.

    ``x`` (B, T_max, C) zero-padded streams, ``in_len`` (B,) valid row
    counts; returns (B, out_len, C) equal to ``linear_resample_time`` row for
    row on each sample's valid prefix. The coordinates are computed in
    float32 exactly as there; the two source rows are gathered and blended.

    Fused crop (the training random-window truncation): with
    ``resample_len`` = R, ``start`` (B,) int and ``out_valid`` (B,) int,
    output row j is row ``start + j`` of the length-R resampled grid (the
    coordinates are evaluated at the shifted indices, so it equals resampling
    to R and slicing on the host bit for bit), and rows ``>= out_valid`` are
    zero."""
    dev = x.device
    in_len = in_len.to(dev)
    in_len_f = in_len.float()
    r = out_len if resample_len is None else resample_len
    scale = in_len_f[:, None] / torch.tensor(float(r), dtype=torch.float32, device=dev)
    j = torch.arange(out_len, dtype=torch.float32, device=dev)[None, :]
    if start is not None:
        j = j + start.to(dev).float()[:, None]
    coords = (j + 0.5) * scale - 0.5
    coords = torch.minimum(coords.clamp(min=0.0), in_len_f[:, None] - 1.0)
    idx0 = coords.floor().long()
    idx1 = torch.minimum(idx0 + 1, in_len[:, None].long() - 1)
    frac = (coords - idx0.float()).to(x.dtype)[..., None]
    c = x.shape[-1]
    x0 = torch.gather(x, 1, idx0[..., None].expand(-1, -1, c))
    x1 = torch.gather(x, 1, idx1[..., None].expand(-1, -1, c))
    y = x0 * (1.0 - frac) + x1 * frac
    if out_valid is not None:
        valid = torch.arange(out_len, device=dev)[None, :] < out_valid.to(dev)[:, None]
        y = y * valid.to(x.dtype)[..., None]
    return y


def nearest_resample_time(x: torch.Tensor, out_len: int, axis: int = -2) -> torch.Tensor:
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    ax = axis % x.ndim
    if out_len % in_len == 0:
        return torch.repeat_interleave(x, out_len // in_len, dim=ax)
    if in_len % out_len == 0:
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(0, in_len, in_len // out_len)
        return x[tuple(idx)]
    idx = np.floor(np.arange(out_len, dtype=np.float64) * in_len / out_len)
    idx = np.minimum(idx, in_len - 1).astype(np.int64)
    return torch.index_select(x, ax, torch.from_numpy(idx).to(x.device))


def downsample_mask(mask: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize of a (B, T) bool mask."""
    return nearest_resample_time(mask, out_len, axis=-1)

"""ctypes binding of the native host resample + concat (``csrc/resample.cpp``;
JAX ``runtime/host_resample.py``).

The per-sample linear resample of every feature stream to ``max_seq_len``
and their channel concat is the data path's host loop. The native function
fuses the two, releases the interpreter lock for the call (so the threaded
loader scales across host cores) and equals the numpy version
``data/dataset.py::resample_concat_np`` bit for bit (``-ffp-contract=off``
keeps the lerp unfused, as numpy computes it). It is built with g++ at first
use into ``build/host/``; a failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from . import native

FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off")
_F32P = ctypes.POINTER(ctypes.c_float)
SIGNATURES = {"resample_concat": (ctypes.c_int, [
    ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_int])}


def load() -> ctypes.CDLL:
    """The built library (built and loaded once)."""
    return native.load("resample", FLAGS, SIGNATURES)


def resample_concat(streams: List[np.ndarray], out_len: int,
                    out: Optional[np.ndarray] = None, threads: int = 1) -> np.ndarray:
    """Resample each (rows_s, C_s) float32 stream to ``out_len`` rows and
    concatenate the channels -> (out_len, sum(C_s)) float32.

    ``threads``: OpenMP team size. 1 (serial) by default, because the usual
    caller is a loader worker thread whose pool already spreads the work; 0
    takes the library's default team."""
    lib = load()
    streams = [np.ascontiguousarray(s, dtype=np.float32) for s in streams]
    if any(s.ndim != 2 or s.shape[0] == 0 or s.shape[1] == 0 for s in streams):
        raise ValueError(f"streams must be non-empty 2-d arrays, got "
                         f"{[s.shape for s in streams]}")
    n = len(streams)
    ptrs = (_F32P * n)(*[s.ctypes.data_as(_F32P) for s in streams])
    rows = (ctypes.c_int * n)(*[s.shape[0] for s in streams])
    chans = (ctypes.c_int * n)(*[s.shape[1] for s in streams])
    total_c = int(sum(s.shape[1] for s in streams))
    if out is None:
        out = np.empty((out_len, total_c), np.float32)
    if (out.shape != (out_len, total_c) or out.dtype != np.float32
            or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"out must be C-contiguous float32 of shape {(out_len, total_c)}, "
            f"got {out.dtype} {out.shape} contiguous={out.flags['C_CONTIGUOUS']}")
    rc = lib.resample_concat(ptrs, rows, chans, n, out_len, out.ctypes.data_as(_F32P), threads)
    if rc != 0:
        raise ValueError(f"resample_concat failed (rc={rc})")
    return out

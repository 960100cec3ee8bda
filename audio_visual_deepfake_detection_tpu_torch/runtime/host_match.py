"""ctypes binding of the native greedy AP matcher (``csrc/match.cpp``; JAX
``runtime/host_match.py``).

The challenge test set is 343,233 videos with up to 100 predictions each:
~34M rows an evaluation. The per-video greedy matching, the one part that
does not vectorize, runs as one OpenMP C++ pass; everything around it is
numpy. Built with g++ at first use into ``build/host/``; a failed build
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

FLAGS = ("-O3", "-fopenmp")
_F64P, _I64P = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
SIGNATURES = {"match_tp": (ctypes.c_int, [
    _F64P, _I64P, _F64P, _I64P, ctypes.c_int64, ctypes.c_int64, _F64P, ctypes.c_int,
    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)])}


def load() -> ctypes.CDLL:
    """The built library (built and loaded once)."""
    return native.load("match", FLAGS, SIGNATURES)


def host_match_tp(p_seg: np.ndarray, p_off: np.ndarray,
                  g_seg: np.ndarray, g_off: np.ndarray,
                  thresholds: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Greedy TP flags of grouped, score-ordered predictions.

    ``p_seg`` (npred, 2) and ``g_seg`` (ngt, 2) are grouped by video through
    the (nvid + 1,) offset arrays; within a group, predictions are in
    descending score order. Returns (nthr, npred) uint8 TP flags in the same
    grouped order."""
    lib = load()
    p_seg = np.ascontiguousarray(p_seg, np.float64)
    g_seg = np.ascontiguousarray(g_seg, np.float64)
    p_off = np.ascontiguousarray(p_off, np.int64)
    g_off = np.ascontiguousarray(g_off, np.int64)
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    nvid = len(p_off) - 1
    npred = p_seg.shape[0]
    if len(g_off) - 1 != nvid:
        raise ValueError(f"offset arrays disagree: {len(g_off) - 1} GT groups, {nvid} "
                         f"prediction groups")
    if p_off[-1] != npred or g_off[-1] != g_seg.shape[0]:
        raise ValueError("offsets do not cover the segment arrays")
    tp = np.zeros((len(thresholds), npred), np.uint8)
    rc = lib.match_tp(
        p_seg.ctypes.data_as(_F64P), p_off.ctypes.data_as(_I64P),
        g_seg.ctypes.data_as(_F64P), g_off.ctypes.data_as(_I64P),
        nvid, npred, thresholds.ctypes.data_as(_F64P), len(thresholds), n_threads,
        tp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"match_tp failed with rc={rc}")
    return tp

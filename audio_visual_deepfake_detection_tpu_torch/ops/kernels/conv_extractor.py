"""Emotion2Vec conv feature extractor K5: the CUDA kernels, their plain
version and the packing (JAX ``ops/pallas/conv_extractor.py``).

The extractor is fairseq's ``ConvFeatureExtractionModel`` in ``layer_norm``
mode: seven bias-free Conv1d layers, (512, 10, 5), (512, 3, 2) x 4,
(512, 2, 2) x 2, each followed by a LayerNorm over the 512 channels (eps
1e-5, with affine) and the exact (erf) GELU: a 16 kHz wav (B, L) becomes
(B, conv_output_length(L), 512) features at 50 Hz.

Numerics (both versions, the XLA path of the JAX ``ConvFeatureExtractor``):
the wav and the weights rounded to the compute dtype, products accumulated
in f32 and rounded once, LN statistics in f32 (fast variance clamped at 0),
the LN output rounded, the GELU computed in f32 from that and rounded. Every
layer's output is in the compute dtype.

``fused_conv_extractor`` launches ``csrc/conv_extractor.cu`` for a CUDA
tensor on an sm_90 card (replacing ``fused_conv_extractor``, ``pallas_call``
at ``conv_extractor.py:210``) and runs ``conv_extractor_math`` for a CPU
tensor. Layers 1-6 take one of two routes (``ROUTE_NAMES``; ``ROUTES``
counts the launches by the route the C entry reports): bfloat16 on wgmma,
float32 on wgmma in 3xTF32 (hi.lo + lo.hi + hi.hi of the operands' TF32
parts, each 32-deep stage's tensor-core sum added in f32), the weights split
at packing (``tf32_split``), the activations by the kernel in shared
memory. float32 differs from ``conv_extractor_math`` by f32 rounding only.
There is no other route: a CUDA tensor launches the kernel or the wrapper
raises.

The TPU kernel's layout (40-sample wav rows with 8 halo lanes, the
(48, 4096) unfold matrix, pair-reshaped taps) answers Mosaic's lack of
strided slices and is not carried over: ``pack_conv_extractor`` keeps each
weight as (512, k * 512) with the taps outermost, so that the k input rows a
frame reads are one contiguous run of the previous layer's (T, 512) output.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...core.runtime import use_kernel
from ..mvit_math import gelu, layer_norm
from .fused_block import tf32_split

CONV_SPEC: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 2, 2), (512, 2, 2))
CH = 512
LN_EPS = 1e-5
ROUTE_NAMES = ("wgmma bf16", "wgmma 3xTF32")

# kernel launches since the last reset: one per call, whatever the number of
# launches inside (CPU calls and plain runs never count), and by the route
# the C entry reports (ROUTE_NAMES)
LAUNCHES = 0
ROUTES = collections.Counter()


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    ROUTES.clear()


def layer_lengths(length: int, spec=CONV_SPEC):
    """Output length of every layer for a wav of ``length`` samples."""
    out = []
    for _, k, s in spec:
        length = (length - k) // s + 1
        out.append(length)
    return out


def conv_output_length(length: int, spec=CONV_SPEC) -> int:
    return layer_lengths(length, spec)[-1]


# ----------------------------------------------------------------- packing

class ConvExtractorPacked(NamedTuple):
    w0: torch.Tensor                 # (512, 10) f32 of compute-dtype values
    ws: Tuple[torch.Tensor, ...]     # six (512, k * 512) compute dtype, taps outermost
    ln: torch.Tensor                 # (14, 512) f32: weight, bias of layers 0..6
    # f32 only: ws split into TF32 parts, six (2, 512, k * 512): hi, lo
    split: Optional[Tuple[torch.Tensor, ...]] = None


def pack_conv_extractor(weights: Sequence[torch.Tensor], ln: torch.Tensor,
                        cdtype) -> ConvExtractorPacked:
    """Seven Conv1d weights in torch's (out, in, k) layout and the (14, 512)
    LN rows -> kernel inputs, pre-rounded to the compute dtype; in float32
    also the TF32 hi and lo parts of layers 1-6, which the card's route
    reads (the exact weights stay beside them for the plain version: hi +
    lo is a weight only to 2^-22 of it)."""
    for w, (dim, k, _) in zip(weights, CONV_SPEC):
        if w.shape[0] != dim or w.shape[-1] != k:
            raise ValueError(f"conv weight {tuple(w.shape)} does not fit ({dim}, ., {k})")
    w0 = weights[0].detach().to(cdtype).float().reshape(CH, CONV_SPEC[0][1]).contiguous()
    ws = tuple(w.detach().to(cdtype).permute(0, 2, 1).reshape(CH, -1).contiguous()
               for w in weights[1:])
    split = (tuple(torch.stack(tf32_split(w)).contiguous() for w in ws)
             if cdtype == torch.float32 else None)
    return ConvExtractorPacked(w0, ws, ln.detach().float().reshape(14, CH).contiguous(), split)


def unpack_conv_extractor(p: ConvExtractorPacked):
    """The packed weights back in torch's (out, in, k) layout (views)."""
    return [p.w0[:, None, :]] + [w.reshape(CH, -1, CH).permute(0, 2, 1) for w in p.ws]


# -------------------------------------------------------------- plain math

def _conv1d(x, w, stride: int):
    """Conv1d of compute-dtype values with f32 accumulation, rounded once.
    On the CPU a bf16 conv runs on f32 copies (exact products, f32 sums)."""
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        return F.conv1d(x.float(), w.float(), stride=stride).to(x.dtype)
    return F.conv1d(x, w, stride=stride)


def conv_extractor_math(wav, weights, ln, dtype, spec=CONV_SPEC) -> torch.Tensor:
    """Plain version. wav (B, L) float; ``weights`` one (out, in, k) tensor
    per layer of ``spec``; ``ln`` (2 * layers, out) rows (weight, bias per
    layer); returns (B, conv_output_length(L, spec), out) in ``dtype``."""
    x = wav.to(dtype)[:, None, :]
    for i, (w, (_, _, stride)) in enumerate(zip(weights, spec)):
        x = _conv1d(x, w.to(dtype), stride).transpose(1, 2)
        x = gelu(layer_norm(x, ln[2 * i], ln[2 * i + 1], dtype, eps=LN_EPS)).transpose(1, 2)
    return x.transpose(1, 2).contiguous()


# ----------------------------------------------------------------- wrapper

def fused_conv_extractor(wav: torch.Tensor, p: ConvExtractorPacked) -> torch.Tensor:
    """K5. wav (B, L) f32 with conv_output_length(L) >= 1 -> features
    (B, conv_output_length(L), 512) in the packed weights' compute dtype."""
    cd = p.ws[0].dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv extractor takes float32 or bfloat16 weights, got {cd}")
    if wav.dim() != 2 or wav.dtype != torch.float32:
        raise ValueError(f"wav must be (B, L) float32, got {tuple(wav.shape)} {wav.dtype}")
    if conv_output_length(wav.shape[1]) < 1:
        raise ValueError(f"a wav of {wav.shape[1]} samples gives no output frame")
    if not use_kernel(wav):
        return conv_extractor_math(wav, unpack_conv_extractor(p), p.ln, cd)
    return _launch(wav.contiguous(), p, cd)


def _launch(wav, p, cd):
    global LAUNCHES
    from .build import load

    b, length = wav.shape
    lens = layer_lengths(length)
    # the card reads the f32 weights' TF32 parts
    ws = p.ws if cd == torch.bfloat16 else p.split
    if ws is None:
        raise ValueError("float32 packed weights lack their TF32 parts (pack_conv_extractor)")
    for name, a, dt in [("w0", p.w0, torch.float32), ("ln", p.ln, torch.float32)] + \
            [(f"w{i + 1}", w, cd) for i, w in enumerate(ws)]:
        if a.device != wav.device or not a.is_contiguous() or a.dtype != dt:
            raise ValueError(f"packed {name} must be contiguous {dt} on {wav.device}")
    # ping-pong scratch: layer 0, 2, 4 write `even`, layers 1, 3, 5 `odd`
    even = torch.empty((b, lens[0], CH), dtype=cd, device=wav.device)
    odd = torch.empty((b, lens[1], CH), dtype=cd, device=wav.device)
    out = torch.empty((b, lens[-1], CH), dtype=cd, device=wav.device)
    if b == 0:
        return out
    lib = load()
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
    route = ctypes.c_int(-1)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        err = lib.avdd_conv_extractor(
            ptr(wav), ptr(p.w0), *(ptr(w) for w in ws), ptr(p.ln), ptr(even), ptr(odd),
            ptr(out), b, length, 0 if cd == torch.float32 else 1, ctypes.c_void_p(stream),
            ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"conv extractor kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    ROUTES[ROUTE_NAMES[route.value]] += 1
    return out

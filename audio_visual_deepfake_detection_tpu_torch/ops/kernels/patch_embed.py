"""MViT patch embed K2: the CUDA kernel and its plain version (JAX
``ops/pallas/patch_embed.py``).

``fused_patch_embed`` (f32 frames in [0, 1]) and ``fused_patch_embed_u8``
(raw uint8 frames, normalized inside: ``float(u) * np.float32(1 / 255)``, the
multiply of both pipelines) are the wrappers ``frontends/mvit.py::PatchEmbed``
calls at the production geometry (kernel (3,15,15), stride (1,12,12),
padding (1,3,3), 96x96x3 frames). A CUDA tensor on an sm_90 card launches
``csrc/patch_embed.cu`` (which replaces the Pallas kernel
``fused_patch_embed``, ``pallas_call`` at ``patch_embed.py:169``); a CPU
tensor runs ``patch_embed_math``.

Numerics (both): the frames and the weights are rounded to the compute dtype,
all kt*kh*kw*cin taps accumulate in f32, the sum is rounded once to the
compute dtype and the bias (rounded to it too) is added in the compute dtype,
as the JAX ``PatchEmbed`` does (``mvit.py:187-189``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ...core.runtime import use_kernel

KERNEL = (3, 15, 15)
STRIDE = (1, 12, 12)
PADDING = (1, 3, 3)
FRAME = (96, 96, 3)
MAX_FEATURES = 128
WIDTHS = (96, 128)     # the bf16 kernel's product widths (features past F zero-padded)
RUN = 48               # positions of one (kt, kh) run of the bf16 weight layout
INV255 = np.float32(1.0 / 255.0)

# kernel launches since the last reset (CPU calls and plain runs never count)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def normalize_u8(video: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> f32 in [0, 1] by the pipelines' multiply."""
    return video.float() * INV255


def patch_embed_math(video: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     cdtype, stride=STRIDE, padding=PADDING) -> torch.Tensor:
    """Plain version: (B, T, H, W, cin) float frames, torch Conv3d weight
    (F, cin, kt, kh, kw) and bias (F,) -> (B, T', H', W', F) in ``cdtype``.
    The f32 convolution of compute-dtype values is exact per product."""
    x = video.to(cdtype).float().permute(0, 4, 1, 2, 3)
    w = weight.to(cdtype).float()
    y = F.conv3d(x, w, None, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).to(cdtype) + bias.to(cdtype)


def patch_embed_u8_math(video: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        cdtype) -> torch.Tensor:
    """Plain version of the uint8 entry: ``patch_embed_math`` on the
    normalized frames."""
    return patch_embed_math(normalize_u8(video), weight, bias, cdtype)


def product_width(f: int) -> int:
    """The bf16 kernel's product width for F features."""
    return next(n for n in WIDTHS if f <= n)


def pack_weight(weight: torch.Tensor, cdtype) -> torch.Tensor:
    """The kernel's weight layout. f32: (kt*kh*kw*cin, F), tap-major with the
    feature axis contiguous (the FMA kernel's coalesced weight row). bf16:
    (kt*kh, N, 48) with N = ``product_width(F)``: per (kt, kh) run and
    feature, position 1 + kw*cin + c holds tap (kw, c), positions 0, 46 and
    47 and the features past F are zero (the wgmma kernel's B tiles, see
    ``csrc/patch_embed.cu``)."""
    f = weight.shape[0]
    if cdtype == torch.float32:
        return weight.permute(2, 3, 4, 1, 0).reshape(-1, f).contiguous()
    w = weight.permute(2, 3, 0, 4, 1).reshape(KERNEL[0] * KERNEL[1], f, -1)
    w = F.pad(w, (1, RUN - 1 - w.shape[-1], 0, product_width(f) - f))
    return w.to(cdtype).contiguous()


def _check(video, weight, cdtype, dtype):
    if video.dim() != 5 or tuple(video.shape[2:]) != FRAME or video.dtype != dtype:
        raise ValueError(f"patch embed takes (B, T, 96, 96, 3) {dtype}, got "
                         f"{tuple(video.shape)} {video.dtype}")
    if tuple(weight.shape[1:]) != (3,) + KERNEL or weight.shape[0] > MAX_FEATURES:
        raise ValueError(f"patch embed weight must be (F<={MAX_FEATURES}, 3, 3, 15, 15), "
                         f"got {tuple(weight.shape)}")
    if cdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patch embed computes in float32 or bfloat16, got {cdtype}")


def fused_patch_embed(video: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      cdtype) -> torch.Tensor:
    """(B, T, 96, 96, 3) f32 frames in [0, 1] -> (B, T, 8, 8, F) in ``cdtype``."""
    _check(video, weight, cdtype, torch.float32)
    if not use_kernel(video):
        return patch_embed_math(video, weight, bias, cdtype)
    return _launch(video, weight, bias, cdtype)


def fused_patch_embed_u8(video: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         cdtype) -> torch.Tensor:
    """(B, T, 96, 96, 3) uint8 frames -> (B, T, 8, 8, F) in ``cdtype``, the
    frames normalized inside (bit for bit the f32 entry on
    ``normalize_u8(video)``)."""
    _check(video, weight, cdtype, torch.uint8)
    if not use_kernel(video):
        return patch_embed_u8_math(video, weight, bias, cdtype)
    return _launch(video, weight, bias, cdtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and on 16 bytes (the kernel copies 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(video, weight, bias, cdtype):
    global LAUNCHES
    from .build import load

    video = _aligned(video)
    u8 = video.dtype == torch.uint8
    b, t = video.shape[:2]
    f = weight.shape[0]
    w = pack_weight(weight, cdtype)
    bf = bias.float().contiguous()
    out = torch.empty((b, t, 8, 8, f), dtype=cdtype, device=video.device)
    if b == 0 or t == 0:
        return out
    # the bf16 kernel stages f32 frames rounded to bf16 by a first pass
    scratch = (torch.empty(video.shape, dtype=torch.bfloat16, device=video.device)
               if cdtype == torch.bfloat16 and not u8 else None)
    lib = load()
    ptr = lambda a: ctypes.c_void_p(None if a is None else a.data_ptr())  # noqa: E731
    with torch.cuda.device(video.device):
        stream = torch.cuda.current_stream(video.device).cuda_stream
        err = lib.avdd_patch_embed(ptr(video), ptr(w), ptr(bf), ptr(out), ptr(scratch), b, t, f,
                                   0 if cdtype == torch.float32 else 1, int(u8),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"patch embed kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

"""MViT patch embed K2: the CUDA kernel and its plain version (JAX
``ops/pallas/patch_embed.py``).

``fused_patch_embed`` is the wrapper ``frontends/mvit.py::PatchEmbed`` calls
at the production geometry (kernel (3,15,15), stride (1,12,12), padding
(1,3,3), 96x96x3 frames). A CUDA tensor on an sm_90 card launches
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

import torch
import torch.nn.functional as F

from ...core.runtime import use_kernel

KERNEL = (3, 15, 15)
STRIDE = (1, 12, 12)
PADDING = (1, 3, 3)
FRAME = (96, 96, 3)
MAX_FEATURES = 128

# kernel launches since the last reset (CPU calls and plain runs never count)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def patch_embed_math(video: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     cdtype, stride=STRIDE, padding=PADDING) -> torch.Tensor:
    """Plain version: (B, T, H, W, cin) float frames, torch Conv3d weight
    (F, cin, kt, kh, kw) and bias (F,) -> (B, T', H', W', F) in ``cdtype``.
    The f32 convolution of compute-dtype values is exact per product."""
    x = video.to(cdtype).float().permute(0, 4, 1, 2, 3)
    w = weight.to(cdtype).float()
    y = F.conv3d(x, w, None, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).to(cdtype) + bias.to(cdtype)


def pack_weight(weight: torch.Tensor, cdtype) -> torch.Tensor:
    """The kernel's weight layout. f32: (kt*kh*kw*cin, F), tap-major with the
    feature axis contiguous (the FMA kernel's coalesced weight row). bf16:
    (F, kt*kh*48), each (kt, kh) run of kw*cin = 45 taps padded to 48 with
    zeros, the tap axis contiguous (the tensor-core kernel's B fragments)."""
    f = weight.shape[0]
    if cdtype == torch.float32:
        return weight.permute(2, 3, 4, 1, 0).reshape(-1, f).contiguous()
    w = weight.permute(0, 2, 3, 4, 1).reshape(f, KERNEL[0], KERNEL[1], -1)
    return F.pad(w, (0, 48 - w.shape[-1])).reshape(f, -1).to(cdtype).contiguous()


def fused_patch_embed(video: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      cdtype) -> torch.Tensor:
    """(B, T, 96, 96, 3) f32 frames -> (B, T, 8, 8, F) in ``cdtype``."""
    if video.dim() != 5 or tuple(video.shape[2:]) != FRAME:
        raise ValueError(f"patch embed takes (B, T, 96, 96, 3), got {tuple(video.shape)}")
    if tuple(weight.shape[1:]) != (3,) + KERNEL or weight.shape[0] > MAX_FEATURES:
        raise ValueError(f"patch embed weight must be (F<={MAX_FEATURES}, 3, 3, 15, 15), "
                         f"got {tuple(weight.shape)}")
    if cdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patch embed computes in float32 or bfloat16, got {cdtype}")
    if not use_kernel(video):
        return patch_embed_math(video, weight, bias, cdtype)
    return _launch(video, weight, bias, cdtype)


def _launch(video, weight, bias, cdtype):
    global LAUNCHES
    from .build import load

    if video.dtype != torch.float32 or not video.is_contiguous():
        raise ValueError("patch embed kernel takes contiguous float32 frames")
    b, t = video.shape[:2]
    f = weight.shape[0]
    w = pack_weight(weight, cdtype)
    bf = bias.float().contiguous()
    out = torch.empty((b, t, 8, 8, f), dtype=cdtype, device=video.device)
    if b == 0 or t == 0:
        return out
    lib = load()
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
    with torch.cuda.device(video.device):
        stream = torch.cuda.current_stream(video.device).cuda_stream
        err = lib.avdd_patch_embed(ptr(video), ptr(w), ptr(bf), ptr(out), b, t, f,
                                   0 if cdtype == torch.float32 else 1,
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"patch embed kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

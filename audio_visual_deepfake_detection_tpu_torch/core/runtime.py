"""Numerics switches and the kernel policy.

Kernel policy (one rule for every wrapper in ``ops/kernels``):
- a CPU tensor takes the kernel's plain PyTorch version,
- a CUDA tensor on an sm_90 card launches the hand-written kernel,
- a CUDA tensor on any other architecture, or any other device, raises.
There is no fallback and no switch that routes a CUDA tensor to the plain
version; tests and ``chip_smoke.py`` call the plain versions directly.
"""

from __future__ import annotations

import functools

import torch

KERNEL_CAPABILITY = (9, 0)


def set_numerics() -> None:
    """Full-precision float32 on the card: TF32 off for cuBLAS and cuDNN;
    bf16 products reduce in f32 (no reduced-precision split-K sums)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@functools.lru_cache(maxsize=None)
def _capability(index: int):
    return torch.cuda.get_device_capability(index)


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel. False: run the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel or plain path for device {t.device}")
    cap = _capability(t.device.index if t.device.index is not None
                      else torch.cuda.current_device())
    if cap != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"kernels are built for sm_90a (Hopper); device {t.device} has "
            f"compute capability {cap[0]}.{cap[1]}")
    return True


def entry_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless ``name`` asks for
    the CPU. A CUDA device that is not there raises; nothing carries on on
    the CPU in its place."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but no CUDA device is available "
                           f"(run on the CPU with --device cpu)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return device

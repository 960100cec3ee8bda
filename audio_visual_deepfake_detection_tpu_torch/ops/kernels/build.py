"""Build the package's CUDA sources with nvcc and load them through ctypes.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` over
``csrc/*.cu`` (K1 and K6 fused_block, K2 patch_embed, K3 mvit_attention, K4
mvit_block with its attention step in mvit_attention, K5 conv_extractor, K7
band_attention, K8 full_attention; headers common.cuh and, for the wgmma
kernels of K1, K2, K3, K4, K5 and K8, wgmma.cuh) into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``build/kernels/`` at the repository root, in a file named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. The build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
LINK_FLAGS = ARCH + ["-shared"]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None   # wall time of the build this process ran, if any
BUILD_LOG = ""         # nvcc's output (-Xptxas -v: registers, smem, spills)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavdd_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library already exists: one
    nvcc per source, all started together, then one link."""
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc_path(), *COMPILE_FLAGS, "-Xptxas", "-v", "-c",
                               "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [f"[{src.name}]\n{proc.communicate()[0]}" for src, proc in zip(_sources(), procs)]
    BUILD_LOG = "\n".join(logs)
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
    tmp = out.with_suffix(f".{tag}")
    link = subprocess.run([nvcc_path(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The built library, with argument types declared for every entry."""
    global _lib
    if _lib is not None:        # every launch comes here: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.avdd_fused_block.restype = i
            lib.avdd_fused_block.argtypes = [
                p, p, p, p, p, p, p, p, p, p, p, p,   # tensors + out
                p,                                     # q|k|v (bf16) / k|v (f32) scratch
                p,                                     # droppath coefs or null
                i, i, i, i, i, i, i,                   # B T C H w mode dtype
                p,                                     # stream
            ]
            lib.avdd_fused_block_smem.restype = i
            lib.avdd_fused_block_smem.argtypes = [i, i, i]
            lib.avdd_patch_embed.restype = i
            lib.avdd_patch_embed.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            q = ctypes.c_longlong
            lib.avdd_pooled_attention.restype = i
            lib.avdd_pooled_attention.argtypes = [
                p, p, p, p, p, p,                      # q k v band rel out
                i, i, i, i, i, i, i,                   # B nh nq nk d T S
                q, q, q, q, q, q,                      # q and out strides
                ctypes.c_float, i, i, p,               # scale flags dtype stream
                ctypes.POINTER(i),                     # the kernel launched
            ]
            lib.avdd_msblock.restype = i
            lib.avdd_msblock.argtypes = [p] * 22 + [i] * 7 + [p]
            lib.avdd_conv_extractor.restype = i
            lib.avdd_conv_extractor.argtypes = [p] * 12 + [i] * 3 + [p]
            lib.avdd_full_mha.restype = i
            lib.avdd_full_mha.argtypes = [p] * 5 + [i] * 4 + [q] * 12 + [i, p]
            lib.avdd_band_attention.restype = i
            lib.avdd_band_attention.argtypes = [ctypes.c_char_p]   # a packed BandArgs
            lib.avdd_full_mha_smem.restype = i
            lib.avdd_full_mha_smem.argtypes = [i, i, i]
            _lib = lib
    return _lib

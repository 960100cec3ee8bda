"""Build the package's CUDA sources with nvcc and load them through ctypes.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` over
``csrc/*.cu`` into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library lands in ``build/kernels/``
at the repository root, in a file named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once. The build
runs at first use, never at import.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavdd_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library already exists."""
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The built library, with argument types declared for every entry."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.avdd_fused_block.restype = i
            lib.avdd_fused_block.argtypes = [
                p, p, p, p, p, p, p, p, p, p, p, p,   # tensors + out
                i, i, i, i, i, i, i,                   # B T C H w mode dtype
                p,                                     # stream
            ]
            lib.avdd_fused_block_smem.restype = i
            lib.avdd_fused_block_smem.argtypes = [i, i, i, i]
            _lib = lib
    return _lib

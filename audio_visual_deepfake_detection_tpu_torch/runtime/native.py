"""Build the host helpers' C++ sources with g++ and load them through ctypes.

Each source under ``runtime/csrc/`` becomes one shared library in
``build/host/`` at the repository root, in a file named by a hash of the
source, the flags, the machine and the compiler's version: an edited source
(or another host) rebuilds, an unchanged one loads at once. The build runs
at first use, never at import. A failed build raises with the compiler's
message; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"

_lock = threading.RLock()      # guards the build directory and the loaded libraries


@functools.lru_cache(maxsize=1)
def compiler() -> Tuple[str, str]:
    """(path, first line of ``--version``) of g++; raises if there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native host helpers cannot be built")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return cxx, version.stdout.partition("\n")[0]


def library_path(src: Path, flags) -> Path:
    h = hashlib.sha256(" ".join([*flags, platform.machine(), compiler()[1]]).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(src: Path, flags) -> Path:
    """Compile ``src`` with ``g++ flags -shared -fPIC`` unless its hashed
    library exists. Raises RuntimeError with g++'s output if it fails."""
    with _lock:
        out = library_path(src, flags)
        if out.exists():
            return out
        cxx = compiler()[0]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)      # atomic: concurrent builds agree
    return out


_libs: Dict[Path, ctypes.CDLL] = {}


def load(name: str, flags, signatures: Dict[str, Tuple]) -> ctypes.CDLL:
    """The library of ``runtime/csrc/<name>.cpp``, built if needed and
    loaded once, with each function of ``signatures`` ({name: (restype,
    argtypes)}) declared."""
    src = CSRC / f"{name}.cpp"
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(str(build(src, flags)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[src] = lib
    return lib

"""Build a native source of ``csrc/`` at first use and load it with
``ctypes``: CUDA sources (``load``, with ``nvcc``) and host C++ sources
(``load_host``, with ``g++``).

Each source is a plain C interface (no PyTorch headers), so a build takes
seconds. The shared library lands in ``mocogan_tpu_torch/build/`` (listed
in ``.gitignore``) under a name that carries a hash of the source and the
flags, so an edited source is never served by a stale library. A build
writes to a temporary name and renames it into place, so concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

# name -> (library, build record); a library stays loaded for the process.
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native sources need a host "
                           "C++ compiler")
    return path


def _load(name: str, src: str, compiler, flags: Sequence[str]
          ) -> Tuple[ctypes.CDLL, dict]:
    if name in _LOADED:
        return _LOADED[name]
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode()
                             ).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
    record = {"path": lib_path, "seconds": 0.0, "log": ""}
    if not os.path.exists(lib_path):
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([compiler(), *flags, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"build failed for {src}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = proc.stdout + proc.stderr
    lib = ctypes.CDLL(lib_path)
    _LOADED[name] = (lib, record)
    return lib, record


def load(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<name>.cu`` for ``sm_90a``.

    Returns (library, record); record holds ``path``, ``seconds`` (0.0 when
    the library was already built) and ``log`` (nvcc's output, including
    ptxas's register and shared-memory report)."""
    return _load(name, os.path.join(CSRC, f"{name}.cu"), _nvcc, NVCC_FLAGS)


def load_host(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) with ``g++`` and load ``csrc/<name>.cc``; returns
    (library, record) as ``load`` does."""
    return _load(name, os.path.join(CSRC, f"{name}.cc"), _gxx, GXX_FLAGS)

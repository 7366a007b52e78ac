"""Build the port's CUDA sources into shared libraries and load them.

Each ``phc_gnn_torch/csrc/<name>.cu`` exposes a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``phc_gnn_torch/_build/lib<name>-<hash>.so`` the first time one of its
kernels is launched, and bound with ``ctypes``.  The hash covers the source
and the flags, so an edited source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "source_names", "library_path",
           "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source_names():
    """Names of every CUDA source of the port (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (toolkit / "bin" / "nvcc").exists():
        return str(toolkit / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of phc_gnn_torch are "
                       "built from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, path: Path) -> None:
    """nvcc ``csrc/<name>.cu`` into ``path``; raises ``RuntimeError`` with the
    compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: a reader never sees half a file


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _compile(name, path)
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib

"""Build the port's CUDA sources into shared libraries and load them.

Each ``phc_gnn_torch/csrc/<name>.cu`` exposes a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``phc_gnn_torch/_build/lib<name>-<hash>.so`` the first time one of its
kernels is launched, and bound with ``ctypes``.  The hash covers the source
and the flags, so an edited source builds anew.  Kernels launch on PyTorch's
current stream (``stream``).
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

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "source_names", "library_path",
           "check_launch", "load", "load_all", "stream"]

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


def _compile(names) -> None:
    """nvcc each ``csrc/<name>.cu`` of ``names`` into its ``library_path``,
    one compiler process per source, all started together; raises
    ``RuntimeError`` with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        path = library_path(name)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, which every
    kernel of the port launches on."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    return load_all([name])[name]


def load_all(names=None) -> Dict[str, ctypes.CDLL]:
    """The ctypes handles of ``names`` (default: every source), building the
    missing ones in parallel."""
    names = source_names() if names is None else list(names)
    with _LOCK:
        missing = [n for n in names
                   if n not in _LIBS and not library_path(n).exists()]
        if missing:
            _compile(missing)
        for n in names:
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(library_path(n)))
        return {n: _LIBS[n] for n in names}

"""ctypes binding of the native C++ batcher (native/batcher.cpp).

Counterpart of phc_gnn_tpu/data/native.py:44-151.  The port compiles the
same source with ``g++`` into ``phc_gnn_torch/_build/libbatcher-<hash>.so``
the first time a function here is called; the hash covers the source and
the flags, so an edited source builds anew.  JAX's binding falls back to
numpy where no toolchain exists; this one raises instead (a missing
compiler, a failed build or load is a ``RuntimeError``), so that a loader
never switches packer without the caller knowing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["SOURCE", "library_path", "get_lib", "sort_edges_by_receiver",
           "build_csr_rowptr", "pack_batch_native"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native batcher's source {SOURCE} is missing")
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbatcher-{digest}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native batcher failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a reader never sees half a file


def get_lib() -> ctypes.CDLL:
    """The ctypes handle of the batcher, built on first use; raises
    ``RuntimeError`` if it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        lib.sort_edges_by_receiver.argtypes = [_i32p, ctypes.c_int64,
                                               ctypes.c_int32, _i64p]
        lib.build_csr_rowptr.argtypes = [_i32p, ctypes.c_int64,
                                         ctypes.c_int32, _i64p]
        lib.pack_batch.argtypes = [
            _i32p, _i32p, _i32p, _i32p, _i64p, _i64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p, _u8p, _u8p, _u8p]
        lib.pack_batch.restype = ctypes.c_int32
        _LIB = lib
        return lib


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def sort_edges_by_receiver(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Stable argsort of receivers (a counting sort), int64."""
    receivers = _as_i32(receivers)
    perm = np.empty(receivers.shape[0], np.int64)
    get_lib().sort_edges_by_receiver(
        receivers.ctypes.data_as(_i32p), receivers.shape[0], num_nodes,
        perm.ctypes.data_as(_i64p))
    return perm


def build_csr_rowptr(recv_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    """CSR row pointers [num_nodes + 1] (int64) of sorted receivers, every
    edge counted (``graph.build_csr_rowptr`` is the plan's mask-aware
    rule)."""
    recv_sorted = _as_i32(recv_sorted)
    rowptr = np.empty(num_nodes + 1, np.int64)
    get_lib().build_csr_rowptr(recv_sorted.ctypes.data_as(_i32p),
                               recv_sorted.shape[0], num_nodes,
                               rowptr.ctypes.data_as(_i64p))
    return rowptr


def pack_batch_native(node_feats, edge_feats, senders, receivers,
                      node_offsets, edge_offsets, num_nodes_pad: int,
                      num_edges_pad: int, num_graphs_pad: int) -> dict:
    """Pack the concatenated arrays of several graphs (integer features,
    graph-local edge indices, per-graph offsets) into padded buffers, edges
    sorted by receiver: the numpy arrays ``nodes``, ``edges``, ``senders``,
    ``receivers``, ``graph_ids`` (int32) and the uint8 masks
    ``node_mask``, ``edge_mask``, ``graph_mask``.  Raises ``ValueError``
    when the graphs do not fit the bucket."""
    lib = get_lib()
    node_feats = _as_i32(node_feats)
    edge_feats = _as_i32(edge_feats)
    senders = _as_i32(senders)
    receivers = _as_i32(receivers)
    node_offsets = np.ascontiguousarray(node_offsets, np.int64)
    edge_offsets = np.ascontiguousarray(edge_offsets, np.int64)
    num_graphs = node_offsets.shape[0] - 1
    fx = node_feats.shape[1] if node_feats.ndim == 2 else 1
    fe = edge_feats.shape[1] if edge_feats.ndim == 2 else 1

    out = {
        "nodes": np.empty((num_nodes_pad, fx), np.int32),
        "edges": np.empty((num_edges_pad, fe), np.int32),
        "senders": np.empty(num_edges_pad, np.int32),
        "receivers": np.empty(num_edges_pad, np.int32),
        "graph_ids": np.empty(num_nodes_pad, np.int32),
        "node_mask": np.empty(num_nodes_pad, np.uint8),
        "edge_mask": np.empty(num_edges_pad, np.uint8),
        "graph_mask": np.empty(num_graphs_pad, np.uint8),
    }
    rc = lib.pack_batch(
        node_feats.ctypes.data_as(_i32p), edge_feats.ctypes.data_as(_i32p),
        senders.ctypes.data_as(_i32p), receivers.ctypes.data_as(_i32p),
        node_offsets.ctypes.data_as(_i64p), edge_offsets.ctypes.data_as(_i64p),
        num_graphs, fx, fe, num_nodes_pad, num_edges_pad, num_graphs_pad,
        out["nodes"].ctypes.data_as(_i32p), out["edges"].ctypes.data_as(_i32p),
        out["senders"].ctypes.data_as(_i32p),
        out["receivers"].ctypes.data_as(_i32p),
        out["graph_ids"].ctypes.data_as(_i32p),
        out["node_mask"].ctypes.data_as(_u8p),
        out["edge_mask"].ctypes.data_as(_u8p),
        out["graph_mask"].ctypes.data_as(_u8p))
    if rc != 0:
        raise ValueError(
            f"batch does not fit bucket ({num_nodes_pad},{num_edges_pad},"
            f"{num_graphs_pad})")
    return out

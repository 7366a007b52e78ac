"""The fixed aggregations of the PNA family over the receiver CSR: mean, min,
max, var and std, with JAX's streamed VJPs.

Hopper kernels (``csrc/segment_reduce.cu``), each beside its plain PyTorch
version and with a launch counter of its own:

- ``segment_extreme`` replaces ``_scan_kernel`` with op="max" (H,
  phc_gnn_tpu/ops/stream_scan.py:600-652): per CSR segment, the max (or, with
  ``minimum``, the min) of the rows ``msgs[e]`` whose ``mask[e]`` holds; 0
  for a segment without such a row;
- ``segment_moments`` replaces ``_scan_kernel_pair`` (I, :656-686) with the
  XLA glue of ``_seg_var_parts`` (:1079-1093) in its epilogue:
  ``(mean, var)`` with ``cnt = max(real edges, 1)``, ``mean = sum m / cnt``
  and ``var = sum m^2 / cnt - mean^2``, JAX's formula.

The aggregations around them, each an ``autograd.Function`` whose backward
is JAX's closed form in plain torch (none of JAX's backwards is a Pallas
kernel):

- ``segment_extreme_aggregate`` (``_seg_extreme_streamed``, :1012-1043):
  the backward gives EVERY edge that attains its segment's extreme the whole
  cotangent, ``dm = where(mask & (m == out[recv]), g[recv], 0)``; the XLA
  composite ``jax.ops.segment_max``, and ``graph.segment.segment_max``
  beside it, split it among ties instead;
- ``segment_var_aggregate`` (``_seg_var_streamed``, :1071-1114):
  ``dm = 2 (m - mean[recv]) (g / cnt)[recv] mask``;
- ``segment_std_aggregate``: ``sqrt(relu(var) + 1e-5)`` on top, through
  autograd, as JAX's ``segment_std_streamed`` (:1130-1138);
- ``segment_mean_aggregate`` (``_seg_mean_streamed``, :966-997): kernel C's
  forward role (``segment_sum.segment_sum_masked``) over the count, with the
  backward ``dm = (g / cnt)[recv] mask``.

``counts`` [N] is the number of REAL edges of each receiver
(``graph.segment.segment_count`` with the edge mask): in the receiver CSR,
masked edges among real ones stay inside their segment, so it cannot be
read off ``rowptr``.

A wrapper runs the plain version for tensors on the CPU.  For CUDA tensors
it launches the kernel or raises; it never falls back.  H and I are
``torch.library`` ops (``torch.ops.phc_gnn.segment_extreme``,
``segment_moments``, as in ``ops/segment_softmax.py``), so that
``torch.export`` traces them.

H and I read float32 only.  Under the model's bf16 ``compute_dtype`` the
aggregations cast the messages to float32 before them, as JAX's glue does
(stream_scan.py:1016, :1083), and the mean feeds its bf16 messages to C's
bf16 instance; every output is float32 and every backward returns ``dm``
in the messages' dtype (:997, :1040, :1111).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from phc_gnn_torch.ops import _build
from phc_gnn_torch.ops.segment_sum import (check_masked_csr, segment_ids,
                                           segment_sum_masked, upcast)

__all__ = ["segment_extreme", "segment_extreme_plain", "segment_moments",
           "segment_moments_plain", "segment_extreme_aggregate",
           "segment_mean_aggregate", "segment_var_aggregate",
           "segment_std_aggregate", "STD_EPS"]

STD_EPS = 1e-5  # sqrt(relu(var) + eps) (stream_scan.py:1133)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("segment_reduce")
        lib.segment_extreme_f32.argtypes = [_P, _P, _P, _P, _I64, _I64,
                                            ctypes.c_int, _P]
        lib.segment_extreme_f32.restype = ctypes.c_int
        lib.segment_moments_f32.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _P]
        lib.segment_moments_f32.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def _real_rows(msgs, mask, rowptr):
    """(segment of each real edge inside a segment, its row of ``msgs``)."""
    seg = segment_ids(rowptr)
    real = mask[:seg.shape[0]]
    return seg[real], msgs[:seg.shape[0]][real]


def segment_extreme_plain(msgs, mask, rowptr, minimum: bool = False):
    """The function of kernel H in ``msgs``' dtype; exact in any dtype (a
    selection), so the checks hold the kernel to it bit for bit."""
    seg, rows = _real_rows(msgs, mask, rowptr)
    out = torch.zeros((rowptr.shape[0] - 1, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(rows), rows,
                              "amin" if minimum else "amax",
                              include_self=False)


def segment_moments_plain(msgs, mask, rowptr):
    """The function of kernel I in ``msgs``' dtype (the checks pass
    float64): ``(mean, var)``, JAX's formula."""
    seg, rows = _real_rows(msgs, mask, rowptr)
    n = rowptr.shape[0] - 1
    zeros = torch.zeros((n, msgs.shape[1]), dtype=msgs.dtype,
                        device=msgs.device)
    s = zeros.index_add(0, seg, rows)
    s2 = zeros.index_add(0, seg, rows * rows)
    cnt = torch.zeros(n, dtype=msgs.dtype, device=msgs.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=msgs.dtype)).clamp_min(1.0)[:, None]
    mean = s / cnt
    return mean, s2 / cnt - mean * mean


def _fake_out(name, msgs, mask, rowptr):
    check_masked_csr(name, msgs, mask, rowptr, (torch.float32,), fake=True)
    return msgs.new_empty((rowptr.shape[0] - 1, msgs.shape[1]))


@torch.library.custom_op("phc_gnn::segment_extreme", mutates_args=(),
                         device_types="cpu")
def _extreme_op(msgs: torch.Tensor, mask: torch.Tensor, rowptr: torch.Tensor,
                minimum: bool) -> torch.Tensor:
    return segment_extreme_plain(msgs, mask, rowptr, minimum)


@_extreme_op.register_kernel("cuda")
def _extreme_cuda(msgs, mask, rowptr, minimum):
    check_masked_csr("segment_extreme", msgs, mask, rowptr, (torch.float32,))
    dev = msgs.device
    n, d = rowptr.shape[0] - 1, msgs.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    _build.check_launch("segment_extreme", _lib().segment_extreme_f32(
        msgs.data_ptr(), mask.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        n, d, int(minimum), _build.stream(dev)))
    segment_extreme.launches += 1
    return out


_extreme_op.register_fake(
    lambda msgs, mask, rowptr, minimum: _fake_out("segment_extreme", msgs,
                                                  mask, rowptr))


@torch.library.custom_op("phc_gnn::segment_moments", mutates_args=(),
                         device_types="cpu")
def _moments_op(msgs: torch.Tensor, mask: torch.Tensor, rowptr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return segment_moments_plain(msgs, mask, rowptr)


@_moments_op.register_kernel("cuda")
def _moments_cuda(msgs, mask, rowptr):
    check_masked_csr("segment_moments", msgs, mask, rowptr, (torch.float32,))
    dev = msgs.device
    n, d = rowptr.shape[0] - 1, msgs.shape[1]
    mean = torch.empty((n, d), dtype=torch.float32, device=dev)
    var = torch.empty((n, d), dtype=torch.float32, device=dev)
    _build.check_launch("segment_moments", _lib().segment_moments_f32(
        msgs.data_ptr(), mask.data_ptr(), rowptr.data_ptr(), mean.data_ptr(),
        var.data_ptr(), n, d, _build.stream(dev)))
    segment_moments.launches += 1
    return mean, var


@_moments_op.register_fake
def _moments_fake(msgs, mask, rowptr):
    mean = _fake_out("segment_moments", msgs, mask, rowptr)
    return mean, torch.empty_like(mean)


def segment_extreme(msgs, mask, rowptr, minimum: bool = False):
    """[N, D] max (or min) of the rows ``msgs[e]`` whose ``mask[e]`` holds,
    per CSR segment of ``rowptr`` [N + 1]; 0 for a segment without one
    (kernel H, ``torch.ops.phc_gnn.segment_extreme``)."""
    return torch.ops.phc_gnn.segment_extreme(msgs, mask, rowptr, minimum)


segment_extreme.launches = 0


def segment_moments(msgs, mask, rowptr):
    """``(mean, var)``, each [N, D], of the rows ``msgs[e]`` whose
    ``mask[e]`` holds, per CSR segment of ``rowptr`` [N + 1]: both 0 for a
    segment without one (kernel I, ``torch.ops.phc_gnn.segment_moments``)."""
    return torch.ops.phc_gnn.segment_moments(msgs, mask, rowptr)


segment_moments.launches = 0


class _SegmentExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, receivers, mask, rowptr, minimum):
        out = segment_extreme(upcast(msgs), mask, rowptr, minimum)
        ctx.save_for_backward(msgs, out, receivers, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        msgs, out, receivers, mask = ctx.saved_tensors
        hit = mask[:, None] & (upcast(msgs) == out.index_select(0, receivers))
        dm = torch.where(hit, g.index_select(0, receivers), 0.0)
        return dm.to(msgs.dtype), None, None, None, None


def segment_extreme_aggregate(msgs, receivers, mask, rowptr,
                              minimum: bool = False):
    """The masked max (or min) of the receiver-sorted ``msgs`` [E, D] per
    receiver, [N, D] for ``rowptr`` [N + 1], 0 where a receiver has no real
    edge (kernel H on the card); its backward gives every tied extreme edge
    the whole cotangent."""
    return _SegmentExtreme.apply(msgs, receivers, mask, rowptr, minimum)


class _SegmentMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, receivers, mask, rowptr, cnt):
        ctx.save_for_backward(receivers, mask, cnt)
        ctx.msgs_dtype = msgs.dtype
        return segment_sum_masked(msgs, mask, rowptr) / cnt[:, None]

    @staticmethod
    def backward(ctx, g):
        receivers, mask, cnt = ctx.saved_tensors
        dm = (g / cnt[:, None]).index_select(0, receivers) * mask[:, None]
        return dm.to(ctx.msgs_dtype), None, None, None, None


def segment_mean_aggregate(msgs, receivers, mask, rowptr, counts):
    """The masked mean of the receiver-sorted ``msgs`` [E, D] per receiver,
    [N, D] for ``rowptr`` [N + 1] and the real-edge ``counts`` [N] (kernel
    C's forward role on the card), 0 where a receiver has no real edge."""
    return _SegmentMean.apply(msgs, receivers, mask, rowptr,
                              counts.clamp_min(1.0))


class _SegmentVar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, receivers, mask, rowptr, cnt):
        mean, var = segment_moments(upcast(msgs), mask, rowptr)
        ctx.save_for_backward(msgs, mean, cnt, receivers, mask)
        return var

    @staticmethod
    def backward(ctx, g):
        msgs, mean, cnt, receivers, mask = ctx.saved_tensors
        dm = (2.0 * (upcast(msgs) - mean.index_select(0, receivers))
              * (g / cnt[:, None]).index_select(0, receivers)
              * mask[:, None])
        return dm.to(msgs.dtype), None, None, None, None


def segment_var_aggregate(msgs, receivers, mask, rowptr, counts):
    """The masked variance ``E[m^2] - E[m]^2`` of the receiver-sorted
    ``msgs`` [E, D] per receiver, [N, D] for ``rowptr`` [N + 1] and the
    real-edge ``counts`` [N] (kernel I on the card), 0 where a receiver has
    no real edge."""
    return _SegmentVar.apply(msgs, receivers, mask, rowptr,
                             counts.clamp_min(1.0))


def segment_std_aggregate(msgs, receivers, mask, rowptr, counts):
    """``sqrt(relu(var) + 1e-5)`` of ``segment_var_aggregate``."""
    var = segment_var_aggregate(msgs, receivers, mask, rowptr, counts)
    return torch.sqrt(torch.relu(var) + STD_EPS)

"""Quaternion whitening batch norm ('q-batch-norm'): the statistics, the
whitened output and the analytic backward.

Hopper kernels (``csrc/fused_whitening.cu``), each beside its plain PyTorch
version, which follows the formula path of phc_gnn_tpu/ops/fused_whitening.py
(``_stats``, ``_chol_fields``, ``_transform``, ``_fused_whitening_bwd``,
:61-156, :481-519).  ``x`` is ``[N, 4d]`` component-major: columns
``k*d:(k+1)*d`` are component k of the d features.

- ``wbn_stats`` replaces ``_wbn_stats_kernel`` (:184), J: over the rows where
  ``mask`` holds, ``cnt = max(sum m, 1)``, the 4 means and the biased 4x4
  covariance of every feature, and the closed-form Cholesky factor ``L`` of
  ``cov + eps I`` (``[10, d]`` in JAX's ``_L_IDX`` order); one launch of a
  grid of thread-block clusters (``wbn_plan``);
- ``wbn_transform`` replaces ``_wbn_transform_kernel`` (:236), K:
  ``y = Gamma L^{-1} (x - mean) + beta`` on EVERY row, its threads over
  the (row, feature) pairs, each feature's factor staged once a CTA;
- ``wbn_bwd_sums`` replaces ``_wbn_bwd_sums_kernel`` (:253), L, and the T/S/M
  algebra that JAX runs in XLA between L and M (:408-412): ``dGamma``,
  ``dbeta``, ``M = L^{-T} S L^{-1}`` from ``Lbar = -tril(sum w z^T)`` and
  ``sum w``, every sum over ALL rows; one cluster launch, as J, whose sweep
  takes the sums linear in the rows (``sum g``, ``sum g (x - mean)^T``) and
  whose epilogue derives the rest;
- ``wbn_dx`` replaces ``_wbn_dx_kernel`` (:304), M:
  ``dx = w + (m / cnt) (M u - sum w)``, only the mean-path term masked;
- ``wbn_transform_eval`` is the eval path (phc_gnn_tpu/nn/norm.py:331-345,
  inline XLA there): K's kernel with the Cholesky factor of the running
  covariance (J's device function) in its prologue, one launch, returning
  the factor too; counted under ``wbn_transform``.

``fused_whitening`` is an ``autograd.Function`` that returns
``(y, mean [4, d], cov [4, 4, d])``, differentiable in ``x``, ``gamma`` and
``beta``; mean and cov are detached (fused_whitening.py:432-446).
``eval_whitening`` is the eval path (norm.py:331-345): the running stats'
Cholesky and K in one launch, differentiable in ``x``, ``gamma`` and ``beta`` with the
statistics fixed, so that ``dx = w = L^{-T} Gamma^T g`` and ``dbeta``,
``dGamma`` are L's sums: the ``frozen`` variants of L and M, which skip the
T/S/M algebra and the mean-path term (through the training variants, an
all-false mask would give ``cnt = 0`` and a NaN there).  The plain versions
run in the dtype of their inputs, so a check can run them in float64.

A wrapper runs the plain version for tensors on the CPU.  For CUDA tensors it
launches its kernel or raises; it never falls back.  ``<wrapper>.launches``
counts the launches.

``wbn_plan`` computes J's and L's launch: a cluster owns a slab of features
(all four component columns of each), its CTAs split the rows and meet
through distributed shared memory, and each feature's outputs come from one
rank's epilogue (``csrc/fused_whitening.cu``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from phc_gnn_torch.ops import _build

__all__ = ["L_IDX", "WbnPlan", "wbn_plan", "wbn_stats", "wbn_stats_plain",
           "wbn_transform", "wbn_transform_plain", "wbn_bwd_sums", "wbn_bwd_sums_plain",
           "wbn_dx", "wbn_dx_plain", "wbn_transform_eval",
           "wbn_transform_eval_plain", "wbn_cholesky_plain", "fused_whitening",
           "eval_whitening"]

# rows of the Cholesky factor [10, d] (fused_whitening.py:473-474)
L_IDX = [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2),
         (3, 0), (3, 1), (3, 2), (3, 3)]

# J's and L's launch plan (csrc/fused_whitening.cu holds the same constants)
WBN_SLAB = 8                 # features a cluster owns (kSlab)
WBN_MAX_CLUSTER = 16         # CTAs a cluster: past 8, a non-portable size
# clusters of each size that an H100 holds at once, at L's one CTA an SM
# (cudaOccupancyMaxActiveClusters, read by tools/time_fused_whitening.py):
# clusters of 16 and 8 fit only inside one GPC, so fewer than 132 / size
WBN_CLUSTERS_HELD = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}
WBN_MIN_ROWS = 256           # no more CTAs a cluster than blocks of these rows
WBN_WARPS = 8                # warps a CTA (256 threads)
WBN_MAX_SMEM = 48 * 1024     # dynamic shared memory without an opt-in
WBN_STATS_SUMS = 15          # J: count, 4 means, 10 co-moments
WBN_SUMS = 20                # L, both variants: sum g 4, sum g (x - mean)^T 16
WBN_KERNELS = ("wbn_stats", "wbn_bwd_sums", "wbn_bwd_sums_frozen")


class WbnPlan(NamedTuple):
    """The launch of J or L: ``grid`` CTAs in clusters of ``cluster``, one
    cluster a slab of ``slab`` features (columns ``k*d + f`` for k = 0..3);
    the CTA of rank r owns the rows ``[r * rows_per_cta, min(n, (r + 1) *
    rows_per_cta))``; ``smem_bytes`` of dynamic shared memory hold every
    rank's partials, each warp's and the cluster's totals."""
    slab: int
    cluster: int
    rows_per_cta: int
    smem_bytes: int
    grid: int


def wbn_smem_bytes(slab: int, cluster: int, sums: int) -> int:
    """J's and L's dynamic shared memory (``smem_floats`` of the source):
    slots of ``sums + 4`` floats a feature (J's shift beside its partials)
    for each of ``cluster`` ranks, each warp and the totals."""
    return 4 * slab * (cluster + WBN_WARPS + 1) * (sums + 4)


@functools.lru_cache(maxsize=256)
def wbn_plan(n: int, d: int, sums: int) -> WbnPlan:
    """The launch plan of J (``sums=15``) or L, either variant (20), at
    ``[n, 4d]``: slabs of ``WBN_SLAB`` features in clusters of 16, 8, 4, 2
    or 1 CTAs, the largest with no more CTAs than ``WBN_MIN_ROWS``-row
    blocks of n whose clusters the card holds all at once at a CTA an SM
    (``WBN_CLUSTERS_HELD``), so that they run in one wave wherever the
    slabs are no more than the card's SMs."""
    slabs = max(1, -(-d // WBN_SLAB))
    cluster = WBN_MAX_CLUSTER
    while cluster > 1 and (cluster > -(-n // WBN_MIN_ROWS)
                           or slabs > WBN_CLUSTERS_HELD[cluster]):
        cluster //= 2
    return WbnPlan(WBN_SLAB, cluster, -(-n // cluster),
                   wbn_smem_bytes(WBN_SLAB, cluster, sums), slabs * cluster)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load("fused_whitening")
        lib.wbn_stats_f32.argtypes = ([_P, _P, _F32] + [_P] * 4 + [_I64] * 6
                                      + [_P])
        lib.wbn_transform_f32.argtypes = [_P] * 6 + [_I64] * 3 + [_P]
        lib.wbn_bwd_sums_f32.argtypes = [_P] * 9 + [_I64] * 6 + [_P]
        lib.wbn_dx_f32.argtypes = [_P] * 10 + [_I64, _I64, _P]
        lib.wbn_transform_eval_f32.argtypes = [_P] * 5 + [_F32, _P, _P] + [
            _I64] * 3 + [_P]
        lib.wbn_bwd_sums_frozen_f32.argtypes = [_P] * 6 + [_I64] * 6 + [_P]
        lib.wbn_dx_frozen_f32.argtypes = [_P] * 4 + [_I64, _I64, _P]
        lib.wbn_max_active_clusters.argtypes = [_I64] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.wbn_stats_f32, lib.wbn_transform_f32,
                   lib.wbn_bwd_sums_f32, lib.wbn_dx_f32,
                   lib.wbn_transform_eval_f32,
                   lib.wbn_bwd_sums_frozen_f32, lib.wbn_dx_frozen_f32,
                   lib.wbn_max_active_clusters):
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def _max_active_clusters(plan: WbnPlan, kernel: str) -> int:
    """How many clusters of ``plan`` the current CUDA device holds at once
    for ``kernel`` of ``WBN_KERNELS`` (``cudaOccupancyMaxActiveClusters``);
    a grid of more clusters runs in waves.  A check of the plan for the
    card's tests; no path calls it."""
    out = ctypes.c_int()
    err = _lib().wbn_max_active_clusters(WBN_KERNELS.index(kernel),
                                         plan.cluster, plan.smem_bytes,
                                         ctypes.byref(out))
    _build.check_launch("wbn_max_active_clusters", err)
    return out.value


# ------------------------------------------------------------ plain versions

def _slices(a: torch.Tensor) -> List[torch.Tensor]:
    d = a.shape[1] // 4
    return [a[:, k * d:(k + 1) * d] for k in range(4)]


def _chol_fields(cov: Dict, eps: float) -> Dict:
    """Closed-form Cholesky of the symmetric ``cov`` {(j, k): [d], j <= k}
    plus ``eps I`` (``_chol_fields``, fused_whitening.py:61-78)."""
    l = {}
    l[(0, 0)] = torch.sqrt(cov[(0, 0)] + eps)
    l[(1, 0)] = cov[(0, 1)] / l[(0, 0)]
    l[(1, 1)] = torch.sqrt(cov[(1, 1)] + eps - l[(1, 0)] ** 2)
    l[(2, 0)] = cov[(0, 2)] / l[(0, 0)]
    l[(2, 1)] = (cov[(1, 2)] - l[(1, 0)] * l[(2, 0)]) / l[(1, 1)]
    l[(2, 2)] = torch.sqrt(cov[(2, 2)] + eps
                           - (l[(2, 1)] ** 2 + l[(2, 0)] ** 2))
    l[(3, 0)] = cov[(0, 3)] / l[(0, 0)]
    l[(3, 1)] = (cov[(1, 3)] - l[(1, 0)] * l[(3, 0)]) / l[(1, 1)]
    l[(3, 2)] = (cov[(2, 3)]
                 - (l[(2, 1)] * l[(3, 1)] + l[(2, 0)] * l[(3, 0)])) / l[(2, 2)]
    l[(3, 3)] = torch.sqrt(cov[(3, 3)] + eps
                           - (l[(3, 2)] ** 2 + l[(3, 1)] ** 2
                              + l[(3, 0)] ** 2))
    return l


def _inv_diag(l: Dict) -> List[torch.Tensor]:
    return [1.0 / l[(k, k)] for k in range(4)]


def _fwd_subst(l: Dict, b, il) -> List[torch.Tensor]:
    """Solve L z = b for the 4 component slices b."""
    z0 = b[0] * il[0]
    z1 = (b[1] - l[(1, 0)] * z0) * il[1]
    z2 = (b[2] - l[(2, 0)] * z0 - l[(2, 1)] * z1) * il[2]
    z3 = (b[3] - l[(3, 0)] * z0 - l[(3, 1)] * z1 - l[(3, 2)] * z2) * il[3]
    return [z0, z1, z2, z3]


def _bwd_subst(l: Dict, b, il) -> List[torch.Tensor]:
    """Solve L^T w = b."""
    w3 = b[3] * il[3]
    w2 = (b[2] - l[(3, 2)] * w3) * il[2]
    w1 = (b[1] - l[(2, 1)] * w2 - l[(3, 1)] * w3) * il[1]
    w0 = (b[0] - l[(1, 0)] * w1 - l[(2, 0)] * w2 - l[(3, 0)] * w3) * il[0]
    return [w0, w1, w2, w3]


def _m_from_lbar(l: Dict, lbar: Dict) -> List[List[torch.Tensor]]:
    """``T = L^T Lbar``, ``S = copyltu(T)``, ``M = L^{-T} S L^{-1}``
    (``_m_from_lbar``, fused_whitening.py:110-130); ``m[a][b] = M_ab``."""
    t = {}
    for a in range(4):
        for b in range(a + 1):
            t[(a, b)] = sum(l[(c, a)] * lbar[(c, b)] for c in range(a, 4))
    s = {}
    for a in range(4):
        for b in range(a + 1):
            s[(a, b)] = s[(b, a)] = t[(a, b)]
    il = _inv_diag(l)
    v_cols = [_bwd_subst(l, [s[(a, b)] for a in range(4)], il)
              for b in range(4)]
    return [_bwd_subst(l, [v_cols[b][a] for b in range(4)], il)
            for a in range(4)]


def _fields(l_s: torch.Tensor) -> Dict:
    return {jk: l_s[i] for i, jk in enumerate(L_IDX)}


def _stack_l(l: Dict) -> torch.Tensor:
    return torch.stack([l[jk] for jk in L_IDX])


def _stack_cov(cov: Dict) -> torch.Tensor:
    return torch.stack([torch.stack([cov[(min(j, k), max(j, k))]
                                     for k in range(4)]) for j in range(4)])


def wbn_stats_plain(x, mask, eps: float):
    """``(mean [4, d], cov [4, 4, d], L [10, d], cnt [1])``: the masked mean,
    then the centred, biased covariance (``_stats``)."""
    m = mask[:, None].to(x.dtype)
    cnt = m.sum().clamp_min(1.0)
    c = _slices(x)
    mean = [(ck * m).sum(0) / cnt for ck in c]
    cm = [(ck - mu) * m for ck, mu in zip(c, mean)]
    cov = {(j, k): (cm[j] * cm[k]).sum(0) / cnt
           for j in range(4) for k in range(j, 4)}
    l = _chol_fields(cov, eps)
    return torch.stack(mean), _stack_cov(cov), _stack_l(l), cnt.reshape(1)


def wbn_cholesky_plain(cov, eps: float):
    """``L [10, d]`` of ``cov [4, 4, d] + eps I`` from its upper triangle,
    as JAX's eval path reads it (norm.py:333-340)."""
    return _stack_l(_chol_fields(
        {(j, k): cov[j, k] for j in range(4) for k in range(j, 4)}, eps))


def wbn_transform_eval_plain(x, mean, cov, gamma, beta, eps: float):
    """``(y, L)``: the eval Cholesky ``wbn_cholesky_plain``, then
    ``wbn_transform_plain`` with the running ``mean``."""
    l = wbn_cholesky_plain(cov, eps)
    return wbn_transform_plain(x, mean, l, gamma, beta), l


def _whiten(x, mean, l):
    """``(u, z, L fields, 1 / diag L)`` with ``u = x - mean`` and
    ``z = L^{-1} u``, as component slices."""
    lf = _fields(l)
    il = _inv_diag(lf)
    cu = [ck - mean[k] for k, ck in enumerate(_slices(x))]
    return cu, _fwd_subst(lf, cu, il), lf, il


def wbn_transform_plain(x, mean, l, gamma, beta):
    """``y = Gamma z + beta`` on every row (``_transform``)."""
    _, zs, _, _ = _whiten(x, mean, l)
    return torch.cat([sum(gamma[c, k] * zs[k] for k in range(4)) + beta[c]
                      for c in range(4)], dim=1)


def _solve_w(g, gamma, lf, il):
    """``w = L^{-T} Gamma^T g`` per row, as component slices."""
    gs = _slices(g)
    hs = [sum(gamma[c, k] * gs[c] for c in range(4)) for k in range(4)]
    return gs, _bwd_subst(lf, hs, il)


def wbn_bwd_sums_plain(x, g, gamma, mean, l, frozen: bool = False):
    """``(dGamma [4, 4, d], dbeta [4, d], M [16, d], sum w [4, d])`` over ALL
    rows (``_fused_whitening_bwd``, :496-514); row ``a*4+b`` of M is
    ``M_ab``.  ``frozen``: ``(dGamma, dbeta)`` alone."""
    _, zs, lf, il = _whiten(x, mean, l)
    gs = _slices(g)
    dbeta = torch.stack([gc.sum(0) for gc in gs])
    dgamma = torch.stack([torch.stack([(gs[c] * zs[k]).sum(0)
                                       for k in range(4)]) for c in range(4)])
    if frozen:
        return dgamma, dbeta
    _, ws = _solve_w(g, gamma, lf, il)
    lbar = {(j, k): -(ws[j] * zs[k]).sum(0) for j, k in L_IDX}
    m_rows = _m_from_lbar(lf, lbar)
    mmat = torch.stack([m_rows[a][b] for a in range(4) for b in range(4)])
    return dgamma, dbeta, mmat, torch.stack([wk.sum(0) for wk in ws])


def wbn_dx_plain(x, g, mask, gamma, mean, l, mmat, sw, cnt,
                 frozen: bool = False):
    """``dx = w + (m / cnt) (M u - sum w)`` (:515-519); ``frozen``: ``dx =
    w``."""
    cu, _, lf, il = _whiten(x, mean, l)
    _, ws = _solve_w(g, gamma, lf, il)
    if frozen:
        return torch.cat(ws, dim=1)
    scale = mask[:, None].to(x.dtype) * (1.0 / cnt)
    return torch.cat([ws[a] + scale * (sum(mmat[a * 4 + b] * cu[b]
                                           for b in range(4)) - sw[a])
                      for a in range(4)], dim=1)


# ------------------------------------------------------------------ wrappers

def _check(x, named, mask=None, g=None):
    """``x`` float32 [N, 4d] on a CUDA device; each ``(name, tensor, shape)``
    of ``named`` float32 of that shape; ``mask`` bool [N]; ``g`` like ``x``;
    all on x's device and contiguous."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the whitening kernels run on CPU or CUDA tensors, "
                         f"got {dev}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] % 4:
        raise TypeError(f"x must be a float32 [N, 4d] tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    named = [("x", x, tuple(x.shape))] + list(named)
    if g is not None:
        named.append(("g", g, tuple(x.shape)))
    for name, t, shape in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be float32 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != x.shape[:1]:
            raise TypeError(f"mask must be bool [{x.shape[0]}], got "
                            f"{mask.dtype} {tuple(mask.shape)}")
        named.append(("mask", mask, None))
    for name, t, _ in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _field_checks(d: int, gamma, mean, l):
    """Gamma, the mean and the Cholesky factor, which K, L and M read, named
    with their shapes for ``_check``."""
    return [("gamma", gamma, (4, 4, d)), ("mean", mean, (4, d)),
            ("l", l, (10, d))]


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _plan_args(n: int, d: int, sums: int):
    """The plan's (slab, cluster, rows, smem) for the C entry points."""
    if n >= 2 ** 31:
        raise ValueError(f"the whitening kernels take fewer than 2^31 rows, "
                         f"got {n}")
    plan = wbn_plan(n, d, sums)
    return plan.slab, plan.cluster, plan.rows_per_cta, plan.smem_bytes


def wbn_stats(x, mask, eps: float):
    """``(mean [4, d], cov [4, 4, d], L [10, d], cnt [1])`` of the masked
    rows of ``x`` [N, 4d], in one cluster launch (kernel J)."""
    if x.device.type == "cpu":
        return wbn_stats_plain(x, mask, eps)
    _check(x, [], mask)
    n, d = x.shape[0], x.shape[1] // 4
    dev = x.device
    mean, cov, l, cnt = (_empty(dev, 4, d), _empty(dev, 4, 4, d),
                         _empty(dev, 10, d), _empty(dev, 1))
    _build.check_launch("wbn_stats", _lib().wbn_stats_f32(
        x.data_ptr(), mask.data_ptr(), eps, mean.data_ptr(), cov.data_ptr(),
        l.data_ptr(), cnt.data_ptr(), n, d, *_plan_args(n, d, WBN_STATS_SUMS),
        _build.stream(dev)))
    wbn_stats.launches += 1
    return mean, cov, l, cnt


wbn_stats.launches = 0


def wbn_transform(x, mean, l, gamma, beta):
    """``y = Gamma L^{-1} (x - mean) + beta`` on every row (kernel K)."""
    if x.device.type == "cpu":
        return wbn_transform_plain(x, mean, l, gamma, beta)
    n, d = x.shape[0], x.shape[1] // 4
    _check(x, _field_checks(d, gamma, mean, l) + [("beta", beta, (4, d))])
    y = torch.empty_like(x)
    _build.check_launch("wbn_transform", _lib().wbn_transform_f32(
        x.data_ptr(), mean.data_ptr(), l.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), y.data_ptr(), n, d, _build.SMS,
        _build.stream(x.device)))
    wbn_transform.launches += 1
    return y


wbn_transform.launches = 0


def wbn_transform_eval(x, mean, cov, gamma, beta, eps: float):
    """``(y, L)`` of the eval path in one launch of K: ``L [10, d]`` the
    Cholesky factor of the running ``cov [4, 4, d] + eps I`` (its upper
    triangle), ``y = Gamma L^{-1} (x - mean) + beta`` on every row.  Counted
    under ``wbn_transform.launches``."""
    if x.device.type == "cpu":
        return wbn_transform_eval_plain(x, mean, cov, gamma, beta, eps)
    n, d = x.shape[0], x.shape[1] // 4
    _check(x, [("gamma", gamma, (4, 4, d)), ("mean", mean, (4, d)),
               ("cov", cov, (4, 4, d)), ("beta", beta, (4, d))])
    y, l = torch.empty_like(x), _empty(x.device, 10, d)
    _build.check_launch("wbn_transform_eval", _lib().wbn_transform_eval_f32(
        x.data_ptr(), mean.data_ptr(), cov.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), eps, y.data_ptr(), l.data_ptr(), n, d, _build.SMS,
        _build.stream(x.device)))
    wbn_transform.launches += 1
    return y, l


def wbn_bwd_sums(x, g, gamma, mean, l, frozen: bool = False):
    """``(dGamma [4, 4, d], dbeta [4, d], M [16, d], sum w [4, d])`` over all
    rows, in one cluster launch with the T/S/M algebra in its epilogue
    (kernel L).  ``frozen`` (the eval path, its statistics fixed):
    ``(dGamma, dbeta)`` alone, from L's frozen variant."""
    if x.device.type == "cpu":
        return wbn_bwd_sums_plain(x, g, gamma, mean, l, frozen)
    n, d = x.shape[0], x.shape[1] // 4
    _check(x, _field_checks(d, gamma, mean, l), g=g)
    dev = x.device
    if frozen:
        dgamma, dbeta = _empty(dev, 4, 4, d), _empty(dev, 4, d)
        _build.check_launch("wbn_bwd_sums", _lib().wbn_bwd_sums_frozen_f32(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), l.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), n, d,
            *_plan_args(n, d, WBN_SUMS), _build.stream(dev)))
        wbn_bwd_sums.launches += 1
        return dgamma, dbeta
    dgamma, dbeta, mmat, sw = (_empty(dev, 4, 4, d), _empty(dev, 4, d),
                               _empty(dev, 16, d), _empty(dev, 4, d))
    _build.check_launch("wbn_bwd_sums", _lib().wbn_bwd_sums_f32(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), l.data_ptr(),
        gamma.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        mmat.data_ptr(), sw.data_ptr(), n, d, *_plan_args(n, d, WBN_SUMS),
        _build.stream(dev)))
    wbn_bwd_sums.launches += 1
    return dgamma, dbeta, mmat, sw


wbn_bwd_sums.launches = 0


def wbn_dx(x, g, mask, gamma, mean, l, mmat, sw, cnt, frozen: bool = False):
    """``dx = w + (m / cnt) (M u - sum w)``, elementwise (kernel M); ``cnt``
    is the [1] count of ``wbn_stats``.  ``frozen`` (the eval path, its
    statistics fixed): ``dx = w``, from M's frozen variant, which reads
    neither ``mask``, ``mmat``, ``sw`` nor ``cnt`` (they may be None)."""
    if x.device.type == "cpu":
        return wbn_dx_plain(x, g, mask, gamma, mean, l, mmat, sw, cnt, frozen)
    n, d = x.shape[0], x.shape[1] // 4
    if frozen:
        _check(x, _field_checks(d, gamma, mean, l), g=g)
        dx = torch.empty_like(x)
        _build.check_launch("wbn_dx", _lib().wbn_dx_frozen_f32(
            g.data_ptr(), l.data_ptr(), gamma.data_ptr(), dx.data_ptr(), n, d,
            _build.stream(x.device)))
        wbn_dx.launches += 1
        return dx
    _check(x, _field_checks(d, gamma, mean, l) + [
        ("mmat", mmat, (16, d)), ("sw", sw, (4, d)), ("cnt", cnt, (1,))],
        mask, g)
    dx = torch.empty_like(x)
    _build.check_launch("wbn_dx", _lib().wbn_dx_f32(
        x.data_ptr(), g.data_ptr(), mask.data_ptr(), mean.data_ptr(),
        l.data_ptr(), gamma.data_ptr(), mmat.data_ptr(), sw.data_ptr(),
        cnt.data_ptr(), dx.data_ptr(), n, d, _build.stream(x.device)))
    wbn_dx.launches += 1
    return dx


wbn_dx.launches = 0


class _FusedWhitening(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, gamma, beta, eps):
        mean, cov, l, cnt = wbn_stats(x, mask, eps)
        y = wbn_transform(x, mean, l, gamma, beta)
        ctx.save_for_backward(x, mask, gamma, mean, l, cnt)
        ctx.mark_non_differentiable(mean, cov)
        return y, mean, cov

    @staticmethod
    def backward(ctx, gy, _gmean, _gcov):
        x, mask, gamma, mean, l, cnt = ctx.saved_tensors
        gy = gy.contiguous()
        dgamma, dbeta, mmat, sw = wbn_bwd_sums(x, gy, gamma, mean, l)
        dx = wbn_dx(x, gy, mask, gamma, mean, l, mmat, sw, cnt)
        return dx, None, dgamma, dbeta, None


def fused_whitening(x, mask: Optional[torch.Tensor], gamma, beta,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Training-mode quaternion whitening of ``x`` [N, 4d]:
    ``(y [N, 4d], mean [4, d], cov [4, 4, d])``, differentiable in ``x``,
    ``gamma`` [4, 4, d] and ``beta`` [4, d]; ``mean`` and the biased ``cov``
    are detached.  ``mask`` [N] bool gates the statistics (``None`` counts
    every row); every row is whitened."""
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return _FusedWhitening.apply(x, mask, gamma, beta, float(eps))


class _EvalWhitening(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, mean, cov, eps):
        y, l = wbn_transform_eval(x, mean, cov, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, l)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, mean, l = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dgamma = dbeta = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dgamma, dbeta = wbn_bwd_sums(x, gy, gamma, mean, l, frozen=True)
        if ctx.needs_input_grad[0]:
            dx = wbn_dx(x, gy, None, gamma, mean, l, None, None, None,
                        frozen=True)
        return dx, dgamma, dbeta, None, None, None


def eval_whitening(x, mean, cov, gamma, beta, eps: float = 1e-5):
    """Eval-mode quaternion whitening of ``x`` [N, 4d] with the running
    ``mean`` [4, d] and ``cov`` [4, 4, d]: ``y = Gamma L^{-1} (x - mean) +
    beta``, ``L`` the Cholesky factor of ``cov + eps I`` (one launch of K,
    ``wbn_transform_eval``).  Differentiable in ``x``, ``gamma`` and
    ``beta`` (the frozen variants of L and M, fed the factor K returns), not
    in the running stats; no host sync, so a CUDA graph can capture it,
    forward and backward."""
    return _EvalWhitening.apply(x, gamma, beta, mean, cov, float(eps))

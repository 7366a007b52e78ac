"""Dataset evaluators: a copy of phc_gnn_tpu/train/evaluators.py (numpy).

ROC-AUC (molhiv), AP (molpcba), accuracy (ppa/mnist/cifar10), MAE (zinc):
host-side implementations matching the OGB ``Evaluator`` and the custom
evaluators the reference uses (train_hiv.py:211-214, train_zinc.py:166-177,
train_mnist.py:175-189).  NaN targets (missing labels, padding graphs) are
excluded per column, as OGB does for molpcba.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rocauc", "average_precision", "accuracy", "mae", "get_evaluator",
           "EVALUATORS"]


def _binary_clean(y_true, y_pred):
    mask = np.isfinite(y_true)
    return y_true[mask], y_pred[mask]


def _rocauc_single(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUC via the Mann-Whitney U statistic (rank-based, ties averaged)."""
    pos = y_true > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return np.nan
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    r_pos = ranks[pos].sum()
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def rocauc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean ROC-AUC over label columns with both classes present (OGB style)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim == 1:
        y_true, y_pred = y_true[:, None], y_pred[:, None]
    aucs = []
    for c in range(y_true.shape[1]):
        t, p = _binary_clean(y_true[:, c], y_pred[:, c])
        if len(t) == 0:
            continue
        a = _rocauc_single(t, p)
        if np.isfinite(a):
            aucs.append(a)
    return float(np.mean(aucs)) if aucs else np.nan


def _ap_single(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision (step interpolation over distinct thresholds, tied
    scores grouped — matches sklearn.average_precision_score)."""
    pos = (y_true > 0.5).astype(np.float64)
    n_pos = pos.sum()
    if n_pos == 0:
        return np.nan
    order = np.argsort(-y_score, kind="mergesort")
    scores = y_score[order]
    tp = np.cumsum(pos[order])
    # indices where the threshold changes (group ties)
    distinct = np.r_[scores[1:] != scores[:-1], True]
    tp_d = tp[distinct]
    count_d = np.arange(1, len(tp) + 1)[distinct]
    precision = tp_d / count_d
    recall = tp_d / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def average_precision(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean AP over label columns with at least one positive (OGB ap metric)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim == 1:
        y_true, y_pred = y_true[:, None], y_pred[:, None]
    aps = []
    for c in range(y_true.shape[1]):
        t, p = _binary_clean(y_true[:, c], y_pred[:, c])
        if len(t) == 0 or (t > 0.5).sum() == 0:
            continue
        aps.append(_ap_single(t, p))
    return float(np.mean(aps)) if aps else np.nan


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """y_pred: logits [N, C] or labels [N]; y_true: labels [N] (NaN = skip)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred)
    mask = np.isfinite(y_true.astype(np.float64))
    if y_pred.ndim == 2:
        y_hat = y_pred.argmax(axis=-1)
    else:
        y_hat = y_pred
    return float((y_hat[mask] == y_true[mask].astype(np.int64)).mean())


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true, y_pred = np.asarray(y_true).reshape(-1), np.asarray(y_pred).reshape(-1)
    mask = np.isfinite(y_true)
    return float(np.abs(y_pred[mask] - y_true[mask]).mean())


EVALUATORS = {
    "rocauc": rocauc,
    "ap": average_precision,
    "acc": accuracy,
    "mae": mae,
}


def get_evaluator(name: str):
    if name not in EVALUATORS:
        raise ValueError(f"unknown evaluator {name!r}; valid: {sorted(EVALUATORS)}")
    return EVALUATORS[name]

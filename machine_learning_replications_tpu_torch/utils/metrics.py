"""Evaluation metrics: on tensors (any device), and host-side AUC batches.

Port of the JAX package's ``utils/metrics.py``. The reference evaluates with
``sklearn.metrics``: ``classification_report`` at threshold 0.5
(``train_ensemble_public.py:63-64``), the ROC curve with its AUC (``:67-77``)
and the precision-recall curve (``:79-88``), each with a 95% Wald band
``1.96*sqrt(p*(1-p)/n)`` (``:76,:84``). The tensor functions take tensors or
host arrays (numpy arrays become CPU tensors) and compute with static
shapes: AUC by the rank statistic with tie handling, ROC/PR curves as
cumulative scans over the score-sorted order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _average_ranks(scores: torch.Tensor) -> torch.Tensor:
    """1-based ranks with ties given their group-average rank."""
    s = torch.sort(scores).values
    lo = torch.searchsorted(s, scores, side="left")
    hi = torch.searchsorted(s, scores, side="right")
    return 0.5 * (lo + hi + 1).to(s.dtype)


def roc_auc(y_true, scores) -> torch.Tensor:
    """AUC-ROC = P(score⁺ > score⁻) + ½P(tie), via average ranks: sklearn's
    trapezoidal ``roc_auc_score`` exactly, ties included. NaN when a class
    is empty."""
    scores = _t(scores)
    y = _t(y_true).to(device=scores.device, dtype=scores.dtype)
    n_pos = torch.sum(y)
    n_neg = y.shape[0] - n_pos
    r = _average_ranks(scores)
    u = torch.sum(r * y) - n_pos * (n_pos + 1.0) / 2.0
    return u / (n_pos * n_neg)


def roc_auc_batch_host(y_true, scores) -> np.ndarray:
    """Tie-averaged rank AUC over a batch of score rows ``[L, m]`` → ``[L]``,
    in host numpy (scipy ``rankdata`` along the row axis): the Mann-Whitney
    U statistic, equal to sklearn's trapezoidal ``roc_auc_score``. Returns
    NaN rows when a class is empty, rather than warning."""
    from scipy.stats import rankdata

    y = np.asarray(y_true, np.float64)
    n_pos = y.sum()
    n_neg = y.size - n_pos
    scores = np.atleast_2d(np.asarray(scores, np.float64))
    if n_pos == 0 or n_neg == 0:
        return np.full(scores.shape[0], np.nan)
    r = rankdata(scores, axis=-1, method="average")
    u = (r * y[None, :]).sum(axis=-1) - n_pos * (n_pos + 1.0) / 2.0
    return u / (n_pos * n_neg)


class RocCurve(NamedTuple):
    """Fixed-length ROC scan: point k uses the top-k scores as positives."""

    fpr: torch.Tensor         # [n+1]
    tpr: torch.Tensor         # [n+1]
    thresholds: torch.Tensor  # [n+1] — descending; [0] is +inf (no positives)


def roc_curve(y_true, scores) -> RocCurve:
    """ROC points over every score cut, in descending-threshold order (ties
    give repeated points, which add no area)."""
    scores = _t(scores)
    order = torch.argsort(-scores, stable=True)
    y = _t(y_true).to(scores.device)[order].to(scores.dtype)
    z = torch.zeros(1, dtype=y.dtype, device=y.device)
    tp = torch.cat([z, torch.cumsum(y, 0)])
    fp = torch.cat([z, torch.cumsum(1.0 - y, 0)])
    thr = torch.cat([torch.full((1,), torch.inf, dtype=scores.dtype, device=scores.device),
                     scores[order]])
    return RocCurve(fpr=fp / fp[-1], tpr=tp / tp[-1], thresholds=thr)


class PrCurve(NamedTuple):
    precision: torch.Tensor   # [n+1] — ends at 1.0 (zero-recall convention)
    recall: torch.Tensor      # [n+1] — descending from 1 to 0
    thresholds: torch.Tensor  # [n]


def precision_recall_curve(y_true, scores) -> PrCurve:
    """PR points over every cut (sklearn convention: recall descends to 0,
    final precision pinned to 1). Tied thresholds yield repeated points."""
    scores = _t(scores)
    order = torch.argsort(-scores, stable=True)
    y = _t(y_true).to(scores.device)[order].to(scores.dtype)
    tp = torch.cumsum(y, 0)
    k = torch.arange(1, y.shape[0] + 1, dtype=y.dtype, device=y.device)
    n_pos = tp[-1]
    one = torch.ones(1, dtype=y.dtype, device=y.device)
    precision = torch.cat([torch.flip(tp / k, [0]), one])
    recall = torch.cat([torch.flip(tp / n_pos, [0]), torch.zeros_like(one)])
    return PrCurve(precision=precision, recall=recall,
                   thresholds=torch.flip(scores[order], [0]))


def average_precision(y_true, scores) -> torch.Tensor:
    """AP = Σ (R_k − R_{k−1}) · P_k over descending thresholds (sklearn's
    definition; each tied row contributes its own step)."""
    pr = precision_recall_curve(y_true, scores)
    dr = pr.recall[:-1] - pr.recall[1:]
    return torch.sum(dr * pr.precision[:-1])


class ClassificationReport(NamedTuple):
    """Per-class tensors indexed [neg, pos] — the classification_report fields."""

    precision: torch.Tensor     # [2]
    recall: torch.Tensor        # [2]
    f1: torch.Tensor            # [2]
    support: torch.Tensor       # [2]
    accuracy: torch.Tensor      # []
    macro_avg: torch.Tensor     # [3] precision/recall/f1
    weighted_avg: torch.Tensor  # [3]


def classification_report(y_true, y_pred) -> ClassificationReport:
    """Binary classification_report (the reference's evaluation at threshold
    0.5, ``train_ensemble_public.py:63-64``) as float32 tensors."""
    yp = _t(y_pred).to(torch.float32)
    yt = _t(y_true).to(device=yp.device, dtype=torch.float32)
    out = []
    for cls in (0.0, 1.0):
        t = yt if cls == 1.0 else 1.0 - yt
        p = yp if cls == 1.0 else 1.0 - yp
        tp = torch.sum(t * p)
        prec = tp / torch.clamp_min(torch.sum(p), 1.0)
        rec = tp / torch.clamp_min(torch.sum(t), 1.0)
        f1 = torch.where(prec + rec > 0.0, 2.0 * prec * rec / (prec + rec), 0.0)
        out.append((prec, rec, f1, torch.sum(t)))
    precision = torch.stack([out[0][0], out[1][0]])
    recall = torch.stack([out[0][1], out[1][1]])
    f1 = torch.stack([out[0][2], out[1][2]])
    support = torch.stack([out[0][3], out[1][3]])
    acc = torch.mean((yt == yp).to(torch.float32))
    w = support / torch.sum(support)
    macro = torch.stack([torch.mean(precision), torch.mean(recall), torch.mean(f1)])
    weighted = torch.stack([torch.sum(w * precision), torch.sum(w * recall), torch.sum(w * f1)])
    return ClassificationReport(precision=precision, recall=recall, f1=f1, support=support,
                                accuracy=acc, macro_avg=macro, weighted_avg=weighted)


def wald_ci_halfwidth(p, n):
    """95% Wald band half-width ``1.96*sqrt(p*(1-p)/n)`` — the reference's
    CI formula (``train_ensemble_public.py:76,:84``)."""
    return 1.96 * torch.sqrt(_t(p) * (1.0 - _t(p)) / n)


def report_text(rep: ClassificationReport) -> str:
    """Host-side pretty printer mirroring sklearn's report layout."""
    rows = [f"{'':>12} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"]
    for i, name in enumerate(("0.0", "1.0")):
        rows.append(
            f"{name:>12} {float(rep.precision[i]):>9.2f} "
            f"{float(rep.recall[i]):>9.2f} {float(rep.f1[i]):>9.2f} "
            f"{int(rep.support[i]):>9d}"
        )
    n = int(torch.sum(rep.support))
    rows.append("")
    rows.append(f"{'accuracy':>12} {'':>9} {'':>9} {float(rep.accuracy):>9.2f} {n:>9d}")
    for name, avg in (("macro avg", rep.macro_avg), ("weighted avg", rep.weighted_avg)):
        rows.append(
            f"{name:>12} {float(avg[0]):>9.2f} {float(avg[1]):>9.2f} "
            f"{float(avg[2]):>9.2f} {n:>9d}"
        )
    return "\n".join(rows)

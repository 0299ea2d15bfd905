"""Host-side ROC / PR figures with 95% Wald CI bands.

Copy of the JAX package's ``utils/plots.py`` over the port's
``utils.metrics``. The reference plots ``metrics.plot_roc_curve`` and
``metrics.plot_precision_recall_curve`` and fills a hand-rolled 95% Wald
band ``1.96·sqrt(p(1−p)/n)`` around each curve
(``train_ensemble_public.py:67-88``). Curves and the band half-widths come
from ``utils.metrics``; matplotlib renders them with the non-interactive Agg
backend, so it works headless. matplotlib is imported inside the functions:
importing this module never needs it.
"""

from __future__ import annotations

import os

import numpy as np

from machine_learning_replications_tpu_torch.device import to_host
from machine_learning_replications_tpu_torch.utils import metrics


def _axes():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def roc_figure(
    y_true: np.ndarray,
    scores: np.ndarray,
    *,
    label: str = "ensemble",
    out_path: str | os.PathLike | None = None,
):
    """ROC curve + AUC in the legend + Wald CI band, reference style
    (``train_ensemble_public.py:67-77``). Returns the matplotlib figure;
    saves a PNG when ``out_path`` is given."""
    plt = _axes()
    curve = metrics.roc_curve(y_true, scores)
    auc = float(metrics.roc_auc(y_true, scores))
    fpr = to_host(curve.fpr)
    tpr = to_host(curve.tpr)
    half = to_host(metrics.wald_ci_halfwidth(curve.tpr, y_true.shape[0]))

    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(fpr, tpr, label=f"{label} (AUC = {auc:.2f})")
    ax.fill_between(
        fpr,
        np.clip(tpr - half, 0, 1),
        np.clip(tpr + half, 0, 1),
        alpha=0.25,
        linewidth=0,
    )
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8, color="grey")
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC (95% Wald CI band)")
    ax.legend(loc="lower right")
    if out_path is not None:
        fig.savefig(os.fspath(out_path), dpi=150, bbox_inches="tight")
    return fig


def pr_figure(
    y_true: np.ndarray,
    scores: np.ndarray,
    *,
    label: str = "ensemble",
    out_path: str | os.PathLike | None = None,
):
    """Precision-recall curve + AP + Wald CI band
    (``train_ensemble_public.py:79-88``)."""
    plt = _axes()
    curve = metrics.precision_recall_curve(y_true, scores)
    ap = float(metrics.average_precision(y_true, scores))
    rec = to_host(curve.recall)
    prec = to_host(curve.precision)
    half = to_host(metrics.wald_ci_halfwidth(curve.precision, y_true.shape[0]))

    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(rec, prec, label=f"{label} (AP = {ap:.2f})")
    ax.fill_between(
        rec,
        np.clip(prec - half, 0, 1),
        np.clip(prec + half, 0, 1),
        alpha=0.25,
        linewidth=0,
    )
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_title("Precision-Recall (95% Wald CI band)")
    ax.legend(loc="lower left")
    if out_path is not None:
        fig.savefig(os.fspath(out_path), dpi=150, bbox_inches="tight")
    return fig

"""Lasso-based feature selection.

Port of the JAX package's ``models/feature_selection.py``.
Reference: ``LassoCV(random_state=2020, cv=10)`` wrapped in
``SelectFromModel(threshold=-inf, max_features=17)``
(``train_ensemble_public.py:51-55``): the top-17 of 64 features by |lasso
coefficient| at the CV-chosen alpha. With ``cv=10`` an int, KFold does not
shuffle, so the procedure is deterministic.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import LassoSelectConfig
from machine_learning_replications_tpu_torch.device import resolve_device, to_host
from machine_learning_replications_tpu_torch.models import solvers


def _guard_rows(X, y, cfg: LassoSelectConfig, scale: int = 1):
    """Scaled-regime guard: cap the cohort at ``cfg.max_rows × scale`` rows
    (``scale`` = a mesh's data-axis size: the Gram passes shard over it), by
    policy (a seeded stratified subsample, seed 2020, or a refusal)."""
    n = X.shape[0]
    cap = cfg.max_rows * scale
    if n <= cap:
        return X, y, None
    if cfg.scale_policy == "error":
        raise ValueError(
            f"Lasso selection: {n} rows exceeds LassoSelectConfig.max_rows="
            f"{cfg.max_rows} × {scale} device(s); set scale_policy="
            "'subsample', raise max_rows, or pass a larger mesh"
        )
    from machine_learning_replications_tpu_torch.utils.cv import stratified_subsample_indices

    idx = stratified_subsample_indices(to_host(y), cap, seed=2020)
    return X[torch.as_tensor(idx, device=X.device)], y[torch.as_tensor(idx, device=y.device)], int(n)


def fit_select(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    cfg: LassoSelectConfig = LassoSelectConfig(),
    mesh=None,
    *,
    device=None,
) -> tuple[np.ndarray, dict[str, Any]]:
    """Returns ``(support_mask [F] bool, info)`` like ``sfm.get_support()``,
    the lasso path run on ``device`` (default: the card) in ``X``'s dtype;
    the mask and ``info`` are host values.

    With ``mesh``, the O(n) Gram passes run row-sharded over its 'data' axis
    (``parallel.select_trainer``); the CV path solve is row-free either way."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, device=dev).to(X.dtype)
    if mesh is not None:
        from machine_learning_replications_tpu_torch.parallel.mesh import DATA_AXIS
        from machine_learning_replications_tpu_torch.parallel.select_trainer import (
            lasso_fold_stats_sharded,
        )

        X, y, n_orig = _guard_rows(X, y, cfg, scale=mesh.shape[DATA_AXIS])
        stats = lasso_fold_stats_sharded(mesh, X, y, cfg.cv_folds)
        coef, intercept, alpha_, alphas, mse_path = solvers.lasso_cv_from_stats(
            stats, n_alphas=cfg.n_alphas, eps=cfg.eps, tol=cfg.tol, max_iter=cfg.max_iter)
    else:
        X, y, n_orig = _guard_rows(X, y, cfg)
        coef, intercept, alpha_, alphas, mse_path = solvers.lasso_cv(
            X, y, cv_folds=cfg.cv_folds, n_alphas=cfg.n_alphas, eps=cfg.eps,
            tol=cfg.tol, max_iter=cfg.max_iter,
        )
    mask = select_top_k(to_host(coef), cfg.max_features)
    info = {
        "coef": to_host(coef),
        "intercept": float(intercept),
        "alpha_": float(alpha_),
        "alphas": to_host(alphas),
        "mse_path": to_host(mse_path),
    }
    if n_orig is not None:
        info["subsampled_from_rows"] = n_orig
    return mask, info


def select_top_k(coef: np.ndarray, k: int) -> np.ndarray:
    """sklearn SelectFromModel(threshold=-inf, max_features=k): top-k by
    |coef|, numpy's stable argsort (ties → higher index wins, as in
    sklearn)."""
    scores = np.abs(coef)
    mask = np.zeros(scores.shape[0], dtype=bool)
    mask[np.argsort(scores, kind="stable")[-k:]] = True
    return mask

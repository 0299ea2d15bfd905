"""5-fold CV hyperparameter sweep over the GBDT grid (``bench.py`` config 4).

Port of the JAX package's ``models/sweep.py``. The sweep
exploits the boosting prefix property: a forest trained for M stages
contains the forest for every m ≤ M, so it fits one model per (max_depth,
fold) at ``max(n_estimators_grid)`` stages — all folds of a depth in one
``gbdt.fit_folds`` call — and scores every ``n_estimators`` grid point from
per-tree contribution cumsums over each fold's held-out rows. Fold
assignment is sklearn's ``StratifiedKFold(k, shuffle=False)``
(``utils.cv``), so fold AUCs compare with a ``GridSearchCV`` differential.
With ``mesh=`` each (depth, fold) fit and the refit run row-sharded through
``parallel.fit_gbdt_sharded``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig, SweepConfig
from machine_learning_replications_tpu_torch.device import resolve_device, to_host
from machine_learning_replications_tpu_torch.models import gbdt, tree
from machine_learning_replications_tpu_torch.ops import binning
from machine_learning_replications_tpu_torch.parallel.mesh import check_device
from machine_learning_replications_tpu_torch.utils.cv import stratified_kfold_test_masks
from machine_learning_replications_tpu_torch.utils.metrics import roc_auc_batch_host


def staged_proba1(
    params: tree.TreeEnsembleParams, X: torch.Tensor, stages: Any
) -> torch.Tensor:
    """P(class 1) after the first ``m`` boosting stages, for each m in
    ``stages`` → ``[len(stages), n]`` (sklearn ``staged_predict_proba``
    sampled at the grid points, in one pass)."""
    contrib = tree.apply(params, X)                      # [T, n]
    cum = torch.cumsum(contrib, dim=0)
    idx = torch.as_tensor(np.asarray(stages, dtype=np.int64) - 1, device=cum.device)
    raw = params.init_raw + params.learning_rate * cum[idx]
    return torch.sigmoid(raw)


def one_fold(params: tree.TreeEnsembleParams, kk: int) -> tree.TreeEnsembleParams:
    """Fold ``kk`` of ``gbdt.fit_folds``' batched params."""
    return dataclasses.replace(
        params, **{f.name: getattr(params, f.name)[kk]
                   for f in dataclasses.fields(params) if f.name != "max_depth"})


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Grid AUCs and the selected cell.

    ``fold_auc[d, e, k]`` = holdout AUC of depth ``max_depth_grid[d]`` with
    ``n_estimators_grid[e]`` stages on fold ``k``; ``mean_auc`` averages over
    folds; best cell = argmax of ``mean_auc`` (ties → first in grid order,
    like ``GridSearchCV``).
    """

    n_estimators_grid: tuple[int, ...]
    max_depth_grid: tuple[int, ...]
    fold_auc: np.ndarray   # [n_depths, n_estimators, k]
    mean_auc: np.ndarray   # [n_depths, n_estimators]
    best_n_estimators: int
    best_max_depth: int
    best_mean_auc: float


def cv_sweep(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    sweep: SweepConfig = SweepConfig(),
    base: GBDTConfig = GBDTConfig(),
    mesh=None,
    *,
    device=None,
) -> SweepResult:
    """Run the grid on ``device``: one ``gbdt.fit_folds`` per depth covering
    all folds, then staged evaluation over the ``n_estimators`` axis on each
    fold's held-out rows, AUCs on the host.

    Every depth's fit is queued before any score is fetched, so the card
    works through the fits back to back. In the default shared-bins
    protocol the candidate bins are derived once and reused across depths
    (the bin budget is depth-independent); ``base.per_fold_binning`` derives
    per-fold candidates inside each ``fit_folds`` call.

    With ``mesh`` (on ``device``), each (depth, fold) fit runs row-sharded
    through ``parallel.fit_gbdt_sharded`` (the fold masks ride the
    trainers' weight path) and each fold's held-out rows are scored
    row-sharded (``parallel.rowwise``); the mesh path takes the shared-bins
    protocol only, as in JAX.
    """
    dev = resolve_device(device)
    check_device(mesh, dev)
    if mesh is not None:
        if base.per_fold_binning:
            raise ValueError(
                "cv_sweep(mesh=...) runs the shared-bins protocol only; "
                "per_fold_binning is a single-device option (fit_folds)"
            )
    X = to_host(X)
    y = to_host(y)
    est_grid = tuple(sweep.n_estimators_grid)
    depth_grid = tuple(sweep.max_depth_grid)
    m_max = max(est_grid)
    k = sweep.cv_folds
    test_masks = stratified_kfold_test_masks(y, k)
    train_masks = 1.0 - test_masks

    bins = None
    if not base.per_fold_binning:
        bins = binning.bin_features(X, gbdt.bin_budget_capped(base))

    # Per depth, the k fold fits: one batched fit_folds, or k sharded fits.
    params_by_depth = []
    for depth in depth_grid:
        cfg = dataclasses.replace(base, n_estimators=m_max, max_depth=depth)
        if mesh is None:
            params_by_depth.append(gbdt.fit_folds(X, y, train_masks, cfg, bins=bins, device=dev))
        else:
            from machine_learning_replications_tpu_torch.parallel import fit_gbdt_sharded

            params_by_depth.append([
                fit_gbdt_sharded(mesh, X, y, cfg, sample_weight=train_masks[kk], bins=bins)[0]
                for kk in range(k)])

    # Score each fold's HELD-OUT rows only.
    te_idx = [np.flatnonzero(tm > 0.5) for tm in test_masks]
    Xd = torch.as_tensor(X, device=dev)
    fold_auc = np.zeros((len(depth_grid), len(est_grid), k))
    for di, params in enumerate(params_by_depth):
        for kk in range(k):
            if mesh is None:
                rows = torch.as_tensor(te_idx[kk], device=dev)
                probs = staged_proba1(one_fold(params, kk), Xd[rows], est_grid)  # [E, n_te]
            else:
                from machine_learning_replications_tpu_torch.parallel.rowwise import (
                    apply_rows_sharded,
                )

                probs = apply_rows_sharded(
                    mesh, lambda p, x: staged_proba1(p, x, est_grid).T, params[kk],
                    X[te_idx[kk]]).T
            fold_auc[di, :, kk] = roc_auc_batch_host(y[te_idx[kk]], to_host(probs))

    mean_auc = fold_auc.mean(axis=-1)
    di, ei = np.unravel_index(np.argmax(mean_auc), mean_auc.shape)
    return SweepResult(
        n_estimators_grid=est_grid,
        max_depth_grid=depth_grid,
        fold_auc=fold_auc,
        mean_auc=mean_auc,
        best_n_estimators=est_grid[ei],
        best_max_depth=depth_grid[di],
        best_mean_auc=float(mean_auc[di, ei]),
    )


def refit_best(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    result: SweepResult,
    base: GBDTConfig = GBDTConfig(),
    mesh=None,
    *,
    device=None,
) -> tuple[tree.TreeEnsembleParams, GBDTConfig]:
    """Refit the winning cell on the full data (``GridSearchCV(refit=True)``)
    through ``gbdt.fit``, every depth and splitter included: a depth-1
    winner under the default 'exact' splitter refits on the stump kernel
    with every unique-value midpoint as a candidate. With ``mesh`` the refit
    runs row-sharded (``parallel.fit_gbdt_sharded``): a sweep that needed
    the mesh does not funnel its refit through one device; the mesh must be
    on ``device``."""
    dev = resolve_device(device)
    check_device(mesh, dev)
    cfg = dataclasses.replace(
        base,
        n_estimators=result.best_n_estimators,
        max_depth=result.best_max_depth,
    )
    if mesh is not None:
        from machine_learning_replications_tpu_torch.parallel import fit_gbdt_sharded

        params, _ = fit_gbdt_sharded(mesh, to_host(X), to_host(y), cfg)
    else:
        params, _ = gbdt.fit(X, y, cfg, device=dev)
    return params, cfg

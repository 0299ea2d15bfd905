"""The reference program end to end: training and full-pipeline inference.

Port of the JAX package's ``models/pipeline.py``.

Fit (``fit_pipeline``, ``train_ensemble_public.py``'s ``__main__``): KNN-impute
→ LassoCV-select 17 of 64 → fit the stacking ensemble → the quality reference
profile, as stages that a ``persist.checkpoint.StageCheckpointer`` can make
resumable. ``fit_stacking`` replicates ``StackingClassifier.fit``: each base
member is fitted once on all rows (the predict-time members), and 5-fold
stratified ``cross_val_predict`` gives the out-of-fold P(class 1)
meta-features the final LR is fitted on. Fold membership is a ``[k, n]``
mask, never a row subset, so each member's k fold fits run at once: the
SVC's as lanes of batched dual solves (``svm.svc_fit_masked``), the GBDT's as
one grower with a fold axis (``gbdt.fit_folds``: one node-kernel launch per
tree level for all folds), the L1-LR's as lanes of one FISTA.
``cross_val_member_probas_loop`` keeps the per-fold-subset construction as
the differential oracle.

Predict: a raw 64-variable row (NaNs allowed) is KNN-imputed, cut to the
model's own lasso-selected columns and scored by the stacked ensemble. A
contract row (``predict_hf.py:5-27``: the 17 variables in contract order) is
first embedded at its schema positions in a NaN row, so the imputer fills
the 47 columns the contract does not carry — the ``cli predict --model``
route.

Mesh paths (``mesh=``, a ``parallel.make_mesh`` of this rank's process
group, on the same device as ``device``): the imputer's transform and the
stacked probability pass run row-sharded (``parallel.rowwise``), LassoCV's
statistics row-sharded (``parallel.select_trainer``), and the GBDT member
and its fold fits through ``parallel.fit_gbdt_sharded``; the SVC and L1-LR
members run replicated on every rank, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import ExperimentConfig, SVCConfig
from machine_learning_replications_tpu_torch.data.schema import selected_indices, variable_names
from machine_learning_replications_tpu_torch.device import (
    float_dtype,
    resolve_device,
    to_host,
)
from machine_learning_replications_tpu_torch.models import (
    feature_selection,
    gbdt,
    knn_impute,
    scaler,
    solvers,
    stacking,
    svm,
    tree,
)
from machine_learning_replications_tpu_torch.parallel.mesh import check_device
from machine_learning_replications_tpu_torch.utils.cv import (
    stratified_kfold_test_masks,
    stratified_kfold_test_masks_within,
    stratified_subsample_indices,
)


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """Everything needed to go from a raw 64-variable row to a probability.

    ``quality`` is the model's training-time reference profile (a dict of
    tensors, or None), carried through unchanged and unused by inference."""

    imputer: knn_impute.KNNImputerParams
    support_mask: torch.Tensor  # [64] bool — lasso-selected columns
    ensemble: stacking.StackingParams
    quality: Any = None


def contract_rows_to_x64(params: PipelineParams, X17: np.ndarray) -> np.ndarray:
    """Contract-order 17-variable rows → float64 full-width rows with the 17
    at their schema positions and NaN elsewhere, ready for
    ``pipeline_predict_proba1``. A full-pipeline checkpoint selects its own
    lasso top-k columns (ascending index order), not the contract order."""
    X17 = np.asarray(X17, np.float64)
    if X17.ndim == 1:
        X17 = X17[None, :]
    width = int(params.support_mask.shape[0])
    x64 = np.full((X17.shape[0], width), np.nan)
    x64[:, selected_indices()] = X17
    return x64


def resolve_contract_block_fn(params: PipelineParams) -> knn_impute.ImputeBlock:
    """The imputer's block for contract-shaped queries (17 finite variables
    at their schema positions, every other column NaN), resolved once:
    contract rows are all finite by validation, so the pattern is fixed."""
    from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT

    return knn_impute.resolve_block_fn(
        params.imputer, contract_rows_to_x64(params, np.zeros((1, len(EXAMPLE_PATIENT)))))


def support_feature_names(params: PipelineParams) -> list[str]:
    """Schema names of the model's own selected columns, in support-mask
    (ascending schema) order — the space ``impute_select`` emits."""
    names = variable_names()
    return [names[i] for i in np.flatnonzero(to_host(params.support_mask))]


def support_columns(params: PipelineParams) -> torch.Tensor:
    """The support mask's column indices, as an index tensor on the
    imputer's device (one fetch of the mask). Callers that select many
    times resolve it once and pass it to ``impute_select`` as ``cols``."""
    return torch.as_tensor(np.flatnonzero(to_host(params.support_mask)),
                           device=params.imputer.donors.device)


def impute_select(
    params: PipelineParams, X64: "np.ndarray | torch.Tensor",
    block_fn: "knn_impute.ImputeBlock | None" = None,
    cols: "torch.Tensor | None" = None,
    mesh=None,
) -> torch.Tensor:
    """KNN-impute raw 64-wide rows and keep the support columns → the
    ensemble's ``[n, n_selected]`` input, on the imputer's device.
    ``block_fn`` is a pre-resolved imputer block for callers with a fixed
    query NaN pattern (``resolve_contract_block_fn``); ``cols`` the
    pre-resolved ``support_columns`` (else the mask is fetched per call);
    ``mesh`` shards the imputation's rows."""
    X_imp = knn_impute.transform(params.imputer, X64, block_fn=block_fn, mesh=mesh)
    if cols is None:
        cols = support_columns(params)
    return X_imp.index_select(1, cols.to(X_imp.device))


def _check_device(params: PipelineParams, device, mesh=None) -> None:
    dev = resolve_device(device)
    check_device(mesh, dev)
    for name, t in (("imputer", params.imputer.donors), ("ensemble", params.ensemble.meta.coef)):
        if t.device != dev:
            raise ValueError(
                f"the {name} parameters lie on {t.device}, requested device is {dev}: "
                f"convert them with convert.params_to(params, {str(dev)!r})"
            )


def pipeline_predict_proba1_contract(
    params: PipelineParams, X17: np.ndarray, chunk_rows: int | None = None, *, mesh=None,
    device=None,
) -> torch.Tensor:
    """Contract-order 17-variable rows → stacked P(class 1) through the full
    pipeline (the ``cli predict --model`` route)."""
    return pipeline_predict_proba1(params, contract_rows_to_x64(params, X17),
                                   chunk_rows, mesh=mesh, device=device)


def pipeline_predict_proba1(
    params: PipelineParams, X64: "np.ndarray | torch.Tensor", chunk_rows: int | None = None,
    *, mesh=None, device=None,
) -> torch.Tensor:
    """Raw 64-variable rows (NaNs allowed) → stacked P(class 1), on
    ``device`` (default: the card), where the parameters must lie.
    ``chunk_rows`` bounds the rows per stacked pass (default
    ``SVCConfig.predict_chunk_rows``): the SVC member builds an
    ``[rows, n_support]`` kernel block. With ``mesh`` the imputation and
    the stacked pass run row-sharded and every rank gets every row."""
    _check_device(params, device, mesh)
    X17 = impute_select(params, X64, mesh=mesh)
    return _stacked_proba1_bounded(params.ensemble, X17, chunk_rows, mesh)


def _stacked_proba1_bounded(
    ens: stacking.StackingParams, X17: torch.Tensor, chunk_rows: int | None, mesh=None,
) -> torch.Tensor:
    """The memory-bounded stacked-probability tail: ``stacking.predict_proba1``
    over blocks of ``chunk_rows`` rows (default
    ``SVCConfig().predict_chunk_rows``), concatenated on the device; with a
    mesh, row-sharded over its 'data' axis in blocks of that size. The rows
    are cast to the ensemble's dtype first, so a float64 imputer can feed a
    float32 ensemble."""
    if chunk_rows is None:
        chunk_rows = SVCConfig().predict_chunk_rows
    X17 = X17.to(ens.meta.coef.dtype)
    if mesh is not None:
        from machine_learning_replications_tpu_torch.parallel.rowwise import apply_rows_sharded

        return apply_rows_sharded(
            mesh, lambda p, x: stacking.predict_proba1(p, x, device=x.device), ens, X17,
            chunk_rows=chunk_rows)
    n = int(X17.shape[0])
    if n > chunk_rows:
        return torch.cat([stacking.predict_proba1(ens, X17[s:s + chunk_rows], device=X17.device)
                          for s in range(0, n, chunk_rows)])
    return stacking.predict_proba1(ens, X17, device=X17.device)


# ---------------------------------------------------------------------------
# Fit
# ---------------------------------------------------------------------------


# Memory budget for running the SVC fold fits as lanes of one batched solve:
# each fold holds its own [m, m] kernel AND dual matrix, so k folds cost
# ~2·k·m²·itemsize at once (the JAX package's budget for its vmapped
# branch). At SVCConfig.max_rows=8192 and k=5 in float32 that is ~2.7 GB,
# above the budget: the scaled regime fits the folds one after another. Both
# branches give the same numbers.
_SVC_VMAP_BYTES_BUDGET = 2 << 30


def _fold(tree_: Any, j: int) -> Any:
    """Fold ``j`` of a tree whose tensors carry a leading fold axis."""
    if dataclasses.is_dataclass(tree_):
        return dataclasses.replace(tree_, **{f.name: _fold(getattr(tree_, f.name), j)
                                             for f in dataclasses.fields(tree_)})
    if isinstance(tree_, tuple):
        return tuple(_fold(t, j) for t in tree_)
    return tree_[j] if isinstance(tree_, torch.Tensor) else tree_


def _svc_fold_map(one_fold, args: tuple, m: int, k: int, itemsize: int) -> list:
    """The k folds' results, one per fold: one batched call over the leading
    fold axis of ``args`` when all k kernel and dual matrices fit the
    budget, else one call per fold — identical math either way."""
    if 2 * k * m * m * itemsize <= _SVC_VMAP_BYTES_BUDGET:
        out = one_fold(*args)
        return [_fold(out, j) for j in range(k)]
    return [one_fold(*(a[j] for a in args)) for j in range(k)]


def _fit_fingerprint(X64, y, cfg: ExperimentConfig) -> str:
    """Cheap input digest binding a stage-checkpoint dir to (X, y, cfg):
    shapes/dtypes, the config JSON and a deterministic 4096-row stride
    sample of X and y (the JAX package's digest)."""
    import hashlib

    X64 = to_host(X64)
    y = to_host(y)
    h = hashlib.sha256()
    h.update(repr((X64.shape, str(X64.dtype), y.shape, str(y.dtype))).encode())
    h.update(cfg.to_json().encode())
    step = max(1, X64.shape[0] // 4096)
    h.update(np.ascontiguousarray(X64[::step]).tobytes())
    h.update(np.ascontiguousarray(y[::step]).tobytes())
    return h.hexdigest()


def _run_array_stage(stages, name: str, compute):
    """``stages.run`` for a stage whose output is one tensor, kept under one
    key so every stage output is a tree."""
    return stages.run(name, lambda: {"oof": compute()})["oof"]


def _make_stages(device, checkpoint_dir=None, _interrupt_after=None, fingerprint=None,
                 timings=None, mesh=None):
    """The stage runner: checkpointed under ``checkpoint_dir`` (shared by
    ``mesh``'s ranks, rank 0 writing), or straight through when it is None."""
    from machine_learning_replications_tpu_torch.persist.checkpoint import StageCheckpointer

    return StageCheckpointer(checkpoint_dir, device=device, _interrupt_after=_interrupt_after,
                             fingerprint=fingerprint, timings=timings, mesh=mesh)


def _svc_kwargs(cfg: ExperimentConfig) -> dict:
    return dict(C=cfg.svc.C, gamma=None if cfg.svc.gamma == "scale" else cfg.svc.gamma,
                balanced=cfg.svc.class_weight == "balanced", tol=cfg.svc.tol,
                max_iter=cfg.svc.max_iter)


def _lg_kwargs(cfg: ExperimentConfig) -> dict:
    return dict(C=cfg.logreg.C, balanced=cfg.logreg.class_weight == "balanced",
                tol=cfg.logreg.tol, max_iter=cfg.logreg.max_iter)


def fit_stacking(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    cfg: ExperimentConfig = ExperimentConfig(),
    stages=None,
    *,
    mesh=None,
    device=None,
    svc_iterations: "dict | None" = None,
) -> stacking.StackingParams:
    """Fit the stacking ensemble on (already imputed + selected) ``X[n, 17]``
    on ``device`` (default: the card), in ``X``'s float dtype.

    Above ``cfg.svc.max_rows`` rows the SVC member (an O(n²) kernel matrix)
    follows ``cfg.svc.scale_policy``: a stratified subsample of ``max_rows``
    rows (seed ``cfg.seed``), or a refusal. The GBDT and LR members train on
    every row. ``stages`` (a ``StageCheckpointer`` or None) makes each member
    fit and the meta pass a stage. ``svc_iterations`` (a dict), when given,
    receives the dual solves' steps per lane under "member_svc" and
    "meta_svc_oof". With ``mesh`` the GBDT member and its fold fits train
    row-sharded (``parallel.fit_gbdt_sharded``)."""
    dev = resolve_device(device)
    check_device(mesh, dev)
    if stages is None:
        stages = _make_stages(dev)
    Xj = torch.as_tensor(X, device=dev)
    Xj = Xj.to(float_dtype(Xj))
    y_np = to_host(y)
    yj = torch.as_tensor(y_np, device=dev).to(Xj.dtype)
    iters = {} if svc_iterations is None else svc_iterations

    def _fit_svc():
        svc_rows = _svc_fit_rows(y_np, cfg, fold=None)
        if svc_rows is None:
            Xsvc, ysvc = Xj, yj
        else:
            rows = torch.as_tensor(svc_rows, device=dev)
            Xsvc, ysvc = Xj[rows], yj[rows]
        scaler_p = scaler.fit(Xsvc)
        svc_p = svm.svc_fit(scaler.transform(scaler_p, Xsvc), ysvc,
                            probability=cfg.svc.probability, platt_cv=cfg.svc.platt_cv,
                            iterations=iters.setdefault("member_svc", []), **_svc_kwargs(cfg))
        return scaler_p, svc_p

    def _fit_gbdt():
        # At scale the exact splitter's candidate set is unbounded (≈ n per
        # continuous column): the member switches to the capped 'hist'
        # protocol there, at the JAX package's row counts.
        X_np = to_host(Xj)
        gcfg = gbdt.scaled_member_cfg(cfg.gbdt, X_np.shape[0], X_np.shape[1])
        if mesh is not None:
            from machine_learning_replications_tpu_torch.parallel import fit_gbdt_sharded

            return fit_gbdt_sharded(mesh, X_np, y_np, gcfg)[0]
        return gbdt.fit(X_np, y_np, gcfg, device=dev)[0]

    scaler_p, svc_p = stages.run("member_svc", _fit_svc)
    gbdt_p = stages.run("member_gbdt", _fit_gbdt)
    lg_p = stages.run("member_lg", lambda: solvers.logreg_l1_fit(Xj, yj, **_lg_kwargs(cfg)))

    def _fit_meta():
        # The CV pass checkpoints each member's out-of-fold column itself;
        # this outer stage holds only the meta-LR Newton fit.
        meta_X = cross_val_member_probas(Xj, y_np, cfg, stages=stages, mesh=mesh, device=dev,
                                         svc_iterations=iters)
        return solvers.logreg_l2_fit(meta_X, yj, C=cfg.meta.C, tol=cfg.meta.tol,
                                     max_iter=cfg.meta.max_iter)

    meta_p = stages.run("meta", _fit_meta)
    return stacking.StackingParams(scaler=scaler_p, svc=svc_p, gbdt=gbdt_p, logreg=lg_p,
                                   meta=meta_p)


def _svc_fit_rows(y: np.ndarray, cfg: ExperimentConfig, fold: int | None) -> np.ndarray | None:
    """Scaled-regime guard for the SVC member: None (all rows fit), sorted
    subsample indices (seed ``cfg.seed`` for the full fit, ``cfg.seed + 1 +
    fold`` for a fold), or a refusal per ``cfg.svc.scale_policy``."""
    n = np.asarray(y).shape[0]
    if n <= cfg.svc.max_rows:
        return None
    if cfg.svc.scale_policy == "error":
        raise RuntimeError(
            f"SVC member: {n} rows exceeds SVCConfig.max_rows="
            f"{cfg.svc.max_rows} (the RBF kernel matrix is O(n²)); set "
            "scale_policy='subsample' (stratified subsample, default), "
            "raise max_rows, or drop the SVC member"
        )
    if cfg.svc.scale_policy != "subsample":
        raise ValueError(
            f"unknown SVCConfig.scale_policy {cfg.svc.scale_policy!r}; "
            "expected 'subsample' or 'error'"
        )
    seed = cfg.seed if fold is None else cfg.seed + 1 + fold
    return stratified_subsample_indices(y, cfg.svc.max_rows, seed=seed)


def cross_val_member_probas(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    cfg: ExperimentConfig,
    stages=None,
    *,
    mesh=None,
    device=None,
    svc_iterations: "dict | None" = None,
) -> torch.Tensor:
    """Out-of-fold P(class 1) per member — the ``[n, 3]`` meta-feature matrix
    (``cross_val_predict(est, X, y, cv=5, method='predict_proba')`` per
    member, first column dropped), on ``device``.

    Fold membership is a ``[k, n]`` mask: the SVC fold fit zeroes excluded
    rows' box constraints (``C_i = 0`` ⇒ α_i = 0) after refitting the scaler
    on the fold's rows, the GBDT fold fit parks them at node −1 with zero
    gradient, and the L1-LR fold fit zeroes their loss weight. ``stages``
    makes each member's out-of-fold column its own stage.

    With ``mesh`` the GBDT fold fits run one after another as weight-masked
    sharded fits (``parallel.fit_gbdt_sharded``), on the bins ``fit_folds``
    would use (device quantiles only in the scaled 'hist' regime; each
    fold's own bins under ``per_fold_binning``)."""
    dev = resolve_device(device)
    check_device(mesh, dev)
    if stages is None:
        stages = _make_stages(dev)
    Xj = torch.as_tensor(X, device=dev)
    Xj = Xj.to(float_dtype(Xj))
    y_np = to_host(y)
    yj = torch.as_tensor(y_np, device=dev).to(Xj.dtype)
    dtype = Xj.dtype
    n = Xj.shape[0]
    k = cfg.stacking.cv_folds
    test_np = stratified_kfold_test_masks(y_np, k)
    train_np = 1.0 - test_np
    if n > cfg.svc.max_rows:
        _svc_fit_rows(y_np, cfg, fold=0)  # policy check (may raise)
    test = torch.as_tensor(test_np, dtype=dtype, device=dev)
    train = torch.as_tensor(train_np, dtype=dtype, device=dev)
    iters = ({} if svc_iterations is None else svc_iterations).setdefault("meta_svc_oof", [])

    # --- SVC pipeline: fold scaler refit + masked dual + nested Platt CV ---
    # (sklearn clones the whole Pipeline per fold, so the scaler refits on
    # the fold's train rows; the nested Platt folds stratify within them.)
    if n > cfg.svc.max_rows:
        def _svc_oof_fn():
            return torch.as_tensor(
                _svc_oof_subsampled(Xj, y_np, test_np, train_np, cfg, iters),
                dtype=dtype, device=dev)
    else:
        def _svc_oof_fn():
            platt = torch.as_tensor(np.stack([
                stratified_kfold_test_masks_within(y_np, cfg.svc.platt_cv, tm)
                for tm in train_np]), dtype=dtype, device=dev)  # [k, platt_cv, n]

            def one_fold(tm, pm):
                Xt = scaler.transform(scaler.fit(Xj, sample_weight=tm), Xj)
                return Xt, svm.svc_fit_masked(Xt, yj, tm, pm, iterations=iters,
                                              **_svc_kwargs(cfg))

            folds = _svc_fold_map(one_fold, (train, platt), m=n, k=k,
                                  itemsize=Xj.element_size())
            p_svc = torch.stack([svm.predict_proba1(vp, Xt) for Xt, vp in folds])  # [k, n]
            return torch.sum(p_svc * test, dim=0)

    svc_oof = _run_array_stage(stages, "meta_svc_oof", _svc_oof_fn)

    # --- GBDT: mask-parked fold fits, one grower for all k folds ---------
    def _gbdt_oof_mesh():
        from machine_learning_replications_tpu_torch.parallel import fit_gbdt_sharded

        X_np = to_host(Xj)
        if cfg.gbdt.per_fold_binning:
            bins = [gbdt.fold_bins(X_np, tm, cfg.gbdt) for tm in train_np]
        else:
            bins = [gbdt.default_bins(Xj, cfg.gbdt, dev, capped=True)] * k
        probas = [tree.predict_proba1(fit_gbdt_sharded(
            mesh, X_np, y_np, cfg.gbdt, bins=bins[j], sample_weight=train_np[j])[0], Xj)
            for j in range(k)]
        return torch.sum(torch.stack(probas) * test, dim=0)

    def _gbdt_oof():
        from machine_learning_replications_tpu_torch.models.sweep import one_fold

        if mesh is not None:
            return _gbdt_oof_mesh()
        gp = gbdt.fit_folds(to_host(Xj), y_np, train_np, cfg.gbdt, device=dev)
        p_gbdt = torch.stack([tree.predict_proba1(one_fold(gp, j), Xj) for j in range(k)])
        return torch.sum(p_gbdt * test, dim=0)

    gbdt_oof = _run_array_stage(stages, "meta_gbdt_oof", _gbdt_oof)

    # --- L1 logistic regression: masked FISTA, the folds as lanes ---------
    def _lg_oof():
        lp = solvers.logreg_l1_fit(Xj, yj, sample_mask=train, **_lg_kwargs(cfg))
        p_lg = torch.sigmoid(lp.coef @ Xj.T + lp.intercept[:, None])       # [k, n]
        return torch.sum(p_lg * test, dim=0)

    lg_oof = _run_array_stage(stages, "meta_lg_oof", _lg_oof)
    return torch.stack([svc_oof, gbdt_oof, lg_oof], dim=1)


def _svc_oof_subsampled(
    Xj: torch.Tensor,
    y: np.ndarray,
    test_masks_np: np.ndarray,
    train_masks_np: np.ndarray,
    cfg: ExperimentConfig,
    iterations: "list | None" = None,
) -> np.ndarray:
    """Out-of-fold SVC probabilities in the scaled regime: each fold fits on
    a stratified ``max_rows`` subset of its train rows (seed ``cfg.seed + 1
    + fold``; all folds share one shape), and its test rows are scored in
    ``predict_chunk_rows`` chunks against the fold's support set."""
    dev, dtype = Xj.device, Xj.dtype
    k = len(test_masks_np)
    m = cfg.svc.max_rows
    idxs = np.stack([
        stratified_subsample_indices(y, m, rows=np.where(train_masks_np[j] > 0.5)[0],
                                     seed=cfg.seed + 1 + j)
        for j in range(k)
    ])  # [k, m]
    Xsub = Xj[torch.as_tensor(idxs, device=dev)]            # [k, m, F]
    ysub = torch.as_tensor(y[idxs], device=dev).to(dtype)
    platt = torch.as_tensor(np.stack([
        stratified_kfold_test_masks(y[idxs[j]], cfg.svc.platt_cv) for j in range(k)
    ]), dtype=dtype, device=dev)  # [k, platt_cv, m]
    full = torch.ones((k, m), dtype=dtype, device=dev)

    def one_fold(Xs, ys, fm, pm):
        sp = scaler.fit(Xs)
        return sp, svm.svc_fit_masked(scaler.transform(sp, Xs), ys, fm, pm,
                                      iterations=iterations, **_svc_kwargs(cfg))

    folds = _svc_fold_map(one_fold, (Xsub, ysub, full, platt), m=m, k=k,
                          itemsize=Xj.element_size())
    oof = np.zeros(y.shape[0])
    for j, (spj, vpj) in enumerate(folds):  # k is 5; the chunked predict dominates
        te = test_masks_np[j] > 0.5
        Xte = scaler.transform(spj, Xj[torch.as_tensor(np.flatnonzero(te), device=dev)])
        oof[te] = svm.predict_proba1_chunked(vpj, Xte, cfg.svc.predict_chunk_rows)
    return oof


def cross_val_member_probas_loop(
    X: "np.ndarray | torch.Tensor", y: "np.ndarray | torch.Tensor", cfg: ExperimentConfig,
    *, device=None,
) -> np.ndarray:
    """The same meta-features built one fold at a time on physical row
    subsets — the reference's structure, kept as the differential oracle for
    the masked path. Returns host numpy ``[n, 3]``."""
    dev = resolve_device(device)
    X = to_host(X)
    y = to_host(y)
    n = X.shape[0]
    meta = np.zeros((n, 3))
    for tm in stratified_kfold_test_masks(y, cfg.stacking.cv_folds):
        tr = tm < 0.5
        te = ~tr
        Xtr = torch.as_tensor(X[tr], device=dev)
        ytr = torch.as_tensor(y[tr], device=dev).to(Xtr.dtype)
        Xte = torch.as_tensor(X[te], device=dev)
        # svc pipeline (scaler refit per fold, as sklearn clones the Pipeline)
        sp = scaler.fit(Xtr)
        vp = svm.svc_fit(scaler.transform(sp, Xtr), ytr, probability=True,
                         platt_cv=cfg.svc.platt_cv, **_svc_kwargs(cfg))
        meta[te, 0] = to_host(svm.predict_proba1(vp, scaler.transform(sp, Xte)))
        gp, _ = gbdt.fit(X[tr], y[tr], cfg.gbdt, device=dev)
        meta[te, 1] = to_host(tree.predict_proba1(gp, Xte))
        lp = solvers.logreg_l1_fit(Xtr, ytr, **_lg_kwargs(cfg))
        meta[te, 2] = to_host(torch.sigmoid(Xte @ lp.coef + lp.intercept))
    return meta


def fit_pipeline(
    X64: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    cfg: ExperimentConfig = ExperimentConfig(),
    checkpoint_dir: str | None = None,
    _interrupt_after: str | None = None,
    *,
    mesh=None,
    device=None,
) -> tuple[PipelineParams, dict[str, Any]]:
    """The full reference program: impute → select → stack → quality profile,
    on ``device`` (default: the card), in ``X64``'s float dtype.

    ``X64`` is the raw 64-variable cohort (NaNs allowed); it is copied first,
    never written. Returns the fitted params and diagnostics: the selection
    (``"selection"``, ``"n_selected"``), each stage's seconds
    (``"stage_seconds"``) and the SVC dual solves' steps per lane
    (``"svc_iterations"``).

    ``checkpoint_dir`` makes every stage resumable (impute → select →
    member_svc → member_gbdt → member_lg → meta_svc_oof → meta_gbdt_oof →
    meta_lg_oof → meta → quality_profile), each published durably on
    completion; a run re-entered with the same inputs restores finished
    stages. ``_interrupt_after`` is the test hook that simulates preemption
    right after a named stage is durable. With ``mesh`` every rank passes
    the same ``checkpoint_dir`` and rank 0 alone writes it.

    ``mesh`` routes the row-parallel stages through the mesh: the imputer's
    transform, LassoCV's statistics, the GBDT member and its fold fits, and
    the profile's scoring pass. Every rank of the mesh runs this call on the
    same inputs and returns the same model."""
    dev = resolve_device(device)
    check_device(mesh, dev)
    X64 = np.array(to_host(X64), copy=True)
    y = to_host(y)
    timings: dict[str, float] = {}
    iters: dict[str, list] = {}
    stages = _make_stages(
        dev, checkpoint_dir, _interrupt_after,
        _fit_fingerprint(X64, y, cfg) if checkpoint_dir is not None else None, timings, mesh)

    imp_p, X_imp = stages.run(
        "impute", lambda: knn_impute.fit_transform(X64, cfg.imputer, cfg.seed, y=y, mesh=mesh,
                                                  device=dev))

    def _select():
        mask, info = feature_selection.fit_select(X_imp, y, cfg.select, mesh, device=dev)
        # a tuple of tensors and statics; -1 = no subsampling happened
        return (torch.as_tensor(mask, device=dev), torch.as_tensor(info["coef"], device=dev),
                info["intercept"], info["alpha_"], torch.as_tensor(info["alphas"], device=dev),
                torch.as_tensor(info["mse_path"], device=dev),
                info.get("subsampled_from_rows", -1))

    sel = stages.run("select", _select)
    mask = to_host(sel[0])
    info = {"coef": to_host(sel[1]), "intercept": float(sel[2]), "alpha_": float(sel[3]),
            "alphas": to_host(sel[4]), "mse_path": to_host(sel[5])}
    if int(sel[6]) >= 0:
        info["subsampled_from_rows"] = int(sel[6])
    X17 = X_imp.index_select(1, torch.as_tensor(np.flatnonzero(mask), device=dev))
    ens = fit_stacking(X17, y, cfg, stages=stages, mesh=mesh, device=dev, svc_iterations=iters)

    def _quality_profile():
        # The drift baseline: the same post-impute post-select matrix the
        # members trained on, and the fitted ensemble's training scores.
        from machine_learning_replications_tpu_torch.obs import quality

        scores = _ensemble_scores(ens, X17, chunk_rows=cfg.svc.predict_chunk_rows, mesh=mesh)
        prof = quality.build_reference_profile(to_host(X17), scores, y=y)
        return {k: torch.as_tensor(v, device=dev) for k, v in prof.items()}

    qual = stages.run("quality_profile", _quality_profile)
    params = PipelineParams(imputer=imp_p, support_mask=torch.as_tensor(mask, device=dev),
                            ensemble=ens, quality=qual)
    return params, {"selection": info, "n_selected": int(mask.sum()),
                    "stage_seconds": timings, "svc_iterations": iters}


def _ensemble_scores(ens: stacking.StackingParams, X17: torch.Tensor,
                     chunk_rows: int | None = None, mesh=None) -> np.ndarray:
    """Training scores for the reference profile: the stacked P(class 1)
    over imputed-and-selected rows, through the same bounded scoring tail as
    batch inference."""
    return to_host(_stacked_proba1_bounded(ens, X17, chunk_rows, mesh))

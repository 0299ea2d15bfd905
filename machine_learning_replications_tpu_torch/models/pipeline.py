"""Full-pipeline inference — the predict half of the reference program.

Port of the predict half of the JAX package's ``models/pipeline.py``: a raw
64-variable row (NaNs allowed) is KNN-imputed, cut to the model's own
lasso-selected columns and scored by the stacked ensemble. A contract row
(``predict_hf.py:5-27``: the 17 variables in contract order) is first
embedded at its schema positions in a NaN row, so the imputer fills the 47
columns the contract does not carry — the ``cli predict --model`` route.

The fit half (``fit_pipeline``, ``fit_stacking``,
``cross_val_member_probas``) waits for the training solvers (ROADMAP
item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import SVCConfig
from machine_learning_replications_tpu_torch.data.schema import selected_indices, variable_names
from machine_learning_replications_tpu_torch.device import resolve_device, to_host
from machine_learning_replications_tpu_torch.models import knn_impute, stacking


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


def impute_select(
    params: PipelineParams, X64: "np.ndarray | torch.Tensor",
    block_fn: "knn_impute.ImputeBlock | None" = None,
) -> torch.Tensor:
    """KNN-impute raw 64-wide rows and keep the support columns → the
    ensemble's ``[n, n_selected]`` input, on the imputer's device.
    ``block_fn`` is a pre-resolved imputer block for callers with a fixed
    query NaN pattern (``resolve_contract_block_fn``)."""
    X_imp = knn_impute.transform(params.imputer, X64, block_fn=block_fn)
    cols = torch.as_tensor(np.flatnonzero(to_host(params.support_mask)), device=X_imp.device)
    return X_imp.index_select(1, cols)


def _check_device(params: PipelineParams, device) -> None:
    dev = resolve_device(device)
    for name, t in (("imputer", params.imputer.donors), ("ensemble", params.ensemble.meta.coef)):
        if t.device != dev:
            raise ValueError(
                f"the {name} parameters lie on {t.device}, requested device is {dev}: "
                f"convert them with convert.params_to(params, {str(dev)!r})"
            )


def pipeline_predict_proba1_contract(
    params: PipelineParams, X17: np.ndarray, chunk_rows: int | None = None, *, device=None,
) -> torch.Tensor:
    """Contract-order 17-variable rows → stacked P(class 1) through the full
    pipeline (the ``cli predict --model`` route)."""
    return pipeline_predict_proba1(params, contract_rows_to_x64(params, X17),
                                   chunk_rows, device=device)


def pipeline_predict_proba1(
    params: PipelineParams, X64: "np.ndarray | torch.Tensor", chunk_rows: int | None = None,
    *, device=None,
) -> torch.Tensor:
    """Raw 64-variable rows (NaNs allowed) → stacked P(class 1), on
    ``device`` (default: the card), where the parameters must lie.
    ``chunk_rows`` bounds the rows per stacked pass (default
    ``SVCConfig.predict_chunk_rows``): the SVC member builds an
    ``[rows, n_support]`` kernel block."""
    _check_device(params, device)
    X17 = impute_select(params, X64)
    return _stacked_proba1_bounded(params.ensemble, X17, chunk_rows)


def _stacked_proba1_bounded(
    ens: stacking.StackingParams, X17: torch.Tensor, chunk_rows: int | None,
) -> torch.Tensor:
    """The memory-bounded stacked-probability tail: ``stacking.predict_proba1``
    over blocks of ``chunk_rows`` rows (default
    ``SVCConfig().predict_chunk_rows``), concatenated on the device. The rows
    are cast to the ensemble's dtype first, so a float64 imputer can feed a
    float32 ensemble."""
    if chunk_rows is None:
        chunk_rows = SVCConfig().predict_chunk_rows
    X17 = X17.to(ens.meta.coef.dtype)
    n = int(X17.shape[0])
    if n > chunk_rows:
        return torch.cat([stacking.predict_proba1(ens, X17[s:s + chunk_rows], device=X17.device)
                          for s in range(0, n, chunk_rows)])
    return stacking.predict_proba1(ens, X17, device=X17.device)

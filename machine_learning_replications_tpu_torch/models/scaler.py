"""StandardScaler — z-scoring inside the SVC pipeline.

Reference: ``make_pipeline(StandardScaler(), SVC(...))`` at
``train_ensemble_public.py:44``. ``fit`` takes leading batch dimensions
(``X [..., n, F]``, ``sample_weight [..., n]``), so the stacking CV's fold
scalers are one call, as the JAX package's ``vmap`` makes them one program.
"""

from __future__ import annotations

import dataclasses

import torch

from machine_learning_replications_tpu_torch.device import float_dtype


@dataclasses.dataclass(frozen=True)
class ScalerParams:
    mean: torch.Tensor   # [F]
    scale: torch.Tensor  # [F] — stddev, with zero-variance columns forced to 1


def fit(X: torch.Tensor, sample_weight: "torch.Tensor | None" = None) -> ScalerParams:
    """Population (ddof=0) moments, as sklearn's StandardScaler computes them;
    zero variance gives scale 1, so constant columns pass through."""
    if sample_weight is None:
        mean = torch.mean(X, dim=-2)
        var = torch.mean((X - mean[..., None, :]) ** 2, dim=-2)
    else:
        w = sample_weight.to(X.dtype)
        w = w / torch.sum(w, dim=-1, keepdim=True)
        mean = (w[..., None, :] @ X)[..., 0, :]
        var = (w[..., None, :] @ (X - mean[..., None, :]) ** 2)[..., 0, :]
    scale = torch.where(var > 0, torch.sqrt(var), 1.0)
    return ScalerParams(mean=mean, scale=scale)


def transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    X = X.to(float_dtype(X, params.mean))
    if params.mean.dim() > 1:  # batched fold scalers over [..., n, F] rows
        return (X - params.mean[..., None, :]) / params.scale[..., None, :]
    return (X - params.mean) / params.scale

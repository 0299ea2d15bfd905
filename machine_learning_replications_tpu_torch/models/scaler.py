"""StandardScaler — z-scoring inside the SVC pipeline (inference side)."""

from __future__ import annotations

import dataclasses

import torch

from machine_learning_replications_tpu_torch.device import float_dtype


@dataclasses.dataclass(frozen=True)
class ScalerParams:
    mean: torch.Tensor   # [F]
    scale: torch.Tensor  # [F] — stddev, with zero-variance columns forced to 1


def transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    X = X.to(float_dtype(X, params.mean))
    return (X - params.mean) / params.scale

"""Logistic-regression members (inference side): ``σ(X·coef + intercept)``.

Covers the L1 base member and the L2 meta learner alike.
"""

from __future__ import annotations

import dataclasses

import torch

from machine_learning_replications_tpu_torch.device import float_dtype


@dataclasses.dataclass(frozen=True)
class LinearParams:
    coef: torch.Tensor       # [F]
    intercept: torch.Tensor  # scalar


def decision_function(params: LinearParams, X: torch.Tensor) -> torch.Tensor:
    X = X.to(float_dtype(X, params.coef))
    return X @ params.coef + params.intercept


def predict_proba1(params: LinearParams, X: torch.Tensor) -> torch.Tensor:
    """P(class 1); the [1−p, p] pairing happens at the stacking layer."""
    return torch.sigmoid(decision_function(params, X))

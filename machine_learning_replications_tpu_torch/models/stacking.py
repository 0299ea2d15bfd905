"""Stacking ensemble — the flagship forward step.

``StackingClassifier(estimators=[svc-pipeline, gbc, lg],
final_estimator=LogisticRegression)``: each binary member contributes its
P(class 1) as one meta-feature column, in the order (svc, gbc, lg), and the
meta logistic regression maps them to the final probability.

``member_probas`` and ``predict_proba1`` are plain functions on tensors that
already lie where the parameters lie. The ``predict_*`` entry points take
``device=`` (default: the card), move ``X`` there, and check that the
parameters are there too.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device
from machine_learning_replications_tpu_torch.models import linear, scaler, svm, tree


@dataclasses.dataclass(frozen=True)
class StackingParams:
    scaler: scaler.ScalerParams      # inside the SVC pipeline only
    svc: svm.SVCParams
    gbdt: tree.TreeEnsembleParams
    logreg: linear.LinearParams      # L1 base member
    meta: linear.LinearParams        # final estimator over 3 meta-features
    # Optional training reference profile for drift monitoring (a dict of
    # tensors); carried through unchanged, unused by inference.
    quality: Any = None


def member_probas(params: StackingParams, X: torch.Tensor) -> torch.Tensor:
    """Meta-feature matrix ``[n, 3]`` = P(class 1) per member (svc, gbc, lg)."""
    p_svc = svm.predict_proba1(params.svc, scaler.transform(params.scaler, X))
    p_gbc = tree.predict_proba1(params.gbdt, X)
    p_lg = linear.predict_proba1(params.logreg, X)
    dt = torch.promote_types(torch.promote_types(p_svc.dtype, p_gbc.dtype), p_lg.dtype)
    return torch.stack([p_svc.to(dt), p_gbc.to(dt), p_lg.to(dt)], dim=-1)


def _on_device(
    params: StackingParams, X: "np.ndarray | torch.Tensor", device
) -> torch.Tensor:
    dev = resolve_device(device)
    if params.meta.coef.device != dev:
        raise ValueError(
            f"parameters lie on {params.meta.coef.device}, requested device is "
            f"{dev}: convert them with convert.params_to(params, {str(dev)!r})"
        )
    return torch.as_tensor(X, device=dev)


def predict_proba1(
    params: StackingParams, X: "np.ndarray | torch.Tensor", *, device=None
) -> torch.Tensor:
    """Final P(class 1) for each row of ``X[n, 17]``."""
    X = _on_device(params, X, device)
    return linear.predict_proba1(params.meta, member_probas(params, X))


def predict_proba1_with_members(
    params: StackingParams, X: "np.ndarray | torch.Tensor", *, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(p1[n], members[n, 3])`` — the blended probability plus the member
    meta-features it was blended from."""
    X = _on_device(params, X, device)
    m = member_probas(params, X)
    return linear.predict_proba1(params.meta, m), m


def predict_proba(
    params: StackingParams, X: "np.ndarray | torch.Tensor", *, device=None
) -> torch.Tensor:
    """``[n, 2]`` = [1−p, p], sklearn's column layout."""
    p = predict_proba1(params, X, device=device)
    return torch.stack([1.0 - p, p], dim=-1)

"""Weight bridge: parameter containers → the port's dataclasses of tensors.

Each ``*_params_from_arrays`` takes either an object that carries the JAX
dataclass's field names as attributes (a JAX parameter pytree, a sklearn
import, anything alike) or a dict of them, converts every field with
``np.asarray`` and then ``torch.as_tensor`` on ``device``. Nothing here
imports JAX: a caller that holds JAX parameters hands them over as they
are, and numpy does the crossing.

Floating fields default to float64, matching the x64 oracle; integer fields
(tree topology) keep their integer dtype.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device
from machine_learning_replications_tpu_torch.models.linear import LinearParams
from machine_learning_replications_tpu_torch.models.scaler import ScalerParams
from machine_learning_replications_tpu_torch.models.stacking import StackingParams
from machine_learning_replications_tpu_torch.models.svm import SVCParams
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams


def _field(src: Any, name: str) -> Any:
    if isinstance(src, Mapping):
        return src[name]
    return getattr(src, name)


def _tensor(value: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    a = np.array(value)  # a writable copy: JAX hands out read-only buffers
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, device=device).to(dtype)
    return torch.as_tensor(a, device=device)


def _convert(cls, src: Any, device, dtype: torch.dtype, static=()):
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in static:
            kwargs[f.name] = int(_field(src, f.name))
        else:
            kwargs[f.name] = _tensor(_field(src, f.name), dev, dtype)
    return cls(**kwargs)


def scaler_params_from_arrays(
    src: Any, *, device=None, dtype: torch.dtype = torch.float64
) -> ScalerParams:
    return _convert(ScalerParams, src, device, dtype)


def linear_params_from_arrays(
    src: Any, *, device=None, dtype: torch.dtype = torch.float64
) -> LinearParams:
    return _convert(LinearParams, src, device, dtype)


def svc_params_from_arrays(
    src: Any, *, device=None, dtype: torch.dtype = torch.float64
) -> SVCParams:
    return _convert(SVCParams, src, device, dtype)


def tree_params_from_arrays(
    src: Any, *, device=None, dtype: torch.dtype = torch.float64
) -> TreeEnsembleParams:
    return _convert(TreeEnsembleParams, src, device, dtype, static=("max_depth",))


def _quality(src: Any, device: torch.device, dtype: torch.dtype) -> Any:
    if src is None or isinstance(src, (str, bool, int, float)):
        return src
    if isinstance(src, Mapping):
        return {k: _quality(v, device, dtype) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        return type(src)(_quality(v, device, dtype) for v in src)
    return _tensor(src, device, dtype)


def stacking_params_from_arrays(
    src: Any, *, device=None, dtype: torch.dtype = torch.float64
) -> StackingParams:
    dev = resolve_device(device)
    quality = src.get("quality") if isinstance(src, Mapping) else getattr(
        src, "quality", None
    )
    return StackingParams(
        scaler=scaler_params_from_arrays(_field(src, "scaler"), device=dev, dtype=dtype),
        svc=svc_params_from_arrays(_field(src, "svc"), device=dev, dtype=dtype),
        gbdt=tree_params_from_arrays(_field(src, "gbdt"), device=dev, dtype=dtype),
        logreg=linear_params_from_arrays(_field(src, "logreg"), device=dev, dtype=dtype),
        meta=linear_params_from_arrays(_field(src, "meta"), device=dev, dtype=dtype),
        quality=_quality(quality, dev, dtype),
    )


def params_to(params: Any, device) -> Any:
    """A copy of a parameter dataclass (nested ones included) with every
    tensor moved to ``device``; dtypes and static fields are kept."""
    dev = resolve_device(device)
    if isinstance(params, torch.Tensor):
        return params.to(dev)
    if dataclasses.is_dataclass(params):
        return dataclasses.replace(params, **{
            f.name: params_to(getattr(params, f.name), dev)
            for f in dataclasses.fields(params)
        })
    if isinstance(params, Mapping):
        return {k: params_to(v, dev) for k, v in params.items()}
    return params

"""Row-sharded application of pure per-row functions.

Port of the JAX package's ``parallel/rowwise.py``. The cohort's row axis
is the framework's universal parallel dimension: the imputation of a query
block and the stacked ensemble's probability pass are row-parallel. Each
rank maps its own block of rows; the padding rows are sliced off; every
rank then holds the whole output, put back together by one all-reduce over
'data' of a zero ``[rows, …]`` buffer into which each rank has written its
own rows (a sum with zeros is exact, and ``all_reduce`` is the collective
every backend takes on CUDA tensors). Ranks along 'model' map the same
block.

``chunk_rows`` bounds the rows per call (rounded up to a multiple of the
data-axis size so every shard stays equal): the imputer's distance matrix
and the SVC kernel block grow with the rows of a call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import to_host
from machine_learning_replications_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, psum


def replicate(mesh: Mesh, params: Any) -> Any:
    """``params`` (a tensor, or dataclasses and dicts of them) with every
    tensor on this rank's device: each rank holds its own replica."""
    if isinstance(params, torch.Tensor):
        return params.to(mesh.device)
    if dataclasses.is_dataclass(params):
        return dataclasses.replace(params, **{
            f.name: replicate(mesh, getattr(params, f.name)) for f in dataclasses.fields(params)})
    if isinstance(params, dict):
        return {k: replicate(mesh, v) for k, v in params.items()}
    return params


def apply_rows_sharded(
    mesh: Mesh,
    fn: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,
    X,
    *,
    chunk_rows: int | None = None,
    pad_value: float = 0.0,
) -> torch.Tensor:
    """``fn(params, X_block)`` with the rows of ``X`` sharded over 'data' →
    the full ``[n, …]`` output on this rank's device, on every rank.

    ``fn`` must be row-wise (row i of its output depends only on row i of
    its input and on ``params``), its output's leading axis the block's.
    Padding rows (``pad_value``) go through ``fn`` and are dropped, so
    ``fn`` must tolerate them."""
    X_np = to_host(X)
    n = X_np.shape[0]
    S = mesh.shape[DATA_AXIS]
    d = mesh.axis_index(DATA_AXIS)
    chunk = n if chunk_rows is None else min(chunk_rows, n)
    chunk = max(-(-chunk // S) * S, S)
    per = chunk // S
    params_r = replicate(mesh, params)
    outs = []
    for s in range(0, n, chunk):
        block = X_np[s:s + chunk]
        real = block.shape[0]
        if real < chunk:  # the tail: pad so every shard holds `per` rows
            pad = np.full((chunk - real,) + X_np.shape[1:], pad_value, X_np.dtype)
            block = np.concatenate([block, pad])
        mine = fn(params_r, torch.as_tensor(block[d * per:(d + 1) * per]).to(mesh.device))
        full = torch.zeros((chunk,) + tuple(mine.shape[1:]), dtype=mine.dtype,
                           device=mine.device)
        full[d * per:(d + 1) * per] = mine
        outs.append(psum(full, mesh, DATA_AXIS)[:real])
    return outs[0] if len(outs) == 1 else torch.cat(outs)

"""Row-sharded sufficient statistics for LassoCV feature selection.

Port of the JAX package's ``parallel/select_trainer.py``. The
covariance-form LassoCV (``models.solvers.lasso_cv_from_stats``) needs only
per-test-fold second-order statistics — Σ x xᵀ ``[F, F]``, Σ x y ``[F]``
and scalars — so each rank contracts its own row block against the fold
masks of its *global* row range, and one all-reduce per statistic over
'data' replicates the ``[K, F, F]`` statistics on every rank. The CV path
solve that follows is row-free.
"""

from __future__ import annotations

import torch

from machine_learning_replications_tpu_torch.data.sharding import row_block, shard_rows
from machine_learning_replications_tpu_torch.device import float_dtype
from machine_learning_replications_tpu_torch.models import solvers
from machine_learning_replications_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, psum


def lasso_fold_stats_sharded(mesh: Mesh, X, y, cv_folds: int) -> dict:
    """Per-TEST-fold statistics with rows sharded over 'data' — equal (up
    to the order floats are added in) to ``solvers.lasso_fold_stats``, on
    the mesh's device.

    The global mean shift is itself an all-reduce (padding rows are zero, so
    the sums are exact). Padding rows fall outside every fold's
    ``[start, end)`` window of global indices, so they add nothing to any
    statistic."""
    X = torch.as_tensor(X)
    dtype = float_dtype(X)
    (Xl, yl), n = shard_rows(mesh, X.to(dtype), torch.as_tensor(y).to(dtype))
    mu_nu = psum(torch.cat([torch.sum(Xl, dim=0), torch.sum(yl)[None]]), mesh, DATA_AXIS) / n
    mu, nu = mu_nu[:-1], mu_nu[-1]
    Xl = Xl - mu
    yl = yl - nu

    start, _, n_loc = row_block(n, mesh.shape[DATA_AXIS], mesh.axis_index(DATA_AXIS))
    gidx = start + torch.arange(n_loc, device=Xl.device)
    bounds = torch.as_tensor(solvers.fold_bounds(n, cv_folds), device=Xl.device)  # [K, 2]
    mask = ((gidx[None, :] >= bounds[:, :1]) & (gidx[None, :] < bounds[:, 1:])).to(dtype)
    my = mask * yl[None, :]                                   # [K, n_loc]
    local = {
        "sxx": torch.einsum("kn,nf,ng->kfg", mask, Xl, Xl),
        "sx": mask @ Xl,                                      # [K, F]
        "sxy": my @ Xl,                                       # [K, F]
        "sy": torch.sum(my, dim=1),                           # [K]
        "syy": my @ yl,                                       # [K]
        "m": torch.sum(mask, dim=1),                          # [K]
    }
    stats = {k: psum(v, mesh, DATA_AXIS) for k, v in local.items()}
    stats["mu"] = mu
    stats["nu"] = nu
    return stats

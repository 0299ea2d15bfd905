"""Data-parallel level-wise GBDT training (any depth) over the data axis.

Port of the JAX package's ``parallel/hist_trainer.py``. Rows are split
contiguously over the mesh's 'data' axis, and each rank runs the port's one
level-wise stage loop (``gbdt.run_levelwise``) over its own rows, growing
each stage's tree level by level through the one grower
(``gbdt.make_tree_grower``):

  1. every rank builds per-(node, feature, bin) histograms of its own rows
     with the node entry of the hand-written kernel (the CUDA kernel on the
     card, its plain version on the CPU);
  2. one all-reduce per statistic over 'data' replicates the global
     histograms (the grower's ``reduce_fn``);
  3. every rank runs the same split selection and routes its own rows.

Leaf Newton values come from all-reduced leaf sums, the prior from one
all-reduce of the stacked weight and label sums, and each stage's deviance
from one all-reduce of its stacked log-likelihood and weight sums, with no
host sync in the stage loop. The 'model' axis stays replicated (feature
tiles pay off only in the depth-1 stump trainer). Padding contract: rows
appended to even out the shards carry weight 0 and are parked at node −1
(the grower's ``node_init``), with zero gradient, so every reduction
ignores them.
"""

from __future__ import annotations

from typing import Any

import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.data.sharding import shard_rows
from machine_learning_replications_tpu_torch.device import float_dtype, to_host
from machine_learning_replications_tpu_torch.models import gbdt
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams
from machine_learning_replications_tpu_torch.ops import binning
from machine_learning_replications_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, psum
from machine_learning_replications_tpu_torch.parallel.stump_trainer import prior_log_odds


def fit(
    mesh: Mesh,
    X,
    y,
    cfg: GBDTConfig = GBDTConfig(),
    bins: binning.BinnedFeatures | None = None,
    sample_weight=None,
) -> tuple[TreeEnsembleParams, dict[str, Any]]:
    """GBDT fit of any depth with rows sharded over ``mesh``'s 'data' axis,
    on the mesh's device; every rank passes the same full ``X``, ``y`` and
    gets the same forest.

    ``sample_weight`` (0/1 fold masks or real weights) rides the padding
    contract: weight-0 rows are parked at node −1 with zero gradient, so a
    masked fold fit is the same loop as a full fit. Without ``bins`` the
    rows are binned on the host (``gbdt.bin_budget(cfg)``), as in JAX.
    Returns ``(params, {"train_deviance": host array})``."""
    kernels = gbdt.histogram_kernels(cfg)
    dev = mesh.device
    if bins is None:
        bins = binning.bin_features(to_host(X), gbdt.bin_budget(cfg))
    n = bins.binned.shape[0]
    dtype = float_dtype(torch.as_tensor(X[:0]))
    binned = torch.as_tensor(bins.binned)
    bl, _ = shard_rows(mesh, binned.to(torch.uint8) if bins.max_bins <= 256
                       else binned.to(torch.int32))
    y_host = to_host(y)
    w_full = (torch.ones(n, dtype=dtype) if sample_weight is None
              else torch.as_tensor(to_host(sample_weight)).to(dtype))
    (yl, wl), _ = shard_rows(mesh, torch.as_tensor(y_host).to(dtype), w_full)
    w = wl[None]
    thresholds = torch.as_tensor(bins.thresholds).to(dev, dtype)

    def reduce_fn(a: torch.Tensor) -> torch.Tensor:
        return psum(a, mesh, DATA_AXIS)

    grow_tree = gbdt.make_tree_grower(
        bl, thresholds, depth=cfg.max_depth, max_bins=int(bins.max_bins),
        min_samples_split=cfg.min_samples_split, min_samples_leaf=cfg.min_samples_leaf,
        kernels=kernels, node_init=torch.where(w > 0, 0, -1).to(torch.int32),
        reduce_fn=reduce_fn)
    carry = gbdt.levelwise_init(gbdt._prior_log_odds(yl, w, reduce_fn)[0], yl.shape[0],
                                cfg.n_estimators, cfg.max_depth)
    _, feats, thrs, vals, splits, devs = gbdt.run_levelwise(
        grow_tree, yl, carry, 0, cfg.n_estimators, learning_rate=cfg.learning_rate,
        weights=w, reduce_fn=reduce_fn)
    params = gbdt.forest_to_params(
        feats, thrs, vals, splits,
        init_raw=prior_log_odds(y_host, sample_weight, dtype, dev),
        learning_rate=cfg.learning_rate, max_depth=cfg.max_depth)
    return params, {"train_deviance": to_host(devs)}

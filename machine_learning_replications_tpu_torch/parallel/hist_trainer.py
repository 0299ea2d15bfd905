"""Data-parallel level-wise GBDT training (any depth) over the data axis.

Port of the JAX package's ``parallel/hist_trainer.py``: the sharded
counterpart of ``models.gbdt._run_binned``. Rows are split contiguously
over the mesh's 'data' axis; each boosting stage grows its tree level by
level through the port's one grower (``gbdt.make_tree_grower``):

  1. every rank builds per-(node, feature, bin) histograms of its own rows
     with the node entry of the hand-written kernel (the CUDA kernel on the
     card, its plain version on the CPU);
  2. one all-reduce per statistic over 'data' replicates the global
     histograms (the grower's ``reduce_fn``);
  3. every rank runs the same split selection and routes its own rows.

Leaf Newton values come from all-reduced leaf sums and the deviance from
all-reduced log-likelihood partials, with no host sync in the stage loop.
The 'model' axis stays replicated (feature tiles pay off only in the
depth-1 stump trainer). Padding contract: rows appended to even out the
shards carry weight 0 and are parked at node −1 (the grower's
``node_init``), with zero gradient, so every reduction ignores them.
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
    thresholds = torch.as_tensor(bins.thresholds).to(dev, dtype)
    feats, thrs, vals, splits, devs = _run(
        mesh, bl, wl, yl, thresholds, n_stages=cfg.n_estimators, depth=cfg.max_depth,
        max_bins=int(bins.max_bins), learning_rate=cfg.learning_rate,
        min_samples_split=cfg.min_samples_split, min_samples_leaf=cfg.min_samples_leaf,
        backend=gbdt.resolve_backend(cfg, dev))
    params = gbdt.forest_to_params(
        feats, thrs, vals, splits,
        init_raw=prior_log_odds(y_host, sample_weight, dtype, dev),
        learning_rate=cfg.learning_rate, max_depth=cfg.max_depth)
    return params, {"train_deviance": to_host(devs)}


def _run(
    mesh: Mesh,
    bl: torch.Tensor,          # [n_local, F] this rank's bin rows
    wl: torch.Tensor,          # [n_local] — weights, 0 at padding rows
    yl: torch.Tensor,          # [n_local]
    thresholds: torch.Tensor,  # [F, B-1]
    *,
    n_stages: int,
    depth: int,
    max_bins: int,
    learning_rate: float,
    min_samples_split: int,
    min_samples_leaf: int,
    backend: str,
):
    """The stage loop on one rank → the replicated forest tensors
    ``(feature, threshold, value, is_split [n_stages, NN], deviance)``."""
    dtype = thresholds.dtype
    dev = bl.device
    NN = 2 ** (depth + 1) - 1

    def gsum(*vs: torch.Tensor) -> torch.Tensor:
        return psum(torch.stack([torch.sum(v) for v in vs]), mesh, DATA_AXIS)

    n_real, sum_y = gsum(wl, yl * wl)
    p1 = sum_y / n_real
    f0 = torch.log(p1 / (1.0 - p1))
    # One copy of the growth algorithm; sharding enters only through
    # reduce_fn and the −1-parked padding.
    grow_tree = gbdt.make_tree_grower(
        bl, thresholds, depth=depth, max_bins=max_bins,
        min_samples_split=min_samples_split, min_samples_leaf=min_samples_leaf,
        hist_fn=gbdt.resolve_hist_fn(backend),
        node_init=torch.where(wl > 0, 0, -1).to(torch.int32)[None],
        reduce_fn=lambda a: psum(a, mesh, DATA_AXIS),
    )
    raw = torch.zeros(bl.shape[0], dtype=dtype, device=dev) + f0
    feats = torch.zeros((n_stages, NN), dtype=torch.int32, device=dev)
    thrs = torch.full((n_stages, NN), torch.inf, dtype=dtype, device=dev)
    vals = torch.zeros((n_stages, NN), dtype=dtype, device=dev)
    splits = torch.zeros((n_stages, NN), dtype=torch.bool, device=dev)
    devs = torch.zeros(n_stages, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for t in range(n_stages):
        p = torch.sigmoid(raw)
        g = (yl - p) * wl
        h = p * (1.0 - p) * wl
        feat_t, thr_t, val_t, split_t, node = grow_tree(g[None], h[None])
        raw = raw + learning_rate * val_t[0][torch.clamp_min(node[0], 0).long()] * wl
        ll = gsum((yl * raw - torch.logaddexp(zero, raw)) * wl)[0]
        devs[t] = -2.0 * ll / n_real
        feats[t], thrs[t], vals[t], splits[t] = feat_t[0], thr_t[0], val_t[0], split_t[0]
    return feats, thrs, vals, splits, devs

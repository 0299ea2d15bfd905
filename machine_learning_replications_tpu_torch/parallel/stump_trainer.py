"""Data-parallel depth-1 GBDT training: the sharded counterpart of the
depth-1 stage loop (``models.gbdt._run_stumps``).

Port of the JAX package's ``parallel/stump_trainer.py``. Mesh mapping:

  data  — cohort rows. Each rank histograms its own row block with the
          stump entry that ``gbdt.histogram_kernels`` picks (the CUDA kernel
          on the card, its plain version on the CPU), and the per-stage
          communication is one all-reduce of the ``[2, F_loc, B]`` partials
          over 'data', plus a few scalars.
  model — feature tiles of the split search: each rank histograms and
          scores its ``F/model`` features' candidates; the global best is
          the best over the model shards (``mesh.best_over_model``, the
          lower shard on a tie), and the winner's three scalars are summed
          over 'model'. Routing reads the chosen feature's column from the
          rank's full-width (model-replicated) bin block.

Padding contract, as in JAX: rows padded per shard carry weight 0 and bin
``B-1`` (the weighted path zeroes their statistics; the final bin never
enters a left-of-boundary sum); feature slots padded to a multiple of the
model-axis size hold constant-0 bins with +inf thresholds, so their
candidates are invalid on every shard. Global scalar sums come from model
shard 0 only (a masked sum over both axes), so every rank holds the same
values by construction.

The stage loop makes no host sync: the winner is taken with
``index_select`` on device indices, and the all-reduces are its only waits.
The column tile the kernel reads is sliced once per fit, contiguous
(the kernel takes a contiguous body).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.data.sharding import shard_rows
from machine_learning_replications_tpu_torch.device import float_dtype, to_host
from machine_learning_replications_tpu_torch.models import gbdt
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams
from machine_learning_replications_tpu_torch.ops import binning, histogram
from machine_learning_replications_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    best_over_model,
    psum,
)

# Per-shard budget for the trainer's working set (the JAX package's): above
# it ``fit`` refuses with sizing advice and ``fit_gbdt_sharded`` routes to
# the level-wise trainer instead.
MAX_LAYOUT_BYTES = 8 << 30


def _layout_plan(n: int, F: int, max_bins: int, n_data: int, n_model: int):
    """``(F_pad, n_local, bin_dtype, working-set bytes per shard)`` for a
    mesh shape, with the JAX package's arithmetic: the model-replicated bin
    matrix, ~24 bytes of transient per element of the column tile, six
    per-row vectors, and the B-scaled arrays (thresholds, per-tile
    histograms, their cumsums and the scoring temporaries).

    The kernel reads uint8 or int32 bins only, so where JAX picks uint16
    (257 to 65,536 bins) the port takes int32, and the bytes count four
    per bin id there."""
    F_pad = -(-F // n_model) * n_model
    n_local = -(-n // n_data)
    F_loc = F_pad // n_model
    bin_dtype = np.uint8 if max_bins <= 256 else np.int32
    per_shard = n_local * (
        F_pad * np.dtype(bin_dtype).itemsize + F_loc * 24 + 6 * 8
    ) + max_bins * (F_pad + 9 * F_loc) * 8
    return F_pad, n_local, bin_dtype, per_shard


_TORCH_BINS = {np.uint8: torch.uint8, np.int32: torch.int32}


def fit(
    mesh: Mesh,
    X,
    y,
    cfg: GBDTConfig = GBDTConfig(),
    bins: binning.BinnedFeatures | None = None,
    sample_weight=None,
    max_layout_bytes: int | None = None,
) -> tuple[TreeEnsembleParams, dict[str, Any]]:
    """Depth-1 GBDT fit sharded over ``mesh`` ('data' × 'model'), on the
    mesh's device; every rank passes the same full ``X``, ``y`` and gets the
    same forest.

    ``sample_weight`` (0/1 fold masks or real weights) rides the padding
    contract, so a masked fold fit is the same loop as a full fit.
    ``max_layout_bytes`` overrides the per-shard memory guard. Without
    ``bins`` the rows are binned on the host (``gbdt.bin_budget(cfg)``), as
    in JAX. Returns ``(params, {"train_deviance": host array})``."""
    if cfg.max_depth != 1:
        raise ValueError("the sharded stump trainer fits depth-1 configs")
    kernels = gbdt.histogram_kernels(cfg)
    dev = mesh.device
    if bins is None:
        bins = binning.bin_features(to_host(X), gbdt.bin_budget(cfg))
    n, F = bins.binned.shape
    B = int(bins.max_bins)
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    F_pad, n_local, bin_dtype, per_shard = _layout_plan(n, F, B, n_data, n_model)
    budget = MAX_LAYOUT_BYTES if max_layout_bytes is None else max_layout_bytes
    if per_shard > budget:
        raise RuntimeError(
            f"stump_trainer: per-shard working set needs {per_shard:,} bytes "
            f"(F={F}, n_local={n_local}, max_bins={B}, "
            f"bin dtype {np.dtype(bin_dtype).name}) > budget {budget:,} bytes. "
            "Use splitter='hist' (bounds the candidate count; n_bins<=256 "
            "makes bin ids uint8) or route through parallel.hist_trainer; "
            "adding data shards helps only the row-scaled portion — the "
            "candidate-scaled arrays are model-replicated and do not shard "
            "with 'data'."
        )
    dtype = float_dtype(torch.as_tensor(X[:0]))
    # Rows pad with bin B-1 / weight 0; feature columns pad with bin 0 and
    # +inf thresholds.
    bl, _ = shard_rows(mesh, torch.as_tensor(bins.binned).to(_TORCH_BINS[bin_dtype]),
                       pad_value=B - 1)
    if F_pad > F:
        bl = torch.nn.functional.pad(bl, (0, F_pad - F))
    thresholds = torch.nn.functional.pad(
        torch.as_tensor(bins.thresholds).to(dev, dtype), (0, 0, 0, F_pad - F), value=torch.inf)
    y_host = to_host(y)
    yl, _ = shard_rows(mesh, torch.as_tensor(y_host).to(dtype))
    weighted = not (sample_weight is None and n_local * n_data == n)
    wl = None
    if weighted:
        w_full = (torch.ones(n, dtype=dtype) if sample_weight is None
                  else torch.as_tensor(to_host(sample_weight)).to(dtype))
        wl, _ = shard_rows(mesh, w_full)
    feats, thrs, vals, splits, devs = _run(
        mesh, bl, yl, wl, thresholds, n_stages=cfg.n_estimators,
        learning_rate=cfg.learning_rate, min_samples_leaf=cfg.min_samples_leaf,
        min_samples_split=cfg.min_samples_split, max_bins=B, stump_fn=kernels.stump)
    params = gbdt.forest_to_params(
        feats, thrs, vals, splits,
        init_raw=prior_log_odds(y_host, sample_weight, dtype, dev),
        learning_rate=cfg.learning_rate, max_depth=1)
    return params, {"train_deviance": to_host(devs)}


def prior_log_odds(y, sample_weight, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """F₀ = log-odds of the (weighted) class prior from the full host
    labels, in float64 as the JAX package's host branch takes it, then in
    the fit's dtype."""
    y = np.asarray(y, np.float64)
    if sample_weight is None:
        p1 = float(np.mean(y))
    else:
        w = np.asarray(to_host(sample_weight), np.float64)
        p1 = float((w * y).sum() / w.sum())
    return torch.tensor(np.log(p1 / (1.0 - p1)), dtype=dtype, device=dev)


def _run(
    mesh: Mesh,
    bl: torch.Tensor,                 # [n_local, F_pad] this rank's bin rows, all features
    yl: torch.Tensor,                 # [n_local] labels, 0 at padding rows
    wl: "torch.Tensor | None",        # [n_local] weights, 0 at padding rows; None = all 1
    thr_full: torch.Tensor,           # [F_pad, B-1] (+inf on padded feature slots)
    *,
    n_stages: int,
    learning_rate: float,
    min_samples_leaf: int,
    min_samples_split: int,
    max_bins: int,
    stump_fn,
):
    """The stage loop on one rank → the replicated forest tensors
    ``(feature, threshold, value, is_split [n_stages, 3], deviance)``."""
    dtype = thr_full.dtype
    dev = bl.device
    Bm1 = thr_full.shape[1]
    n_model = mesh.shape[MODEL_AXIS]
    F_loc = bl.shape[1] // n_model
    m_idx = mesh.axis_index(MODEL_AXIS)
    on0 = 1.0 if m_idx == 0 else 0.0
    col0 = m_idx * F_loc
    thr = thr_full[col0:col0 + F_loc]
    cols = bl[:, col0:col0 + F_loc].contiguous()     # the kernel's tile, sliced once
    ws = wl

    def gsum(*vs: torch.Tensor) -> torch.Tensor:
        """Global sums over real rows of per-row ``[n_local]`` vectors, taken
        from model shard 0 and summed over both axes: one all-reduce."""
        return psum(torch.stack([torch.sum(v) for v in vs]) * on0, mesh, None)

    def hist_cum(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Global left-of-boundary sums ``[2, F_loc, B-1]``: this rank's
        histograms over its tile, one all-reduce over 'data', a cumsum."""
        hg = stump_fn(cols, g, h, max_bins)
        hg = psum(hg, mesh, DATA_AXIS)
        return torch.cumsum(hg, dim=2)[:, :, :Bm1]

    if ws is not None:
        n_real, sum_y = gsum(ws, yl * ws)
        CL = hist_cum(ws, torch.ones_like(ws))[0]   # weights don't change: hoisted
    else:
        n_real, sum_y = gsum(torch.ones_like(yl), yl)
        # Unweighted counts are exact: rows with bin <= b, per feature. Padding
        # rows carry bin B-1 and never count; a padded feature's constant-0
        # column is unreachable behind its +inf thresholds.
        CL = psum(gbdt._left_counts(cols, Bm1 + 1).to(dtype), mesh, DATA_AXIS)
    p1 = sum_y / n_real
    f0 = torch.log(p1 / (1.0 - p1))

    raw = torch.zeros(bl.shape[0], dtype=dtype, device=dev) + f0
    feats = torch.zeros((n_stages, 3), dtype=torch.int32, device=dev)
    thrs_o = torch.full((n_stages, 3), torch.inf, dtype=dtype, device=dev)
    vals = torch.zeros((n_stages, 3), dtype=dtype, device=dev)
    splits = torch.zeros((n_stages, 3), dtype=torch.bool, device=dev)
    devs = torch.zeros(n_stages, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.full((1,), torch.inf, dtype=dtype, device=dev)
    no_split = torch.zeros(2, dtype=torch.bool, device=dev)
    feat_mask = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)
    thr_flat = thr.reshape(-1)
    newton = histogram.newton_leaf_value

    for t in range(n_stages):
        p = torch.sigmoid(raw)
        if ws is not None:
            g = (yl - p) * ws
            h = p * (1.0 - p) * ws
        else:
            g = yl - p
            h = p * (1.0 - p)
        GHL = hist_cum(g, h)
        GL, HL = GHL[0], GHL[1]
        GT, HT, G2 = gsum(g, h, g * g)

        # local split scoring over this shard's features
        GR = GT - GL
        CR = n_real - CL
        valid = (CL >= min_samples_leaf) & (CR >= min_samples_leaf) & torch.isfinite(thr)
        diff = GL / torch.clamp_min(CL, 1) - GR / torch.clamp_min(CR, 1)
        proxy = torch.where(valid, diff * diff * CL * CR, -torch.inf)
        flat = proxy.reshape(-1)
        best_local = torch.argmax(flat)
        best_gain = flat.index_select(0, best_local.view(1))[0]
        winner, gains, locs = best_over_model(best_gain, best_local, mesh)
        w_loc = locs.index_select(0, winner.view(1))           # [1]
        f_local = torch.div(w_loc, Bm1, rounding_mode="floor")
        bstar = w_loc - f_local * Bm1
        fstar = winner * F_loc + f_local                        # [1] global feature id

        # The winner's boundary sums and threshold, summed over 'model' from
        # the winning shard (the threshold masked first: +inf·0 is NaN).
        on_winner = winner == m_idx
        picked = torch.stack([GL.reshape(-1).index_select(0, w_loc)[0],
                              HL.reshape(-1).index_select(0, w_loc)[0],
                              thr_flat.index_select(0, w_loc)[0]])
        num_l, den_l, thr_star = psum(torch.where(on_winner, picked, zero), mesh, MODEL_AXIS)
        gain_star = gains.index_select(0, winner.view(1))[0]
        num_r, den_r = GT - num_l, HT - den_l

        mean = GT / torch.clamp_min(n_real, 1)
        impurity = torch.clamp_min(G2 / torch.clamp_min(n_real, 1) - mean * mean, 0.0)
        do = ((n_real >= min_samples_split) & (impurity > histogram.IMPURITY_EPS)
              & torch.isfinite(gain_star)).view(1)
        v_root = newton(GT, HT).view(1)
        v_l, v_r = newton(num_l, den_l).view(1), newton(num_r, den_r).view(1)

        split_bins = bl.index_select(1, fstar)[:, 0]            # the chosen column
        go_left = split_bins.long() <= bstar
        contrib = torch.where(do, torch.where(go_left, v_l, v_r), v_root)
        raw = raw + learning_rate * contrib
        ll_terms = yl * raw - torch.logaddexp(zero, raw)
        ll = gsum(ll_terms * ws if ws is not None else ll_terms)[0]
        devs[t] = -2.0 * ll / n_real

        feats[t] = torch.where(do, fstar, 0).to(torch.int32) * feat_mask
        thrs_o[t] = torch.cat([torch.where(do, thr_star.view(1), inf), inf, inf])
        vals[t] = torch.cat([torch.where(do, zero, v_root), torch.where(do, v_l, zero),
                             torch.where(do, v_r, zero)])
        splits[t] = torch.cat([do, no_split])
    return feats, thrs_o, vals, splits, devs

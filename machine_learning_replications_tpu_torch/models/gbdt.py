"""Gradient-boosted trees — training, fused depth-1 'hist' regime.

Port of the JAX package's ``models/gbdt.py`` for the regime its fused fit
covers (``splitter='hist'``, ``max_depth=1``, at least
``DEVICE_BINNING_MIN_ROWS`` rows): quantile binning on the device, then
every boosting stage over the loop-invariant ``[n, F]`` bin matrix, each
stage's split statistics from one ``ops.histogram.stump_histograms`` pass —
the hand-written CUDA kernel on the card.

Numerics match sklearn's binomial-deviance GBC as the JAX fit does:
F₀ = prior log-odds, residual r = y − σ(F), leaves re-valued by the Newton
step Σr / Σp(1−p) (guarded at |den| < 1e-150), F += lr·leaf, and
``train_deviance[m] = −2·mean(y·F − log(1+eᶠ))``.

The stage loop is eager PyTorch with no host sync: the split column is
picked with ``index_select`` on a device index, per-stage results are
written into preallocated ``[n_stages, 3]`` tensors, and the binning NaN
flag is read once, after the loop.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.device import resolve_device
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams
from machine_learning_replications_tpu_torch.ops import binning, histogram

# 'hist'-mode fits at or above this row count quantise on device and take
# the fused path (the JAX package's threshold, kept so both route alike).
DEVICE_BINNING_MIN_ROWS = 100_000


def uses_fused_hist1(cfg: GBDTConfig, n_rows: int) -> bool:
    """``fit``'s fused-path gate — config and shape only."""
    return (
        cfg.splitter == "hist"
        and cfg.max_depth == 1
        and n_rows >= DEVICE_BINNING_MIN_ROWS
    )


def resolve_backend(cfg: GBDTConfig, device: torch.device) -> str:
    """'auto' → 'pallas' (the hand kernel, named after the TPU kernel it
    replaces) on a CUDA device, the plain 'xla' version elsewhere; the
    explicit values pass through. The JAX package picks 'matmul' on TPU."""
    b = cfg.histogram_backend
    if b not in histogram.BACKENDS:
        raise ValueError(
            f"unknown histogram_backend {b!r}; "
            "expected 'auto', 'matmul', 'pallas' or 'xla'"
        )
    if b == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return b


def _prior_log_odds(y: torch.Tensor) -> torch.Tensor:
    """F₀ = log-odds of the class prior, as a device scalar (no sync)."""
    p1 = torch.mean(y)
    return torch.log(p1 / (1.0 - p1))


def forest_to_params(
    feature: torch.Tensor,    # [M, NN] int32
    threshold: torch.Tensor,  # [M, NN]
    value: torch.Tensor,      # [M, NN]
    is_split: torch.Tensor,   # [M, NN] bool
    init_raw: torch.Tensor,
    learning_rate: float,
    max_depth: int,
) -> TreeEnsembleParams:
    """Heap-layout forest tensors → the inference dataclass (self-loop leaves)."""
    M, NN = feature.shape
    idx = torch.arange(NN, dtype=torch.int32, device=feature.device)[None, :]
    left = torch.where(is_split, 2 * idx + 1, idx).to(torch.int32)
    right = torch.where(is_split, 2 * idx + 2, idx).to(torch.int32)
    return TreeEnsembleParams(
        feature=feature,
        threshold=threshold,
        left=left,
        right=right,
        value=value,
        init_raw=torch.as_tensor(init_raw, device=feature.device),
        learning_rate=torch.tensor(learning_rate, dtype=value.dtype, device=feature.device),
        max_depth=max_depth,
    )


def fit(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    cfg: GBDTConfig = GBDTConfig(),
    *,
    device=None,
) -> tuple[TreeEnsembleParams, dict[str, Any]]:
    """Fit the boosted ensemble on ``device``; returns ``(params, aux)`` with
    ``aux['train_deviance']`` (a device tensor, as on the JAX fused path).

    Only the fused 'hist' depth-1 regime is ported so far; the others raise
    ``NotImplementedError`` naming the ROADMAP item that ports them.
    """
    dev = resolve_device(device)
    backend = resolve_backend(cfg, dev)  # validate eagerly
    n = X.shape[0]
    if not uses_fused_hist1(cfg, n):
        if cfg.splitter == "hist" and cfg.max_depth == 1:
            why = (f"{n} rows < DEVICE_BINNING_MIN_ROWS: the sorted-layout "
                   "_fit_stumps path (ROADMAP queue A, item 3)")
        elif cfg.max_depth >= 2:
            why = ("depth >= 2: _fit_binned / make_tree_grower with the node "
                   "histograms (ROADMAP queue A, item 2)")
        else:
            why = (f"splitter {cfg.splitter!r}: the exact _fit_stumps path "
                   "(ROADMAP queue A, item 3)")
        raise NotImplementedError(f"GBDT regime not ported yet — {why}")
    if cfg.n_estimators == 1 and isinstance(X, np.ndarray) and isinstance(y, np.ndarray):
        raise NotImplementedError(
            "GBDT regime not ported yet — the host single-stump engine "
            "_fit_stump_host (ROADMAP queue A, item 4)"
        )
    Xj = torch.as_tensor(X, device=dev)
    yj = torch.as_tensor(y, device=dev)
    feature, threshold, value, is_split, deviance, f0, nan_flag = _fit_hist1_fused(
        Xj, yj,
        n_bins=cfg.n_bins,
        n_stages=cfg.n_estimators,
        learning_rate=cfg.learning_rate,
        min_samples_split=cfg.min_samples_split,
        min_samples_leaf=cfg.min_samples_leaf,
        backend=backend,
    )
    # One sync for the whole fit, after every stage is queued.
    if bool(nan_flag):
        raise ValueError("input contains NaN; impute before binning")
    params = forest_to_params(
        feature, threshold, value, is_split,
        init_raw=f0, learning_rate=cfg.learning_rate, max_depth=1,
    )
    return params, {"train_deviance": deviance}


def _fit_hist1_fused(
    Xj: torch.Tensor,
    yj: torch.Tensor,
    *,
    n_bins: int,
    n_stages: int,
    learning_rate: float,
    min_samples_split: int,
    min_samples_leaf: int,
    backend: str,
):
    """Quantile binning → all boosting stages over unsorted histograms.

    Returns ``(feature, threshold, value, is_split, deviance, f0, nan_flag)``
    with the forest in ``[n_stages, 3]`` heap layout, all on the device.
    """
    binned, mids, nan_flag = binning.device_binning_core(Xj, n_bins)
    if n_bins <= 256:
        # the only O(n·F) array each stage reads — keep it one byte wide
        binned = binned.to(torch.uint8)
    thresholds = mids.T.contiguous()                         # [F, B-1]
    dtype = thresholds.dtype
    n, F = Xj.shape
    dev = Xj.device
    # Loop-invariant left-of-boundary counts (#rows with bin ≤ b), one
    # row-chunked compare+sum pass as in the JAX fit.
    boundaries = torch.arange(n_bins - 1, dtype=torch.int32, device=dev)
    mapped = binning.chunked_row_reduce(
        binned.to(torch.int32),
        lambda bc: torch.sum(
            bc[:, None, :] <= boundaries[None, :, None], dim=0, dtype=torch.int32
        )[None],
    )
    left_count = torch.sum(mapped, dim=0).T                  # [F, B-1]

    ys = yj.to(dtype)
    f0 = _prior_log_odds(ys)
    CL = left_count.to(dtype)[None]                          # [1, F, B-1]
    CT = torch.tensor([n], dtype=dtype, device=dev)
    Bm1 = n_bins - 1

    raw = torch.full((n,), 0.0, dtype=dtype, device=dev) + f0
    feats = torch.zeros((n_stages, 3), dtype=torch.int32, device=dev)
    thrs = torch.full((n_stages, 3), torch.inf, dtype=dtype, device=dev)
    vals = torch.zeros((n_stages, 3), dtype=dtype, device=dev)
    splits = torch.zeros((n_stages, 3), dtype=torch.bool, device=dev)
    devs = torch.zeros(n_stages, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.full((1,), torch.inf, dtype=dtype, device=dev)
    no_split = torch.zeros(2, dtype=torch.bool, device=dev)
    feat_mask = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)

    for t in range(n_stages):
        p = torch.sigmoid(raw)
        g = ys - p
        h = p * (1.0 - p)
        hist = histogram.stump_histograms(binned, g, h, n_bins, backend=backend)  # [2, F, B]
        GL = torch.cumsum(hist[0], dim=1)[:, :-1][None]      # [1, F, B-1]
        HL = torch.cumsum(hist[1], dim=1)[:, :-1]            # [F, B-1]
        GT = torch.sum(g)
        HT = torch.sum(h)
        sp = histogram.select_splits(
            GL, CL, GT[None], CT, torch.sum(g * g)[None], thresholds,
            min_samples_split, min_samples_leaf,
        )
        do = sp.do_split                                     # [1]
        fstar, bstar = sp.feature, sp.boundary               # [1] each
        best = fstar * Bm1 + bstar
        num_l = GL.reshape(-1).index_select(0, best)
        den_l = HL.reshape(-1).index_select(0, best)
        num_r, den_r = GT - num_l, HT - den_l

        newton = histogram.newton_leaf_value
        v_root = newton(GT, HT)[None]  # unsplit stage: single-leaf Newton value
        v_l, v_r = newton(num_l, den_l), newton(num_r, den_r)

        split_bins = binned.index_select(1, fstar)[:, 0]    # [n]
        go_left = split_bins.long() <= bstar
        contrib = torch.where(do, torch.where(go_left, v_l, v_r), v_root)
        raw = raw + learning_rate * contrib
        devs[t] = -2.0 * torch.mean(ys * raw - torch.logaddexp(zero, raw))

        feats[t] = torch.where(do, fstar, 0).to(torch.int32) * feat_mask
        thrs[t] = torch.cat([torch.where(do, sp.threshold, inf), inf, inf])
        vals[t] = torch.cat([torch.where(do, zero, v_root), torch.where(do, v_l, zero),
                             torch.where(do, v_r, zero)])
        splits[t] = torch.cat([do, no_split])

    return feats, thrs, vals, splits, devs, f0, nan_flag

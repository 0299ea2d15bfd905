"""Gradient-boosted trees — training.

Port of the JAX package's ``models/gbdt.py`` for two regimes:

  * the fused depth-1 'hist' fit (``splitter='hist'``, ``max_depth=1``, at
    least ``DEVICE_BINNING_MIN_ROWS`` rows): quantile binning on the device,
    then every boosting stage over the loop-invariant ``[n, F]`` bin matrix,
    each stage's split statistics from one ``ops.histogram.stump_histograms``
    pass — the hand-written CUDA kernel on the card;
  * the level-wise grower (``max_depth >= 2`` in ``fit``, every depth in
    ``fit_folds``): each tree is built level by level from per-(node,
    feature, bin) histograms (``resolve_hist_fn``: the hand-written CUDA node
    kernel on the card), friedman split selection and Newton leaves, in heap
    layout (root 0, children 2i+1 / 2i+2; non-split nodes self-loop).

Numerics match sklearn's binomial-deviance GBC as the JAX fit does:
F₀ = prior log-odds, residual r = y − σ(F), leaves re-valued by the Newton
step Σr / Σp(1−p) (0 where |den| < 1e-150 in float64, where den == 0
below float64: ``ops.histogram.newton_leaf_value``), F += lr·leaf, and
``train_deviance[m] = −2·mean(y·F − log(1+eᶠ))``.

The stage loops are eager PyTorch with no host sync: split columns and rows
are picked with ``index_select``/``gather``/``take`` on device indices,
per-stage results are written into preallocated tensors, and the binning
NaN flag is read once, after the loop. The grower carries a leading fit axis
``k`` (1 for ``fit``, the folds for ``fit_folds``), so all of a level's
folds share one histogram launch — where the JAX package ``vmap``s the folds
and so keeps its Pallas kernel off them.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the sorted-layout ``_fit_stumps`` path (``splitter='exact'`` at
depth 1, and 'hist' depth 1 below ``DEVICE_BINNING_MIN_ROWS``) and the host
single-stump engine ``_fit_stump_host`` (A-next-2); ``fit_resumable``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.device import float_dtype, resolve_device, to_host
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams
from machine_learning_replications_tpu_torch.ops import binning, histogram

# 'hist'-mode fits at or above this row count quantise on device (and at
# depth 1 take the fused path) — the JAX package's threshold, kept so both
# route alike.
DEVICE_BINNING_MIN_ROWS = 100_000


def default_bins(X: torch.Tensor, cfg: GBDTConfig, device: torch.device) -> binning.BinnedFeatures:
    """Binning policy for a fit that wasn't handed bins explicitly: device
    quantiles on ``device`` for 'hist' at scale, else host unique-value
    midpoints."""
    if cfg.splitter == "hist" and X.shape[0] >= DEVICE_BINNING_MIN_ROWS:
        return binning.bin_features_device(X.to(device), cfg.n_bins)
    return binning.bin_features(to_host(X), bin_budget(cfg))


def uses_fused_hist1(cfg: GBDTConfig, n_rows: int) -> bool:
    """``fit``'s fused-path gate — config and shape only."""
    return (
        cfg.splitter == "hist"
        and cfg.max_depth == 1
        and n_rows >= DEVICE_BINNING_MIN_ROWS
    )


def bin_budget(cfg: GBDTConfig) -> int | None:
    """Bin cap implied by ``cfg.splitter``: 'exact' enumerates every
    unique-value midpoint (None = no cap) on the depth-1 path only; the
    level-wise grower allocates O(2^depth · F · bins) per level, so it stays
    quantile-capped even under 'exact' (identical whenever a feature has at
    most ``n_bins`` values). 'hist' quantises to ``cfg.n_bins`` bins."""
    if cfg.splitter == "exact":
        return None if cfg.max_depth == 1 else cfg.n_bins
    if cfg.splitter == "hist":
        return cfg.n_bins
    raise ValueError(
        f"unknown splitter {cfg.splitter!r}; expected 'exact' or 'hist'"
    )


def bin_budget_capped(cfg: GBDTConfig) -> int:
    """``bin_budget`` but always bounded (the fold fits run the level-wise
    grower, whose allocation scales with the bin count)."""
    b = bin_budget(cfg)
    return cfg.n_bins if b is None else b


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


def resolve_hist_fn(backend: str, feature_bins: tuple[int, ...] | None = None):
    """Node-histogram implementation for a resolved backend name: 'pallas'
    (or 'auto') → ``cuda_histogram.node_histograms_cuda`` (the hand kernel
    on a CUDA tensor, its plain version on a CPU tensor); 'xla' and 'matmul'
    → the plain ``histogram.node_histograms`` on any device.
    ``feature_bins`` only shapes the JAX matmul backend; it is accepted and
    unused."""
    del feature_bins
    if backend in ("auto", "pallas"):
        from machine_learning_replications_tpu_torch.ops.cuda_histogram import (
            node_histograms_cuda,
        )

        return node_histograms_cuda
    if backend in ("xla", "matmul"):
        return histogram.node_histograms
    raise ValueError(f"unknown histogram backend {backend!r}; expected one of "
                     f"{histogram.BACKENDS}")


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
    the deviance path ``aux['train_deviance']``: a device tensor on the fused
    depth-1 path (fetching it would sync inside the fit), a host numpy array
    on the level-wise path (``max_depth >= 2``), as in the JAX package.

    The fit runs in ``float_dtype(X)``. Depth-1 fits off the fused path
    raise ``NotImplementedError`` naming ROADMAP item A-next-2.
    """
    dev = resolve_device(device)
    backend = resolve_backend(cfg, dev)  # validate eagerly
    bin_budget(cfg)                      # validates the splitter
    n = X.shape[0]
    if cfg.max_depth == 1:
        if (cfg.n_estimators == 1 and uses_fused_hist1(cfg, n)
                and isinstance(X, np.ndarray) and isinstance(y, np.ndarray)):
            raise NotImplementedError(
                "GBDT regime not ported yet — the host single-stump engine "
                "_fit_stump_host (ROADMAP A-next-2)"
            )
        if not uses_fused_hist1(cfg, n):
            why = (f"{n} rows < DEVICE_BINNING_MIN_ROWS" if cfg.splitter == "hist"
                   else f"splitter {cfg.splitter!r}")
            raise NotImplementedError(
                f"GBDT regime not ported yet — {why}: the sorted-layout "
                "_fit_stumps path (ROADMAP A-next-2)"
            )
        return _fit_fused(X, y, cfg, backend, dev)
    Xt = torch.as_tensor(X)
    dtype = float_dtype(Xt)
    yj = torch.as_tensor(y, device=dev)
    bins = default_bins(Xt, cfg, dev)
    feature, threshold, value, is_split, deviance = _fit_binned(
        _device_bins(bins.binned, bins.max_bins, dev),
        torch.as_tensor(bins.thresholds, dtype=dtype, device=dev),
        yj,
        n_stages=cfg.n_estimators,
        depth=cfg.max_depth,
        max_bins=bins.max_bins,
        learning_rate=cfg.learning_rate,
        min_samples_split=cfg.min_samples_split,
        min_samples_leaf=cfg.min_samples_leaf,
        backend=backend,
    )
    params = forest_to_params(
        feature, threshold, value, is_split,
        init_raw=_prior_log_odds(yj.to(dtype)), learning_rate=cfg.learning_rate,
        max_depth=cfg.max_depth,
    )
    return params, {"train_deviance": deviance.cpu().numpy()}


def _fit_fused(X, y, cfg: GBDTConfig, backend: str, dev: torch.device):
    """The fused depth-1 'hist' regime of ``fit``."""
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


def _device_bins(binned, max_bins: int, dev: torch.device) -> torch.Tensor:
    """The bin matrix on ``dev``, one byte wide where ``max_bins <= 256``:
    it is the only O(n·F) array every tree level reads."""
    b = torch.as_tensor(binned, device=dev)
    return b.to(torch.uint8) if max_bins <= 256 else b


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


def fit_folds(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    train_masks: "np.ndarray | torch.Tensor",  # [k, n] 1.0 = row in that fold's fit
    cfg: GBDTConfig = GBDTConfig(),
    bins: binning.BinnedFeatures | None = None,
    *,
    device=None,
) -> TreeEnsembleParams:
    """All k masked fold fits at once — the stacking CV's GBDT fan-out and
    the CV sweep's fits. Returns batched params with a leading fold axis on
    the forest tensors, ``init_raw`` and ``learning_rate``.

    Fold masking rides the shared grower: excluded rows park at node −1 and
    carry zero gradient/hessian, so shapes are fold-independent, and each
    tree level of all k folds is one histogram call (on the card, one
    launch of the node kernel). By default candidate thresholds come from
    the full matrix's bins; ``cfg.per_fold_binning=True`` re-derives them
    from each fold's own rows (sklearn's per-refit enumeration), at the cost
    of a ``[k, n, F]`` bin tensor. The fits run in ``float_dtype(X)``.
    """
    dev = resolve_device(device)
    # The JAX package remaps 'pallas' off its fold fits (its kernel has no
    # vmap batching rule); the port's node kernel takes the fold axis itself.
    backend = resolve_backend(cfg, dev)
    masks = torch.as_tensor(to_host(train_masks), device=dev)
    k = masks.shape[0]
    dtype = float_dtype(torch.as_tensor(X))
    if bins is None and cfg.per_fold_binning:
        binned, thresholds, _, max_bins = _per_fold_bins(X, train_masks, cfg)
    else:
        if bins is None:
            bins = binning.bin_features(to_host(X), bin_budget_capped(cfg))
        binned, thresholds, max_bins = bins.binned, bins.thresholds, bins.max_bins
    feature, threshold, value, is_split, f0 = _run_binned_folds(
        _device_bins(binned, max_bins, dev),
        torch.as_tensor(thresholds, dtype=dtype, device=dev),
        torch.as_tensor(y, device=dev),
        masks,
        n_stages=cfg.n_estimators,
        depth=cfg.max_depth,
        max_bins=max_bins,
        learning_rate=cfg.learning_rate,
        min_samples_split=cfg.min_samples_split,
        min_samples_leaf=cfg.min_samples_leaf,
        backend=backend,
    )
    return _fold_params(feature, threshold, value, is_split, f0, cfg, k)


def _fold_params(feature, threshold, value, is_split, f0, cfg: GBDTConfig, k: int):
    NN = feature.shape[2]
    idx = torch.arange(NN, dtype=torch.int32, device=feature.device)[None, None, :]
    left = torch.where(is_split, 2 * idx + 1, idx).to(torch.int32)
    right = torch.where(is_split, 2 * idx + 2, idx).to(torch.int32)
    # Every tensor carries the leading fold axis (learning_rate included).
    return TreeEnsembleParams(
        feature=feature, threshold=threshold, left=left, right=right,
        value=value, init_raw=f0,
        learning_rate=torch.full((k,), cfg.learning_rate, dtype=threshold.dtype,
                                 device=threshold.device),
        max_depth=cfg.max_depth,
    )


def _per_fold_bins(X, train_masks, cfg: GBDTConfig):
    """Host-side per-fold candidate derivation: bin each fold's OWN rows
    (``bin_features`` on the physical subset — byte-for-byte sklearn's
    per-refit enumeration in the exact regime), then re-bin ALL rows
    against each fold's thresholds so shapes stay fold-independent
    (excluded rows carry valid ids but zero gradient/hessian — parked).

    Returns ``(binned [k, n, F] int32, thresholds [k, F, Wmax] (+inf
    padded), feature_bins tuple (per-feature max over folds), max_bins)``.
    """
    X = to_host(X)
    budget = bin_budget_capped(cfg)
    per_fold = [
        binning.bin_features(X[np.asarray(wk) > 0], budget)
        for wk in to_host(train_masks)
    ]
    k, (n, F) = len(per_fold), X.shape
    W = max(bf.thresholds.shape[1] for bf in per_fold)
    thr = np.full((k, F, W), np.inf)
    binned = np.zeros((k, n, F), np.int32)
    for i, bf in enumerate(per_fold):
        thr[i, :, : bf.thresholds.shape[1]] = bf.thresholds
        binned[i] = binning.rebin_with_thresholds(X, bf.thresholds, bf.n_bins)
    feature_bins = tuple(
        int(max(int(bf.n_bins[f]) for bf in per_fold)) for f in range(F)
    )
    return binned, thr, feature_bins, W + 1


def make_tree_grower(
    binned: torch.Tensor,      # [n, F] shared by the k fits, or [k, n, F]
    thresholds: torch.Tensor,  # [F, B-1], or [k, F, B-1]
    *,
    depth: int,
    max_bins: int,
    min_samples_split: int,
    min_samples_leaf: int,
    hist_fn,
    node_init: torch.Tensor | None = None,  # [k, n] int32, −1 ⇒ inactive row
    reduce_fn=lambda a: a,     # cross-shard reduction (a sum over data shards)
):
    """Build the level-synchronous tree-growth step: one copy of the split
    bookkeeping, routing and Newton-leaf math, for the single fit (k = 1)
    and the fold fits alike. A sharded caller would differ only in
    ``reduce_fn`` (histogram and leaf partials summed over shards) and
    ``node_init`` (padding rows parked at −1).

    Returns ``grow_tree(g, h) -> (feat_t, thr_t, val_t, split_t, node)``:
    for ``[k, n]`` gradients and hessians, k trees as ``[k, NN]`` heap-layout
    rows and each row's final ``[k, n]`` int32 node (parked rows stay −1).
    Node ids are int32 throughout, as the node kernel reads them.
    """
    n, F = binned.shape[-2:]
    NN = 2 ** (depth + 1) - 1
    dtype = thresholds.dtype
    dev = binned.device
    rows = torch.arange(n, device=dev)
    if binned.dim() == 3:  # flat offset of (fit, row) in the [k, n, F] matrix
        row_base = (torch.arange(binned.shape[0], device=dev)[:, None] * n + rows) * F
    else:
        row_base = rows * F
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)

    def leaf_sums(v: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
        # float64 accumulation: a float32 index_add_ over ~1M rows errs ~1e-4
        out = torch.zeros(k * (NN + 1), dtype=torch.float64, device=dev)
        out.index_add_(0, seg, v.reshape(-1).double())
        return reduce_fn(out.reshape(k, NN + 1)[:, :NN].to(dtype))

    def grow_tree(g: torch.Tensor, h: torch.Tensor):
        k = g.shape[0]
        node = (torch.zeros((k, n), dtype=torch.int32, device=dev) if node_init is None
                else node_init)
        feat_t = torch.zeros((k, NN), dtype=torch.int32, device=dev)
        thr_t = torch.full((k, NN), torch.inf, dtype=dtype, device=dev)
        split_t = torch.zeros((k, NN), dtype=torch.bool, device=dev)
        for level in range(depth):
            base = 2**level - 1
            K = 2**level
            node_local = torch.where(node >= base, node - base, -1)
            hl = hist_fn(binned, node_local, g, h, K, max_bins)
            hists = histogram.NodeHistograms(*(reduce_fn(a) for a in hl))
            sp = histogram.best_splits(hists, thresholds, min_samples_split, min_samples_leaf)
            feat_t[:, base:base + K] = torch.where(sp.do_split, sp.feature, 0).to(torch.int32)
            thr_t[:, base:base + K] = torch.where(sp.do_split, sp.threshold, inf).to(dtype)
            split_t[:, base:base + K] = sp.do_split
            # Route rows of split nodes to their children; others park.
            kk = torch.clamp_min(node_local, 0).long()  # gather's index dtype
            splits_here = (node_local >= 0) & torch.gather(sp.do_split, 1, kk)
            col = torch.take(binned, row_base + torch.gather(sp.feature, 1, kk))
            go_left = col <= torch.gather(sp.boundary, 1, kk)
            child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
            node = torch.where(splits_here, child, node)
        # Newton leaf values over final row positions (inactive rows → dump
        # segment NN of their fit, which is dropped)
        fit_base = torch.arange(k, device=dev)[:, None] * (NN + 1)
        seg = (torch.where(node >= 0, node, NN) + fit_base).reshape(-1)
        val_t = histogram.newton_leaf_value(leaf_sums(g, seg, k), leaf_sums(h, seg, k))
        return feat_t, thr_t, val_t, split_t, node

    return grow_tree


def _binned_init(thresholds: torch.Tensor, y: torch.Tensor, n_stages: int, depth: int):
    """Boosting carry at stage 0 for the level-wise path (the
    checkpoint/resume unit): raw scores, the four forest tensors, deviance."""
    n = y.shape[0]
    NN = 2 ** (depth + 1) - 1
    dtype = thresholds.dtype
    dev = y.device
    f0 = _prior_log_odds(y.to(dtype))
    return (
        f0.expand(n).clone(),
        torch.zeros((n_stages, NN), dtype=torch.int32, device=dev),
        torch.full((n_stages, NN), torch.inf, dtype=dtype, device=dev),
        torch.zeros((n_stages, NN), dtype=dtype, device=dev),
        torch.zeros((n_stages, NN), dtype=torch.bool, device=dev),
        torch.zeros(n_stages, dtype=dtype, device=dev),
    )


def _fit_binned(
    binned: torch.Tensor,      # [n, F] integer bin ids
    thresholds: torch.Tensor,  # [F, B-1]
    y: torch.Tensor,           # [n] ∈ {0, 1}
    *,
    n_stages: int,
    depth: int,
    max_bins: int,
    learning_rate: float,
    min_samples_split: int,
    min_samples_leaf: int,
    backend: str = "xla",
):
    """All stages of one level-wise fit → ``(feature, threshold, value,
    is_split, deviance)``."""
    carry = _run_binned(
        binned, thresholds, y,
        _binned_init(thresholds, y, n_stages, depth),
        0, n_stages,
        depth=depth, max_bins=max_bins, learning_rate=learning_rate,
        min_samples_split=min_samples_split, min_samples_leaf=min_samples_leaf,
        backend=backend,
    )
    return carry[1:]


def _run_binned(
    binned: torch.Tensor,      # [n, F] integer bin ids
    thresholds: torch.Tensor,  # [F, B-1]
    y: torch.Tensor,           # [n] ∈ {0, 1}
    carry,
    start: int,
    stop: int,
    *,
    depth: int,
    max_bins: int,
    learning_rate: float,
    min_samples_split: int,
    min_samples_leaf: int,
    backend: str = "xla",
):
    """Stages ``[start, stop)`` of a level-wise fit from ``carry``
    (``_binned_init``'s layout). The forest and deviance tensors of the carry
    are written in place; the new carry is returned."""
    dtype = thresholds.dtype
    yf = y.to(dtype)
    grow_tree = make_tree_grower(
        binned, thresholds,
        depth=depth, max_bins=max_bins,
        min_samples_split=min_samples_split,
        min_samples_leaf=min_samples_leaf,
        hist_fn=resolve_hist_fn(backend),
    )
    raw, feats, thrs, vals, splits, devs = carry
    zero = torch.zeros((), dtype=dtype, device=yf.device)
    for t in range(start, stop):
        p = torch.sigmoid(raw)
        g = yf - p          # residual (negative gradient of deviance)
        h = p * (1.0 - p)   # Newton denominator terms
        feat_t, thr_t, val_t, split_t, node = grow_tree(g[None], h[None])
        raw = raw + learning_rate * val_t[0][node[0].long()]
        devs[t] = -2.0 * torch.mean(yf * raw - torch.logaddexp(zero, raw))
        feats[t], thrs[t], vals[t], splits[t] = feat_t[0], thr_t[0], val_t[0], split_t[0]
    return raw, feats, thrs, vals, splits, devs


def _run_binned_folds(
    binned: torch.Tensor,       # [n, F] shared, or [k, n, F] per fold
    thresholds: torch.Tensor,   # [F, B-1] shared, or [k, F, B-1]
    y: torch.Tensor,            # [n]
    train_masks: torch.Tensor,  # [k, n]
    *,
    n_stages: int,
    depth: int,
    max_bins: int,
    learning_rate: float,
    min_samples_split: int,
    min_samples_leaf: int,
    backend: str,
):
    """All stages of k masked fits at once → ``(feature, threshold, value,
    is_split [k, n_stages, NN], f0 [k])``."""
    dtype = thresholds.dtype
    yf = y.to(dtype)
    w = train_masks.to(dtype)
    k, n = w.shape
    NN = 2 ** (depth + 1) - 1
    dev = yf.device
    p1 = torch.sum(yf * w, dim=1) / torch.sum(w, dim=1)
    f0 = torch.log(p1 / (1.0 - p1))
    grow_tree = make_tree_grower(
        binned, thresholds,
        depth=depth, max_bins=max_bins,
        min_samples_split=min_samples_split,
        min_samples_leaf=min_samples_leaf,
        hist_fn=resolve_hist_fn(backend),
        node_init=torch.where(w > 0, 0, -1).to(torch.int32),
    )
    raw = f0[:, None].expand(k, n).clone()
    feats = torch.zeros((k, n_stages, NN), dtype=torch.int32, device=dev)
    thrs = torch.full((k, n_stages, NN), torch.inf, dtype=dtype, device=dev)
    vals = torch.zeros((k, n_stages, NN), dtype=dtype, device=dev)
    splits = torch.zeros((k, n_stages, NN), dtype=torch.bool, device=dev)
    for t in range(n_stages):
        p = torch.sigmoid(raw)
        g = (yf - p) * w
        h = p * (1.0 - p) * w
        feat_t, thr_t, val_t, split_t, node = grow_tree(g, h)
        raw = raw + learning_rate * torch.gather(val_t, 1, torch.clamp_min(node, 0).long()) * w
        feats[:, t], thrs[:, t], vals[:, t], splits[:, t] = feat_t, thr_t, val_t, split_t
    return feats, thrs, vals, splits, f0

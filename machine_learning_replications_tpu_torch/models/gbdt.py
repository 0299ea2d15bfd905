"""Gradient-boosted trees — training.

Port of the JAX package's ``models/gbdt.py``. ``fit`` routes as the JAX
``fit`` does, over three engines:

  * depth 1 (``_fit_stumps``): every boosting stage over the loop-invariant
    ``[n, F]`` bin matrix, each stage's split statistics from one stump
    histogram pass — the hand-written CUDA stump kernel on the card — and a
    cumulative sum over bins. The bins come from device quantile binning on
    the fused 'hist' path (at least ``DEVICE_BINNING_MIN_ROWS`` rows, u8
    ids), else from host binning: 'exact' takes every unique-value midpoint
    (up to n + 1 bins, int32 ids), 'hist' below the row gate its
    quantile-capped midpoints;
  * the host single-stump engine ``_fit_stump_host`` (``n_estimators == 1``
    at the fused path's shape with host inputs), host numpy only;
  * the level-wise stage loop ``run_levelwise`` (``max_depth >= 2`` in
    ``fit``, every depth in ``fit_folds``; also ``fit_resumable`` and the
    sharded ``parallel.hist_trainer``): each tree is built level by level
    by the one grower (``make_tree_grower``) from per-(node, feature, bin)
    histograms, friedman split selection and Newton leaves from float64
    leaf sums, in heap layout (root 0, children 2i+1 / 2i+2; non-split nodes
    self-loop).

``histogram_kernels`` is the one place the histogram entries are chosen
from ``cfg.histogram_backend``: the hand-written CUDA kernels
(``ops.cuda_histogram``; their plain versions on a CPU tensor) or the plain
versions (``ops.histogram``) on any device.

Numerics match sklearn's binomial-deviance GBC as the JAX fit does:
F₀ = prior log-odds, residual r = y − σ(F), leaves re-valued by the Newton
step Σr / Σp(1−p) (0 where |den| < 1e-150 in float64, where den == 0
below float64: ``ops.histogram.newton_leaf_value``), F += lr·leaf, and
``train_deviance[m] = −2·mean(y·F − log(1+eᶠ))``.

The stage loops are eager PyTorch with no host sync: split columns and rows
are picked with ``index_select``/``gather``/``take`` on device indices,
per-stage results are written into preallocated tensors, and the binning
NaN flag is read once, after the loop. The level-wise loop carries a
leading fit axis ``k`` (1 for ``fit``, the folds for ``fit_folds``), so all
of a level's folds share one histogram launch — where the JAX package
``vmap``s the folds and so keeps its Pallas kernel off them. Per-row weights
(the fold masks, the sharded fit's padding and sample weights) and a
cross-shard ``reduce_fn`` are its only other differences.

Each layer boundary is an ``obs.spans.region`` (free with no tracer
installed; it launches nothing and never waits): ``gbdt.fit`` per call,
``gbdt.binning`` (the bins, their device copy and, at depth 1, the per-bin
row counts), and per stage ``gbdt.stage`` (``t``) holding ``gbdt.grad``,
``gbdt.hist``, ``gbdt.split``, ``gbdt.route`` (each per ``level``), the
grower's ``gbdt.leaf_sums`` and ``gbdt.update``.

``fit_resumable`` runs the same stage loops in chunks, checkpointing the
boosting carry (``persist.checkpoint.save_step``) after each, and
``scaled_member_cfg`` is the stacking member's splitter switch at scale.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.device import float_dtype, resolve_device, to_host
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams
from machine_learning_replications_tpu_torch.obs.spans import region
from machine_learning_replications_tpu_torch.ops import binning, histogram

# 'hist'-mode fits at or above this row count quantise on device (and at
# depth 1 take the fused path) — the JAX package's threshold, kept so both
# route alike.
DEVICE_BINNING_MIN_ROWS = 100_000


def uses_device_binning(cfg: GBDTConfig, n_rows: int) -> bool:
    """The binning gate: device quantiles for 'hist' fits at scale, host
    unique-value midpoints everywhere else."""
    return cfg.splitter == "hist" and n_rows >= DEVICE_BINNING_MIN_ROWS


def default_bins(X: torch.Tensor, cfg: GBDTConfig, device: torch.device, *,
                 capped: bool = False) -> binning.BinnedFeatures:
    """Binning policy for a fit that wasn't handed bins explicitly: device
    quantiles on ``device`` for 'hist' at scale, else host unique-value
    midpoints (under ``bin_budget_capped`` with ``capped``, as the fold
    fits bin)."""
    if uses_device_binning(cfg, X.shape[0]):
        return binning.bin_features_device(X.to(device), cfg.n_bins)
    return binning.bin_features(to_host(X), bin_budget_capped(cfg) if capped else bin_budget(cfg))


def uses_fused_hist1(cfg: GBDTConfig, n_rows: int) -> bool:
    """``fit``'s fused-path gate — config and shape only."""
    return cfg.max_depth == 1 and uses_device_binning(cfg, n_rows)


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


class HistogramKernels(NamedTuple):
    """The three histogram entries a fit calls."""

    stump: Callable  # (binned [n, F], g [n], h [n], B) -> [2, F, B]
    node: Callable   # (binned, node_local, g, h, K, B) -> histogram.NodeHistograms
    leaf: Callable   # (node [k, n], g [k, n], h [k, n], k, NN) -> [2, k, NN + 1] float64


def histogram_kernels(cfg: GBDTConfig) -> HistogramKernels:
    """The one place a fit's histogram entries are chosen, from
    ``cfg.histogram_backend``. The field keeps the JAX package's four values;
    the port has two behaviours: 'auto' and 'pallas' take the hand-written
    kernels (``ops.cuda_histogram``, each of which computes its plain version
    on a CPU tensor), 'xla' and 'matmul' the plain versions
    (``ops.histogram``) on any device."""
    b = cfg.histogram_backend
    if b in ("auto", "pallas"):
        from machine_learning_replications_tpu_torch.ops import cuda_histogram

        return HistogramKernels(cuda_histogram.stump_histograms_cuda,
                                cuda_histogram.node_histograms_cuda,
                                cuda_histogram.leaf_sums_cuda)
    if b in ("xla", "matmul"):
        return HistogramKernels(histogram.stump_histograms_reference,
                                histogram.node_histograms, histogram.leaf_sums)
    raise ValueError(f"unknown histogram_backend {b!r}; "
                     "expected 'auto', 'matmul', 'pallas' or 'xla'")


def _same(a: torch.Tensor) -> torch.Tensor:
    return a


def _prior_log_odds(y: torch.Tensor, weights: torch.Tensor | None = None,
                    reduce_fn=_same) -> torch.Tensor:
    """F₀ = log-odds of the class prior, as a device scalar (no sync); with
    ``[k, n]`` weights, ``[k]`` weighted priors from one ``reduce_fn`` of the
    stacked row sums."""
    if weights is None:
        p1 = torch.mean(y)
    else:
        n_real, sum_y = reduce_fn(torch.stack([torch.sum(weights, dim=1),
                                               torch.sum(y * weights, dim=1)]))
        p1 = sum_y / n_real
    return torch.log(p1 / (1.0 - p1))


def forest_to_params(
    feature: torch.Tensor,    # [M, NN] int32, or [k, M, NN]
    threshold: torch.Tensor,  # [M, NN], or [k, M, NN]
    value: torch.Tensor,      # [M, NN], or [k, M, NN]
    is_split: torch.Tensor,   # [M, NN] bool, or [k, M, NN]
    init_raw: torch.Tensor,   # scalar, or [k]
    learning_rate: float,
    max_depth: int,
) -> TreeEnsembleParams:
    """Heap-layout forest tensors → the inference dataclass (self-loop
    leaves). With a leading fit axis (``fit_folds``) every tensor carries
    it, ``learning_rate`` included."""
    dev = feature.device
    idx = torch.arange(feature.shape[-1], dtype=torch.int32, device=dev)
    left = torch.where(is_split, 2 * idx + 1, idx).to(torch.int32)
    right = torch.where(is_split, 2 * idx + 2, idx).to(torch.int32)
    return TreeEnsembleParams(
        feature=feature,
        threshold=threshold,
        left=left,
        right=right,
        value=value,
        init_raw=torch.as_tensor(init_raw, device=dev),
        # filled on the host and copied: no fill kernel on the card
        learning_rate=torch.full(feature.shape[:-2], learning_rate, dtype=value.dtype).to(dev),
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
    on every other path, as in the JAX package.

    Four regimes, routed as the JAX ``fit`` routes them:

      * ``n_estimators == 1`` on the fused path's shape with host numpy
        inputs: ``_fit_stump_host`` (host numpy, no device work);
      * 'hist' at depth 1 and at least ``DEVICE_BINNING_MIN_ROWS`` rows:
        ``_fit_fused`` (device quantile binning, then the stage loop);
      * any other depth-1 fit ('exact', or 'hist' below the row gate): host
        binning, then the same stage loop over the host bins
        (``_fit_stumps``) — under 'exact' every unique-value midpoint is a
        candidate, so the bins go to the kernel as int32 above 256;
      * ``max_depth >= 2``: the level-wise stage loop (``run_levelwise``).

    The fit runs in ``float_dtype(X)``.
    """
    with region("gbdt.fit"):
        dev = resolve_device(device)
        kernels = histogram_kernels(cfg)  # validate eagerly
        bin_budget(cfg)                   # validates the splitter
        n = X.shape[0]
        if (cfg.max_depth == 1 and cfg.n_estimators == 1 and uses_fused_hist1(cfg, n)
                and isinstance(X, np.ndarray) and isinstance(y, np.ndarray)):
            return _fit_stump_host(X, y, cfg, dev)
        if uses_fused_hist1(cfg, n):
            return _fit_fused(X, y, cfg, kernels, dev)
        Xt = torch.as_tensor(X)
        dtype = float_dtype(Xt)
        ys = torch.as_tensor(y, device=dev).to(dtype)
        with region("gbdt.binning"):
            bins = default_bins(Xt, cfg, dev)
            binned = _device_bins(bins.binned, bins.max_bins, dev)
            thresholds = torch.as_tensor(bins.thresholds, dtype=dtype, device=dev)
            if cfg.max_depth == 1:
                counts = _stump_counts(binned, thresholds)
        if cfg.max_depth == 1:
            feature, threshold, value, is_split, deviance, _ = _fit_stumps(
                binned, thresholds, counts, ys, cfg, kernels)
        else:
            carry = levelwise_init(_prior_log_odds(ys), ys.shape[0], cfg.n_estimators,
                                   cfg.max_depth)
            grow_tree = make_tree_grower(
                binned, thresholds, depth=cfg.max_depth, max_bins=bins.max_bins,
                min_samples_split=cfg.min_samples_split,
                min_samples_leaf=cfg.min_samples_leaf, kernels=kernels)
            _, feature, threshold, value, is_split, deviance = run_levelwise(
                grow_tree, ys, carry, 0, cfg.n_estimators, learning_rate=cfg.learning_rate)
        params = forest_to_params(
            feature, threshold, value, is_split,
            init_raw=_prior_log_odds(ys), learning_rate=cfg.learning_rate,
            max_depth=cfg.max_depth,
        )
        return params, {"train_deviance": deviance.cpu().numpy()}


def _fit_fused(X, y, cfg: GBDTConfig, kernels: HistogramKernels, dev: torch.device):
    """The fused depth-1 'hist' regime of ``fit``: quantile binning on the
    device (u8 ids up to 256 bins), then ``_fit_stumps``. The binning NaN
    flag is read once, after every stage is queued."""
    Xj = torch.as_tensor(X, device=dev)
    with region("gbdt.binning"):
        binned, mids, nan_flag = binning.device_binning_core(Xj, cfg.n_bins)
        if cfg.n_bins <= 256:
            # the only O(n·F) array each stage reads — keep it one byte wide
            binned = binned.to(torch.uint8)
        thresholds = mids.T.contiguous()                     # [F, B-1]
        counts = _stump_counts(binned, thresholds)
    feature, threshold, value, is_split, deviance, f0 = _fit_stumps(
        binned, thresholds, counts, torch.as_tensor(y, device=dev).to(thresholds.dtype),
        cfg, kernels)
    if bool(nan_flag):
        raise ValueError("input contains NaN; impute before binning")
    params = forest_to_params(
        feature, threshold, value, is_split,
        init_raw=f0, learning_rate=cfg.learning_rate, max_depth=1,
    )
    return params, {"train_deviance": deviance}


def fit_resumable(
    X: "np.ndarray | torch.Tensor",
    y: "np.ndarray | torch.Tensor",
    cfg: GBDTConfig = GBDTConfig(),
    *,
    checkpoint_dir: str,
    checkpoint_every: int = 10,
    bins: binning.BinnedFeatures | None = None,
    _interrupt_after_chunks: int | None = None,
    device=None,
) -> tuple[TreeEnsembleParams, dict[str, Any]]:
    """``fit`` with checkpoint-and-restart every ``checkpoint_every`` boosting
    stages, on host bins (``bin_budget(cfg)``) at every depth.

    The checkpoint unit is the boosting carry (raw scores, the forest
    tensors, the deviance path), published as ``step_<stages done>`` under
    ``checkpoint_dir`` (``persist.checkpoint.save_step``, the newest two
    kept). On entry the newest step that loads is restored and training
    continues from there. The stages are deterministic on the CPU, so a
    resumed fit is bit-identical to an unbroken one there; on the card the
    histogram kernel's float atomics add in no fixed order, so two fits —
    resumed or not — agree to rounding.

    ``_interrupt_after_chunks`` is a test hook: raise ``SimulatedInterrupt``
    after that many chunks to emulate preemption."""
    from machine_learning_replications_tpu_torch.persist import checkpoint

    dev = resolve_device(device)
    kernels = histogram_kernels(cfg)
    dtype = float_dtype(torch.as_tensor(X))
    if bins is None:
        bins = binning.bin_features(to_host(X), bin_budget(cfg))
    binned = _device_bins(bins.binned, bins.max_bins, dev)
    thresholds = torch.as_tensor(bins.thresholds, dtype=dtype, device=dev)
    ys = torch.as_tensor(y, device=dev).to(dtype)
    n_stages = cfg.n_estimators
    if cfg.max_depth == 1:
        carry = _stump_init(ys, _prior_log_odds(ys), n_stages)
        counts = _stump_counts(binned, thresholds)

        def run(carry, s, e):
            return _run_stumps(binned, thresholds, counts, ys, carry, s, e, cfg, kernels)
    else:
        carry = levelwise_init(_prior_log_odds(ys), ys.shape[0], n_stages, cfg.max_depth)
        grow_tree = make_tree_grower(
            binned, thresholds, depth=cfg.max_depth, max_bins=bins.max_bins,
            min_samples_split=cfg.min_samples_split, min_samples_leaf=cfg.min_samples_leaf,
            kernels=kernels)

        def run(carry, s, e):
            return run_levelwise(grow_tree, ys, carry, s, e, learning_rate=cfg.learning_rate)

    start, restored = checkpoint.restore_latest_step(checkpoint_dir, device=dev)
    if start:
        carry = restored
    chunks_done = 0
    for s in range(start, n_stages, checkpoint_every):
        e = min(s + checkpoint_every, n_stages)
        carry = run(carry, s, e)
        checkpoint.save_step(checkpoint_dir, e, carry)
        chunks_done += 1
        if (_interrupt_after_chunks is not None and chunks_done >= _interrupt_after_chunks
                and e < n_stages):
            raise checkpoint.SimulatedInterrupt(f"after stage {e}")

    _, feats, thrs, vals, splits, devs = carry
    params = forest_to_params(
        feats, thrs, vals, splits, init_raw=_prior_log_odds(ys),
        learning_rate=cfg.learning_rate, max_depth=cfg.max_depth,
    )
    return params, {"train_deviance": to_host(devs)}


# The JAX package's depth-1 'exact' fit lays rows out sorted, replicated per
# feature, and refuses a layout past this budget; its pipeline member
# switches to 'hist' before that (``scaled_member_cfg``). The port has no
# sorted layout, but keeps the estimate and its constants (the JAX
# ``ops/histogram.py`` blocked-boundary threshold and block) so the member
# switches splitter at the same row counts as in JAX.
_STUMP_LAYOUT_BYTES_BUDGET = 4 << 30
_BLOCKED_BOUNDARY_MIN_N = 16_384
_BOUNDARY_BLOCK = 512


def _stump_layout_bytes(n: int, F: int, B: int) -> int:
    """The JAX depth-1 sorted layout's dominant allocations at ``B`` split
    candidates: the ``[F, F, n]`` bins tensor plus (above the
    blocked-boundary threshold) the per-stage ``[F, B-1, block]``
    boundary-partial buffer."""
    itemsize = 1 if B <= 256 else 2 if B <= 65536 else 4
    est = F * F * n * itemsize
    if n >= _BLOCKED_BOUNDARY_MIN_N:
        est += F * max(B - 1, 1) * _BOUNDARY_BLOCK * 8
    return est


def scaled_member_cfg(cfg: GBDTConfig, n_rows: int, n_features: int) -> GBDTConfig:
    """The pipeline's full-data GBDT member config at scale: a depth-1
    'exact' config switches to 'hist' at device-binning scale, or where the
    JAX sorted layout's worst case (B ≈ n) would pass its budget — the JAX
    package's rule, so both packages fit the same member at every row count.
    Other configs pass through."""
    import dataclasses

    if cfg.splitter != "exact" or cfg.max_depth != 1:
        return cfg
    if n_rows >= DEVICE_BINNING_MIN_ROWS or (
        _stump_layout_bytes(n_rows, n_features, n_rows) > _STUMP_LAYOUT_BYTES_BUDGET
    ):
        return dataclasses.replace(cfg, splitter="hist")
    return cfg


def _device_bins(binned, max_bins: int, dev: torch.device) -> torch.Tensor:
    """The bin matrix on ``dev``, one byte wide where ``max_bins <= 256``:
    it is the only O(n·F) array every tree level reads."""
    b = torch.as_tensor(binned, device=dev)
    return b.to(torch.uint8) if max_bins <= 256 else b


def _left_counts(binned: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``[F, B-1]`` int64: the rows with bin ≤ b, per feature — loop-invariant,
    one integer ``bincount`` per feature (exact on any device)."""
    counts = torch.stack([torch.bincount(binned[:, f].long(), minlength=n_bins)
                          for f in range(binned.shape[1])])
    return torch.cumsum(counts, dim=1)[:, :-1]


def _stump_counts(binned: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """``[1, F, B-1]``: ``_left_counts`` in the fit's dtype, as the depth-1
    stage loop reads them; part of a depth-1 fit's binning."""
    return _left_counts(binned, thresholds.shape[1] + 1).to(thresholds.dtype)[None]


def _fit_stumps(
    binned: torch.Tensor,      # [n, F] integer bin ids (uint8, or int32 past 256 bins)
    thresholds: torch.Tensor,  # [F, B-1], +inf past a feature's last boundary
    counts: torch.Tensor,      # [1, F, B-1] rows with bin <= b (_stump_counts)
    ys: torch.Tensor,          # [n] labels in the working dtype
    cfg: GBDTConfig,
    kernels: HistogramKernels,
):
    """All ``cfg.n_estimators`` stages of a depth-1 fit over the
    loop-invariant bin matrix → ``(feature, threshold, value, is_split,
    deviance, f0)``, the forest in ``[n_stages, 3]`` heap layout, all on
    ``binned``'s device."""
    f0 = _prior_log_odds(ys)
    carry = _run_stumps(binned, thresholds, counts, ys, _stump_init(ys, f0, cfg.n_estimators),
                        0, cfg.n_estimators, cfg, kernels)
    return (*carry[1:], f0)


def _stump_init(ys: torch.Tensor, f0: torch.Tensor, n_stages: int):
    """Depth-1 boosting carry at stage 0 (the checkpoint/resume unit): raw
    scores, the four ``[n_stages, 3]`` forest tensors, deviance."""
    n, dtype, dev = ys.shape[0], ys.dtype, ys.device
    return (
        torch.full((n,), 0.0, dtype=dtype, device=dev) + f0,
        torch.zeros((n_stages, 3), dtype=torch.int32, device=dev),
        torch.full((n_stages, 3), torch.inf, dtype=dtype, device=dev),
        torch.zeros((n_stages, 3), dtype=dtype, device=dev),
        torch.zeros((n_stages, 3), dtype=torch.bool, device=dev),
        torch.zeros(n_stages, dtype=dtype, device=dev),
    )


def _run_stumps(
    binned: torch.Tensor,
    thresholds: torch.Tensor,
    CL: torch.Tensor,
    ys: torch.Tensor,
    carry,
    start: int,
    stop: int,
    cfg: GBDTConfig,
    kernels: HistogramKernels,
):
    """Stages ``[start, stop)`` of a depth-1 fit from ``carry``
    (``_stump_init``'s layout) and the per-bin row counts ``CL``
    (``_stump_counts``); the forest and deviance tensors are written in
    place and the new carry is returned.

    The one stage loop of both depth-1 device regimes: the fused fit (device
    quantile bins, u8) and the host-binned fit (the JAX package's
    ``_fit_stumps``: 'exact' unique-value midpoints, or 'hist' below the
    device-binning gate). The JAX ``_fit_stumps`` reads boundary sums off a
    replicated sorted ``[F, F, n]`` layout because the TPU serialises
    scatters and gathers; here each stage's split statistics come from one
    ``kernels.stump`` pass (on the card, the hand-written stump
    kernel, at B = n + 1 bins under 'exact' on a continuous column) and a
    cumulative sum over bins — the same sums, added in another order.
    No host sync: split columns are picked with ``index_select`` on device
    indices and per-stage results go into preallocated tensors.
    """
    n, F = binned.shape
    n_bins = thresholds.shape[1] + 1
    dtype = thresholds.dtype
    dev = binned.device
    learning_rate = cfg.learning_rate
    CT = torch.tensor([n], dtype=dtype, device=dev)
    Bm1 = n_bins - 1

    raw, feats, thrs, vals, splits, devs = carry
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.full((1,), torch.inf, dtype=dtype, device=dev)
    no_split = torch.zeros(2, dtype=torch.bool, device=dev)
    feat_mask = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)

    for t in range(start, stop):
        with region("gbdt.stage", t=t):
            with region("gbdt.grad"):
                p = torch.sigmoid(raw)
                g = ys - p
                h = p * (1.0 - p)
            with region("gbdt.hist", level=0):
                hist = kernels.stump(binned, g, h, n_bins)
            with region("gbdt.split", level=0):
                GL = torch.cumsum(hist[0], dim=1)[:, :-1][None]  # [1, F, B-1]
                HL = torch.cumsum(hist[1], dim=1)[:, :-1]        # [F, B-1]
                GT = torch.sum(g)
                HT = torch.sum(h)
                sp = histogram.select_splits(
                    GL, CL, GT[None], CT, torch.sum(g * g)[None], thresholds,
                    cfg.min_samples_split, cfg.min_samples_leaf,
                )
                do = sp.do_split                                 # [1]
                fstar, bstar = sp.feature, sp.boundary           # [1] each
                best = fstar * Bm1 + bstar
                num_l = GL.reshape(-1).index_select(0, best)
                den_l = HL.reshape(-1).index_select(0, best)
                num_r, den_r = GT - num_l, HT - den_l

                newton = histogram.newton_leaf_value
                v_root = newton(GT, HT)[None]  # unsplit stage: single-leaf Newton value
                v_l, v_r = newton(num_l, den_l), newton(num_r, den_r)

                feats[t] = torch.where(do, fstar, 0).to(torch.int32) * feat_mask
                thrs[t] = torch.cat([torch.where(do, sp.threshold, inf), inf, inf])
                vals[t] = torch.cat([torch.where(do, zero, v_root), torch.where(do, v_l, zero),
                                     torch.where(do, v_r, zero)])
                splits[t] = torch.cat([do, no_split])
            with region("gbdt.route", level=0):
                split_bins = binned.index_select(1, fstar)[:, 0]    # [n]
                go_left = split_bins.long() <= bstar
            with region("gbdt.update"):
                contrib = torch.where(do, torch.where(go_left, v_l, v_r), v_root)
                raw = raw + learning_rate * contrib
                devs[t] = -2.0 * torch.mean(ys * raw - torch.logaddexp(zero, raw))

    return raw, feats, thrs, vals, splits, devs


# Host single-stump engine: quantile candidates come from a systematic
# subsample above this many rows (the JAX package's constant).
_STUMP_CANDIDATE_SAMPLE = 131_072


def _fit_stump_host(
    X: np.ndarray, y: np.ndarray, cfg: GBDTConfig, dev: torch.device
) -> tuple[TreeEnsembleParams, dict[str, Any]]:
    """Single-stump fit in host numpy, threaded over columns (the JAX
    package's ``_fit_stump_host``, copied in its semantics).

    The one-shot regime (``n_estimators == 1`` at device-binning scale, host
    inputs). At stage 0 the raw score is the constant prior ``f0``, so
    ``p = mean(y)``, the hessian ``p(1-p)`` is one scalar, and the split
    search needs only a per-feature label histogram and count histogram.
    Candidates follow ``binning.device_binning_core`` (empirical-quantile
    candidates, the same midpoint guard, bin = ``#{mids < v}``) with the
    JAX engine's two deviations: above ``_STUMP_CANDIDATE_SAMPLE`` rows the
    candidates come from a systematic row subsample, and duplicate midpoints
    are deduplicated (the same partitions). Selection, leaf values and the
    deviance use the friedman proxy, the Newton guard and the binomial
    deviance, accumulated in float64. The forest lands on ``dev`` in the
    fit's working dtype (``float_dtype(X)``); ``train_deviance`` is a host
    array.
    """
    n, F = X.shape
    B = cfg.n_bins
    if np.isnan(X).any():
        raise ValueError("input contains NaN; impute before binning")
    fdt = np.float64 if X.dtype == np.float64 else np.float32   # float_dtype(X)
    y64 = np.asarray(y, np.float64)
    p1 = float(y64.mean())
    f0 = float(np.log(p1 / (1.0 - p1)))
    h_const = p1 * (1.0 - p1)
    binary_y = histogram.is_binary_labels(np.asarray(y))
    y_bool = np.asarray(y) > 0.5 if binary_y else None
    # round-based: keeps the sample near the documented target
    step = max(1, round(n / _STUMP_CANDIDATE_SAMPLE))

    def col_stats(f):
        col = X[:, f]
        src = col[::step] if step > 1 else col
        m = src.shape[0]
        q_idx = np.round(np.linspace(0.0, 1.0, B) * (m - 1)).astype(np.int64)
        cs = np.partition(src, q_idx)      # kth element == full sort[q_idx]
        u = cs[q_idx]
        mids = ((u[:-1] + u[1:]) / 2.0).astype(col.dtype)
        # sklearn BestSplitter guard, as in device_binning_core
        mids = np.where(mids == u[1:], u[:-1], mids)
        mids = np.unique(mids)             # dedupe: same partitions, less work
        b = np.searchsorted(mids, col, side="left")    # == #{mids < v}
        cnt = np.bincount(b, minlength=B).astype(np.float64)
        if binary_y:
            sy = np.bincount(b[y_bool], minlength=B).astype(np.float64)
        else:
            sy = np.bincount(b, weights=y64, minlength=B)
        thr = np.full(B - 1, np.inf)
        thr[: mids.shape[0]] = mids.astype(np.float64)
        return thr, cnt, sy

    workers = max(1, min(F, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as ex:
        per_col = list(ex.map(col_stats, range(F)))
    thresholds = np.stack([r[0] for r in per_col])         # [F, B-1]
    CNT = np.stack([r[1] for r in per_col])                # [F, B]
    SY = np.stack([r[2] for r in per_col])                 # [F, B]

    # select_splits' math, float64 host edition (K = 1)
    hist_g = SY - p1 * CNT
    GL = np.cumsum(hist_g, axis=1)[:, :-1]                 # [F, B-1]
    CL = np.cumsum(CNT, axis=1)[:, :-1]
    SYL = np.cumsum(SY, axis=1)[:, :-1]
    GT = float(hist_g[0].sum())
    HT = n * h_const
    CR = n - CL
    GR = GT - GL
    valid = (
        (CL >= cfg.min_samples_leaf)
        & (CR >= cfg.min_samples_leaf)
        & np.isfinite(thresholds)
    )
    diff = GL / np.maximum(CL, 1) - GR / np.maximum(CR, 1)
    proxy = np.where(valid, diff * diff * CL * CR, -np.inf)
    best = int(np.argmax(proxy))                           # flat (f, b) order
    Bm1 = B - 1
    fstar, bstar = best // Bm1, best % Bm1
    best_gain = proxy[fstar, bstar]

    sum_g2 = float(np.dot(y64 - p1, y64 - p1))
    impurity = max(sum_g2 / max(n, 1) - (GT / max(n, 1)) ** 2, 0.0)
    do = bool(
        (n >= cfg.min_samples_split)
        and (impurity > histogram.IMPURITY_EPS)
        and np.isfinite(best_gain)
    )

    def newton(num, den):
        return 0.0 if abs(den) < histogram.NEWTON_DEN_GUARD else num / den

    num_l, den_l = GL[fstar, bstar], h_const * CL[fstar, bstar]
    v_root = newton(GT, HT)
    v_l = newton(num_l, den_l)
    v_r = newton(GT - num_l, HT - den_l)

    # binomial deviance of the updated scores — raw takes only two values
    # (or one, unsplit), so the mean reduces to histogram aggregates
    lr = cfg.learning_rate
    if do:
        n_l, sum_y_l = CL[fstar, bstar], SYL[fstar, bstar]
        raw_l, raw_r = f0 + lr * v_l, f0 + lr * v_r
        ll = (
            sum_y_l * raw_l + (y64.sum() - sum_y_l) * raw_r
            - n_l * np.logaddexp(0.0, raw_l)
            - (n - n_l) * np.logaddexp(0.0, raw_r)
        )
    else:
        raw0 = f0 + lr * v_root
        ll = y64.sum() * raw0 - n * np.logaddexp(0.0, raw0)
    dev_ = -2.0 * ll / n

    tensor = lambda a: torch.as_tensor(np.asarray(a, fdt), device=dev)  # noqa: E731
    params = forest_to_params(
        torch.tensor([[fstar if do else 0, 0, 0]], dtype=torch.int32, device=dev),
        tensor([[thresholds[fstar, bstar] if do else np.inf, np.inf, np.inf]]),
        tensor([[0.0, v_l, v_r] if do else [v_root, 0.0, 0.0]]),
        torch.tensor([[do, False, False]], device=dev),
        init_raw=tensor(f0), learning_rate=lr, max_depth=1,
    )
    return params, {"train_deviance": np.asarray([dev_], fdt)}


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
    kernels = histogram_kernels(cfg)
    dtype = float_dtype(torch.as_tensor(X))
    w = torch.as_tensor(to_host(train_masks), device=dev).to(dtype)
    if bins is None and cfg.per_fold_binning:
        binned, thresholds, _, max_bins = _per_fold_bins(X, train_masks, cfg)
    else:
        if bins is None:
            bins = binning.bin_features(to_host(X), bin_budget_capped(cfg))
        binned, thresholds, max_bins = bins.binned, bins.thresholds, bins.max_bins
    ys = torch.as_tensor(y, device=dev).to(dtype)
    f0 = _prior_log_odds(ys, w)
    grow_tree = make_tree_grower(
        _device_bins(binned, max_bins, dev), torch.as_tensor(thresholds, dtype=dtype, device=dev),
        depth=cfg.max_depth, max_bins=max_bins, min_samples_split=cfg.min_samples_split,
        min_samples_leaf=cfg.min_samples_leaf, kernels=kernels,
        node_init=torch.where(w > 0, 0, -1).to(torch.int32))
    carry = levelwise_init(f0, w.shape[1], cfg.n_estimators, cfg.max_depth, deviance=False)
    _, feature, threshold, value, is_split, _ = run_levelwise(
        grow_tree, ys, carry, 0, cfg.n_estimators, learning_rate=cfg.learning_rate, weights=w)
    return forest_to_params(feature, threshold, value, is_split, init_raw=f0,
                            learning_rate=cfg.learning_rate, max_depth=cfg.max_depth)


def fold_bins(X: np.ndarray, train_mask, cfg: GBDTConfig) -> binning.BinnedFeatures:
    """One fold's own candidates: the fold's rows (``train_mask > 0``)
    binned on the host, then ALL rows re-binned against those thresholds
    (excluded rows carry valid ids and zero weight)."""
    bf = binning.bin_features(X[np.asarray(train_mask) > 0], bin_budget_capped(cfg))
    return binning.BinnedFeatures(
        binned=binning.rebin_with_thresholds(X, bf.thresholds, bf.n_bins),
        thresholds=bf.thresholds, n_bins=bf.n_bins)


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
    per_fold = [fold_bins(X, wk, cfg) for wk in to_host(train_masks)]
    k, (n, F) = len(per_fold), X.shape
    W = max(bf.thresholds.shape[1] for bf in per_fold)
    thr = np.full((k, F, W), np.inf)
    binned = np.zeros((k, n, F), np.int32)
    for i, bf in enumerate(per_fold):
        thr[i, :, : bf.thresholds.shape[1]] = bf.thresholds
        binned[i] = bf.binned
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
    kernels: HistogramKernels,
    node_init: torch.Tensor | None = None,  # [k, n] int32, −1 ⇒ inactive row
    reduce_fn=_same,           # cross-shard reduction (a sum over data shards)
):
    """Build the level-synchronous tree-growth step: one copy of the split
    bookkeeping, routing and Newton-leaf math, for the single fit (k = 1),
    the fold fits and the sharded fit alike. The fold fits park their
    held-out rows at −1 through ``node_init``; the sharded fit parks its
    padding rows so and sums histogram and leaf partials over shards through
    ``reduce_fn``. ``kernels`` (``histogram_kernels``) gives the node
    histograms and the leaf sums.

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
    hist_fn, leaf_fn = kernels.node, kernels.leaf

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
            with region("gbdt.hist", level=level):
                node_local = torch.where(node >= base, node - base, -1)
                hl = hist_fn(binned, node_local, g, h, K, max_bins)
                hists = histogram.NodeHistograms(*(reduce_fn(a) for a in hl))
            with region("gbdt.split", level=level):
                sp = histogram.best_splits(hists, thresholds, min_samples_split,
                                           min_samples_leaf)
                feat_t[:, base:base + K] = torch.where(sp.do_split, sp.feature,
                                                       0).to(torch.int32)
                thr_t[:, base:base + K] = torch.where(sp.do_split, sp.threshold, inf).to(dtype)
                split_t[:, base:base + K] = sp.do_split
            with region("gbdt.route", level=level):
                # Route rows of split nodes to their children; others park.
                kk = torch.clamp_min(node_local, 0).long()  # gather's index dtype
                splits_here = (node_local >= 0) & torch.gather(sp.do_split, 1, kk)
                col = torch.take(binned, row_base + torch.gather(sp.feature, 1, kk))
                go_left = col <= torch.gather(sp.boundary, 1, kk)
                child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
                node = torch.where(splits_here, child, node)
        with region("gbdt.leaf_sums"):
            # Newton leaf values over final row positions, from float64 sums
            # (a float32 index_add_ over ~1M rows errs ~1e-4); segment NN of
            # each fit, where inactive rows may land, is dropped
            num, den = (reduce_fn(s[:, :NN].to(dtype)) for s in leaf_fn(node, g, h, k, NN))
            val_t = histogram.newton_leaf_value(num, den)
        return feat_t, thr_t, val_t, split_t, node

    return grow_tree


def levelwise_init(f0: torch.Tensor, n: int, n_stages: int, depth: int, *,
                   deviance: bool = True):
    """The level-wise boosting carry at stage 0 (the checkpoint/resume
    unit): raw scores at the prior ``f0``, the four forest tensors in heap
    layout and the deviance path. A scalar ``f0`` gives one fit's carry (raw
    ``[n]``, forest ``[n_stages, NN]``); ``[k]`` priors lead raw and forest
    with the fit axis. The fold fits keep no deviance (``deviance=False``:
    ``None`` in its place)."""
    lead, dtype, dev = f0.shape, f0.dtype, f0.device
    shape = (*lead, n_stages, 2 ** (depth + 1) - 1)
    return (
        f0[..., None].expand(*lead, n).clone(),
        torch.zeros(shape, dtype=torch.int32, device=dev),
        torch.full(shape, torch.inf, dtype=dtype, device=dev),
        torch.zeros(shape, dtype=dtype, device=dev),
        torch.zeros(shape, dtype=torch.bool, device=dev),
        torch.zeros(n_stages, dtype=dtype, device=dev) if deviance else None,
    )


def run_levelwise(
    grow_tree,                 # make_tree_grower's step
    y: torch.Tensor,           # [n] labels in the working dtype
    carry,                     # levelwise_init's layout
    start: int,
    stop: int,
    *,
    learning_rate: float,
    weights: torch.Tensor | None = None,  # [k, n]; None: one unweighted fit
    reduce_fn=_same,
):
    """Stages ``[start, stop)`` of k level-wise fits from ``carry`` → the
    new carry: the one stage loop of ``fit`` at depth ≥ 2,
    ``fit_resumable``, ``fit_folds`` and ``parallel.hist_trainer.fit``. A
    stage takes g and h from the sigmoid of the raw scores, grows one tree
    per fit (``grow_tree``), adds its leaf values to the raw scores and, where
    the carry keeps one, writes the deviance. The carry's forest and deviance
    tensors are written in place, through ``[k, …]`` views where the carry
    has no fit axis.

    ``weights`` (the fold masks; the sharded fit's sample weights, 0 at its
    padding rows) scale g, h, the update and the deviance's terms; the
    grower must park their rows of weight 0 at −1 (``node_init``). Without
    them the fit is one fit with every row active, and the stage does no
    clamp and no multiply. ``reduce_fn`` sums the weighted deviance's
    log-likelihood and weight partials over shards, in one call a stage."""
    raw, feats, thrs, vals, splits, devs = carry
    r = raw.view(-1, raw.shape[-1])                             # [k, n]
    feats_k, thrs_k, vals_k, splits_k = (a.view(r.shape[0], *a.shape[-2:])
                                         for a in (feats, thrs, vals, splits))
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    w = weights
    if w is not None and devs is not None:
        w_sum = torch.sum(w)
    for t in range(start, stop):
        with region("gbdt.stage", t=t):
            with region("gbdt.grad"):
                p = torch.sigmoid(r)
                g = y - p          # residual (negative gradient of deviance)
                h = p * (1.0 - p)  # Newton denominator terms
                if w is not None:
                    g, h = g * w, h * w
            feat_t, thr_t, val_t, split_t, node = grow_tree(g, h)
            with region("gbdt.update"):
                if w is None:
                    r = r + learning_rate * val_t[0][node.long()]
                else:
                    r = r + learning_rate * torch.gather(
                        val_t, 1, torch.clamp_min(node, 0).long()) * w
                if devs is not None:
                    terms = y * r - torch.logaddexp(zero, r)
                    if w is None:
                        devs[t] = -2.0 * torch.mean(terms)
                    else:
                        ll, n_real = reduce_fn(torch.stack([torch.sum(terms * w), w_sum]))
                        devs[t] = -2.0 * ll / n_real
                feats_k[:, t], thrs_k[:, t], vals_k[:, t], splits_k[:, t] = (feat_t, thr_t,
                                                                             val_t, split_t)
    return r.view(raw.shape), feats, thrs, vals, splits, devs

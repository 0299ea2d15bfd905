"""Feature quantisation for histogram-based tree growing.

Port of the JAX package's ``ops/binning.py``, two regimes, one
representation (a value's bin is the number of thresholds strictly below
it; "split at boundary b" means "go left iff bin <= b"):

  * host (``bin_features``, ``rebin_with_thresholds``, ``feature_bin_counts``):
    numpy copied verbatim — unique-value midpoints, quantile-capped at
    ``n_bins`` — bit-identical to sklearn's exact enumeration whenever a
    column has at most ``n_bins`` distinct values;
  * device (``device_binning_core``, ``bin_features_device``): each column
    sorted on the device, ``n_bins`` empirical quantile candidates taken
    (duplicates weighted), row-chunked compare+sum for the ids.

The semantics are the JAX functions' to the bit, so a fit on the same
matrix bins it identically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

ROW_CHUNK = 65_536


@dataclasses.dataclass(frozen=True)
class BinnedFeatures:
    """Quantised design matrix + the threshold table to decode splits
    (numpy arrays from the host build, tensors from the device build)."""

    binned: "np.ndarray | torch.Tensor"      # [n, F] int32 — bin index per value
    thresholds: "np.ndarray | torch.Tensor"  # [F, n_bins-1] — candidate split values,
                                             # +inf past the last real boundary of a feature
    n_bins: np.ndarray                       # [F] int32 — real bin count per feature

    @property
    def max_bins(self) -> int:
        return self.thresholds.shape[1] + 1


def bin_features(X: np.ndarray, n_bins: int | None = 256) -> BinnedFeatures:
    """Quantize ``X[n, F]`` column-wise into at most ``n_bins`` bins.

    ``n_bins=None`` disables the cap: every unique-value midpoint becomes a
    candidate threshold — the exact-enumeration regime of sklearn's
    ``BestSplitter`` at any cardinality (``GBDTConfig.splitter='exact'``).

    A value lands in bin ``b`` = number of thresholds strictly below it;
    "split at boundary b" then means "go left iff bin <= b", and the
    real-valued threshold stored in the fitted tree is ``thresholds[f, b]``
    (a midpoint, matching sklearn's ``(v_i + v_{i+1})/2``).
    """
    n, F = X.shape
    uniques = []
    for f in range(F):
        u = np.unique(X[:, f])  # sorted, NaN would sort last — reject it
        if np.isnan(u).any():
            raise ValueError(f"feature {f} contains NaN; impute before binning")
        if n_bins is not None and u.size > n_bins:
            # Quantile-spaced representative subset (keep extremes).
            q = np.linspace(0, 1, n_bins)
            idx = np.unique((q * (u.size - 1)).round().astype(int))
            u = u[idx]
        uniques.append(u)
    width = max(max(u.size for u in uniques) - 1, 1)
    thresholds = np.full((F, width), np.inf)
    counts = np.ones(F, np.int32)
    binned = np.zeros((n, F), np.int32)
    for f, u in enumerate(uniques):
        mids = (u[:-1] + u[1:]) / 2.0
        # sklearn guard (BestSplitter): if the midpoint rounds up to the upper
        # value, use the lower value as the threshold so the upper sample
        # still routes right under "x <= t goes left".
        mids = np.where(mids == u[1:], u[:-1], mids)
        thresholds[f, : mids.size] = mids
        counts[f] = u.size
        # bin(v) = #{mids < v}, except v exactly equal to a midpoint stays in
        # the left bin — searchsorted(side='left') gives precisely that.
        binned[:, f] = np.searchsorted(mids, X[:, f], side="left")
    return BinnedFeatures(binned=binned, thresholds=thresholds, n_bins=counts)


def rebin_with_thresholds(
    X: np.ndarray, thresholds: np.ndarray, n_bins: np.ndarray | None = None
) -> np.ndarray:
    """Bin ALL rows of ``X`` against an existing threshold table: bin id =
    number of real thresholds strictly below the value (the exact
    convention ``bin_features`` uses, so rows that were in the table's fit
    set reproduce their original ids bit-for-bit). Rows outside the fit
    set land in the nearest edge bin — the per-fold-binning path uses this
    to give every (masked) row an id under each fold's own candidates.

    ``n_bins`` (per-feature real bin counts) selects the real boundaries as
    ``thresholds[f, :n_bins[f]-1]`` — required for exactness when a
    feature's data contains ±inf (a −inf midpoint is a REAL boundary that
    an isfinite filter would drop, shifting every id down by one). Without
    it, boundaries are taken as the finite entries (valid whenever the
    data itself is finite, since the pad value is +inf).
    """
    n, F = X.shape
    out = np.zeros((n, F), np.int32)
    for f in range(F):
        thr = thresholds[f]
        if n_bins is not None:
            thr = thr[: int(n_bins[f]) - 1]
        else:
            thr = thr[np.isfinite(thr)]
        out[:, f] = np.searchsorted(thr, X[:, f], side="left")
    return out


def feature_bin_counts(bins: BinnedFeatures) -> tuple[int, ...]:
    """Static per-feature bin counts (the JAX matmul histogram backend's
    traffic lever; the port's kernels take every feature at ``max_bins``)."""
    return tuple(int(x) for x in np.asarray(bins.n_bins))


def chunked_row_reduce(
    X: torch.Tensor,
    per_chunk_fn: Callable[[torch.Tensor], torch.Tensor],
    chunk: int = ROW_CHUNK,
) -> torch.Tensor:
    """``per_chunk_fn`` over row chunks of ``X [n, ...]``, results
    concatenated along rows. For dense compare+reduce passes whose broadcast
    intermediate (``[chunk, B, F]``) must never exist at full n. The JAX
    version pads to equal chunks for ``lax.map``; eager PyTorch takes the
    ragged last chunk as it is."""
    n = X.shape[0]
    if n == 0:
        raise ValueError("chunked_row_reduce: zero-row input")
    return torch.cat(
        [per_chunk_fn(X[s:s + chunk]) for s in range(0, n, chunk)], dim=0
    )


def device_binning_core(X: torch.Tensor, n_bins: int):
    """Quantile binning on ``X``'s device.

    Returns ``(binned [n, F] int32, mids [n_bins-1, F], nan_flag)``, the
    last a 0-d bool tensor: the caller checks it once, after everything is
    queued, so binning costs no host sync of its own.
    """
    n, F = X.shape
    if n == 0:
        raise ValueError("device binning: zero-row input")
    nan_flag = torch.isnan(X).any()
    Xs = torch.sort(X, dim=0).values                       # [n, F]
    # jnp.linspace(0, 1, B) is exactly i / (B - 1) in float64 (the x64
    # oracle's default float); scaled by n − 1 and rounded half to even.
    # Computed in float64 whatever X's dtype: in float32 the products drift
    # and the picked ranks move by one at large n.
    q = torch.arange(n_bins, dtype=torch.float64, device=X.device) / (n_bins - 1)
    q_idx = torch.round(q * (n - 1)).long()
    u = Xs[q_idx, :]                                       # [B, F] candidates
    mids = (u[:-1] + u[1:]) / 2.0
    # sklearn BestSplitter guard: a midpoint that rounds up to the upper
    # value would mis-route the upper sample under "x <= t goes left".
    mids = torch.where(mids == u[1:], u[:-1], mids)        # [B-1, F]

    def _bin_chunk(xc: torch.Tensor) -> torch.Tensor:      # [chunk, F]
        return torch.sum(xc[:, None, :] > mids[None, :, :], dim=1, dtype=torch.int32)

    binned = chunked_row_reduce(X, _bin_chunk)             # [n, F] int32
    return binned, mids, nan_flag


def bin_features_device(X: torch.Tensor, n_bins: int = 256) -> BinnedFeatures:
    """Device-side quantile binning for the scaled regime:
    ``device_binning_core`` on ``X``'s device, then one sync on its NaN flag
    (binning NaNs silently distorts the candidate set, so refuse — impute
    first). Duplicate candidates yield duplicate midpoints, which describe
    the same row partition; ``n_bins`` is reported as the candidate count.
    """
    binned, mids, nan_flag = device_binning_core(X, n_bins)
    if bool(nan_flag):
        raise ValueError("input contains NaN; impute before binning")
    counts = np.full(X.shape[1], n_bins, np.int32)
    return BinnedFeatures(binned=binned, thresholds=mids.T, n_bins=counts)

"""The training-time reference profile a fitted model carries.

Copy of ``build_reference_profile`` and the binning helpers it calls from
the JAX package's ``obs/quality.py`` (numpy only); the registry, the
streaming monitor and the feed stay there until serving is ported.

The profile is built at fit time over the post-impute, post-select
``X[n, 17]`` and the training score distribution: per-feature equal-width
histograms (``DEFAULT_FEATURE_BINS`` bins between the training min and max,
out-of-range values clipped into the edge bins), moments and quantiles, the
score histogram over fixed [0, 1] bins, and per score bin the training
positive rate — the label-free calibration reference.
"""

from __future__ import annotations

import numpy as np

PROFILE_VERSION = 1
DEFAULT_FEATURE_BINS = 10
DEFAULT_SCORE_BINS = 10
#: Quantile levels stored per feature.
PROFILE_QUANTILES = (0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99)


def build_reference_profile(
    X: np.ndarray,
    scores: np.ndarray,
    y: np.ndarray | None = None,
    feature_bins: int = DEFAULT_FEATURE_BINS,
    score_bins: int = DEFAULT_SCORE_BINS,
) -> dict[str, np.ndarray]:
    """The baseline a served model carries: per-feature equal-width
    histograms + moments + quantiles over ``X[n, F]``, the training score
    histogram over fixed [0, 1] bins, and — when training labels ``y`` are
    given — the per-score-bin positive rate (NaN-filled without labels).

    Returns a plain ``{str: np.ndarray}`` dict (scalars as 0-d arrays), which
    a checkpoint carries as a mapping."""
    X = np.asarray(X, np.float64)
    if X.ndim != 2 or X.shape[0] < 1:
        raise ValueError(f"profile needs a non-empty [n, F] matrix, got {X.shape}")
    if not np.isfinite(X).all():
        raise ValueError("profile input must be post-impute (finite); found NaN/Inf")
    scores = np.asarray(scores, np.float64).ravel()
    if scores.shape[0] != X.shape[0]:
        raise ValueError(f"scores length {scores.shape[0]} != rows {X.shape[0]}")
    n, F = X.shape
    B, S = int(feature_bins), int(score_bins)
    if B < 2 or S < 2:
        raise ValueError("feature_bins and score_bins must be >= 2")

    mins = X.min(axis=0)
    maxs = X.max(axis=0)
    # Constant columns get a unit-width span so the bin arithmetic stays
    # finite; all their mass lands in bin 0.
    widths = np.where(maxs > mins, maxs - mins, 1.0)
    edges = mins[:, None] + widths[:, None] * (np.arange(B + 1, dtype=np.float64)[None, :] / B)
    counts = np.stack(
        [np.bincount(c, minlength=B) for c in _feature_bin_indices(X, mins, widths, B).T]
    ).astype(np.float64)

    q = np.asarray(PROFILE_QUANTILES, np.float64)
    score_edges = np.linspace(0.0, 1.0, S + 1)
    s_idx = _score_bin_indices(scores, S)
    score_counts = np.bincount(s_idx, minlength=S).astype(np.float64)
    calib_pos_rate = np.full(S, np.nan)
    calib_mean_score = np.full(S, np.nan)
    for b in range(S):
        m = s_idx == b
        if m.any():
            calib_mean_score[b] = float(scores[m].mean())
            if y is not None:
                calib_pos_rate[b] = float(np.asarray(y, np.float64)[m].mean())

    return {
        "version": np.asarray(PROFILE_VERSION, np.int64),
        "n_rows": np.asarray(n, np.int64),
        "bin_edges": edges,                      # [F, B+1]
        "bin_counts": counts,                    # [F, B]
        "mean": X.mean(axis=0),
        "std": X.std(axis=0),
        "minimum": mins,
        "maximum": maxs,
        "quantile_levels": q,
        "quantiles": np.quantile(X, q, axis=0).T,  # [F, Q]
        "score_edges": score_edges,              # [S+1]
        "score_counts": score_counts,            # [S]
        "calib_mean_score": calib_mean_score,    # [S] training mean score/bin
        "calib_pos_rate": calib_pos_rate,        # [S] training pos rate/bin
    }


def _feature_bin_indices(
    X: np.ndarray, mins: np.ndarray, widths: np.ndarray, n_bins: int
) -> np.ndarray:
    """Equal-width bin index per value, out-of-range clipped into the edge
    bins."""
    idx = np.floor((X - mins[None, :]) / widths[None, :] * n_bins)
    return np.clip(idx, 0, n_bins - 1).astype(np.int16)


def _score_bin_indices(scores: np.ndarray, n_bins: int) -> np.ndarray:
    idx = np.floor(np.asarray(scores, np.float64) * n_bins)
    return np.clip(idx, 0, n_bins - 1).astype(np.int16)

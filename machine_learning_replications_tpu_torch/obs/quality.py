"""Model-quality observability: the training-time reference profile a
fitted model carries, and the streaming drift monitor a server feeds.

The JAX package's ``obs/quality.py`` (numpy + the registry + the journal)
merged into the port: ``build_reference_profile`` is the port's own copy
(slice 5), everything from ``_feature_bin_indices`` on is a copy of the JAX
module under the port's package name. The one change is
``_as_host_profile``, which also takes a profile of torch tensors on any
device (a port checkpoint's ``quality`` after ``convert``).

The profile is built at fit time over the post-impute, post-select
``X[n, 17]`` and the training score distribution: per-feature equal-width
histograms (``DEFAULT_FEATURE_BINS`` bins between the training min and max,
out-of-range values clipped into the edge bins), moments and quantiles, the
score histogram over fixed [0, 1] bins, and per score bin the training
positive rate — the label-free calibration reference.

``QualityMonitor`` takes each served batch's real (unpadded) rows, blended
and member probabilities, and keeps per-feature PSI and binned KS of a
sliding window against the reference, the score PSI, calibration bins and
mean pairwise member disagreement; ``AsyncQualityFeed`` hands batches to it
on a background thread. PSI below ``DEFAULT_WARN_PSI`` (0.1) is ``ok``,
below ``DEFAULT_ALERT_PSI`` (0.25) ``warn``, above ``alert``; transitions
are journaled and the ``quality_*`` families ride ``/metrics``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Sequence

import numpy as np

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import (
    REGISTRY,
    MetricsRegistry,
)

# Registered at import (rule metrics-catalog): the first scrape of a
# serving process sees the feed families' metadata before any feed
# exists; the registry is idempotent across re-declares.
QUALITY_FEED_DROPPED = REGISTRY.counter(
    "quality_feed_dropped_rows_total",
    "Rows that never reached the quality monitor, by reason: "
    "sampled = thinned under queue pressure, overflow = shed at "
    "a full hand-off queue, dead = feed quarantined.",
    labels=("reason",),
)
for _reason in ("sampled", "overflow", "dead"):
    QUALITY_FEED_DROPPED.labels(reason=_reason)
QUALITY_FEED_DEPTH = REGISTRY.gauge(
    "quality_feed_depth",
    "Batches waiting in the async quality hand-off queue.",
)

PROFILE_VERSION = 1
DEFAULT_FEATURE_BINS = 10
DEFAULT_SCORE_BINS = 10
#: Quantile levels stored per feature (diagnostics for /debug/quality and
#: obs_report; the drift statistics themselves run on the histograms).
PROFILE_QUANTILES = (0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99)

#: Industry-convention PSI thresholds (module docstring has the rationale).
DEFAULT_WARN_PSI = 0.1
DEFAULT_ALERT_PSI = 0.25

_STATUS_LEVEL = {"ok": 0, "warn": 1, "alert": 2}

#: Status transitions remembered per monitor (the ``transitions`` ring on
#: ``/debug/quality``): enough for a trigger daemon to debounce a
#: sustained alert from ONE poll instead of re-reading the journal, small
#: enough that the payload stays a snapshot, not a log.
TRANSITION_HISTORY = 32


# ---------------------------------------------------------------------------
# Reference profile
# ---------------------------------------------------------------------------


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
    bins — one vectorized multiply/clip, the whole per-batch binning cost."""
    idx = np.floor((X - mins[None, :]) / widths[None, :] * n_bins)
    return np.clip(idx, 0, n_bins - 1).astype(np.int16)


def profile_bin_geometry(prof: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(mins, widths)`` from a host profile's ``bin_edges``, degenerate
    (zero-width) features floored to 1.0. ONE implementation on purpose —
    the monitor's constructor, ``rebase``, and the shadow comparator's
    ``cohort_quality`` (``learn.shadow``) must bin with identical
    geometry, or the live monitor and the shadow gate would judge the
    same rows differently."""
    mins = prof["bin_edges"][:, 0]
    widths = prof["bin_edges"][:, -1] - mins
    return mins, np.where(widths > 0, widths, 1.0)


def pairwise_disagreement(members: np.ndarray) -> np.ndarray:
    """Per-row mean pairwise ``|p_i − p_j|`` over ensemble members
    (``members[n, m]``) — the ensemble-agreement statistic. ONE
    implementation on purpose: the serving monitor's window feed and the
    shadow comparator (``learn.shadow``) must judge with identical
    semantics, or a shadow verdict's disagreement delta would disagree
    with the live monitor on the same inputs. ``m < 2`` yields zeros
    (no pairs to disagree)."""
    members = np.asarray(members, np.float64)
    n, m = members.shape
    pair_sum = np.zeros(n)
    for i in range(m):
        for j in range(i + 1, m):
            pair_sum += np.abs(members[:, i] - members[:, j])
    return pair_sum / max(m * (m - 1) / 2, 1)


def _score_bin_indices(scores: np.ndarray, n_bins: int) -> np.ndarray:
    idx = np.floor(np.asarray(scores, np.float64) * n_bins)
    return np.clip(idx, 0, n_bins - 1).astype(np.int16)


def _as_host_profile(profile: Any) -> dict[str, np.ndarray]:
    """Coerce a restored profile (numpy, or torch tensors on any device,
    fresh off a checkpoint) to host numpy and sanity-check the keys this
    module needs."""
    if not isinstance(profile, dict):
        raise TypeError(
            f"quality profile must be a dict pytree, got {type(profile).__name__}"
        )
    prof = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
            for k, v in profile.items()}
    needed = ("bin_edges", "bin_counts", "score_edges", "score_counts", "n_rows")
    missing = [k for k in needed if k not in prof]
    if missing:
        raise ValueError(f"quality profile missing keys: {missing}")
    version = int(prof.get("version", 1))
    if version > PROFILE_VERSION:
        raise ValueError(
            f"quality profile version {version} is newer than this build "
            f"supports ({PROFILE_VERSION})"
        )
    return prof


# ---------------------------------------------------------------------------
# Drift statistics
# ---------------------------------------------------------------------------


def psi(
    expected_counts: Sequence[float],
    actual_counts: Sequence[float],
    eps: float = 1e-4,
) -> float:
    """Population Stability Index between two histograms on shared bins:
    ``sum((p_a − p_e) · ln(p_a / p_e))``. Proportions are floored at
    ``eps`` (the standard zero-bin smoothing) so an empty bin on either
    side contributes a large-but-finite term instead of ±inf."""
    e = np.asarray(expected_counts, np.float64)
    a = np.asarray(actual_counts, np.float64)
    if e.shape != a.shape or e.ndim != 1:
        raise ValueError(f"histogram shapes differ: {e.shape} vs {a.shape}")
    if e.sum() <= 0 or a.sum() <= 0:
        raise ValueError("psi needs non-empty histograms on both sides")
    p_e = np.maximum(e / e.sum(), eps)
    p_a = np.maximum(a / a.sum(), eps)
    return float(np.sum((p_a - p_e) * np.log(p_a / p_e)))


def ks_binned(
    expected_counts: Sequence[float], actual_counts: Sequence[float]
) -> float:
    """Kolmogorov–Smirnov distance between two *binned* distributions:
    the max |CDF difference| evaluated at the shared bin edges. A lower
    bound on the exact sample KS (within-bin detail is quantized away),
    which is the right trade for a streaming monitor that stores counts,
    not rows."""
    e = np.asarray(expected_counts, np.float64)
    a = np.asarray(actual_counts, np.float64)
    if e.shape != a.shape or e.ndim != 1:
        raise ValueError(f"histogram shapes differ: {e.shape} vs {a.shape}")
    if e.sum() <= 0 or a.sum() <= 0:
        raise ValueError("ks needs non-empty histograms on both sides")
    return float(
        np.abs(np.cumsum(e) / e.sum() - np.cumsum(a) / a.sum()).max()
    )


def _psi_rows(
    expected: np.ndarray, actual: np.ndarray, eps: float = 1e-4
) -> np.ndarray:
    """Row-wise ``psi``: one PSI per feature over ``[F, B]`` histogram
    matrices, vectorized (same smoothing and math as the scalar
    function, which stays the spec and the test oracle)."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    p_e = np.maximum(e / e.sum(axis=1, keepdims=True), eps)
    p_a = np.maximum(a / a.sum(axis=1, keepdims=True), eps)
    return np.sum((p_a - p_e) * np.log(p_a / p_e), axis=1)


def _ks_rows(expected: np.ndarray, actual: np.ndarray) -> np.ndarray:
    """Row-wise ``ks_binned`` over ``[F, B]`` histogram matrices."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    return np.abs(
        np.cumsum(e, axis=1) / e.sum(axis=1, keepdims=True)
        - np.cumsum(a, axis=1) / a.sum(axis=1, keepdims=True)
    ).max(axis=1)


def _round(v: float | None, nd: int = 6) -> float | None:
    return None if v is None else round(float(v), nd)


def _null_if_nan(v: float) -> float | None:
    return None if v != v else float(v)


# ---------------------------------------------------------------------------
# Streaming monitor
# ---------------------------------------------------------------------------


class QualityMonitor:
    """Sliding-window drift monitor the serving engine feeds per flush.

    State is three bounded rings over the last ``window`` *real* (unpadded)
    rows: per-feature bin indices (``[window, F]`` int16), score bin index
    + raw score, and per-row mean pairwise member disagreement. Rings make
    the windowed histograms exact (no decay-factor tuning), bound memory
    explicitly (~40 bytes/row at F=17), and keep ``observe_batch`` to one
    vectorized binning pass outside the lock plus ring writes inside it —
    the same bounded-over-unbounded discipline as the admission queue.

    Drift statistics refresh at most once per ``refresh_rows`` observed
    rows AND at most once per ``refresh_interval_s`` wall seconds (and
    always on ``snapshot()``): gauges, status, and the journaled
    ``quality_status`` transition event all come from the refresh path,
    so a high-qps flush loop pays ring writes, not PSI math, per batch.
    The time floor is the r12 fix for the r11-measured ~30% saturated-
    throughput tax: at 1000 qps with 64-row flushes a rows-only policy
    re-ran the whole windowed PSI/KS pass on every single flush, burning
    real CPU for statistics that cannot meaningfully move inside a
    second — drift is a minutes-scale signal.
    """

    def __init__(
        self,
        profile: Any,
        warn_psi: float = DEFAULT_WARN_PSI,
        alert_psi: float = DEFAULT_ALERT_PSI,
        window: int = 2048,
        min_rows: int = 200,
        refresh_rows: int = 32,
        refresh_interval_s: float = 1.0,
        feature_names: Sequence[str] | None = None,
        registry: MetricsRegistry | None = None,
    ) -> None:
        self._profile = _as_host_profile(profile)
        F, B = self._profile["bin_counts"].shape
        self._F, self._B = F, B
        self._S = int(self._profile["score_counts"].shape[0])
        if not 0 < warn_psi <= alert_psi:
            raise ValueError(
                f"need 0 < warn_psi <= alert_psi, got {warn_psi} / {alert_psi}"
            )
        if window < 1 or min_rows < 1 or refresh_rows < 1:
            raise ValueError("window, min_rows, refresh_rows must be >= 1")
        if refresh_interval_s < 0:
            raise ValueError("refresh_interval_s must be >= 0")
        if window < min_rows:
            # A window that can never reach min_rows would pin every drift
            # statistic at "not enough data" forever — monitoring silently
            # off while /healthz keeps saying ok. Refuse at construction.
            raise ValueError(
                f"window ({window}) must be >= min_rows ({min_rows}), or "
                "the drift statistics can never be computed"
            )
        self.warn_psi = float(warn_psi)
        self.alert_psi = float(alert_psi)
        self.window = int(window)
        self.min_rows = int(min_rows)
        self.refresh_rows = int(refresh_rows)
        self.refresh_interval_s = float(refresh_interval_s)
        # −inf: the first due batch always refreshes, whatever the floor
        # (monotonic's epoch is arbitrary — a small absolute value could
        # sit inside a large interval on a freshly booted host).
        self._last_refresh_t = float("-inf")
        if feature_names is None:
            from machine_learning_replications_tpu_torch.data.schema import SELECTED_17

            feature_names = (
                SELECTED_17 if len(SELECTED_17) == F
                else tuple(f"f{i}" for i in range(F))
            )
        if len(feature_names) != F:
            raise ValueError(
                f"{len(feature_names)} feature names for {F} features"
            )
        self.feature_names = tuple(str(n) for n in feature_names)
        self._mins, self._widths = profile_bin_geometry(self._profile)

        self._lock = threading.Lock()
        # Serializes whole refresh passes (copy → compute → commit): the
        # batcher flush thread and /debug/quality handler threads both
        # refresh, and unserialized passes could commit a STALE window's
        # statistics over a fresher one — overwriting real drift gauges
        # and journaling phantom recovery transitions.
        self._refresh_lock = threading.Lock()
        self._feat_ring = np.zeros((self.window, F), np.int16)
        self._score_ring = np.zeros(self.window, np.int16)
        self._score_val_ring = np.zeros(self.window, np.float64)
        self._dis_ring = np.full(self.window, np.nan)
        self._rows = 0        # ring-write cursor (truncated-batch rows)
        self._rows_total = 0  # every real row ever observed
        self._last_refresh_rows = 0
        self._status = "ok"
        # Profile generation: bumped by rebase(). Bin indices are
        # computed outside the lock against a snapshot of the profile's
        # edges; a batch whose generation is stale by ring-write time was
        # binned under a superseded profile and must be dropped, not
        # written into the fresh window.
        self._epoch = 0
        # Bounded status-transition history (newest last): what the
        # continual-learning trigger daemon debounces on — K consecutive
        # alert polls are cheap to judge when the recent arc rides the
        # snapshot itself.
        self._transitions: collections.deque = collections.deque(
            maxlen=TRANSITION_HISTORY
        )
        self._disabled_reason: str | None = None  # set by disable()
        # Last refresh's derived statistics (NaN = not computable yet).
        self._feature_psi = np.full(F, np.nan)
        self._feature_ks = np.full(F, np.nan)
        self._score_psi = float("nan")
        self._disagreement = float("nan")

        reg = registry or REGISTRY
        self._g_feature_psi = reg.gauge(
            "quality_feature_psi",
            "Windowed PSI of the feature vs its training reference "
            "histogram (NaN until min_rows).",
            labels=("feature",),
        )
        self._g_feature_ks = reg.gauge(
            "quality_feature_ks",
            "Windowed binned KS distance of the feature vs its training "
            "reference (NaN until min_rows).",
            labels=("feature",),
        )
        self._g_score_psi = reg.gauge(
            "quality_score_psi",
            "Windowed PSI of the predicted-probability distribution vs "
            "the training score distribution (NaN until min_rows).",
        )
        self._g_disagreement = reg.gauge(
            "quality_member_disagreement",
            "Windowed mean pairwise |p_i - p_j| across ensemble members "
            "(NaN until min_rows or without member outputs).",
        )
        self._g_window = reg.gauge(
            "quality_window_rows", "Real rows in the sliding drift window."
        )
        self._g_status = reg.gauge(
            "quality_status",
            "Drift status: 0 = ok, 1 = warn, 2 = alert (worst PSI vs the "
            "configured thresholds).",
        )
        self._c_rows = reg.counter(
            "quality_rows_total", "Real (unpadded) rows observed by the "
            "quality monitor."
        )
        self._c_transitions = reg.counter(
            "quality_status_transitions_total",
            "Drift status transitions, labeled by the state entered.",
            labels=("to",),
        )
        # Materialize every series now: a scrape taken before traffic (or
        # before min_rows) must show the families, with NaN marking
        # "no data yet" on the drift gauges (legal for gauges; the JSON
        # payloads render these as null).
        for name in self.feature_names:
            self._g_feature_psi.set(float("nan"), feature=name)
            self._g_feature_ks.set(float("nan"), feature=name)
        self._g_score_psi.get().set(float("nan"))
        self._g_disagreement.get().set(float("nan"))
        self._g_window.get().set(0.0)
        self._g_status.get().set(0.0)
        self._c_rows.get()
        for s in ("ok", "warn", "alert"):
            self._c_transitions.labels(to=s)

    # -- ingest -------------------------------------------------------------

    def observe_batch(
        self,
        X: np.ndarray,
        p1: np.ndarray,
        members: np.ndarray | None = None,
    ) -> None:
        """Feed one flushed batch of real rows: ``X[n, F]`` contract-space
        rows (post-impute/post-select for the pipeline route), ``p1[n]``
        blended probabilities, ``members[n, M]`` per-member probabilities
        (None when the served family has no members, e.g. a bare GBDT).
        Binning is vectorized out of the lock; the lock covers only the
        ring writes."""
        X = np.asarray(X, np.float64)
        p1 = np.asarray(p1, np.float64).ravel()
        n = X.shape[0]
        if n == 0:
            return
        if X.ndim != 2 or X.shape[1] != self._F or p1.shape[0] != n:
            raise ValueError(
                f"observe_batch shapes: X {X.shape}, p1 {p1.shape}, "
                f"expected [n, {self._F}] / [n]"
            )
        if not np.isfinite(X).all():
            # The monitored space is post-impute (finite) by contract; a
            # NaN here would turn into a garbage int16 bin index. Raise
            # loudly instead — the engine quarantines a failing feed.
            raise ValueError("observe_batch rows must be finite")
        with self._lock:
            # Snapshot the profile's edges + generation: a concurrent
            # rebase() between this binning pass and the ring write below
            # would otherwise land OLD-edge indices in the fresh window
            # (garbage histograms under the new profile's bin_counts).
            epoch = self._epoch
            mins, widths, B, S = self._mins, self._widths, self._B, self._S
        fidx = _feature_bin_indices(X, mins, widths, B)
        sidx = _score_bin_indices(p1, S)
        if members is not None:
            dis = pairwise_disagreement(members)
        else:
            dis = np.full(n, np.nan)
        n_observed = n  # the true row count — rows_total must not shrink
        # when an oversize batch is truncated to the window below
        if n > self.window:  # only the newest window rows can survive anyway
            p1 = p1[-self.window:]
            fidx, sidx, dis = (
                fidx[-self.window:], sidx[-self.window:], dis[-self.window:]
            )
            n = self.window
        with self._lock:
            if self._epoch != epoch:
                # Rebased mid-batch: these indices were binned under the
                # superseded profile's edges. Dropping the batch is
                # correct — the cleared window must hold only rows judged
                # against the new baseline.
                return
            start = self._rows % self.window
            take = min(n, self.window - start)
            self._feat_ring[start:start + take] = fidx[:take]
            self._score_ring[start:start + take] = sidx[:take]
            self._score_val_ring[start:start + take] = p1[:take]
            self._dis_ring[start:start + take] = dis[:take]
            if take < n:  # wrap
                rest = n - take
                self._feat_ring[:rest] = fidx[take:]
                self._score_ring[:rest] = sidx[take:]
                self._score_val_ring[:rest] = p1[take:]
                self._dis_ring[:rest] = dis[take:]
            self._rows += n
            self._rows_total += n_observed
            # Both throttles must agree: enough new rows to matter AND
            # the wall-clock floor elapsed (the saturated-flush-loop
            # guard — see the class docstring). snapshot() bypasses both.
            due = (
                self._rows - self._last_refresh_rows >= self.refresh_rows
                and time.monotonic() - self._last_refresh_t
                >= self.refresh_interval_s
            )
        self._c_rows.inc(n_observed)
        self._g_window.get().set(float(min(self._rows, self.window)))
        if due:
            self._refresh()

    # -- derive -------------------------------------------------------------

    def _window_copy(self):
        with self._lock:
            n = min(self._rows, self.window)
            return (
                n,
                self._feat_ring[:n].copy(),
                self._score_ring[:n].copy(),
                self._score_val_ring[:n].copy(),
                self._dis_ring[:n].copy(),
            )

    def _refresh(self) -> None:
        """Recompute drift statistics from the current window, update the
        gauges, and journal a ``quality_status`` event when the status
        crosses a threshold in either direction. Whole passes are
        serialized (``_refresh_lock``) so a slower thread can never commit
        a stale window's statistics over a fresher thread's."""
        with self._refresh_lock:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        n, fidx, sidx, _svals, dis = self._window_copy()
        with self._lock:
            self._last_refresh_rows = self._rows
            self._last_refresh_t = time.monotonic()
        if n < self.min_rows:
            return  # stats stay NaN/None until the window is meaningful
        ref_fc = self._profile["bin_counts"]
        # One flat bincount for all F feature histograms (feature f's
        # bins occupy [f·B, (f+1)·B)) and fully vectorized PSI/KS across
        # features: the per-feature python loop this replaces measured
        # ~1 ms per refresh at F=17/window=2048 — the dominant term of
        # the r11 quality throughput tax.
        flat = (
            np.arange(self._F, dtype=np.int64) * self._B
        )[None, :] + fidx
        counts = np.bincount(
            flat.ravel(), minlength=self._F * self._B
        ).reshape(self._F, self._B).astype(np.float64)
        f_psi = _psi_rows(ref_fc, counts)
        f_ks = _ks_rows(ref_fc, counts)
        s_counts = np.bincount(sidx, minlength=self._S)
        s_psi = psi(self._profile["score_counts"], s_counts)
        have_dis = np.isfinite(dis)
        disagreement = float(dis[have_dis].mean()) if have_dis.any() else float("nan")

        worst_psi = max(float(f_psi.max()), s_psi)
        new_status = (
            "alert" if worst_psi >= self.alert_psi
            else "warn" if worst_psi >= self.warn_psi
            else "ok"
        )
        with self._lock:
            self._feature_psi = f_psi
            self._feature_ks = f_ks
            self._score_psi = s_psi
            self._disagreement = disagreement
            old_status, self._status = self._status, new_status
        for f, name in enumerate(self.feature_names):
            self._g_feature_psi.set(float(f_psi[f]), feature=name)
            self._g_feature_ks.set(float(f_ks[f]), feature=name)
        self._g_score_psi.get().set(s_psi)
        self._g_disagreement.get().set(disagreement)
        self._g_status.get().set(float(_STATUS_LEVEL[new_status]))
        if new_status != old_status:
            worst_f, worst_f_psi = self._worst(f_psi, s_psi)
            self._c_transitions.inc(to=new_status)
            record = {
                "ts": journal.utc_now_iso(),
                "from_status": old_status,
                "to_status": new_status,
                "worst_feature": worst_f,
                "worst_psi": _round(worst_f_psi),
                "score_psi": _round(s_psi),
                "window_rows": n,
            }
            with self._lock:
                self._transitions.append(record)
            journal.event(
                "quality_status",
                from_status=old_status,
                to_status=new_status,
                worst_feature=worst_f,
                worst_psi=_round(worst_f_psi),
                score_psi=_round(s_psi),
                window_rows=n,
            )

    def _worst_feature(self, f_psi: np.ndarray) -> tuple[str | None, float | None]:
        if not np.isfinite(f_psi).any():
            return None, None
        i = int(np.nanargmax(f_psi))
        return self.feature_names[i], float(f_psi[i])

    def _worst(
        self, f_psi: np.ndarray, s_psi: float
    ) -> tuple[str | None, float | None]:
        """Worst offender across features AND the score distribution (the
        latter named by a ``__score__`` sentinel no contract variable can
        collide with)."""
        worst_f, worst_psi = self._worst_feature(f_psi)
        if s_psi == s_psi and (worst_psi is None or s_psi > worst_psi):
            return "__score__", float(s_psi)
        return worst_f, worst_psi

    def disable(self, reason: str) -> None:
        """Mark the monitor dead (the engine quarantines a feed whose
        ``observe_batch`` raised). A quarantined monitor must SAY so on
        every surface — frozen statistics presented as live 'ok' are the
        exact silent-monitoring-gap this module exists to close."""
        with self._lock:
            self._disabled_reason = reason
        self._g_status.get().set(float("nan"))

    def reenable(self) -> bool:
        """Clear a quarantine (``resilience.supervisor`` calls this after a
        successful engine restart rebuilds the feed): the monitor resumes
        with its windows intact and the status gauge restored. True when a
        quarantine was actually cleared — the caller journals the
        transition (``quality_feed_reenabled``) only then."""
        with self._lock:
            was_disabled = self._disabled_reason is not None
            self._disabled_reason = None
            status = self._status
        if was_disabled:
            self._g_status.get().set(float(_STATUS_LEVEL[status]))
        return was_disabled

    def rebase(self, profile: Any) -> None:
        """Adopt a NEW reference profile in place — the continual-learning
        promotion path (``serve.server.deploy_model``): a retrained
        candidate fit on the *current* cohort carries its own training
        reference, and after the warm swap the monitor must judge traffic
        against THAT baseline, not the superseded model's. Keeping the
        monitor object (rather than constructing a fresh one) keeps the
        process-global gauge families and the transition counters — the
        promotion shows up as a journaled ``alert → ok`` transition on the
        same series, which is the whole closed-loop story.

        The window rings are cleared (rows were binned under the OLD
        profile's edges — re-judging them against new edges would be
        statistics over garbage indices), and the drift statistics reset
        to not-computable until ``min_rows`` fresh rows arrive. The status
        is deliberately NOT reset: the recovery to ``ok`` must be earned
        by post-swap traffic and journaled as a real transition, never
        declared by the swap itself.

        The new profile must describe the same feature space (same F —
        the gauge label set is fixed at construction); bin counts may
        differ. Raises ``ValueError`` on a mismatched profile, leaving
        the monitor untouched.
        """
        prof = _as_host_profile(profile)
        F, B = prof["bin_counts"].shape
        if F != self._F:
            raise ValueError(
                f"rebase profile is {F} features wide, monitor is {self._F}"
            )
        with self._refresh_lock, self._lock:
            self._epoch += 1  # invalidates in-flight old-edge binnings
            self._profile = prof
            self._B = int(B)
            self._S = int(prof["score_counts"].shape[0])
            self._mins, self._widths = profile_bin_geometry(prof)
            self._feat_ring[:] = 0
            self._score_ring[:] = 0
            self._score_val_ring[:] = 0.0
            self._dis_ring[:] = np.nan
            self._rows = 0
            self._last_refresh_rows = 0
            self._last_refresh_t = float("-inf")
            self._feature_psi = np.full(self._F, np.nan)
            self._feature_ks = np.full(self._F, np.nan)
            self._score_psi = float("nan")
            self._disagreement = float("nan")
        for name in self.feature_names:
            self._g_feature_psi.set(float("nan"), feature=name)
            self._g_feature_ks.set(float("nan"), feature=name)
        self._g_score_psi.get().set(float("nan"))
        self._g_disagreement.get().set(float("nan"))
        self._g_window.get().set(0.0)
        journal.event(
            "quality_rebased",
            reference_rows=int(prof["n_rows"]),
            feature_bins=int(B),
        )

    # -- export -------------------------------------------------------------

    @property
    def n_features(self) -> int:
        """Width of the monitored row space (the reference profile's F) —
        callers validate it against what they will actually feed."""
        return self._F

    @property
    def status(self) -> str:
        with self._lock:
            return self._status

    def health(self) -> dict:
        """The compact ``/healthz`` block: status + the single worst
        offender, so an orchestrator can act on drift without scraping the
        full ``/debug/quality`` payload."""
        with self._lock:
            if self._disabled_reason is not None:
                return {"status": "disabled", "reason": self._disabled_reason}
            status = self._status
            f_psi = self._feature_psi
            s_psi = self._score_psi
        worst_f, worst_psi = self._worst(f_psi, s_psi)
        return {
            "status": status,
            "worst_feature": worst_f,
            "worst_psi": _round(worst_psi),
        }

    def snapshot(self, detail: bool = False) -> dict:
        """The ``/debug/quality`` payload. Always strict-JSON-safe: every
        not-yet-computable statistic is ``None``, never NaN."""
        with self._lock:
            disabled = self._disabled_reason
        if disabled is not None:
            return disabled_snapshot(disabled)
        self._refresh()
        n, fidx, sidx, svals, dis = self._window_copy()
        with self._lock:
            status = self._status
            f_psi = self._feature_psi.copy()
            f_ks = self._feature_ks.copy()
            s_psi = self._score_psi
            disagreement = self._disagreement
            rows_total = self._rows_total
            transitions = [dict(t) for t in self._transitions]
        worst_f, worst_psi = self._worst(f_psi, s_psi)
        out = {
            "enabled": True,
            "status": status,
            "rows_total": rows_total,
            "window_rows": n,
            "min_rows": self.min_rows,
            "thresholds": {
                "warn_psi": self.warn_psi, "alert_psi": self.alert_psi,
            },
            "score_psi": _round(_null_if_nan(s_psi)),
            "member_disagreement": _round(_null_if_nan(disagreement)),
            "worst_feature": worst_f,
            "worst_psi": _round(worst_psi),
            # The bounded recent-transition ring (newest last): the
            # continual-learning trigger debounces from this one payload
            # instead of tailing the journal (docs/CONTINUAL.md).
            "transitions": transitions,
            "reference": {
                "n_rows": int(self._profile["n_rows"]),
                "feature_bins": self._B,
                "score_bins": self._S,
                "version": int(self._profile.get("version", 1)),
            },
        }
        if not detail:
            return out
        ref_mean = self._profile.get("mean")
        features = []
        for f, name in enumerate(self.feature_names):
            counts = np.bincount(fidx[:, f], minlength=self._B) if n else None
            w_mean = None
            if n:
                # Window mean reconstructed from bin midpoints (the monitor
                # stores indices, not values) — a diagnostic, not a statistic.
                mids = 0.5 * (
                    self._profile["bin_edges"][f, :-1]
                    + self._profile["bin_edges"][f, 1:]
                )
                w_mean = float((mids * counts).sum() / counts.sum())
            features.append({
                "name": name,
                "psi": _round(_null_if_nan(float(f_psi[f]))),
                "ks": _round(_null_if_nan(float(f_ks[f]))),
                "window_mean_binned": _round(w_mean),
                "reference_mean": (
                    _round(float(ref_mean[f])) if ref_mean is not None else None
                ),
            })
        features.sort(key=lambda d: -1.0 if d["psi"] is None else d["psi"],
                      reverse=True)
        calib_count = np.bincount(sidx, minlength=self._S) if n else np.zeros(
            self._S, np.int64
        )
        calib_mean = []
        for b in range(self._S):
            m = sidx == b if n else np.zeros(0, bool)
            calib_mean.append(
                _round(float(svals[m].mean())) if n and m.any() else None
            )
        out["features"] = features
        out["calibration"] = {
            "edges": [round(float(e), 6) for e in self._profile["score_edges"]],
            "count": [int(c) for c in calib_count],
            "mean_score": calib_mean,
            "reference_pos_rate": [
                _round(_null_if_nan(float(v)))
                for v in self._profile.get(
                    "calib_pos_rate", np.full(self._S, np.nan)
                )
            ],
            "reference_count": [
                int(c) for c in self._profile["score_counts"]
            ],
        }
        return out


def disabled_snapshot(reason: str) -> dict:
    """The ``/debug/quality`` payload when no monitor is running."""
    return {"enabled": False, "status": "disabled", "reason": reason}


# ---------------------------------------------------------------------------
# Asynchronous hand-off feed
# ---------------------------------------------------------------------------


class AsyncQualityFeed:
    """Bounded hand-off queue between the serving hot path and the
    monitor, serviced by one background daemon thread.

    The r11 bench campaign measured the synchronous feed at ~30% of
    saturated serving throughput: every flush paid binning + ring writes
    + (every ``refresh_rows``) the whole PSI/KS pass *inside the flush
    thread*. This class moves all of that off the hot path:
    ``observe_batch`` now costs three array copies and a deque append —
    the monitor's math runs on the feed thread.

    Backpressure is sampling, then shedding, always counted: while the
    queue sits at or above half of ``capacity`` incoming batches are
    row-sampled (every ``sample_stride``-th row — drift statistics are
    distribution estimates, and an unbiased row subsample keeps them
    honest while cutting the backlog); at full ``capacity`` the batch is
    dropped whole. Both land in
    ``quality_feed_dropped_rows_total{reason=sampled|overflow}`` and in
    per-feed ``stats()``, so a pressured feed is visible, never silent.

    A monitor that raises on the feed thread (mis-sized profile, NaN
    rows) quarantines exactly like the old in-engine path did: one
    journaled ``quality_feed_disabled``, ``monitor.disable(...)`` so
    every surface says so, and the feed goes dead (drops counted) until
    ``reenable`` — which the supervisor calls after a successful engine
    restart, exactly as before.
    """

    def __init__(
        self,
        monitor: "QualityMonitor",
        capacity: int = 64,
        sample_stride: int = 4,
    ) -> None:
        if capacity < 2 or sample_stride < 2:
            raise ValueError("need capacity >= 2 and sample_stride >= 2")
        self.monitor = monitor
        self.capacity = int(capacity)
        self.sample_stride = int(sample_stride)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: list[tuple] = []
        self._dead = False
        self._closed = False
        self._busy = False  # feed thread mid-observe (drain() waits on it)
        self._dropped_rows = 0
        self._sampled_out_rows = 0
        self._observed_rows = 0
        self._c_dropped = QUALITY_FEED_DROPPED
        self._g_depth = QUALITY_FEED_DEPTH
        self._g_depth.get().set(0.0)
        self._thread = threading.Thread(
            target=self._loop, name="quality-feed", daemon=True
        )
        self._thread.start()

    # -- hot path ----------------------------------------------------------

    def observe_batch(self, X, p1, members=None) -> None:
        """Hand one batch off to the feed thread. Never raises on the hot
        path (monitor failures surface on the feed thread and quarantine
        there); array arguments are copied so the caller's buffers are
        free the moment this returns — but only for batches that are
        actually enqueued: the dead/overflow drop paths are copy-free
        (under sustained overload, exactly when the shed path runs
        hottest, a dropped batch must not cost three array copies)."""
        n = int(np.shape(X)[0]) if np.ndim(X) == 2 else 0
        drop_reason = self._drop_reason(n)
        if drop_reason is None:
            sample = None
            with self._lock:
                if len(self._q) >= self.capacity // 2 \
                        and n > self.sample_stride:
                    sample = slice(None, None, self.sample_stride)
            X = np.array(X, np.float64, copy=True)[sample or slice(None)]
            p1 = np.array(p1, np.float64, copy=True).ravel()[
                sample or slice(None)
            ]
            if members is not None:
                members = np.array(members, np.float64, copy=True)[
                    sample or slice(None)
                ]
            if sample is not None:
                kept = X.shape[0]
                with self._lock:
                    self._sampled_out_rows += n - kept
                self._c_dropped.inc(n - kept, reason="sampled")
            with self._lock:
                # Re-check under the lock: the queue may have filled (or
                # the feed died) between the cheap pre-check and the
                # copies.
                if self._dead or self._closed:
                    drop_reason = "dead"
                elif len(self._q) >= self.capacity:
                    drop_reason = "overflow"
                else:
                    self._q.append((X, p1, members))
                    self._g_depth.get().set(float(len(self._q)))
                    self._cv.notify()
                if drop_reason is not None:
                    self._dropped_rows += X.shape[0]
                    n = X.shape[0]  # sampled-out rows already accounted
        if drop_reason is not None:
            self._c_dropped.inc(n, reason=drop_reason)

    def _drop_reason(self, n: int) -> str | None:
        """Cheap pre-copy shed check; accounts the drop when it says so."""
        with self._lock:
            if self._dead or self._closed:
                self._dropped_rows += n
                return "dead"
            if len(self._q) >= self.capacity:
                self._dropped_rows += n
                return "overflow"
        return None

    # -- feed thread -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return  # closed and drained
                X, p1, members = self._q.pop(0)
                self._g_depth.get().set(float(len(self._q)))
                self._busy = True
            try:
                if not self._dead:
                    self.monitor.observe_batch(X, p1, members)
                    with self._lock:
                        self._observed_rows += int(X.shape[0])
                else:
                    # Batches that were already queued when the feed
                    # quarantined: discarded, but never silently — the
                    # offered = observed + sampled_out + dropped identity
                    # must hold through a quarantine too.
                    with self._lock:
                        self._dropped_rows += int(X.shape[0])
                    self._c_dropped.inc(int(X.shape[0]), reason="dead")
            except Exception as exc:
                # Same quarantine contract as the old in-engine feed:
                # telemetry must never take serving down, and a dead
                # monitor must say so on every surface. The poison
                # batch's own rows count as dropped — they never reached
                # the window.
                msg = f"{type(exc).__name__}: {exc}"
                journal.event("quality_feed_disabled", error=msg)
                self.monitor.disable(f"feed quarantined: {msg}")
                with self._lock:
                    self._dead = True
                    self._dropped_rows += int(X.shape[0])
                self._c_dropped.inc(int(X.shape[0]), reason="dead")
            finally:
                with self._lock:
                    self._busy = False
                    self._cv.notify_all()

    # -- control / inspection ----------------------------------------------

    def drain(self, timeout: float = 2.0) -> bool:
        """Block until every handed-off batch has been observed (or the
        timeout passes); True when fully drained. ``/debug/quality`` uses
        this so a snapshot taken right after traffic reflects that
        traffic — the asynchrony is a hot-path optimization, not an
        accuracy tax on debugging."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._q or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def disable(self, reason: str) -> None:
        """Forward a quarantine request (the engine's last-resort path if
        the hand-off itself ever raised)."""
        with self._lock:
            self._dead = True
        self.monitor.disable(reason)

    def reenable(self) -> bool:
        """Clear a quarantine (the supervisor calls this after a
        successful engine restart). True when something was cleared."""
        with self._lock:
            was_dead, self._dead = self._dead, False
        cleared = self.monitor.reenable()
        return was_dead or cleared

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "depth": len(self._q),
                "observed_rows": self._observed_rows,
                "sampled_out_rows": self._sampled_out_rows,
                "dropped_rows": self._dropped_rows,
                "dead": self._dead,
            }

    def close(self, timeout: float = 5.0) -> None:
        """Stop the feed thread after draining what is already queued."""
        with self._lock:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

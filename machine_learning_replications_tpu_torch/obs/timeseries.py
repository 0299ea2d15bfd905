"""In-process time-series history: the substrate alert rules read.

The registry (`obs.registry`) answers "what is the value *now*"; alert
rules need "what has the value been doing" — a burn rate sustained for
five minutes, a gauge absent for thirty seconds, a PSI that moved 0.2
in a window. `TimeSeriesStore` closes that gap without an external TSDB:
a sampler thread snapshots the process-global registry (and, on the
router, the merged fleet page) at a fixed interval into bounded
per-series rings with tiered downsampling —

* **raw tier**: every sample at the sampling interval (default 10 s),
  kept for `raw_retention_s` (default 15 min);
* **aggregate tier**: one point per `agg_bucket_s` (default 1 min),
  kept for `agg_retention_s` (default 4 h). Each point carries the
  bucket's *average* (the right long-window summary for a gauge) and
  its *last* value (the right one for a cumulative counter — rate math
  needs the level at the bucket edge, not the mean of levels).

Scalar derivations are counter-reset-safe: `rate()` sums only positive
deltas (a restart's drop to zero contributes nothing), `delta()` reads
newest minus oldest for rate-of-change rules. Histograms keep their
cumulative bucket vectors in the raw tier only, and `quantile()`
computes a Prometheus-style interpolated quantile over the *windowed
delta* of those vectors — "p99 over the last 5 minutes", not since
process start.

Timestamps are wall-clock on purpose: history points must line up with
journal lines and incident bundles, and a query window of "the last
900 s" tolerates the same clock-step caveats Prometheus does. Tests
inject synthetic `now` values; production passes `time.time()`.

Everything here is jax-free and allocation-bounded: series count is
whatever the registry holds, each series holds at most
`raw_retention_s / interval + agg_retention_s / agg_bucket_s` points.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from machine_learning_replications_tpu_torch.obs.registry import (
    REGISTRY,
    MetricsRegistry,
)

HISTORY_SAMPLES = REGISTRY.counter(
    "history_samples_total",
    "Sampling ticks the time-series history store has ingested.",
)
HISTORY_SERIES = REGISTRY.gauge(
    "history_series",
    "Live series (family x label combination) held by the history "
    "store.",
)

_SCALAR_KINDS = ("counter", "gauge")


def collect_registry(registry: MetricsRegistry = REGISTRY) -> dict:
    """One sampling pass over a live registry, in the same normalized
    shape ``fleetmetrics.parse_exposition`` produces — ``{family:
    {"kind", "series": {((label, value), ...): sample}}}`` — so the
    store ingests local instruments and scraped pages identically."""
    families: dict[str, dict] = {}
    for fam in registry.families():
        series: dict = {}
        for label_values, child in fam.collect():
            key = tuple(sorted(zip(fam.label_names, label_values)))
            if fam.kind == "histogram":
                series[key] = child.snapshot()
            else:
                series[key] = float(child.value)
        families[fam.name] = {"kind": fam.kind, "series": series}
    return families


class _Series:
    """One (family, label-set) stream: a raw ring plus, for scalars, the
    aggregate ring and the in-progress bucket it flushes from."""

    __slots__ = (
        "kind", "raw", "agg", "bucket_start", "bucket_sum", "bucket_n",
        "bucket_last",
    )

    def __init__(self, kind: str, raw_cap: int, agg_cap: int) -> None:
        self.kind = kind
        self.raw: deque = deque(maxlen=raw_cap)
        self.agg: deque = deque(maxlen=agg_cap)
        self.bucket_start: float | None = None
        self.bucket_sum = 0.0
        self.bucket_n = 0
        self.bucket_last = 0.0


class TimeSeriesStore:
    """Bounded, thread-safe history over normalized family snapshots.

    ``ingest(families, now)`` is the only writer (one sampler thread);
    every reader takes the same lock, copies out, and computes outside
    it — queries are served from bounded in-memory rings, never I/O."""

    def __init__(
        self,
        interval_s: float = 10.0,
        raw_retention_s: float = 900.0,
        agg_bucket_s: float = 60.0,
        agg_retention_s: float = 14400.0,
    ) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if agg_bucket_s < interval_s:
            raise ValueError("agg_bucket_s must be >= interval_s")
        self.interval_s = float(interval_s)
        self.raw_retention_s = float(raw_retention_s)
        self.agg_bucket_s = float(agg_bucket_s)
        self.agg_retention_s = float(agg_retention_s)
        # +2: the ring must hold the boundary sample a full-window query
        # differences against, plus one slot of scheduling jitter.
        self._raw_cap = int(raw_retention_s / interval_s) + 2
        self._agg_cap = int(agg_retention_s / agg_bucket_s) + 2
        self._lock = threading.Lock()
        self._series: dict[tuple[str, tuple], _Series] = {}
        self._last_ingest_t: float | None = None
        self._ticks = 0

    # -- write path ---------------------------------------------------------

    def ingest(self, families: dict, now: float) -> None:
        """One sampling tick: fold every series of every family in."""
        with self._lock:
            for name, fam in families.items():
                kind = fam.get("kind")
                if kind not in ("counter", "gauge", "histogram"):
                    continue
                for key, value in fam.get("series", {}).items():
                    sid = (name, tuple(key))
                    s = self._series.get(sid)
                    if s is None:
                        s = self._series[sid] = _Series(
                            kind, self._raw_cap, self._agg_cap
                        )
                    self._ingest_one(s, value, now)
            self._last_ingest_t = now
            self._ticks += 1
            n_series = len(self._series)
        HISTORY_SAMPLES.get().inc()
        HISTORY_SERIES.get().set(float(n_series))

    def _ingest_one(self, s: _Series, value, now: float) -> None:
        if s.kind == "histogram":
            s.raw.append((now, {
                "buckets": dict(value.get("buckets", {})),
                "sum": float(value.get("sum", 0.0)),
                "count": float(value.get("count", 0.0)),
            }))
            return
        v = float(value)
        if v != v:
            # A NaN gauge means "no reading this poll" (the
            # autoscale_signal convention): store nothing — absence is
            # the honest record, and NaN would poison every window
            # aggregate downstream.
            return
        s.raw.append((now, v))
        if s.bucket_start is None:
            s.bucket_start = now
        elif now - s.bucket_start >= self.agg_bucket_s:
            if s.bucket_n:
                s.agg.append((
                    s.bucket_start, s.bucket_sum / s.bucket_n,
                    s.bucket_last,
                ))
            s.bucket_start = now
            s.bucket_sum = 0.0
            s.bucket_n = 0
        s.bucket_sum += v
        s.bucket_n += 1
        s.bucket_last = v

    # -- read path ----------------------------------------------------------

    def families(self) -> dict[str, int]:
        """``{family: live series count}`` — the no-arg answer of
        ``/debug/history``."""
        with self._lock:
            out: dict[str, int] = {}
            for (name, _key) in self._series:
                out[name] = out.get(name, 0) + 1
            return dict(sorted(out.items()))

    def last_sample_age_s(self, family: str, now: float) -> float | None:
        """Seconds since the newest sample of *any* series of `family`
        (None when the family has never been sampled) — the absence
        rule's primitive."""
        newest = None
        with self._lock:
            for (name, _key), s in self._series.items():
                if name != family or not s.raw:
                    continue
                t = s.raw[-1][0]
                if newest is None or t > newest:
                    newest = t
        return None if newest is None else max(0.0, now - newest)

    def _select(self, family: str, labels: dict | None):
        """Matching (labels_dict, _Series) pairs; `labels` is a subset
        filter (every given pair must match)."""
        want = {(k, str(v)) for k, v in (labels or {}).items()}
        out = []
        for (name, key), s in self._series.items():
            if name != family:
                continue
            if want and not want <= set(key):
                continue
            out.append((dict(key), s))
        return out

    def window(
        self, family: str, window_s: float, now: float,
        labels: dict | None = None,
    ) -> list[tuple[dict, list]]:
        """Per matching series: raw points inside ``[now - window_s,
        now]``, prefixed by aggregate-tier points older than the raw
        tier still covers. Scalar points are ``(t, value)``; histogram
        points are ``(t, snapshot_dict)``."""
        t_from = now - float(window_s)
        with self._lock:
            picked = [
                (lab, s.kind, list(s.raw), list(s.agg))
                for lab, s in self._select(family, labels)
            ]
        out = []
        for lab, kind, raw, agg in picked:
            pts: list = []
            raw_start = raw[0][0] if raw else now
            if kind in _SCALAR_KINDS:
                # Aggregate points cover the span the raw ring has
                # already forgotten: average for gauges, bucket-edge
                # level for counters (rate math needs levels).
                use = 1 if kind == "gauge" else 2
                pts = [
                    (t, point[use])
                    for point in agg
                    if t_from <= (t := point[0]) < raw_start
                ]
            pts.extend(p for p in raw if p[0] >= t_from)
            if pts:
                out.append((lab, pts))
        return out

    def latest(
        self, family: str, labels: dict | None = None,
    ) -> list[tuple[dict, float, float]]:
        """Per matching scalar series: ``(labels, t, value)`` of the
        newest sample."""
        with self._lock:
            picked = [
                (lab, s.raw[-1])
                for lab, s in self._select(family, labels)
                if s.kind in _SCALAR_KINDS and s.raw
            ]
        return [(lab, t, v) for lab, (t, v) in picked]

    def avg(
        self, family: str, window_s: float, now: float,
        labels: dict | None = None,
    ) -> list[tuple[dict, float]]:
        """Per matching scalar series: mean over the window."""
        out = []
        for lab, pts in self.window(family, window_s, now, labels):
            vals = [v for _t, v in pts if isinstance(v, float)]
            if vals:
                out.append((lab, sum(vals) / len(vals)))
        return out

    def rate(
        self, family: str, window_s: float, now: float,
        labels: dict | None = None,
    ) -> list[tuple[dict, float]]:
        """Per matching counter series: increase per second over the
        window, reset-safe (only positive deltas count — a restart's
        drop to zero is a reset, not a negative rate)."""
        out = []
        for lab, pts in self.window(family, window_s, now, labels):
            pts = [(t, v) for t, v in pts if isinstance(v, float)]
            if len(pts) < 2:
                continue
            elapsed = pts[-1][0] - pts[0][0]
            if elapsed <= 0:
                continue
            inc = sum(
                max(0.0, b[1] - a[1]) for a, b in zip(pts, pts[1:])
            )
            out.append((lab, inc / elapsed))
        return out

    def delta(
        self, family: str, window_s: float, now: float,
        labels: dict | None = None,
    ) -> list[tuple[dict, float]]:
        """Per matching scalar series: newest minus oldest inside the
        window — the rate-of-change rule's primitive."""
        out = []
        for lab, pts in self.window(family, window_s, now, labels):
            pts = [(t, v) for t, v in pts if isinstance(v, float)]
            if len(pts) >= 2:
                out.append((lab, pts[-1][1] - pts[0][1]))
        return out

    def quantile(
        self, family: str, q: float, window_s: float, now: float,
        labels: dict | None = None,
    ) -> list[tuple[dict, float]]:
        """Per matching histogram series: interpolated quantile of the
        observations that landed *inside the window* (bucket-count delta
        between the window's edges), Prometheus `histogram_quantile`
        style: linear within the bucket, upper bound for +Inf."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        t_from = now - float(window_s)
        with self._lock:
            picked = [
                (lab, list(s.raw))
                for lab, s in self._select(family, labels)
                if s.kind == "histogram" and s.raw
            ]
        out = []
        for lab, raw in picked:
            newest = raw[-1][1]
            # The newest point at-or-before the window start is the
            # baseline; absent one (young series), the delta is the
            # newest cumulative state itself.
            base = None
            for t, snap in raw:
                if t <= t_from:
                    base = snap
                else:
                    break
            value = _histogram_delta_quantile(base, newest, q)
            if value is not None:
                out.append((lab, value))
        return out

    # -- dumps --------------------------------------------------------------

    def query(
        self, family: str, window_s: float | None, now: float,
        labels: dict | None = None,
    ) -> dict:
        """The ``/debug/history`` payload for one family."""
        window_s = float(window_s) if window_s else self.raw_retention_s
        series = []
        for lab, pts in self.window(family, window_s, now, labels):
            # Scalar points serialize as [t, value]; histogram points as
            # [t, count, sum] (buckets stay internal — quantile() is the
            # way to read them).
            series.append({
                "labels": lab,
                "points": [
                    [round(t, 3), v] if isinstance(v, float)
                    else [round(t, 3), v["count"], v["sum"]]
                    for t, v in pts
                ],
            })
        return {
            "family": family,
            "window_s": window_s,
            "interval_s": self.interval_s,
            "series": series,
        }

    def dump(self, window_s: float, now: float) -> dict:
        """Every family's windowed view — the incident bundle's
        ``history.json``."""
        return {
            name: self.query(name, window_s, now)
            for name in self.families()
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "ticks": self._ticks,
                "interval_s": self.interval_s,
                "raw_retention_s": self.raw_retention_s,
                "agg_bucket_s": self.agg_bucket_s,
                "agg_retention_s": self.agg_retention_s,
            }


def _histogram_delta_quantile(base, newest, q: float) -> float | None:
    """Interpolated quantile of (newest - base) cumulative buckets."""
    deltas = []
    for le, cum in newest.get("buckets", {}).items():
        prev = (base or {}).get("buckets", {}).get(le, 0.0)
        d = max(0.0, float(cum) - float(prev))
        bound = float("inf") if le in ("+Inf", "inf") else float(le)
        deltas.append((bound, d))
    deltas.sort(key=lambda x: x[0])
    if not deltas:
        return None
    total = deltas[-1][1]
    if total <= 0:
        return None
    rank = q * total
    lower = 0.0
    prev_cum = 0.0
    for bound, cum in deltas:
        if cum >= rank:
            if bound == float("inf"):
                # Open-ended top bucket: report its lower edge (the
                # last finite bound) — the honest answer Prometheus
                # gives too.
                return lower
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return lower + (bound - lower) * frac
        lower = 0.0 if bound == float("inf") else bound
        prev_cum = cum
    return lower


class HistorySampler:
    """The sampling thread: every `interval_s`, call `collect()` for a
    normalized family map, `ingest` it, then run `on_tick(now)` (the
    alert engine's evaluation hook). Collection failures are swallowed
    per-tick — a scrape hiccup must not kill the history plane — and
    surfaced through the absence of fresh samples, which is exactly
    what staleness rules watch."""

    def __init__(
        self,
        store: TimeSeriesStore,
        collect,
        interval_s: float | None = None,
        on_tick=None,
    ) -> None:
        self.store = store
        self.collect = collect
        self.interval_s = float(interval_s or store.interval_s)
        self.on_tick = on_tick
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "HistorySampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="history-sampler", daemon=True
            )
            self._thread.start()
        return self

    def tick(self, now: float | None = None) -> None:
        """One synchronous sampling pass (tests and the thread body)."""
        if now is None:
            now = time.time()  # graftcheck: disable=monotonic-clock
        try:
            self.store.ingest(self.collect(), now)
        except Exception:
            pass
        if self.on_tick is not None:
            try:
                self.on_tick(now)
            except Exception:
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

"""Process-global metrics registry: labeled instrument families.

Copy of the JAX package's ``obs/registry.py`` (stdlib + numpy): the
primitive instruments ``Counter`` / ``Gauge`` / ``Histogram``, labeled
families over them (``family.labels(direction="h2d")``, the Prometheus data
model) and a registry that renders every family as one Prometheus text
exposition page, byte for byte as the JAX registry renders the same
sequence of operations. ``REGISTRY`` is the port's process-global instance:
``obs.torchmon`` feeds graph-capture, kernel-build, kernel-launch and
transfer accounting into it.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np


class Counter:
    """Monotonic counter (thread-safe). Accepts float increments so it can
    accumulate seconds as well as event counts; the value stays an ``int``
    while only ints are added (the serving exposition's existing rendering
    relies on that)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Cumulative-bucket histogram plus a quantile ring.

    ``buckets`` are upper bounds (``le``) in ascending order; an implicit
    +Inf bucket catches the tail. ``quantile`` interpolates over the ring
    of the most recent ``ring_size`` observations (numpy percentile,
    linear interpolation), so p50/p95/p99 track current traffic instead of
    the process's whole life.
    """

    def __init__(self, buckets: Sequence[float], ring_size: int = 8192) -> None:
        self._lock = threading.Lock()
        self._bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._bounds) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._ring = np.empty(ring_size, np.float64)
        self._ring_n = 0  # total ever written; ring index = n % size

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            while i < len(self._bounds) and v > self._bounds[i]:
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._ring[self._ring_n % self._ring.shape[0]] = v
            self._ring_n += 1

    def observe_many(self, values) -> None:
        """Record a batch of observations under ONE lock acquisition —
        the serving flush path records a whole micro-batch's latencies
        and queue waits at once, and per-row lock round-trips are
        measurable at a thousand requests per second."""
        vs = [float(v) for v in values]
        if not vs:
            return
        with self._lock:
            size = self._ring.shape[0]
            for v in vs:
                i = 0
                while i < len(self._bounds) and v > self._bounds[i]:
                    i += 1
                self._counts[i] += 1
                self._sum += v
                self._ring[self._ring_n % size] = v
                self._ring_n += 1
            self._count += len(vs)

    def quantile(self, q: float | Sequence[float]):
        """Quantile(s) in [0, 1] over the recent-observation ring
        (NaN when empty)."""
        with self._lock:
            n = min(self._ring_n, self._ring.shape[0])
            window = self._ring[:n].copy()
        if n == 0:
            return (
                float("nan")
                if isinstance(q, float)
                else [float("nan")] * len(list(q))
            )
        out = np.percentile(window, np.asarray(q, np.float64) * 100.0)
        return float(out) if isinstance(q, float) else [float(x) for x in out]

    def snapshot(self) -> dict:
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
            return {
                "buckets": {
                    **{str(b): cum[i] for i, b in enumerate(self._bounds)},
                    "+Inf": cum[-1],
                },
                "sum": self._sum,
                "count": self._count,
            }


# ---------------------------------------------------------------------------
# Labeled families + registry
# ---------------------------------------------------------------------------

_NAME_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def _check_name(name: str, what: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK or (
        what == "label" and ":" in name
    ):
        raise ValueError(f"invalid {what} name {name!r}")
    return name


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: int | float) -> str:
    if isinstance(v, bool):  # bool is an int subclass; never a sample value
        raise TypeError("metric value cannot be bool")
    if isinstance(v, int):
        return str(v)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class Family:
    """One named metric with zero or more label dimensions; children are
    created on first ``labels(...)`` call and live for the process."""

    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = ()) -> None:
        self.name = _check_name(name, "metric")
        self.help = help_.replace("\n", " ")
        self.label_names = tuple(
            _check_name(label_name, "label") for label_name in label_names
        )
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv: str):
        """The child instrument for this label combination (created once).
        Every declared label must be supplied, no extras."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {sorted(self.label_names)}, "
                f"got {sorted(kv)}"
            )
        key = tuple(str(kv[label_name]) for label_name in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def get(self):
        """The unlabeled singleton child (only for families declared with
        no label dimensions)."""
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self.labels()

    def remove(self, **kv: str) -> bool:
        """Retire one label combination: the series disappears from the
        exposition instead of lingering forever at its last value (a
        deregistered replica's ``fleet_scrape_stale`` must not read as a
        stuck fact). Returns whether the child existed. A later
        ``labels(...)`` with the same combination starts a fresh child —
        counters restart at zero, which scrape differs must treat as a
        reset, exactly as they must across a process restart."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {sorted(self.label_names)}, "
                f"got {sorted(kv)}"
            )
        key = tuple(str(kv[label_name]) for label_name in self.label_names)
        with self._lock:
            return self._children.pop(key, None) is not None

    def collect(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def _series(self, label_values: tuple[str, ...],
                extra: dict[str, str] | None = None) -> str:
        pairs = list(zip(self.label_names, label_values))
        if extra:
            pairs += list(extra.items())
        if not pairs:
            return self.name
        inner = ",".join(
            f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
        )
        return f"{self.name}{{{inner}}}"

    def render(self, lines: list[str]) -> None:
        lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for label_values, child in self.collect():
            self._render_child(lines, label_values, child)

    def _render_child(self, lines, label_values, child) -> None:
        raise NotImplementedError

    def snapshot(self):
        # Unlabeled families snapshot as their bare value — a JSON
        # consumer should read {"torch_graph_captures_total": 12}, not
        # index a magic empty-string label key.
        if not self.label_names:
            return self._snap_child(self.labels())
        out = {}
        for label_values, child in self.collect():
            key = ",".join(
                f"{k}={v}" for k, v in zip(self.label_names, label_values)
            )
            out[key] = self._snap_child(child)
        return out

    def _snap_child(self, child):
        raise NotImplementedError


class CounterFamily(Family):
    kind = "counter"

    def _make_child(self) -> Counter:
        return Counter()

    def inc(self, n: int | float = 1, **kv: str) -> None:
        self.labels(**kv).inc(n)

    def _render_child(self, lines, label_values, child) -> None:
        lines.append(f"{self._series(label_values)} {_fmt_value(child.value)}")

    def _snap_child(self, child):
        return child.value


class GaugeFamily(Family):
    kind = "gauge"

    def _make_child(self) -> Gauge:
        return Gauge()

    def set(self, v: float, **kv: str) -> None:
        self.labels(**kv).set(v)

    def _render_child(self, lines, label_values, child) -> None:
        lines.append(f"{self._series(label_values)} {_fmt_value(child.value)}")

    def _snap_child(self, child):
        # NaN is the text exposition's legal "no data" gauge value
        # (obs.quality uses it before min_rows), but a bare NaN token is
        # not strict JSON — snapshots are JSON payloads, so it becomes
        # null there (the serving layer's established convention).
        v = child.value
        return None if v != v else v


class HistogramFamily(Family):
    kind = "histogram"

    def __init__(self, name, help_, buckets: Sequence[float],
                 label_names: Sequence[str] = ()) -> None:
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _make_child(self) -> Histogram:
        return Histogram(self.buckets)

    def observe(self, v: float, **kv: str) -> None:
        self.labels(**kv).observe(v)

    def _render_child(self, lines, label_values, child) -> None:
        snap = child.snapshot()
        # Sample names carry the Prometheus histogram suffixes; the label
        # set (if any) rides after the suffix, with `le` appended on
        # buckets.
        labels_tail = self._series(label_values)[len(self.name):]
        for le, c in snap["buckets"].items():
            with_le = self._series(label_values, {"le": le})[len(self.name):]
            lines.append(f"{self.name}_bucket{with_le} {c}")
        lines.append(f"{self.name}_sum{labels_tail} {_fmt_value(snap['sum'])}")
        lines.append(f"{self.name}_count{labels_tail} {snap['count']}")

    def _snap_child(self, child):
        return child.snapshot()


class MetricsRegistry:
    """Named families, registered once, rendered as one exposition page.

    Re-declaring an existing name returns the existing family — provided
    kind and label set match (a process-global registry must be safe to
    declare into from several modules' import paths)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _get_or_make(self, cls, name, help_, label_names, **kw) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or (
                    fam.label_names != tuple(label_names)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}"
                    )
                return fam
            fam = cls(name, help_, label_names=label_names, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str,
                labels: Sequence[str] = ()) -> CounterFamily:
        return self._get_or_make(CounterFamily, name, help_, labels)

    def gauge(self, name: str, help_: str,
              labels: Sequence[str] = ()) -> GaugeFamily:
        return self._get_or_make(GaugeFamily, name, help_, labels)

    def histogram(self, name: str, help_: str, buckets: Sequence[float],
                  labels: Sequence[str] = ()) -> HistogramFamily:
        return self._get_or_make(
            HistogramFamily, name, help_, labels, buckets=buckets
        )

    def families(self) -> list[Family]:
        with self._lock:
            return list(self._families.values())

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family
        (empty string when nothing has been registered — callers append
        this to other expositions)."""
        lines: list[str] = []
        for fam in self.families():
            fam.render(lines)
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        return {
            fam.name: fam.snapshot() for fam in self.families()
        }


#: The process-global registry: the port's runtime accounting
#: (``obs.torchmon``) lands here.
REGISTRY = MetricsRegistry()

"""Declarative latency/availability SLOs with error-budget burn gauges.

An SLO is a target over a ratio of *good* events: "99% of requests answer
under 250 ms", "99.9% of admitted requests don't fail server-side". The
quantity an operator alarms on is not the ratio itself but the **burn
rate** (SRE workbook ch. 5): how fast the error budget — the allowed
fraction of bad events, ``1 − target`` — is being spent. Burn rate 1.0
means bad events arrive exactly at the sustainable rate; 10× means the
budget burns ten times too fast and the pager should fire long before the
monthly window is blown.

``SLOTracker`` evaluates each completed request against every declared
``SLO`` and exports, through the existing process-global registry (so the
gauges ride the same ``/metrics`` page and validator as everything else):

  ``slo_requests_total{slo=…}``             counter — events evaluated
  ``slo_bad_total{slo=…}``                  counter — events that violated
  ``slo_good_ratio{slo=…}``                 gauge — recent-window good ratio
  ``slo_burn_rate{slo=…}``                  gauge — window bad ratio ÷ budget
  ``slo_error_budget_remaining_ratio{slo=…}`` gauge — lifetime budget left
                                            (1 = untouched, 0 = spent,
                                            negative = blown)
  ``slo_target_ratio{slo=…}``               gauge — the declared target
                                            (constant; lets a dashboard
                                            draw the objective line
                                            without configuration)

The recent window is a bounded ring of the last ``window`` events (same
bounded-over-unbounded discipline as the metrics latency ring): burn rate
tracks *current* behavior, while the budget-remaining gauge integrates
the whole process lifetime. Everything is stdlib + the registry — no jax.
"""

from __future__ import annotations

import threading
from typing import Sequence

from machine_learning_replications_tpu_torch.obs.registry import (
    REGISTRY,
    MetricsRegistry,
)


class SLO:
    """One objective. ``kind`` is ``"latency"`` (good = ok AND latency ≤
    ``threshold_s``) or ``"availability"`` (good = ok, i.e. the server
    answered the admitted request without shedding/erroring/timing out)."""

    def __init__(
        self,
        name: str,
        target: float,
        kind: str = "latency",
        threshold_s: float | None = None,
    ) -> None:
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        if kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "latency" and (threshold_s is None or threshold_s <= 0):
            raise ValueError("latency SLO needs a positive threshold_s")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.threshold_s = None if threshold_s is None else float(threshold_s)

    @property
    def budget(self) -> float:
        """The error budget: the allowed bad fraction, ``1 − target``."""
        return 1.0 - self.target

    def is_good(self, latency_s: float, ok: bool) -> bool:
        if self.kind == "availability":
            return ok
        return ok and latency_s <= self.threshold_s

    def describe(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "target": self.target,
            **(
                {"threshold_seconds": self.threshold_s}
                if self.threshold_s is not None else {}
            ),
        }


def default_slos(
    latency_ms: float = 250.0,
    latency_target: float = 0.99,
    availability_target: float = 0.999,
) -> list[SLO]:
    """The serving layer's stock objectives (overridable per-flag from
    ``cli.py serve``): p99-style latency under ``latency_ms``, and
    three-nines availability of admitted requests."""
    return [
        SLO(
            f"latency_le_{latency_ms:g}ms", latency_target,
            kind="latency", threshold_s=latency_ms / 1000.0,
        ),
        SLO("availability", availability_target, kind="availability"),
    ]


class _PerSLO:
    __slots__ = ("slo", "total", "bad", "ring", "ring_bad", "ring_n",
                 "c_requests", "c_bad", "g_good", "g_burn", "g_remaining")

    def __init__(self, slo: SLO, window: int) -> None:
        self.slo = slo
        self.total = 0
        self.bad = 0
        self.ring = bytearray(window)  # 1 = bad event, ring of recents
        self.ring_bad = 0
        self.ring_n = 0
        # Child instruments cached at declaration (observe() runs per
        # request on the serving flush path; resolving five label sets
        # per call is measurable at event-loop throughput).
        self.c_requests = self.c_bad = None
        self.g_good = self.g_burn = self.g_remaining = None


class SLOTracker:
    """Evaluates requests against declared SLOs and keeps the registry
    gauges current. One ``observe`` per completed admission decision."""

    def __init__(
        self,
        slos: Sequence[SLO],
        registry: MetricsRegistry | None = None,
        window: int = 2048,
        families: dict | None = None,
    ) -> None:
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        reg = registry or REGISTRY
        self._lock = threading.Lock()
        self._state = [_PerSLO(s, int(window)) for s in slos]
        if families is not None:
            # A caller (the fleet-level tracker in obs.fleetmetrics)
            # supplies pre-registered family objects under its own
            # names; the catalog rule wants family names as literals at
            # their registration site, so the names cannot be built here.
            self._requests = families["requests"]
            self._bad = families["bad"]
            self._good_ratio = families["good_ratio"]
            self._burn = families["burn"]
            self._remaining = families["remaining"]
            self._target = families["target"]
        else:
            self._requests = reg.counter(
                "slo_requests_total", "Requests evaluated against the SLO.",
                labels=("slo",),
            )
            self._bad = reg.counter(
                "slo_bad_total", "Requests that violated the SLO.",
                labels=("slo",),
            )
            self._good_ratio = reg.gauge(
                "slo_good_ratio",
                "Good-event ratio over the recent request window.",
                labels=("slo",),
            )
            self._burn = reg.gauge(
                "slo_burn_rate",
                "Error-budget burn rate over the recent window (bad ratio "
                "/ budget; 1.0 = burning exactly at the sustainable rate).",
                labels=("slo",),
            )
            self._remaining = reg.gauge(
                "slo_error_budget_remaining_ratio",
                "Lifetime error budget remaining (1 = untouched, 0 = "
                "spent, negative = blown).",
                labels=("slo",),
            )
            self._target = reg.gauge(
                "slo_target_ratio", "The declared SLO target (constant).",
                labels=("slo",),
            )
        for st in self._state:
            s = st.slo
            # Materialize every series at declaration: a scrape taken
            # before the first request still shows the objectives. The
            # children are kept — observe() updates them without a label
            # resolution per call.
            st.c_requests = self._requests.labels(slo=s.name)
            st.c_bad = self._bad.labels(slo=s.name)
            st.g_good = self._good_ratio.labels(slo=s.name)
            st.g_burn = self._burn.labels(slo=s.name)
            st.g_remaining = self._remaining.labels(slo=s.name)
            st.g_good.set(1.0)
            st.g_burn.set(0.0)
            st.g_remaining.set(1.0)
            self._target.set(s.target, slo=s.name)

    @property
    def slos(self) -> list[SLO]:
        return [st.slo for st in self._state]

    def observe(self, latency_s: float, ok: bool) -> None:
        for st in self._state:
            good = st.slo.is_good(latency_s, ok)
            with self._lock:
                st.total += 1
                if not good:
                    st.bad += 1
                i = st.ring_n % len(st.ring)
                if st.ring_n >= len(st.ring):
                    st.ring_bad -= st.ring[i]
                st.ring[i] = 0 if good else 1
                st.ring_bad += st.ring[i]
                st.ring_n += 1
                n_window = min(st.ring_n, len(st.ring))
                bad_ratio = st.ring_bad / n_window
                lifetime_bad_ratio = st.bad / st.total
            budget = st.slo.budget
            st.c_requests.inc()
            if not good:
                st.c_bad.inc()
            st.g_good.set(1.0 - bad_ratio)
            st.g_burn.set(bad_ratio / budget)
            st.g_remaining.set(1.0 - lifetime_bad_ratio / budget)

    def snapshot(self) -> list[dict]:
        out = []
        for st in self._state:
            with self._lock:
                total, bad = st.total, st.bad
                n_window = min(st.ring_n, len(st.ring))
                ring_bad = st.ring_bad
            budget = st.slo.budget
            bad_ratio = ring_bad / n_window if n_window else 0.0
            out.append({
                **st.slo.describe(),
                "requests_total": total,
                "bad_total": bad,
                "window_good_ratio": 1.0 - bad_ratio,
                "burn_rate": bad_ratio / budget,
                "error_budget_remaining_ratio": (
                    1.0 - (bad / total) / budget if total else 1.0
                ),
            })
        return out

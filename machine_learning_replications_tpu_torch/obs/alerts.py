"""Declarative alert rules over the in-process history store.

The telemetry plane already *exports* every signal an operator would
page on — SLO burn gauges (`slo_burn_rate` / `fleet_slo_burn_rate`),
scrape staleness, quality PSI, rotation state. This module *watches*
them: a small set of rule types evaluated against `obs.timeseries`
windows each sampling tick, with the two defenses real alerting grew
the hard way —

* **hold-down** (`for_s`): a breach must persist before the rule fires,
  so one noisy sample cannot page;
* **resolve hysteresis** (`resolve_for_s`): a firing rule must observe
  *continuous* clearance before it resolves, so a signal oscillating
  around the threshold cannot flap fire/resolve every tick.

Rule types (each a JSON-able spec, loadable from ``--alert-rules``):

``threshold``
    Aggregate of one family's matching series vs a bound —
    ``value(window avg, or latest when window_s is 0) OP threshold``.
    Breaches when ANY matching series breaches; the reading reported is
    the worst one.
``burn_rate``
    The Google-SRE multi-window shape: fires only when BOTH a fast
    window (default 5 min) and a slow window (default 1 h) of the burn
    gauge average at or above ``factor``. The fast window makes the
    alert responsive, the slow one makes it *proportional* — a burst
    that cannot meaningfully dent the budget never sustains the slow
    window. Factor 14.4 over a 30-day budget means "at this rate the
    whole month's budget is gone in ~2 days".
``absence``
    No fresh sample of the family within ``stale_after_s`` (a replica
    that stopped scraping, a probe that stopped probing). Grace-period
    guarded: never breaches before the engine itself has been running
    ``stale_after_s``.
``rate_of_change``
    ``|newest - oldest|`` over ``window_s`` at or above ``max_delta`` —
    the drift shape (quality PSI) where the *level* may be acceptable
    but the *movement* is the story.

State machine per rule::

    inactive -> pending (breach seen) -> firing (breach held for_s)
    firing -> resolving (clear seen) -> inactive (clear held
    resolve_for_s); resolving -> firing again on re-breach, without
    re-journaling.

Transitions journal ``alert_fired`` / ``alert_resolved`` and ride
``alerts_active{rule,severity}`` + ``alerts_transitions_total``; the
active set is served on ``GET /fleet/alerts`` (router) and
``GET /debug/alerts`` (replica), and summarized on ``/healthz``.
Jax-free by construction.
"""

from __future__ import annotations

import json

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.obs.timeseries import TimeSeriesStore

ALERTS_ACTIVE = REGISTRY.gauge(
    "alerts_active",
    "1 while the rule is firing (0: inactive/pending/resolving). Every "
    "configured rule materializes its series at engine start — an "
    "absent series is a config mystery, a 0 is a healthy fact.",
    labels=("rule", "severity"),
)
ALERTS_TRANSITIONS = REGISTRY.counter(
    "alerts_transitions_total",
    "Rule state-machine transitions by kind (fired / resolved).",
    labels=("rule", "transition"),
)

SEVERITIES = ("info", "warn", "page")

_OPS = {
    ">=": lambda v, t: v >= t,
    ">": lambda v, t: v > t,
    "<=": lambda v, t: v <= t,
    "<": lambda v, t: v < t,
}


class Rule:
    """Shared spec plumbing; subclasses implement ``check(store, now)``
    returning ``(breached, value, detail)`` — `value` the reading that
    drove the verdict, `detail` a human-readable fragment."""

    type = "rule"

    def __init__(self, spec: dict) -> None:
        self.name = str(spec["name"])
        self.severity = str(spec.get("severity", "warn"))
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: severity must be one of "
                f"{SEVERITIES}, got {self.severity!r}"
            )
        self.family = str(spec["family"])
        self.labels = dict(spec.get("labels") or {})
        self.for_s = float(spec.get("for_s", 30.0))
        self.resolve_for_s = float(spec.get("resolve_for_s", 60.0))
        if self.for_s < 0 or self.resolve_for_s < 0:
            raise ValueError(
                f"rule {self.name!r}: for_s/resolve_for_s must be >= 0"
            )

    def check(self, store: TimeSeriesStore, now: float):
        raise NotImplementedError

    def describe(self) -> dict:
        return {
            "name": self.name, "type": self.type,
            "severity": self.severity, "family": self.family,
            "labels": self.labels, "for_s": self.for_s,
            "resolve_for_s": self.resolve_for_s,
        }

    @staticmethod
    def _worst(readings, op):
        """The series whose value argues hardest for the breach: max
        for >=/>, min for <=/< (readings: [(labels, value)])."""
        if not readings:
            return None, None
        pick = max if op in (">=", ">") else min
        lab, v = pick(readings, key=lambda r: r[1])
        return lab, v


class ThresholdRule(Rule):
    type = "threshold"

    def __init__(self, spec: dict) -> None:
        super().__init__(spec)
        self.op = str(spec.get("op", ">="))
        if self.op not in _OPS:
            raise ValueError(
                f"rule {self.name!r}: op must be one of {sorted(_OPS)}"
            )
        self.threshold = float(spec["threshold"])
        self.window_s = float(spec.get("window_s", 0.0))

    def check(self, store, now):
        if self.window_s > 0:
            readings = store.avg(
                self.family, self.window_s, now, labels=self.labels
            )
        else:
            readings = [
                (lab, v) for lab, _t, v in
                store.latest(self.family, labels=self.labels)
            ]
        lab, v = self._worst(readings, self.op)
        if v is None:
            return False, None, "no data"
        breached = _OPS[self.op](v, self.threshold)
        return breached, v, (
            f"{self.family}{lab or {}} = {v:.4g} "
            f"(breach when {self.op} {self.threshold:g})"
        )

    def describe(self) -> dict:
        d = super().describe()
        d.update(op=self.op, threshold=self.threshold,
                 window_s=self.window_s)
        return d


class BurnRateRule(Rule):
    type = "burn_rate"

    def __init__(self, spec: dict) -> None:
        super().__init__(spec)
        self.factor = float(spec.get("factor", 14.4))
        self.fast_s = float(spec.get("fast_s", 300.0))
        self.slow_s = float(spec.get("slow_s", 3600.0))
        if self.fast_s > self.slow_s:
            raise ValueError(
                f"rule {self.name!r}: fast_s must be <= slow_s"
            )

    def _window_worst(self, store, window_s, now):
        readings = store.avg(
            self.family, window_s, now, labels=self.labels
        )
        return self._worst(readings, ">=")

    def check(self, store, now):
        lab_f, fast = self._window_worst(store, self.fast_s, now)
        _lab_s, slow = self._window_worst(store, self.slow_s, now)
        if fast is None or slow is None:
            return False, None, "no data"
        breached = fast >= self.factor and slow >= self.factor
        return breached, fast, (
            f"{self.family}{lab_f or {}} burn x{fast:.2f} over "
            f"{self.fast_s:g}s / x{slow:.2f} over {self.slow_s:g}s "
            f"(breach when both >= x{self.factor:g})"
        )

    def describe(self) -> dict:
        d = super().describe()
        d.update(factor=self.factor, fast_s=self.fast_s,
                 slow_s=self.slow_s)
        return d


class AbsenceRule(Rule):
    type = "absence"

    def __init__(self, spec: dict) -> None:
        super().__init__(spec)
        self.stale_after_s = float(spec.get("stale_after_s", 60.0))
        self._born: float | None = None

    def check(self, store, now):
        if self._born is None:
            self._born = now
        age = store.last_sample_age_s(self.family, now)
        if age is None:
            # Never sampled: only suspicious once the engine has been
            # alive long enough that a healthy sampler must have
            # produced at least one sample.
            if now - self._born < self.stale_after_s:
                return False, None, "warming up"
            return True, None, (
                f"{self.family}: never sampled in "
                f"{now - self._born:.0f}s"
            )
        breached = age >= self.stale_after_s
        return breached, age, (
            f"{self.family}: newest sample {age:.1f}s old "
            f"(breach when >= {self.stale_after_s:g}s)"
        )

    def describe(self) -> dict:
        d = super().describe()
        d.update(stale_after_s=self.stale_after_s)
        return d


class RateOfChangeRule(Rule):
    type = "rate_of_change"

    def __init__(self, spec: dict) -> None:
        super().__init__(spec)
        self.max_delta = float(spec["max_delta"])
        self.window_s = float(spec.get("window_s", 300.0))

    def check(self, store, now):
        readings = [
            (lab, abs(d)) for lab, d in
            store.delta(self.family, self.window_s, now,
                        labels=self.labels)
        ]
        lab, v = self._worst(readings, ">=")
        if v is None:
            return False, None, "no data"
        breached = v >= self.max_delta
        return breached, v, (
            f"{self.family}{lab or {}} moved {v:.4g} over "
            f"{self.window_s:g}s (breach when >= {self.max_delta:g})"
        )

    def describe(self) -> dict:
        d = super().describe()
        d.update(max_delta=self.max_delta, window_s=self.window_s)
        return d


_RULE_TYPES = {
    cls.type: cls
    for cls in (ThresholdRule, BurnRateRule, AbsenceRule,
                RateOfChangeRule)
}


def build_rule(spec: dict) -> Rule:
    kind = spec.get("type")
    cls = _RULE_TYPES.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown rule type {kind!r} (know {sorted(_RULE_TYPES)})"
        )
    return cls(spec)


def load_rules(path: str) -> list[Rule]:
    """A rules file is a JSON list of specs (see the rule classes for
    fields). Validation is eager — a typo'd rule fails startup, not the
    3 a.m. incident it was supposed to catch."""
    with open(path, encoding="utf-8") as fh:
        specs = json.load(fh)
    if not isinstance(specs, list):
        raise ValueError(f"{path}: expected a JSON list of rule specs")
    rules = [build_rule(s) for s in specs]
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate rule names")
    return rules


def default_rules(role: str) -> list[Rule]:
    """Built-in rule set per process role. Conservative thresholds:
    these must hold zero false positives through the chaos drill's
    healthy baseline AND the saturation bench."""
    if role == "router":
        return [
            BurnRateRule({
                "name": "fleet_error_budget_burn", "severity": "page",
                "family": "fleet_slo_burn_rate", "factor": 14.4,
                "fast_s": 300.0, "slow_s": 3600.0,
                "for_s": 60.0, "resolve_for_s": 120.0,
            }),
            ThresholdRule({
                "name": "fleet_replica_stale", "severity": "warn",
                "family": "fleet_scrape_stale", "op": ">=",
                "threshold": 1.0, "window_s": 0.0,
                "for_s": 30.0, "resolve_for_s": 60.0,
            }),
            ThresholdRule({
                "name": "fleet_no_ready_replicas", "severity": "page",
                "family": "fleet_replicas",
                "labels": {"state": "ready"},
                "op": "<", "threshold": 1.0, "window_s": 0.0,
                "for_s": 15.0, "resolve_for_s": 30.0,
            }),
        ]
    if role == "replica":
        return [
            BurnRateRule({
                "name": "slo_error_budget_burn", "severity": "page",
                "family": "slo_burn_rate", "factor": 14.4,
                "fast_s": 300.0, "slow_s": 3600.0,
                "for_s": 60.0, "resolve_for_s": 120.0,
            }),
            RateOfChangeRule({
                "name": "quality_psi_drift", "severity": "warn",
                "family": "quality_psi", "max_delta": 0.2,
                "window_s": 900.0,
                "for_s": 60.0, "resolve_for_s": 300.0,
            }),
        ]
    raise ValueError(f"unknown role {role!r}")


_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

_INACTIVE, _PENDING, _FIRING, _RESOLVING = (
    "inactive", "pending", "firing", "resolving",
)


class _RuleState:
    __slots__ = ("state", "since", "fired_at", "value", "detail")

    def __init__(self) -> None:
        self.state = _INACTIVE
        self.since: float | None = None   # entered current state
        self.fired_at: float | None = None
        self.value = None
        self.detail = ""


class AlertEngine:
    """Evaluate every rule once per `evaluate(now)` (the history
    sampler's `on_tick`); returns the transitions this pass produced so
    the caller can forward firings to the incident capturer. Pure of
    I/O and clocks — `now` is injected, which is what makes the
    hold-down/hysteresis tests deterministic."""

    def __init__(self, rules, store: TimeSeriesStore) -> None:
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError("duplicate rule names")
        self.rules = list(rules)
        self.store = store
        self._state = {r.name: _RuleState() for r in self.rules}
        # Materialize every rule's series at 0 up front.
        for r in self.rules:
            ALERTS_ACTIVE.set(0.0, rule=r.name, severity=r.severity)

    def evaluate(self, now: float) -> list[dict]:
        transitions: list[dict] = []
        for rule in self.rules:
            st = self._state[rule.name]
            try:
                breached, value, detail = rule.check(self.store, now)
            except Exception as exc:  # a broken rule must not take
                breached, value = False, None  # down the whole pass
                detail = f"check error: {exc}"
            st.value, st.detail = value, detail
            if st.state == _INACTIVE:
                if breached:
                    st.state, st.since = _PENDING, now
                    if now - st.since >= rule.for_s:
                        self._fire(rule, st, now, transitions)
            elif st.state == _PENDING:
                if not breached:
                    st.state, st.since = _INACTIVE, None
                elif now - st.since >= rule.for_s:
                    self._fire(rule, st, now, transitions)
            elif st.state == _FIRING:
                if not breached:
                    st.state, st.since = _RESOLVING, now
                    if now - st.since >= rule.resolve_for_s:
                        self._resolve(rule, st, now, transitions)
            elif st.state == _RESOLVING:
                if breached:
                    # Re-breach during hysteresis: still the SAME
                    # incident — back to firing without re-journaling.
                    st.state, st.since = _FIRING, st.fired_at
                elif now - st.since >= rule.resolve_for_s:
                    self._resolve(rule, st, now, transitions)
        return transitions

    def _fire(self, rule, st, now, transitions) -> None:
        st.state, st.since, st.fired_at = _FIRING, now, now
        ALERTS_ACTIVE.set(1.0, rule=rule.name, severity=rule.severity)
        ALERTS_TRANSITIONS.inc(rule=rule.name, transition="fired")
        journal.event(
            "alert_fired",
            rule=rule.name,
            severity=rule.severity,
            value=(round(st.value, 6)
                   if isinstance(st.value, float) else st.value),
            detail=st.detail,
        )
        transitions.append(self._transition(rule, st, now, "fired"))

    def _resolve(self, rule, st, now, transitions) -> None:
        fired_for = now - (st.fired_at if st.fired_at is not None
                           else now)
        st.state, st.since, st.fired_at = _INACTIVE, None, None
        ALERTS_ACTIVE.set(0.0, rule=rule.name, severity=rule.severity)
        ALERTS_TRANSITIONS.inc(rule=rule.name, transition="resolved")
        journal.event(
            "alert_resolved",
            rule=rule.name,
            severity=rule.severity,
            seconds=round(fired_for, 3),
        )
        tr = self._transition(rule, st, now, "resolved")
        tr["fired_for_s"] = round(fired_for, 3)
        transitions.append(tr)

    def _transition(self, rule, st, now, kind) -> dict:
        return {
            "transition": kind,
            "rule": rule.name,
            "severity": rule.severity,
            "at": now,
            "value": st.value,
            "detail": st.detail,
            "spec": rule.describe(),
        }

    # -- read side ----------------------------------------------------------

    def active(self) -> list[dict]:
        """Firing (and still-resolving) rules, worst severity first —
        the ``/fleet/alerts`` payload."""
        out = []
        for rule in self.rules:
            st = self._state[rule.name]
            if st.state in (_FIRING, _RESOLVING):
                out.append({
                    "rule": rule.name,
                    "severity": rule.severity,
                    "state": st.state,
                    "since": st.fired_at,
                    "value": st.value,
                    "detail": st.detail,
                })
        out.sort(key=lambda a: -_SEV_RANK.get(a["severity"], 0))
        return out

    def snapshot(self) -> dict:
        """Every rule's current state (the full debug view)."""
        rules = []
        for rule in self.rules:
            st = self._state[rule.name]
            d = rule.describe()
            d.update(state=st.state, value=st.value, detail=st.detail)
            rules.append(d)
        return {"rules": rules, "active": self.active()}

    def summary(self) -> dict:
        """The /healthz block: counts plus the worst firing severity."""
        states = [self._state[r.name].state for r in self.rules]
        firing = [
            r for r in self.rules
            if self._state[r.name].state in (_FIRING, _RESOLVING)
        ]
        worst = None
        for r in firing:
            if worst is None or _SEV_RANK[r.severity] > _SEV_RANK[worst]:
                worst = r.severity
        return {
            "rules": len(self.rules),
            "firing": len(firing),
            "pending": states.count(_PENDING),
            "max_severity": worst,
        }

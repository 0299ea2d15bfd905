"""Load-driven autoscaler: the fleet's size becomes a control loop.

The stack already *emits* every signal an autoscaler needs and acts on
none of them: the router counts sheds and latency per request
(``fleet_requests_total`` / ``fleet_request_latency_seconds``), every
replica's ``/healthz`` carries its admission-queue depth, and the SLO
trackers (``obs.slo``) export burn-rate gauges. This module closes the
loop with the same shape as the continual-learning trigger
(``learn.trigger``): a jax-free poller feeding a pure, debounced policy
that drives the lifecycle manager (``fleet.lifecycle``).

Signals, per poll (all best-effort; an unreachable surface is a
``None`` that simply doesn't vote):

  ``queue_depth``   max replica admission-queue depth (``/healthz``)
  ``latency_ms``    router-side mean /predict latency over the polls
                    since the last tick (histogram sum/count deltas)
  ``shed_rate``     shed fraction of routed requests since the last
                    tick (``fleet_requests_total`` outcome deltas;
                    ``no_replica`` counts as shed — an empty rotation
                    is the worst overload there is)
  ``burn_rate``     max SLO burn rate across replicas (``slo_burn_rate``
                    from each replica's ``/metrics?format=json``)
  ``alerts_active`` count of alert rules currently *firing* on the
                    router's own alert engine (``/fleet/alerts``;
                    docs/OBSERVABILITY.md "Alerting & incidents").
                    Disabled by default (``None`` thresholds) — wire
                    ``out_alerts_active=1`` to make any page-severity
                    firing alert a scale-out vote; either way the
                    reading is journaled with every decision

Policy (``AutoscalePolicy``), tuned against the failure modes a naive
"scale on threshold" loop has:

  * **Debounce** — ``breach_polls`` consecutive polls with ANY scale-out
    signal over its threshold before a scale-out fires; ``idle_polls``
    consecutive polls with EVERY signal under its scale-in threshold
    before a scale-in fires. One hot poll is a batch flush; one quiet
    poll is a gap between bursts.
  * **Cooldown** — ``cooldown_s`` after *any* action, both directions.
    A spawned replica takes tens of seconds to warm; re-deciding before
    the last decision landed would thrash the fleet against its own
    startup transient. Flapping load therefore costs at most one
    spawn/retire per cooldown window.
  * **Bounds** — ``min_replicas``/``max_replicas`` (owned by the
    lifecycle manager, mirrored here for suppression journaling): the
    loop can neither scale the service to zero nor fork-bomb the host.

Every decision that could act journals an ``autoscale_decision`` —
fired or suppressed, with the readings that drove it — and the raw
readings ride ``autoscale_signal{signal=}`` gauges continuously, so the
journal answers "why did/didn't the fleet grow at t?" and the metrics
page shows what the controller saw (docs/FLEET.md "Elastic fleet").
"""

from __future__ import annotations

import json
import math
import time
import urllib.request

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

AUTOSCALE_DECISIONS = REGISTRY.counter(
    "autoscale_decisions_total",
    "Autoscaler decisions by outcome (scale_out / scale_in fired; "
    "suppressed_cooldown / suppressed_at_max / suppressed_at_min: a "
    "debounced breach or idle streak that did not act).",
    labels=("decision",),
)
for _d in ("scale_out", "scale_in", "suppressed_cooldown",
           "suppressed_at_max", "suppressed_at_min"):
    AUTOSCALE_DECISIONS.labels(decision=_d)
AUTOSCALE_SIGNAL = REGISTRY.gauge(
    "autoscale_signal",
    "The load readings the autoscaler last observed (NaN = surface "
    "unreachable this poll).",
    labels=("signal",),
)
AUTOSCALE_STREAK = REGISTRY.gauge(
    "autoscale_streak",
    "Consecutive breach/idle polls toward the debounce thresholds.",
    labels=("kind",),
)
AUTOSCALE_DESIRED = REGISTRY.gauge(
    "autoscale_desired_replicas",
    "The autoscaler's current desired replica count.",
)
for _k in ("breach", "idle"):
    AUTOSCALE_STREAK.set(0.0, kind=_k)

SIGNALS = (
    "queue_depth", "latency_ms", "shed_rate", "burn_rate",
    "alerts_active",
)


class AutoscaleThresholds:
    """Scale-out fires when ANY ``out_*`` signal is breached (sustained);
    scale-in only when EVERY available signal sits at or under its
    ``in_*`` twin — growing the fleet is cheap insurance, shrinking it
    must be provably safe. A ``None`` threshold disables that signal."""

    def __init__(
        self,
        out_queue_depth: float | None = 8.0,
        out_latency_ms: float | None = 250.0,
        out_shed_rate: float | None = 0.02,
        out_burn_rate: float | None = 4.0,
        out_alerts_active: float | None = None,
        in_queue_depth: float | None = 1.0,
        in_latency_ms: float | None = 50.0,
        in_shed_rate: float | None = 0.0,
        in_burn_rate: float | None = 1.0,
        in_alerts_active: float | None = None,
    ) -> None:
        self.out = {
            "queue_depth": out_queue_depth,
            "latency_ms": out_latency_ms,
            "shed_rate": out_shed_rate,
            "burn_rate": out_burn_rate,
            # Off by default: the alert plane is an operator surface
            # first; opting it into the control loop is a deliberate
            # coupling (a paging alert then both wakes a human AND adds
            # capacity).
            "alerts_active": out_alerts_active,
        }
        self.scale_in = {
            "queue_depth": in_queue_depth,
            "latency_ms": in_latency_ms,
            "shed_rate": in_shed_rate,
            "burn_rate": in_burn_rate,
            "alerts_active": in_alerts_active,
        }
        for name in SIGNALS:
            hi, lo = self.out[name], self.scale_in[name]
            if hi is not None and lo is not None and lo > hi:
                raise ValueError(
                    f"in_{name} ({lo}) must not exceed out_{name} ({hi})"
                )

    def describe(self) -> dict:
        return {"out": dict(self.out), "in": dict(self.scale_in)}


class AutoscalePolicy:
    """The debounce/cooldown/bounds state machine (see module
    docstring). Pure of I/O: feed it one ``observe(signals, ...)`` per
    poll; it returns an action dict (``{"decision", "target", ...}``)
    when the fleet should change size, else ``None``."""

    def __init__(
        self,
        thresholds: AutoscaleThresholds | None = None,
        min_replicas: int = 1,
        max_replicas: int = 4,
        breach_polls: int = 3,
        idle_polls: int = 10,
        cooldown_s: float = 30.0,
        step: int = 1,
        clock=time.monotonic,
    ) -> None:
        if breach_polls < 1 or idle_polls < 1:
            raise ValueError("breach_polls and idle_polls must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if step < 1:
            raise ValueError("step must be >= 1")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        self.thresholds = thresholds or AutoscaleThresholds()
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.breach_polls = int(breach_polls)
        self.idle_polls = int(idle_polls)
        self.cooldown_s = float(cooldown_s)
        self.step = int(step)
        self._clock = clock
        self._breach = 0
        self._idle = 0
        self._last_action_t: float | None = None

    # -- policy ---------------------------------------------------------------

    def cooldown_remaining_s(self) -> float:
        if self._last_action_t is None:
            return 0.0
        return max(
            0.0, self.cooldown_s - (self._clock() - self._last_action_t)
        )

    def observe(self, signals: dict, desired: int, ready: int) -> dict | None:
        """One poll: ``signals`` maps each of ``SIGNALS`` to a float or
        None (surface unreachable). ``desired`` is the lifecycle
        manager's current target, ``ready`` the in-rotation count (both
        journaled with the decision)."""
        now = self._clock()
        for name in SIGNALS:
            v = signals.get(name)
            AUTOSCALE_SIGNAL.set(
                float(v) if v is not None else math.nan, signal=name
            )
        breaches = [
            name for name in SIGNALS
            if self.thresholds.out[name] is not None
            and signals.get(name) is not None
            and signals[name] >= self.thresholds.out[name]
        ]
        readings = {
            name: signals.get(name) for name in SIGNALS
        }
        available = [
            name for name in SIGNALS
            if self.thresholds.scale_in[name] is not None
            and signals.get(name) is not None
        ]
        idle = bool(available) and not breaches and all(
            signals[name] <= self.thresholds.scale_in[name]
            for name in available
        )
        if breaches:
            self._breach += 1
            self._idle = 0
        elif idle:
            self._idle += 1
            self._breach = 0
        else:
            # The in-between zone (or a blind poll): neither streak may
            # ride through it — debounce means *consecutive* evidence.
            self._breach = 0
            self._idle = 0
        AUTOSCALE_STREAK.set(float(self._breach), kind="breach")
        AUTOSCALE_STREAK.set(float(self._idle), kind="idle")

        if breaches and self._breach >= self.breach_polls:
            return self._decide(
                now, "scale_out", desired, ready, readings,
                reason="breach: " + ",".join(breaches),
                at_bound=desired >= self.max_replicas,
                bound_name="suppressed_at_max",
                target=min(self.max_replicas, desired + self.step),
                first_crossing=self._breach == self.breach_polls,
            )
        if idle and self._idle >= self.idle_polls:
            return self._decide(
                now, "scale_in", desired, ready, readings,
                reason="idle: all signals under scale-in thresholds",
                at_bound=desired <= self.min_replicas,
                bound_name="suppressed_at_min",
                target=max(self.min_replicas, desired - self.step),
                first_crossing=self._idle == self.idle_polls,
            )
        return None

    # -- internals ------------------------------------------------------------

    def _decide(
        self, now: float, decision: str, desired: int, ready: int,
        readings: dict, reason: str, at_bound: bool, bound_name: str,
        target: int, first_crossing: bool,
    ) -> dict | None:
        if at_bound:
            # A lasting breach at max (or the quiet steady state at min)
            # would otherwise journal once per poll forever: journal at
            # the debounce crossing only, count always.
            AUTOSCALE_DECISIONS.inc(decision=bound_name)
            if first_crossing:
                self._journal(
                    decision=None, suppressed_by=bound_name,
                    reason=reason, desired=desired, ready=ready,
                    target=None, readings=readings,
                )
            return None
        if self.cooldown_remaining_s() > 0:
            AUTOSCALE_DECISIONS.inc(decision="suppressed_cooldown")
            if first_crossing:
                self._journal(
                    decision=None, suppressed_by="cooldown",
                    reason=reason, desired=desired, ready=ready,
                    target=None, readings=readings,
                )
            return None
        self._last_action_t = now
        self._breach = 0
        self._idle = 0
        AUTOSCALE_STREAK.set(0.0, kind="breach")
        AUTOSCALE_STREAK.set(0.0, kind="idle")
        AUTOSCALE_DECISIONS.inc(decision=decision)
        self._journal(
            decision=decision, suppressed_by=None, reason=reason,
            desired=desired, ready=ready, target=target,
            readings=readings,
        )
        return {
            "decision": decision, "target": target, "reason": reason,
            "signals": readings,
        }

    def _journal(self, decision, suppressed_by, reason, desired, ready,
                 target, readings) -> None:
        journal.event(
            "autoscale_decision",
            decision=decision,
            suppressed_by=suppressed_by,
            reason=reason,
            desired=desired,
            ready=ready,
            target=target,
            breach_streak=self._breach,
            idle_streak=self._idle,
            breach_polls_needed=self.breach_polls,
            idle_polls_needed=self.idle_polls,
            cooldown_remaining_s=round(self.cooldown_remaining_s(), 3),
            signals={
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in readings.items()
            },
        )


def _fetch_json(url: str, timeout_s: float):
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


class AutoscaleDaemon:
    """The poller: collect signals from the router and replicas, feed
    the policy, drive the lifecycle manager, tick its state machine.
    ``tick()`` is the unit tests drive; ``run`` is the daemon loop
    ``cli fleet autoscale`` wraps."""

    def __init__(
        self,
        router_url: str,
        manager,
        policy: AutoscalePolicy | None = None,
        poll_interval_s: float = 1.0,
        poll_timeout_s: float = 5.0,
        say=None,
    ) -> None:
        self.router_url = router_url.rstrip("/")
        self.manager = manager
        self.policy = policy or AutoscalePolicy(
            min_replicas=manager.min_replicas,
            max_replicas=manager.max_replicas,
        )
        self.poll_interval_s = float(poll_interval_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self.say = say
        self._prev_outcomes: dict[str, float] | None = None
        self._prev_latency: tuple[float, float] | None = None

    # -- signal collection ----------------------------------------------------

    def collect_signals(self) -> dict:
        """One poll's readings (each None when its surface is
        unreachable). Router counters are turned into *recent* rates by
        differencing against the previous poll — the policy reacts to
        what is happening, not to the lifetime average."""
        signals: dict = {name: None for name in SIGNALS}
        replicas: list[dict] = []
        try:
            page = _fetch_json(
                self.router_url + "/metrics?format=json",
                self.poll_timeout_s,
            )
        except Exception:
            return signals
        runtime = page.get("runtime") or {}
        replicas = page.get("replicas") or []

        # The router's own alert engine (docs/OBSERVABILITY.md): count
        # rules in the *firing* state — a resolving alert's condition
        # has already cleared and must not keep voting for capacity. A
        # router without the alert plane (disabled, pre-alerting) just
        # leaves the signal None.
        try:
            alerts_page = _fetch_json(
                self.router_url + "/fleet/alerts", self.poll_timeout_s
            )
            if alerts_page.get("enabled"):
                signals["alerts_active"] = float(sum(
                    1 for a in alerts_page.get("active") or []
                    if a.get("state") == "firing"
                ))
        except Exception:
            pass

        outcomes = runtime.get("fleet_requests_total")
        if isinstance(outcomes, dict):
            flat = {k: float(v) for k, v in outcomes.items()}
            if self._prev_outcomes is not None:
                d_total = sum(flat.values()) - sum(
                    self._prev_outcomes.values()
                )
                shed_keys = ("outcome=shed", "outcome=no_replica")
                d_shed = sum(
                    flat.get(k, 0.0) - self._prev_outcomes.get(k, 0.0)
                    for k in shed_keys
                )
                if d_total > 0:
                    signals["shed_rate"] = max(0.0, d_shed) / d_total
                else:
                    signals["shed_rate"] = 0.0
            self._prev_outcomes = flat

        lat = runtime.get("fleet_request_latency_seconds")
        if isinstance(lat, dict) and "sum" in lat and "count" in lat:
            cur = (float(lat["sum"]), float(lat["count"]))
            if self._prev_latency is not None:
                d_sum = cur[0] - self._prev_latency[0]
                d_count = cur[1] - self._prev_latency[1]
                if d_count > 0:
                    signals["latency_ms"] = 1000.0 * d_sum / d_count
            self._prev_latency = cur

        # Per-replica surfaces are polled serially: a wedged replica
        # must cost this tick a bounded, SHORT stall, not poll_timeout_s
        # × fleet size × 2 fetches — the debounce window would stretch
        # from seconds to minutes exactly when the fleet is overloaded.
        # (The registry prober rotates a truly wedged replica out within
        # a few probes, after which it is skipped here entirely.)
        from machine_learning_replications_tpu_torch.fleet.lifecycle import (
            replica_queue_depth,
        )

        rep_timeout = min(2.0, self.poll_timeout_s)
        depths, burns = [], []
        for rep in replicas:
            if not rep.get("in_rotation"):
                continue
            url = (rep.get("url") or "").rstrip("/")
            if not url:
                continue
            # Queue depth rides the router page since r17: the registry's
            # per-replica load block carries the /readyz-probed depth the
            # least-loaded balancer picks on, so the autoscaler reads the
            # SAME view (docs/FLEET.md "Router data plane") and skips one
            # HTTP fetch per replica per tick. The direct /healthz fetch
            # stays as the fallback for a pre-r17 router page.
            depth = (rep.get("load") or {}).get("last_queue_depth")
            if depth is None:
                depth = replica_queue_depth(url, timeout_s=rep_timeout)
            if depth is not None:
                depths.append(float(depth))
            try:
                rmetrics = _fetch_json(
                    url + "/metrics?format=json", rep_timeout
                )
                burn = (rmetrics.get("runtime") or {}).get("slo_burn_rate")
                if isinstance(burn, dict):
                    vals = [
                        float(v) for v in burn.values()
                        if isinstance(v, (int, float))
                        and not math.isnan(float(v))
                    ]
                    if vals:
                        burns.append(max(vals))
            except Exception:
                pass
        if depths:
            signals["queue_depth"] = max(depths)
        if burns:
            signals["burn_rate"] = max(burns)
        signals["ready"] = sum(
            1 for r in replicas if r.get("in_rotation")
        )
        return signals

    # -- the loop -------------------------------------------------------------

    def tick(self) -> dict | None:
        signals = self.collect_signals()
        ready = signals.get("ready") or 0
        action = self.policy.observe(
            signals, desired=self.manager.desired, ready=ready,
        )
        if action is not None:
            self.manager.scale_to(action["target"])
            if self.say:
                self.say(
                    f"{action['decision']} → {self.manager.desired} "
                    f"replicas ({action['reason']})"
                )
        AUTOSCALE_DESIRED.get().set(float(self.manager.desired))
        self.manager.tick()
        return action

    def run(self, stop_check=None, max_ticks: int | None = None) -> int:
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            if stop_check is not None and stop_check():
                break
            try:
                self.tick()
            except Exception as exc:
                # The control loop must outlive any one bad poll: a
                # router restart mid-tick becomes a journaled blip, not
                # a dead autoscaler and a frozen fleet.
                journal.event("autoscale_tick_error", error=str(exc))
                if self.say:
                    self.say(f"tick failed: {exc}")
            ticks += 1
            time.sleep(self.poll_interval_s)
        return ticks

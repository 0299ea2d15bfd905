"""Drift-triggered retraining: the decision of WHEN to act.

PR 4's quality monitor turns silent input drift into a journaled
``ok → warn → alert`` status on every replica; this module turns a
*sustained* alert into exactly one retrain decision. Three rules, all
tuned against the failure modes a naive "retrain on alert" trigger has:

  * **Debounce** — ``alert_streak`` consecutive alert observations
    before firing. A single alert snapshot can be a burst of outlier
    patients or one poll racing a window refresh; retraining is
    expensive and swaps a clinical model, so it must answer to a
    *sustained* signal. The replica-side transition ring
    (``/debug/quality``'s ``transitions`` — the PR 10 satellite) rides
    each poll, so flapping (alert → ok → alert between polls) is visible
    in one payload instead of requiring a journal tail.
  * **Cooldown** — ``cooldown_s`` between fires. A refit takes minutes
    and its effect lands only after shadow + promotion; re-firing while
    the previous cycle is in flight would stack retrains of the same
    drift.
  * **Schedule** — an optional ``schedule_s`` periodic fire (subject to
    the same cooldown), for cohorts that drift too slowly to alert but
    accumulate bias worth refreshing on a calendar.

Every observation that *could* fire journals a ``learn_trigger`` event —
fired or suppressed, with the suppressing rule and the offending
features — so the journal answers "why did/didn't the loop act at t?"
without reconstruction.

jax-free (enforced: graftcheck rule ``import-purity``): the trigger
is an HTTP poller plus a tiny state machine; it
runs happily inside the router process or the ``cli learn run`` daemon.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

TRIGGERS = REGISTRY.counter(
    "learn_trigger_total",
    "Continual-learning trigger decisions by outcome (fired: a retrain "
    "cycle starts; suppressed_debounce / suppressed_cooldown: an alert "
    "observation that did not fire).",
    labels=("outcome",),
)
for _o in ("fired", "suppressed_debounce", "suppressed_cooldown"):
    TRIGGERS.labels(outcome=_o)
ALERT_STREAK = REGISTRY.gauge(
    "learn_trigger_alert_streak",
    "Consecutive alert observations across the polled fleet (resets on "
    "any non-alert poll).",
)
ALERT_STREAK.get().set(0.0)


def poll_quality(url: str, timeout_s: float = 5.0) -> dict:
    """One replica's ``/debug/quality`` payload reduced to what the
    trigger needs: ``{"ok", "status", "worst_feature", "worst_psi",
    "transitions"}``. Never raises — an unreachable replica reads as
    ``ok=False`` and simply doesn't vote this poll."""
    try:
        with urllib.request.urlopen(
            url.rstrip("/") + "/debug/quality", timeout=timeout_s
        ) as resp:
            body = json.loads(resp.read())
        return {
            "ok": True,
            "status": body.get("status"),
            "worst_feature": body.get("worst_feature"),
            "worst_psi": body.get("worst_psi"),
            "transitions": body.get("transitions") or [],
        }
    except Exception as exc:
        return {
            "ok": False, "status": None, "worst_feature": None,
            "worst_psi": None, "transitions": [],
            "error": f"{type(exc).__name__}: {exc}",
        }


def replica_urls(router_url: str, timeout_s: float = 5.0) -> list[str]:
    """The fleet's replica URLs off the router's registry snapshot —
    the trigger polls replicas directly (quality lives replica-side; the
    router is jax-free and has no monitor)."""
    with urllib.request.urlopen(
        router_url.rstrip("/") + "/fleet/replicas", timeout=timeout_s
    ) as resp:
        snap = json.loads(resp.read())["replicas"]
    return [r["url"] for r in snap]


class TriggerPolicy:
    """The debounce/cooldown/schedule state machine. Feed it one
    ``observe(...)`` per poll pass; it returns a decision dict when a
    retrain should start, else ``None``. Pure of I/O — the daemon owns
    polling, this owns policy (the ``HealthProber``/``ReplicaRegistry``
    split, again)."""

    def __init__(
        self,
        alert_streak: int = 3,
        cooldown_s: float = 600.0,
        schedule_s: float | None = None,
        clock=time.monotonic,
    ) -> None:
        if alert_streak < 1:
            raise ValueError("alert_streak must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if schedule_s is not None and schedule_s <= 0:
            raise ValueError("schedule_s must be > 0 when set")
        self.alert_streak = int(alert_streak)
        self.cooldown_s = float(cooldown_s)
        self.schedule_s = None if schedule_s is None else float(schedule_s)
        self._clock = clock
        self._streak = 0
        self._last_fire_t: float | None = None
        self._started_t = clock()

    # -- policy --------------------------------------------------------------

    def observe(self, polls: list[dict]) -> dict | None:
        """One poll pass over the fleet: ``polls`` is
        ``[{"url", ...poll_quality payload}]``. Fires on a sustained
        alert (any replica alerting counts — drift is a property of the
        traffic, and the first replica to see enough window rows speaks
        for the cohort) or on schedule. Every suppressed alert is
        journaled too (the "every decision" contract)."""
        now = self._clock()
        alerting = [p for p in polls if p.get("status") == "alert"]
        reachable = [p for p in polls if p.get("ok")]
        if alerting:
            self._streak += 1
        elif reachable:
            self._streak = 0
        ALERT_STREAK.get().set(float(self._streak))

        worst = self._worst(alerting)
        if alerting:
            if self._streak < self.alert_streak:
                self._journal(
                    fired=False, reason="alert",
                    suppressed_by="debounce", worst=worst,
                    alerting=[p.get("url") for p in alerting],
                )
                TRIGGERS.inc(outcome="suppressed_debounce")
                return None
            if self._in_cooldown(now):
                self._journal(
                    fired=False, reason="alert",
                    suppressed_by="cooldown", worst=worst,
                    alerting=[p.get("url") for p in alerting],
                )
                TRIGGERS.inc(outcome="suppressed_cooldown")
                return None
            return self._fire(now, "alert", worst, alerting)
        if self.schedule_s is not None and not self._in_cooldown(now):
            anchor = (
                self._last_fire_t if self._last_fire_t is not None
                else self._started_t
            )
            if now - anchor >= self.schedule_s:
                return self._fire(now, "schedule", worst, alerting)
        return None

    # -- internals -----------------------------------------------------------

    def _in_cooldown(self, now: float) -> bool:
        return (
            self._last_fire_t is not None
            and now - self._last_fire_t < self.cooldown_s
        )

    def cooldown_remaining_s(self) -> float:
        if self._last_fire_t is None:
            return 0.0
        return max(
            0.0, self.cooldown_s - (self._clock() - self._last_fire_t)
        )

    def _worst(self, alerting: list[dict]) -> dict | None:
        """The worst offending feature across alerting replicas — what
        the journaled decision names as the drift's face."""
        best = None
        for p in alerting:
            psi = p.get("worst_psi")
            if psi is not None and (best is None or psi > best["psi"]):
                best = {"feature": p.get("worst_feature"), "psi": psi}
        return best

    def _fire(
        self, now: float, reason: str, worst: dict | None,
        alerting: list[dict],
    ) -> dict:
        self._last_fire_t = now
        self._streak = 0
        ALERT_STREAK.get().set(0.0)
        TRIGGERS.inc(outcome="fired")
        decision = {
            "reason": reason,
            "worst_feature": worst["feature"] if worst else None,
            "worst_psi": worst["psi"] if worst else None,
            "alerting_replicas": [p.get("url") for p in alerting],
        }
        self._journal(fired=True, reason=reason, worst=worst,
                      alerting=decision["alerting_replicas"])
        return decision

    def _journal(
        self, fired: bool, reason: str, worst: dict | None,
        alerting: list[Any], suppressed_by: str | None = None,
    ) -> None:
        journal.event(
            "learn_trigger",
            fired=fired,
            reason=reason,
            suppressed_by=suppressed_by,
            streak=self._streak,
            alert_streak_needed=self.alert_streak,
            cooldown_remaining_s=round(self.cooldown_remaining_s(), 3),
            worst_feature=worst["feature"] if worst else None,
            worst_psi=worst["psi"] if worst else None,
            alerting_replicas=alerting,
        )

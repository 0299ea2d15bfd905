"""Periodic ``/readyz`` prober feeding the replica registry.

The replicas already publish exactly the signal a load balancer needs
(PR 5's liveness/readiness split): ``/readyz`` answers 200 only when the
engine is warm, the server is not draining, and the breaker is closed —
and since the fleet tier it also echoes the replica's id and served
checkpoint version. This thread closes the loop: every ``interval_s`` it
GETs each registered replica's ``/readyz`` (bounded by ``timeout_s``)
and reports the verdict to ``ReplicaRegistry.observe_probe``, which owns
all rotation policy. The prober itself decides nothing — it is a clock
plus an HTTP client, so the rotation rules live (and are tested) in one
place.

Runs on its own daemon thread with plain blocking ``urllib`` — probing
is off the router's event loop by construction, and at fleet sizes where
sequential probing would lag the tick, the interval is the knob (or run
several probers over disjoint registries).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request


def probe_replica(url: str, timeout_s: float = 2.0) -> dict:
    """One ``/readyz`` probe: ``{"ok", "ready", "version", "queue_depth",
    "clock_perf", "t_send", "t_recv"}``. ``ok`` is HTTP-level success (an
    explicit 503 is ok=True, ready=False — the replica answered, and said
    no); transport failures are ok=False. ``queue_depth`` (None when the
    replica predates the field) feeds the registry's least-loaded score —
    the probe the rotation already pays for doubles as the cross-router
    load signal. ``clock_perf`` (the replica's monotonic clock echoed in
    the body, None on older replicas) plus the local send/receive stamps
    around the call feed the router's per-replica clock-offset estimator
    (``obs.fleettrace.ClockSync``) from the same GET. Never raises."""
    t_send = time.perf_counter()
    try:
        with urllib.request.urlopen(
            url.rstrip("/") + "/readyz", timeout=timeout_s
        ) as resp:
            body = json.loads(resp.read())
        ok = True
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read() or b"{}")
        except (ValueError, OSError):
            body = {}
        ok = True
    except Exception:
        body, ok = {}, False
    t_recv = time.perf_counter()
    clock = body.get("clock_perf")
    return {
        "ok": ok, "ready": bool(body.get("ready")),
        "version": body.get("version"),
        "queue_depth": body.get("queue_depth"),
        "clock_perf": clock if isinstance(clock, (int, float)) else None,
        "t_send": t_send, "t_recv": t_recv,
    }


class HealthProber:
    """Daemon thread probing every registered replica each tick."""

    def __init__(
        self,
        registry,
        interval_s: float = 0.5,
        timeout_s: float = 2.0,
        clock_sync=None,
    ) -> None:
        self.registry = registry
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        # Optional obs.fleettrace.ClockSync: probes double as NTP-style
        # offset samples for the fleet trace join.
        self.clock_sync = clock_sync
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-prober", daemon=True
        )

    def start(self) -> "HealthProber":
        self._thread.start()
        return self

    def tick(self) -> None:
        """One probe pass over the current membership (also the unit the
        tests drive directly, without the thread)."""
        for replica_id, url in self.registry.urls():
            if self._stop.is_set():
                return
            verdict = probe_replica(url, timeout_s=self.timeout_s)
            offset_ms = None
            if (
                self.clock_sync is not None and verdict["ok"]
                and verdict.get("clock_perf") is not None
            ):
                offset_ms = 1000.0 * self.clock_sync.observe(
                    replica_id, verdict["t_send"], verdict["t_recv"],
                    verdict["clock_perf"],
                )
            self.registry.observe_probe(
                replica_id, ok=verdict["ok"], ready=verdict["ready"],
                version=verdict["version"],
                queue_depth=verdict.get("queue_depth"),
                clock_offset_ms=offset_ms,
            )

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass  # a probe pass must never kill the prober

    def close(self, timeout: float | None = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

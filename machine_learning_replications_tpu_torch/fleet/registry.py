"""Replica registry — the front-door router's source of routing truth.

One serving replica is a single point of failure; a fleet of N is only a
*service* once something tracks which of them may receive traffic right
now. This module is that something: a thread-safe table of replicas with
an explicit rotation state machine, fed by two independent signals —

  * **probes** (``fleet.health.HealthProber``): periodic ``/readyz``
    GETs. A replica enters rotation after a successful ready probe and
    leaves it after ``fail_threshold`` consecutive failed ones; a
    replica that left (for any reason) re-enters only after
    ``recover_probes`` consecutive ready probes, so a flapping replica
    cannot oscillate into rotation on a single lucky probe. The probe
    also carries the replica's served checkpoint version (``/readyz``
    echoes it), which is how the deploy controller observes a rollout
    landing.
  * **request outcomes** (the router's data path): ``breaker_failures``
    consecutive transport/5xx failures open the replica's breaker —
    rotation out *now*, without waiting for the next probe tick, because
    the requests ARE the probe when traffic is flowing. Recovery is
    probe-driven like any other out state.

**Least-loaded rotation** (power-of-two-choices): ``pick`` no longer
walks a round-robin ring. Each replica carries three live load signals —

  * ``outstanding``: upstream attempts dispatched by THIS router and not
    yet answered (``note_dispatch`` / ``note_complete``),
  * ``ewma_latency_ms``: an exponentially weighted moving average of this
    router's observed attempt latencies (``note_complete``),
  * ``last_queue_depth``: the replica's own admission-queue depth, read
    off ``/readyz`` by the prober (``observe_probe``) — the shared
    signal that also sees load from OTHER routers (``--workers N``
    router processes each run their own registry).

``pick`` samples TWO distinct in-rotation candidates uniformly at random
and takes the lower-scored one (``score = ewma_latency × (1 +
outstanding + queue_depth)``); ties (e.g. an idle fleet with no signal
yet) break to the replica picked least recently, so cold fleets still
spread. Two random choices instead of a global arg-min is deliberate:
full least-loaded herds every router worker onto the same momentarily
idle replica between signal refreshes, while two choices gets
exponentially better load balance than random for one extra sample
(Mitzenmacher) with no herding — and never scans the fleet under the
lock.

An **admin hold** (``hold`` / ``release``) is orthogonal to probe state:
the rolling-deploy controller holds a replica while its new version
warms, which removes it from ``pick`` without touching the probe state
machine — release puts it back the moment probes agree it is ready.

Every transition is journaled (``fleet_replica_registered`` /
``fleet_replica_deregistered`` / ``fleet_rotation`` with direction and
reason) and mirrored on the process registry (``fleet_replicas{state=}``
gauge, ``fleet_rotations_total{direction=}``), so a chaos run can assert
the kill → out → recover → in arc from the journal and one scrape.

No jax anywhere in ``fleet/``: the router is a pure-Python front door
and must start in milliseconds, not after an XLA backend init.
"""

from __future__ import annotations

import random
import threading
import time

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

FLEET_REPLICAS = REGISTRY.gauge(
    "fleet_replicas",
    "Registered replicas by rotation state (probing: awaiting first "
    "ready probe; ready: in rotation; out: rotated out).",
    labels=("state",),
)
FLEET_ROTATIONS = REGISTRY.counter(
    "fleet_rotations_total",
    "Rotation transitions by direction (in: replica began receiving "
    "traffic; out: replica stopped).",
    labels=("direction",),
)
FLEET_PROBES = REGISTRY.counter(
    "fleet_probe_total",
    "Health probes by result (ok: HTTP 200 ready; not_ready: explicit "
    "503; error: transport failure).",
    labels=("result",),
)
# Materialize the fixed label sets at import so the first scrape shows
# the full state space (a zero is a fact; an absent series is a mystery).
for _state in ("probing", "ready", "out"):
    FLEET_REPLICAS.labels(state=_state)
for _direction in ("in", "out"):
    FLEET_ROTATIONS.labels(direction=_direction)

#: Rotation states (``Replica.state``).
PROBING, READY, OUT = "probing", "ready", "out"


class Replica:
    """One registered serving replica. Mutated only under the registry
    lock; ``as_dict`` is the externally visible snapshot."""

    __slots__ = (
        "id", "url", "state", "reason", "version", "held",
        "probe_fails", "probe_oks", "request_fails",
        "registered_at", "last_probe_at", "last_change_at",
        "outstanding", "ewma_latency_ms", "last_queue_depth",
        "last_pick_seq", "clock_offset_ms",
    )

    def __init__(self, replica_id: str, url: str) -> None:
        self.id = replica_id
        self.url = url.rstrip("/")
        self.state = PROBING
        self.reason = "registered"
        self.version: int | None = None
        self.held = False
        self.probe_fails = 0
        self.probe_oks = 0
        self.request_fails = 0
        # Wall-clock by intent: these are display timestamps in the
        # /fleet/replicas payload, never duration operands.
        self.registered_at = time.time()  # graftcheck: disable=monotonic-clock
        self.last_probe_at: float | None = None
        self.last_change_at = self.registered_at
        # Load signals driving least-loaded picking (module docstring).
        self.outstanding = 0
        self.ewma_latency_ms: float | None = None
        self.last_queue_depth: int | None = None
        self.last_pick_seq = 0  # LRU tie-break for the cold fleet
        # Smoothed replica-minus-router monotonic-clock offset (from the
        # prober's ClockSync feed); None until the first clock-carrying
        # probe. Surfaced on /fleet/replicas for trace-join debugging.
        self.clock_offset_ms: float | None = None

    #: Latency prior (ms) for a replica with no sample yet: low enough
    #: that exploration beats any realistically-warm replica's score, so
    #: a fresh replica is never starved — but NOT near-zero, so the
    #: load factor still caps the exploration burst. Against a warm
    #: replica idling at W ms, a cold replica stops winning once its
    #: outstanding count passes ~W/0.25 (e.g. ~20 in-flight at 5 ms,
    #: ~400 at 100 ms): a bounded probe window, not the whole in-flight
    #: load of a 1000-connection router piling onto one cold engine.
    LATENCY_PRIOR_MS = 0.25

    def score(self) -> float:
        """Expected-cost score for power-of-two-choices: recent latency
        scaled by everything already queued at (or in flight to) the
        replica. A replica with no latency sample yet scores on the
        exploration prior above — sampled quickly, never starved, and
        never handed an unbounded cold-start burst."""
        lat = (
            max(self.ewma_latency_ms, 1e-3)
            if self.ewma_latency_ms is not None else self.LATENCY_PRIOR_MS
        )
        return lat * (
            1.0 + self.outstanding + (self.last_queue_depth or 0)
        )

    def as_dict(self) -> dict:
        return {
            "id": self.id,
            "url": self.url,
            "state": self.state,
            "reason": self.reason,
            "in_rotation": self.state == READY and not self.held,
            "held": self.held,
            "version": self.version,
            "probe_fails": self.probe_fails,
            "request_fails": self.request_fails,
            "registered_at": self.registered_at,
            "last_probe_at": self.last_probe_at,
            "clock_offset_ms": (
                None if self.clock_offset_ms is None
                else round(self.clock_offset_ms, 3)
            ),
            # The load view the balancer picks on (docs/FLEET.md "Router
            # data plane") — operators and the autoscaler read the same
            # numbers that drive rotation.
            "load": {
                "ewma_latency_ms": (
                    None if self.ewma_latency_ms is None
                    else round(self.ewma_latency_ms, 3)
                ),
                "outstanding": self.outstanding,
                "last_queue_depth": self.last_queue_depth,
                "score": round(self.score(), 3),
            },
        }


class ReplicaRegistry:
    """The fleet's rotation table (see module docstring).

    ``fail_threshold`` — consecutive failed probes before rotation out;
    ``recover_probes`` — consecutive ready probes before an ``out``
    replica re-enters; ``breaker_failures`` — consecutive request
    failures that rotate a replica out immediately.
    """

    #: EWMA smoothing for observed attempt latency: ~the last 10
    #: attempts dominate, so one slow outlier decays within a dozen
    #: requests instead of poisoning the replica's score for minutes.
    EWMA_ALPHA = 0.2

    def __init__(
        self,
        fail_threshold: int = 2,
        recover_probes: int = 2,
        breaker_failures: int = 3,
        rng: random.Random | None = None,
    ) -> None:
        if min(fail_threshold, recover_probes, breaker_failures) < 1:
            raise ValueError("thresholds must be >= 1")
        self.fail_threshold = int(fail_threshold)
        self.recover_probes = int(recover_probes)
        self.breaker_failures = int(breaker_failures)
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._rng = rng or random.Random()
        self._pick_seq = 0  # monotonic pick stamp (LRU tie-break)
        self._retire_listeners: list = []

    # -- membership ---------------------------------------------------------

    def add_retire_listener(self, fn) -> None:
        """``fn(replica_id)`` runs whenever a replica's *process* is
        gone for good — deregistration, or replacement by a same-id
        re-registration with a new url. The telemetry plane hooks this
        to retire the replica's per-replica gauge series
        (``fleet_scrape_stale``, ``fleet_clock_offset_ms``) instead of
        letting them linger forever at their last value. Listeners run
        outside the lock; exceptions are swallowed (telemetry hygiene
        must never break membership)."""
        self._retire_listeners.append(fn)

    def _notify_retire(self, replica_id: str) -> None:
        for fn in self._retire_listeners:
            try:
                fn(replica_id)
            except Exception:
                pass

    def register(self, replica_id: str, url: str) -> dict:
        """Add (or re-add) a replica. Re-registration with the same id is
        idempotent when the url matches (a replica retrying its
        registration must not reset its rotation state) and a fresh
        start otherwise (the process behind the id was replaced)."""
        with self._lock:
            old = self._replicas.get(replica_id)
            if old is not None and old.url == url.rstrip("/"):
                return old.as_dict()
            # Same id, different url: the replacement starts in PROBING,
            # so an in-rotation predecessor leaves rotation RIGHT HERE —
            # account it like deregister does, or fleet_rotations_total
            # drifts in>out and the journal arc has a silent capacity
            # drop at exactly this transition.
            replaced_in = (
                old is not None and old.state == READY and not old.held
            )
            self._replicas[replica_id] = rep = Replica(replica_id, url)
            self._refresh_gauge_locked()
        if old is not None:
            # The process behind the id was replaced: the OLD process's
            # per-replica series must not survive as the new one's.
            self._notify_retire(replica_id)
        if replaced_in:
            FLEET_ROTATIONS.inc(direction="out")
            journal.event(
                "fleet_rotation", replica=replica_id, direction="out",
                reason="replaced by re-registration with a new url",
            )
        journal.event(
            "fleet_replica_registered", replica=replica_id, url=rep.url,
        )
        return rep.as_dict()

    def deregister(self, replica_id: str) -> bool:
        with self._lock:
            rep = self._replicas.pop(replica_id, None)
            if rep is None:
                return False
            was_in = rep.state == READY and not rep.held
            self._refresh_gauge_locked()
        self._notify_retire(replica_id)
        if was_in:
            FLEET_ROTATIONS.inc(direction="out")
        journal.event(
            "fleet_replica_deregistered", replica=replica_id, url=rep.url,
        )
        return True

    def get(self, replica_id: str) -> dict | None:
        with self._lock:
            rep = self._replicas.get(replica_id)
            return rep.as_dict() if rep is not None else None

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                rep.as_dict()
                for _, rep in sorted(self._replicas.items())
            ]

    def urls(self) -> list[tuple[str, str]]:
        """(id, url) for every registered replica — the prober's worklist."""
        with self._lock:
            return [
                (rep.id, rep.url)
                for _, rep in sorted(self._replicas.items())
            ]

    # -- routing ------------------------------------------------------------

    def ready_count(self) -> int:
        with self._lock:
            return sum(
                1 for rep in self._replicas.values()
                if rep.state == READY and not rep.held
            )

    def pick(self, exclude: set[str] | None = None) -> dict | None:
        """The least-loaded of two random in-rotation choices (module
        docstring), preferring replicas not in ``exclude`` (the retry
        path's already-tried set). Falls back to an excluded-but-ready
        replica when nothing else is in rotation — against a shrunken
        fleet, retrying the same replica beats failing the request
        outright. None when nothing is ready."""
        with self._lock:
            ready = [
                rep for rep in self._replicas.values()
                if rep.state == READY and not rep.held
            ]
            if not ready:
                return None
            pool = [
                rep for rep in ready
                if not exclude or rep.id not in exclude
            ] or ready
            if len(pool) == 1:
                chosen = pool[0]
            else:
                a, b = self._rng.sample(pool, 2)
                sa, sb = a.score(), b.score()
                if sa != sb:
                    chosen = a if sa < sb else b
                else:
                    # No signal separates them (cold fleet): take the
                    # one picked least recently so traffic still spreads.
                    chosen = a if a.last_pick_seq <= b.last_pick_seq \
                        else b
            self._pick_seq += 1
            chosen.last_pick_seq = self._pick_seq
            return chosen.as_dict()

    def note_dispatch(self, replica_id: str) -> None:
        """An upstream attempt is in flight to the replica: its
        ``outstanding`` count — the most immediate load signal there is
        — rises until ``note_complete``."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.outstanding += 1

    def note_complete(self, replica_id: str,
                      latency_s: float | None = None) -> None:
        """The attempt finished (any outcome). ``latency_s`` feeds the
        EWMA only when the replica actually answered — a conn-error's
        instant failure or a timeout's capped wait says nothing about
        how fast the replica serves."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return
            rep.outstanding = max(0, rep.outstanding - 1)
            if latency_s is not None:
                ms = latency_s * 1000.0
                if rep.ewma_latency_ms is None:
                    rep.ewma_latency_ms = ms
                else:
                    a = self.EWMA_ALPHA
                    rep.ewma_latency_ms += a * (ms - rep.ewma_latency_ms)

    def mark_success(self, replica_id: str) -> None:
        """A routed request succeeded: the failure streak resets."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.request_fails = 0

    def mark_failure(self, replica_id: str, reason: str) -> None:
        """A routed request failed at the transport or with a 5xx. After
        ``breaker_failures`` consecutive ones the replica's breaker opens
        — rotation out immediately, recovery via probes."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return
            rep.request_fails += 1
            if rep.request_fails < self.breaker_failures or \
                    rep.state != READY:
                return
            self._transition_locked(
                rep, OUT, f"breaker open ({rep.request_fails} consecutive "
                f"request failures; last: {reason})",
            )

    # -- admin hold (rolling deploys) ---------------------------------------

    def hold(self, replica_id: str) -> bool:
        """Remove the replica from ``pick`` without touching probe state
        — the deploy controller's parking brake."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.held:
                return False
            was_in = rep.state == READY
            rep.held = True
            self._refresh_gauge_locked()
        if was_in:
            # Only an in-rotation replica LEAVES rotation here: holding
            # a probing/out replica (a lifecycle retire racing a crash)
            # must not journal a rotation that never happened.
            FLEET_ROTATIONS.inc(direction="out")
            journal.event(
                "fleet_rotation", replica=replica_id, direction="out",
                reason="admin_hold",
            )
        return True

    def release(self, replica_id: str) -> bool:
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or not rep.held:
                return False
            rep.held = False
            now_in = rep.state == READY
            self._refresh_gauge_locked()
        if now_in:
            # A replica that went OUT while held (stopped heartbeating
            # mid-drain) does NOT re-enter rotation on release — probes
            # own that door; journaling direction=in here would claim a
            # rotation the router never made.
            FLEET_ROTATIONS.inc(direction="in")
            journal.event(
                "fleet_rotation", replica=replica_id, direction="in",
                reason="admin_release",
            )
        return True

    # -- probe feedback ------------------------------------------------------

    def observe_probe(
        self, replica_id: str, ok: bool, ready: bool,
        version: int | None = None,
        queue_depth: int | None = None,
        clock_offset_ms: float | None = None,
    ) -> None:
        """Prober feedback for one replica: ``ok`` means the probe got an
        HTTP answer at all, ``ready`` the replica's own readiness verdict
        (an explicit 503 is a *healthy* not-ready, e.g. draining — it
        still counts against rotation, but as ``not_ready`` rather than
        a transport failure). ``queue_depth`` is the replica's own
        admission-queue depth off the same probe — the cross-router load
        signal ``pick`` folds into its score. ``clock_offset_ms`` is the
        smoothed clock offset the prober's ClockSync derived from the
        same probe (display-only here; the join reads ClockSync)."""
        FLEET_PROBES.inc(
            result="ok" if ok and ready else
            "not_ready" if ok else "error"
        )
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return
            rep.last_probe_at = time.time()  # graftcheck: disable=monotonic-clock
            if ok and version is not None:
                rep.version = version
            if ok and queue_depth is not None:
                # The field arrives off an UNTRUSTED /readyz body (any
                # process can register via the control plane): a
                # non-numeric value must not abort the probe pass — it
                # would freeze probing for every replica behind this one
                # in the tick, including rotated-out ones waiting to
                # recover.
                try:
                    rep.last_queue_depth = max(0, int(queue_depth))
                except (TypeError, ValueError):
                    pass
            if ok and clock_offset_ms is not None:
                rep.clock_offset_ms = float(clock_offset_ms)
            if ok and ready:
                rep.probe_fails = 0
                rep.probe_oks += 1
                if rep.state == PROBING or (
                    rep.state == OUT
                    and rep.probe_oks >= self.recover_probes
                ):
                    rep.request_fails = 0
                    self._transition_locked(rep, READY, "ready probe")
                return
            rep.probe_oks = 0
            rep.probe_fails += 1
            if rep.state == READY and (
                not ok and rep.probe_fails >= self.fail_threshold
                or ok and not ready
            ):
                # An explicit not-ready rotates out on the FIRST probe —
                # the replica itself said so (draining, degraded, cold);
                # transport silence needs fail_threshold strikes, since a
                # single dropped probe packet should not empty a fleet.
                self._transition_locked(
                    rep, OUT,
                    "replica reports not ready" if ok else
                    f"{rep.probe_fails} consecutive probe failures",
                )

    # -- internals -----------------------------------------------------------

    def _transition_locked(self, rep: Replica, state: str,
                           reason: str) -> None:
        """State change + journal + metrics, under the registry lock so
        published order matches transition order (the supervisor's
        breaker lesson)."""
        was_in = rep.state == READY and not rep.held
        rep.state = state
        rep.reason = reason
        rep.last_change_at = time.time()  # graftcheck: disable=monotonic-clock
        if state == OUT:
            # Recovery hysteresis starts from zero at the moment of the
            # outage: ok-probes accumulated while READY must not let a
            # breaker-opened replica skip the recover_probes gate on its
            # first post-outage probe.
            rep.probe_oks = 0
        now_in = rep.state == READY and not rep.held
        self._refresh_gauge_locked()
        if was_in != now_in:
            FLEET_ROTATIONS.inc(direction="in" if now_in else "out")
        journal.event(
            "fleet_rotation", replica=rep.id,
            direction="in" if now_in else "out", reason=reason,
            state=state, version=rep.version,
        )

    def _refresh_gauge_locked(self) -> None:
        counts = {PROBING: 0, READY: 0, OUT: 0}
        for rep in self._replicas.values():
            if rep.held and rep.state == READY:
                # A held-ready replica is effectively out of rotation;
                # the gauge reflects what the router would route to.
                counts[OUT] += 1
            else:
                counts[rep.state] += 1
        for state, n in counts.items():
            FLEET_REPLICAS.set(float(n), state=state)

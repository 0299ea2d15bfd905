"""Replica lifecycle manager — spawn, drain-first retire, crash-replace.

The registry (``fleet.registry``) answers *who may receive traffic*; this
module answers *who exists at all*. It owns a set of local replica
processes (real ``cli serve`` subprocesses in production, injectable
launchers in tests) and drives each through one explicit arc:

  spawn      launch the process on an allocated port with ``--register``
             pointed at the router; the replica self-enrols and warms.
             The manager probes ``/readyz`` directly — rotation-in stays
             the router prober's decision, but the manager must know
             when a spawn *landed* (and when it never will).
  ready      first ready probe within ``ready_deadline_s``. A spawn that
             never becomes ready (crashed child, corrupt checkpoint,
             injected ``lifecycle.spawn`` fault) is killed, deregistered,
             and retried under capped exponential backoff — it fails
             closed: the unready replica never entered rotation, so the
             fleet it was meant to grow is merely not grown yet.
  drain      retirement is **drain-first** by contract: an admin *hold*
             through the router removes the replica from rotation while
             it keeps serving in-flight work, then the manager waits for
             its queue to empty (bounded by ``drain_settle_s``).
  term       graceful SIGTERM — the replica's own drain machinery
             (docs/RESILIENCE.md liveness/readiness split) finishes
             in-flight replies and deregisters itself.
  kill       only after ``term_deadline_s``: a replica that refuses to
             drain (wedged loop, injected ``lifecycle.drain`` fault) is
             SIGKILLed — bounded retirement, never a zombie holding a
             port.
  respawn    crash replacement: a managed process that exits (or a
             replica the registry reports persistently unresponsive
             while its process claims to live) is detected on the next
             tick, deregistered, and respawned on the same id/port with
             backoff — the idempotent re-registration path the kill
             drill already proved brings it back through probes.

Every transition is journaled (``lifecycle_*`` events) and counted
(``lifecycle_transitions_total{event=}``, ``lifecycle_replicas{state=}``)
so the surge drill can assert the whole arc from one journal.

The manager is tick-driven and never blocks: ``tick()`` advances every
replica's state machine by at most one step and returns — the autoscale
daemon calls it once per poll, and tests drive it directly with fake
clocks and launchers. jax-free like the rest of ``fleet/``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.fleet.health import probe_replica
from machine_learning_replications_tpu_torch.resilience import faults

LIFECYCLE_TRANSITIONS = REGISTRY.counter(
    "lifecycle_transitions_total",
    "Replica lifecycle transitions by event (spawn, ready, spawn_failed, "
    "drain, term, kill, exit, crash).",
    labels=("event",),
)
LIFECYCLE_REPLICAS = REGISTRY.gauge(
    "lifecycle_replicas",
    "Managed replicas by lifecycle state (pending: awaiting a backoff "
    "respawn slot).",
    labels=("state",),
)
# Materialize the full label space at import (the registry convention:
# a zero is a fact, an absent series is a mystery).
for _event in ("spawn", "ready", "spawn_failed", "drain", "term", "kill",
               "exit", "crash"):
    LIFECYCLE_TRANSITIONS.labels(event=_event)

#: Lifecycle states (``ManagedReplica.state``).
PENDING, SPAWNING, READY, DRAINING, TERMINATING = (
    "pending", "spawning", "ready", "draining", "terminating",
)
_STATES = (PENDING, SPAWNING, READY, DRAINING, TERMINATING)
for _state in _STATES:
    LIFECYCLE_REPLICAS.labels(state=_state)


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-allocated free TCP port. The momentary bind/release race is
    acceptable here: the replica binds it back within milliseconds, and a
    lost race surfaces as a failed spawn the backoff path already owns."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def replica_queue_depth(url: str, timeout_s: float = 2.0) -> int | None:
    """The replica's ``/healthz`` queue depth — the drain-settle signal.
    None when unreachable (a dead replica has, by definition, drained)."""
    try:
        with urllib.request.urlopen(
            url.rstrip("/") + "/healthz", timeout=timeout_s
        ) as resp:
            body = json.loads(resp.read())
        depth = body.get("queue_depth")
        return int(depth) if isinstance(depth, (int, float)) else None
    except Exception:
        return None


class RouterClient:
    """The manager's (and autoscaler's) thin HTTP view of the router's
    control plane. Every call is best-effort and never raises — the
    control loop must keep ticking through a router blip, and each
    operation is retried implicitly by the next tick."""

    def __init__(self, router_url: str, timeout_s: float = 5.0) -> None:
        self.base = router_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def _post(self, body: dict) -> dict | None:
        try:
            req = urllib.request.Request(
                self.base + "/fleet/replicas",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def snapshot(self) -> list[dict] | None:
        """The registry snapshot, or None when the router is unreachable
        (callers must distinguish 'empty fleet' from 'no answer')."""
        try:
            with urllib.request.urlopen(
                self.base + "/fleet/replicas", timeout=self.timeout_s
            ) as r:
                return json.loads(r.read())["replicas"]
        except Exception:
            return None

    def hold(self, replica_id: str) -> bool:
        out = self._post({"hold": replica_id})
        return bool(out and out.get("held"))

    def release(self, replica_id: str) -> bool:
        out = self._post({"release": replica_id})
        return bool(out and out.get("released"))

    def deregister(self, replica_id: str) -> bool:
        out = self._post({"deregister": replica_id})
        return bool(out and out.get("deregistered"))


class ReplicaSpec:
    """How to launch one replica: the checkpoint it serves, the serve
    flags it runs under, and where its journal goes. ``command`` builds
    the real ``cli serve`` invocation; tests inject a launcher instead of
    a different command."""

    def __init__(
        self,
        model: str,
        register_url: str,
        host: str = "127.0.0.1",
        serve_args: tuple[str, ...] | list[str] = (),
        journal_dir: str | None = None,
        python: str = sys.executable,
        no_aot: bool = False,
    ) -> None:
        self.model = model
        self.register_url = register_url.rstrip("/")
        self.host = host
        self.serve_args = tuple(serve_args)
        self.journal_dir = journal_dir
        self.python = python
        # Fleet-wide AOT escape hatch (docs/AOT.md): force every spawned
        # replica onto the tracing path — `cli fleet autoscale --no-aot`.
        # Scale-out reaction time then pays the full ladder compile
        # again, but a bad published executable bundle cannot touch the
        # fleet at all.
        self.no_aot = bool(no_aot)

    def command(self, replica_id: str, port: int,
                model: str | None = None) -> list[str]:
        cmd = [
            self.python, "-m", "machine_learning_replications_tpu_torch",
            "serve", "--model", model or self.model,
            "--host", self.host, "--port", str(port),
            "--replica-id", replica_id,
            "--register", self.register_url,
            *(("--no-aot",) if self.no_aot else ()),
            *self.serve_args,
        ]
        if self.journal_dir:
            cmd += [
                "--journal",
                os.path.join(
                    self.journal_dir, f"replica_{replica_id}.jsonl"
                ),
            ]
        return cmd


def _default_launcher(cmd: list[str]):
    return subprocess.Popen(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


class ManagedReplica:
    """One lifecycle slot. The id and port are stable across respawns —
    the registry's idempotent re-registration (same id, same url) is what
    lets a replacement probe straight back into rotation."""

    __slots__ = (
        "id", "seq", "port", "url", "proc", "state", "spawned_at",
        "ready_at", "ready_deadline", "drain_deadline", "term_deadline",
        "attempts", "next_spawn_at", "respawn", "skip_term",
        "retire_reason", "host",
    )

    def __init__(self, replica_id: str, port: int, host: str,
                 seq: int = 0) -> None:
        self.id = replica_id
        self.seq = seq
        self.host = host
        self.port = port
        self.url = f"http://{host}:{port}"
        self.proc = None
        self.state = PENDING
        self.spawned_at = 0.0
        self.ready_at: float | None = None
        self.ready_deadline = 0.0
        self.drain_deadline = 0.0
        self.term_deadline = 0.0
        self.attempts = 0          # consecutive failed spawn/crash cycles
        self.next_spawn_at = 0.0   # backoff gate for the next attempt
        self.respawn = False
        self.skip_term = False     # lifecycle.drain corrupt: TERM suppressed
        self.retire_reason = ""

    def as_dict(self) -> dict:
        return {
            "id": self.id,
            "port": self.port,
            "url": self.url,
            "state": self.state,
            "pid": self.proc.pid if self.proc is not None else None,
            "attempts": self.attempts,
            "respawn": self.respawn,
        }


class LifecycleManager:
    """The spawn/retire/replace state machine over a set of
    ``ManagedReplica`` slots (see module docstring).

    ``scale_to(n)`` sets the desired non-draining replica count (clamped
    to ``[min_replicas, max_replicas]``); ``tick()`` reconciles toward it
    one bounded step per call. Retirement is newest-first (the surge
    capacity leaves first; the steady-state fleet keeps its warm
    veterans).
    """

    def __init__(
        self,
        spec: ReplicaSpec,
        router: RouterClient,
        min_replicas: int = 1,
        max_replicas: int = 4,
        ready_deadline_s: float = 300.0,
        drain_settle_s: float = 10.0,
        term_deadline_s: float = 30.0,
        respawn_backoff_s: float = 1.0,
        respawn_backoff_max_s: float = 30.0,
        unresponsive_probe_fails: int = 8,
        launcher=_default_launcher,
        clock=time.monotonic,
        say=None,
    ) -> None:
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        self.spec = spec
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.ready_deadline_s = float(ready_deadline_s)
        self.drain_settle_s = float(drain_settle_s)
        self.term_deadline_s = float(term_deadline_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_max_s = float(respawn_backoff_max_s)
        self.unresponsive_probe_fails = int(unresponsive_probe_fails)
        self._launcher = launcher
        self._clock = clock
        self._say = say
        self._seq = 0
        self.desired = 0
        self._replicas: dict[str, ManagedReplica] = {}

    # -- public surface -------------------------------------------------------

    def say(self, msg: str) -> None:
        if self._say is not None:
            self._say(msg)

    def scale_to(self, n: int) -> int:
        """Set the desired replica count (clamped to bounds); the tick
        loop converges toward it. Returns the clamped target."""
        self.desired = max(self.min_replicas, min(self.max_replicas, int(n)))
        return self.desired

    def counts(self) -> dict:
        out = {state: 0 for state in _STATES}
        for rep in self._replicas.values():
            out[rep.state] += 1
        out["desired"] = self.desired
        # "active" slots are the ones counted against the target: every
        # slot not already on its way out.
        out["active"] = sum(
            out[s] for s in (PENDING, SPAWNING, READY)
        )
        return out

    def replicas(self) -> list[dict]:
        return [r.as_dict() for _, r in sorted(self._replicas.items())]

    def get(self, replica_id: str) -> ManagedReplica | None:
        return self._replicas.get(replica_id)

    def tick(self) -> None:
        """One reconciliation pass: advance every slot's arc, detect
        crashes, then spawn/retire toward ``desired``."""
        now = self._clock()
        snapshot = self.router.snapshot()
        by_id = {
            r["id"]: r for r in snapshot or []
        } if snapshot is not None else None
        for rep in list(self._replicas.values()):
            self._advance(rep, now, by_id)
        counts = self.counts()
        if counts["active"] < self.desired:
            for _ in range(self.desired - counts["active"]):
                self._new_slot(now)
        elif counts["active"] > self.desired:
            # Retire newest READY slots first; a slot still spawning is
            # cheaper to abandon than a warm veteran, but abandoning a
            # half-warm process is still a retire arc (drain is a no-op
            # on a replica that never took traffic).
            excess = counts["active"] - self.desired
            # Numeric creation order, not id strings: "as-10" must sort
            # after "as-9", or a long-lived daemon retires the veteran.
            candidates = sorted(
                (r for r in self._replicas.values()
                 if r.state in (READY, SPAWNING, PENDING)),
                key=lambda r: r.seq, reverse=True,
            )
            for rep in candidates[:excess]:
                self._retire(rep, now, reason="scale_in")
        # Backoff-gated (re)spawns.
        for rep in self._replicas.values():
            if rep.state == PENDING and now >= rep.next_spawn_at:
                self._spawn(rep, now)
        self._refresh_gauge()

    def close(self, kill: bool = True) -> None:
        """Drill/daemon teardown: stop every managed child. ``kill=False``
        sends SIGTERM only (graceful, may outlive the manager)."""
        for rep in self._replicas.values():
            if rep.proc is not None and rep.proc.poll() is None:
                try:
                    rep.proc.terminate()
                except OSError:
                    pass
        if kill:
            deadline = time.monotonic() + self.term_deadline_s
            for rep in self._replicas.values():
                if rep.proc is None:
                    continue
                while rep.proc.poll() is None and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                if rep.proc.poll() is None:
                    try:
                        rep.proc.kill()
                    except OSError:
                        pass
            for rep in self._replicas.values():
                self.router.deregister(rep.id)

    # -- per-slot state machine ----------------------------------------------

    def _advance(self, rep: ManagedReplica, now: float,
                 by_id: dict | None) -> None:
        exited = (
            rep.proc is not None and rep.proc.poll() is not None
        )
        if rep.state in (SPAWNING, READY) and exited:
            self._on_crash(rep, now, f"process exited {rep.proc.poll()}")
            return
        if rep.state == READY and by_id is not None:
            # Registry-observed zombie: the process claims to live but
            # stopped answering probes (wedged interpreter, blackholed
            # socket). The registry already rotated it out; the manager
            # replaces it.
            reg = by_id.get(rep.id)
            if reg is not None and reg.get("state") == "out" and \
                    reg.get("probe_fails", 0) >= self.unresponsive_probe_fails:
                self._kill_proc(rep, reason="unresponsive")
                self._on_crash(
                    rep, now,
                    f"unresponsive ({reg['probe_fails']} failed probes "
                    "with a live process)",
                )
                return
        if rep.state == SPAWNING:
            verdict = probe_replica(rep.url)
            if verdict["ok"] and verdict["ready"]:
                rep.state = READY
                rep.ready_at = now
                rep.attempts = 0
                seconds = round(now - rep.spawned_at, 3)
                LIFECYCLE_TRANSITIONS.inc(event="ready")
                journal.event(
                    "lifecycle_ready", replica=rep.id, url=rep.url,
                    seconds=seconds, respawn=rep.respawn,
                )
                self.say(f"replica {rep.id} ready in {seconds}s")
            elif now >= rep.ready_deadline:
                # The fail-closed branch: an unready spawn never entered
                # rotation (rotation-in is probe-gated), so the only
                # cleanup is the process itself.
                self._kill_proc(rep, reason="ready_timeout")
                self._spawn_failed(
                    rep, now,
                    f"not ready within {self.ready_deadline_s:g}s",
                )
        elif rep.state == DRAINING:
            depth = replica_queue_depth(rep.url)
            if depth in (None, 0) or now >= rep.drain_deadline:
                self._term(rep, now, drained=depth in (None, 0))
        elif rep.state == TERMINATING:
            if exited or rep.proc is None:
                code = rep.proc.poll() if rep.proc is not None else None
                LIFECYCLE_TRANSITIONS.inc(event="exit")
                journal.event(
                    "lifecycle_exit", replica=rep.id, code=code,
                    reason=rep.retire_reason,
                )
                self.router.deregister(rep.id)
                del self._replicas[rep.id]
                self.say(f"replica {rep.id} retired (exit {code})")
            elif now >= rep.term_deadline:
                self._kill_proc(rep, reason="term_deadline")

    def _on_crash(self, rep: ManagedReplica, now: float,
                  detail: str) -> None:
        LIFECYCLE_TRANSITIONS.inc(event="crash")
        journal.event(
            "lifecycle_crash", replica=rep.id, state=rep.state,
            detail=detail,
        )
        self.say(f"replica {rep.id} crashed ({detail})")
        self.router.deregister(rep.id)
        if rep.state == SPAWNING:
            self._spawn_failed(rep, now, f"crashed while warming: {detail}")
            return
        rep.attempts += 1
        rep.respawn = True
        rep.state = PENDING
        rep.proc = None
        self._maybe_move_port(rep)
        rep.next_spawn_at = now + self._backoff(rep.attempts)

    def _spawn_failed(self, rep: ManagedReplica, now: float,
                      reason: str) -> None:
        rep.attempts += 1
        backoff = self._backoff(rep.attempts)
        LIFECYCLE_TRANSITIONS.inc(event="spawn_failed")
        journal.event(
            "lifecycle_spawn_failed", replica=rep.id, reason=reason,
            attempts=rep.attempts, retry_in_s=round(backoff, 3),
        )
        self.say(
            f"replica {rep.id} spawn failed ({reason}); retry in "
            f"{backoff:.1f}s"
        )
        self.router.deregister(rep.id)
        rep.state = PENDING
        rep.proc = None
        self._maybe_move_port(rep)
        rep.next_spawn_at = now + backoff

    def _maybe_move_port(self, rep: ManagedReplica) -> None:
        """Same-id/same-port respawn is the contract for the common
        crash (the idempotent re-registration path) — but a port stolen
        during the backoff window would otherwise EADDRINUSE every
        retry forever. After 3 consecutive failures, move the slot to a
        fresh port; same-id-new-url re-registration is already a
        journaled, supported registry transition."""
        if rep.attempts >= 3:
            rep.port = free_port(rep.host)
            rep.url = f"http://{rep.host}:{rep.port}"

    def _backoff(self, attempts: int) -> float:
        # Clamped exponent (the supervisor's overflow lesson): attempts
        # can grow unboundedly across a long outage.
        return min(
            self.respawn_backoff_max_s,
            self.respawn_backoff_s * (2.0 ** min(attempts - 1, 16)),
        )

    def _new_slot(self, now: float) -> None:
        self._seq += 1
        rep = ManagedReplica(f"as-{self._seq}", free_port(self.spec.host),
                             self.spec.host, seq=self._seq)
        self._replicas[rep.id] = rep
        self._spawn(rep, now)

    def _spawn(self, rep: ManagedReplica, now: float) -> None:
        model = self.spec.model
        try:
            if faults.fire("lifecycle.spawn"):
                # corrupt mode: launch a replica that can never become
                # ready (nonexistent checkpoint — the child dies or never
                # warms; either way the ready-deadline branch owns it).
                model = self.spec.model + ".__corrupt__"
        except faults.InjectedFault as exc:
            self._spawn_failed(rep, now, f"injected: {exc}")
            return
        cmd = self.spec.command(rep.id, rep.port, model=model)
        try:
            rep.proc = self._launcher(cmd)
        except OSError as exc:
            self._spawn_failed(rep, now, f"launch error: {exc}")
            return
        rep.state = SPAWNING
        rep.spawned_at = now
        rep.ready_deadline = now + self.ready_deadline_s
        rep.skip_term = False
        LIFECYCLE_TRANSITIONS.inc(event="spawn")
        journal.event(
            "lifecycle_spawn", replica=rep.id, port=rep.port,
            pid=rep.proc.pid if rep.proc is not None else None,
            attempt=rep.attempts + 1, respawn=rep.respawn,
        )
        self.say(
            f"replica {rep.id} spawning on port {rep.port}"
            + (" (respawn)" if rep.respawn else "")
        )

    def _retire(self, rep: ManagedReplica, now: float,
                reason: str) -> None:
        skip_term = False
        try:
            # corrupt = simulate a replica that ignores its SIGTERM: the
            # graceful signal is suppressed so the kill-deadline
            # escalation below is forced to carry the retirement.
            skip_term = faults.fire("lifecycle.drain")
        except faults.InjectedFault as exc:
            # Fail closed: the replica stays in rotation and serving;
            # the retirement is simply not started this tick (re-decided
            # on the next one).
            journal.event(
                "lifecycle_drain_error", replica=rep.id,
                error=f"injected: {exc}",
            )
            return
        if rep.state == PENDING:
            # Never launched (still in a backoff window): nothing to
            # drain, nothing to kill — drop the slot.
            journal.event(
                "lifecycle_exit", replica=rep.id, code=None, reason=reason,
            )
            LIFECYCLE_TRANSITIONS.inc(event="exit")
            del self._replicas[rep.id]
            return
        self.router.hold(rep.id)  # out of rotation, still serving
        rep.state = DRAINING
        rep.retire_reason = reason
        rep.skip_term = skip_term
        rep.drain_deadline = now + self.drain_settle_s
        LIFECYCLE_TRANSITIONS.inc(event="drain")
        journal.event(
            "lifecycle_drain", replica=rep.id, reason=reason,
            settle_deadline_s=self.drain_settle_s,
        )
        self.say(f"replica {rep.id} draining ({reason})")

    def _term(self, rep: ManagedReplica, now: float,
              drained: bool) -> None:
        delivered = False
        if not rep.skip_term and rep.proc is not None and \
                rep.proc.poll() is None:
            try:
                rep.proc.terminate()
                delivered = True
            except OSError:
                pass
        rep.state = TERMINATING
        rep.term_deadline = now + self.term_deadline_s
        LIFECYCLE_TRANSITIONS.inc(event="term")
        journal.event(
            "lifecycle_term", replica=rep.id, drained=drained,
            delivered=delivered,
            kill_deadline_s=self.term_deadline_s,
        )

    def _kill_proc(self, rep: ManagedReplica, reason: str) -> None:
        if rep.proc is not None and rep.proc.poll() is None:
            try:
                rep.proc.kill()
            except OSError:
                pass
            LIFECYCLE_TRANSITIONS.inc(event="kill")
            journal.event("lifecycle_kill", replica=rep.id, reason=reason)
            self.say(f"replica {rep.id} SIGKILLed ({reason})")

    def _refresh_gauge(self) -> None:
        counts = {state: 0 for state in _STATES}
        for rep in self._replicas.values():
            counts[rep.state] += 1
        for state, n in counts.items():
            LIFECYCLE_REPLICAS.set(float(n), state=state)


def kill_replica(rep: ManagedReplica) -> None:
    """Drill helper: SIGKILL a managed replica's process directly (the
    chaos scenario's murder weapon — the manager must *detect* this, so
    it goes around the manager on purpose)."""
    if rep.proc is not None and rep.proc.poll() is None:
        os.kill(rep.proc.pid, signal.SIGKILL)

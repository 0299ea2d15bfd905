"""Front-door HTTP router: N replicas behind one address, zero-downtime.

The router reuses the serving stack's proven transport — the same
``serve.protocol`` parse rules and ``serve.transport`` non-blocking
event loop the 1332-qps front end runs on — with a different
application behind it: instead of an engine, a **replica registry**
(``fleet.registry``), a **health prober** (``fleet.health``), and a
**proxy data path** with per-request retry and hedging.

Data path (``POST /predict``) — ONE loop thread owns every socket end
to end, client side and replica side:

  * The handler (event-loop thread) picks an in-rotation replica —
    **least-loaded, power-of-two-choices** over the registry's live
    per-replica signals (EWMA attempt latency × (1 + outstanding
    attempts + queue depth); see ``fleet.registry``) — and fires the
    attempt through the transport's ``UpstreamPool``: non-blocking
    connect, per-replica keep-alive connection reuse, incremental
    response parsing, write backpressure, and the strict
    poisoned-connection rules a proxy needs. No thread hand-off per
    request anywhere on the path: the attempt completes as a loop
    callback, exactly like the timers it races. (The previous data
    plane proxied through a small pool of forwarder threads holding
    blocking ``http.client`` upstreams — the same thread-per-request
    architecture whose removal replica-side bought 10.1×.)
  * The client's deadline (``--request-timeout``, tightened by an
    inbound ``X-Request-Deadline-Ms``, never loosened) rides DOWN to the
    replica as the remaining budget and is enforced router-side by a
    loop timer: a request is answered or 504'd in bounded time, never
    hung — the same contract the replicas make individually.
  * **Retry**: a transport failure or 5xx marks the replica
    (``registry.mark_failure`` — the per-replica breaker) and re-sends
    the request to the next replica, up to ``max_attempts`` and always
    within the deadline. A 503 shed retries on a *different* replica
    immediately; when only the shedding replica exists, the upstream's
    ``Retry-After`` is honored (bounded by the remaining budget) before
    one same-replica retry — and passed through to the client when the
    budget cannot cover it. ``/predict`` is a pure function, so
    re-sends and duplicates cannot double-apply anything.
  * **Hedging** (``hedge_ms`` > 0): when the first attempt has not
    answered within the hedge delay and a second in-rotation replica
    exists, a duplicate fires; the first reply wins, the loser's
    attempt is cancelled (its connection closes — a half-spoken
    exchange can never be pooled). Tail latency from one slow replica
    costs one duplicate request instead of a client-visible stall.
  * Replies pass through the replica's body and identity headers
    (``X-Replica`` / ``X-Model-Version`` / ``X-Serve-Path``) — the
    rolling-deploy crossover is provable from the client side.

For many-core hosts, ``cli fleet router --workers N`` forks N router
processes sharing one ``SO_REUSEPORT`` port (``make_router(reuse_port=
True)``), each with its own registry converging through the replicas'
periodic registration heartbeats; the replica-side queue-depth probe
signal keeps their load views consistent.

Control plane: ``/fleet/replicas`` (GET snapshot; POST register /
deregister — ``cli serve --register`` posts here), ``/fleet/deploy``
(POST starts a rolling deploy through ``fleet.deploy``; GET status),
``/healthz`` / ``/readyz`` (a router with zero in-rotation replicas is
alive but not ready), ``/metrics`` (``fleet_*`` families through the
process registry, strict-exposition clean), ``/fleet/metrics`` (the
aggregated fleet exposition: in-rotation replicas scraped and merged
per ``obs.fleetmetrics``, stale replicas marked, the router's own
families appended), ``/fleet/trace`` (the cross-process joined
timeline: the router's tail-sampled traces with each serving replica's
phases fetched by request id and offset-corrected into the upstream
span, per ``obs.fleettrace``), and ``/debug/requests`` (the router's
own flight-recorded traces: route → upstream → respond phase
attribution per sampled request; ``?id=`` exact lookup over the
all-completions index).

No jax imports anywhere on this path (graftcheck rule
``import-purity`` proves it transitively in CI) — the router starts in
milliseconds and runs fine on a host with no accelerator stack at all.
The one-loop-thread socket-ownership contract is annotated with
``@loop_only`` / ``@cross_thread`` (``contracts.py``) and enforced by
rule ``loop-discipline``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.parse

from machine_learning_replications_tpu_torch.obs import (
    alerts as obs_alerts,
    fleetmetrics,
    fleettrace,
    incident as obs_incident,
    journal,
    reqtrace,
    timeseries as obs_timeseries,
)
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.fleet.health import HealthProber
from machine_learning_replications_tpu_torch.fleet.registry import ReplicaRegistry
from machine_learning_replications_tpu_torch.serve import protocol
from machine_learning_replications_tpu_torch.serve.metrics import LATENCY_BUCKETS_S
from machine_learning_replications_tpu_torch.serve.transport import (
    EventLoopHttpServer,
    UpstreamPool,
)
from machine_learning_replications_tpu_torch.contracts import (
    cross_thread,
    loop_only,
)

FLEET_REQUESTS = REGISTRY.counter(
    "fleet_requests_total",
    "Routed /predict requests by terminal outcome (ok, shed, error, "
    "timeout, no_replica, bad_request).",
    labels=("outcome",),
)
FLEET_UPSTREAM = REGISTRY.counter(
    "fleet_upstream_attempts_total",
    "Upstream /predict attempts by result (ok, shed, server_error, "
    "conn_error, client_error).",
    labels=("result",),
)
FLEET_RETRIES = REGISTRY.counter(
    "fleet_retries_total",
    "Requests re-sent to another replica, by what failed the previous "
    "attempt.",
    labels=("reason",),
)
FLEET_HEDGES = REGISTRY.counter(
    "fleet_hedges_total",
    "Hedged duplicate attempts fired against a second replica.",
)
FLEET_HEDGE_WINS = REGISTRY.counter(
    "fleet_hedge_wins_total",
    "Hedged duplicates that answered before the original attempt.",
)
FLEET_REPLICA_REQUESTS = REGISTRY.counter(
    "fleet_replica_requests_total",
    "Upstream attempts per replica by result.",
    labels=("replica", "result"),
)
FLEET_LATENCY = REGISTRY.histogram(
    "fleet_request_latency_seconds",
    "Router-side /predict latency, admission to reply enqueue.",
    LATENCY_BUCKETS_S,
)
FLEET_DEPLOYS = REGISTRY.counter(
    "fleet_deploys_total",
    "Rolling deploys driven through this router by result.",
    labels=("result",),
)
FLEET_UPSTREAM_CONNS = REGISTRY.counter(
    "fleet_upstream_connections_total",
    "Upstream connection events on the router's loop-owned pool "
    "(opened: fresh TCP connect; reused: attempt rode a pooled "
    "keep-alive connection).",
    labels=("event",),
)
for _outcome in ("ok", "shed", "error", "timeout", "no_replica"):
    FLEET_REQUESTS.labels(outcome=_outcome)
for _event in ("opened", "reused"):
    FLEET_UPSTREAM_CONNS.labels(event=_event)
FLEET_HEDGES.get()
FLEET_HEDGE_WINS.get()

# Child instruments resolved ONCE: labels() takes the family lock and
# rebuilds the key tuple per call — measurable on the loop at four-digit
# qps (the r11 SLOTracker lesson, applied to the router's hot counters).
_REQ_OUTCOME = {
    o: FLEET_REQUESTS.labels(outcome=o)
    for o in ("ok", "shed", "error", "timeout", "no_replica",
              "bad_request")
}
_UP_RESULT = {
    r: FLEET_UPSTREAM.labels(result=r)
    for r in ("ok", "shed", "server_error", "conn_error", "client_error")
}
_CONN_EVENT = {
    e: FLEET_UPSTREAM_CONNS.labels(event=e) for e in ("opened", "reused")
}
_LATENCY = FLEET_LATENCY.get()
_REPLICA_RESULT: dict = {}  # (replica, result) -> child counter


def _replica_counter(replica: str, result: str):
    child = _REPLICA_RESULT.get((replica, result))
    if child is None:
        child = _REPLICA_RESULT[(replica, result)] = \
            FLEET_REPLICA_REQUESTS.labels(replica=replica, result=result)
    return child


FLEET_CAPTURE_DROPPED = REGISTRY.counter(
    "fleet_capture_dropped_total",
    "Served bodies dropped by the capture feed because the writer "
    "thread fell behind (bounded hand-off queue; the capture window is "
    "a bounded recent-cohort ring, so shedding is semantically fine).",
)


class _CaptureFeed:
    """The continual-learning tap's hand-off: the loop thread must not
    pay shard-rotation fsyncs, so captured bodies queue to one daemon
    writer thread (the same reasoning as serve's AsyncQualityFeed).
    The queue is BOUNDED: a disk slower than the request rate sheds
    capture rows (counted) instead of growing router memory without
    bound — the tap must never take the data path down, including by
    OOM."""

    MAX_PENDING = 8192

    def __init__(self, capture) -> None:
        self.capture = capture
        self._q: queue.Queue = queue.Queue(maxsize=self.MAX_PENDING)
        self._thread = threading.Thread(
            target=self._loop, name="fleet-capture", daemon=True
        )
        self._thread.start()

    @loop_only
    def append(self, body: bytes) -> None:
        try:
            self._q.put_nowait(body)
        except queue.Full:
            FLEET_CAPTURE_DROPPED.get().inc()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self.capture.append_line(item)
            except Exception:
                pass  # the data tap must never take the data path down

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10.0)
        self.capture.close()


_PASSTHROUGH_HEADERS = ("x-replica", "x-model-version", "x-serve-path")


class _ProxyJob:
    """One routed /predict request — a state machine that lives entirely
    ON the loop thread: dispatches are ``UpstreamPool`` attempts whose
    completions come back as loop callbacks, racing the hedge and
    deadline timers on the same clock. No locks — admission, every
    retry, the hedge, the deadline, and the reply are serialized by the
    loop by construction; exactly one path flips ``done``."""

    __slots__ = (
        "app", "trace", "responder", "body", "pin", "deadline_mono",
        "deadline_s", "tried", "first_replica", "attempts", "hedged",
        "t_route0", "deadline_timer", "hedge_timer", "done",
        "last_retry_after", "pending",
    )

    def __init__(self, app, trace, responder, body: bytes,
                 pin: str | None, deadline_s: float) -> None:
        self.app = app
        self.trace = trace
        self.responder = responder
        self.body = body
        self.pin = pin
        self.deadline_s = deadline_s
        self.deadline_mono = time.monotonic() + deadline_s
        self.tried: set[str] = set()
        self.first_replica: str | None = None
        self.attempts = 0
        self.hedged = False
        self.t_route0 = time.perf_counter()
        self.deadline_timer = None
        self.hedge_timer = None
        self.last_retry_after: str | None = None
        self.pending: list = []  # in-flight UpstreamAttempts
        self.done = False

    @loop_only
    def _claim(self) -> bool:
        if self.done:
            return False
        self.done = True
        self._settle()
        return True

    @loop_only
    def _settle(self) -> None:
        """Terminal cleanup: stop the timers and cancel the losing
        in-flight attempts (their connections close — a reply may be
        mid-flight on them). A cancelled attempt's completion never
        fires, so its replica's outstanding count is released here."""
        if self.deadline_timer is not None:
            self.deadline_timer.cancel()
        if self.hedge_timer is not None:
            self.hedge_timer.cancel()
        for att in self.pending:
            if att.cancel():
                self.app.registry.note_complete(att.key, None)
        self.pending.clear()

    # -- admission / dispatch (loop thread) ----------------------------------

    @loop_only
    def start(self) -> None:
        rep = self.app.registry.pick()
        if rep is None:
            self.finish_no_replica()
            return
        self.deadline_timer = self.app.httpd.call_later(
            self.deadline_s, self.on_deadline
        )
        if self.app.hedge_s > 0:
            self.hedge_timer = self.app.httpd.call_later(
                self.app.hedge_s, self.on_hedge
            )
        self.dispatch(rep)

    @loop_only
    def finish_no_replica(self) -> None:
        if not self._claim():
            return
        self.app.finish(
            self, "no_replica", 503,
            body=json.dumps({"error": "no ready replicas"}).encode(),
            headers={"Retry-After": "1"},
        )

    @loop_only
    def dispatch(self, rep: dict) -> None:
        if self.done:
            return
        self.attempts += 1
        if self.first_replica is None:
            self.first_replica = rep["id"]
        self.tried.add(rep["id"])
        self._send(rep)

    @loop_only
    def _send(self, rep: dict) -> None:
        """Fire one upstream attempt through the loop-owned pool."""
        remaining = self.deadline_mono - time.monotonic()
        if remaining <= 0.005:
            return  # the deadline timer answers
        headers = {
            "Content-Type": "application/json",
            "X-Request-Id": self.trace.request_id,
            # The remaining budget rides down so the replica's own
            # deadline machinery (504 + cancel-unflushed) is in play for
            # exactly the time the client is still listening.
            "X-Request-Deadline-Ms": str(int(remaining * 1000)),
        }
        if self.pin:
            headers["X-Serve-Path"] = self.pin
        data = protocol.build_request(
            "POST", "/predict", headers, self.body,
            host=f"{rep['id']}",
        )
        self.app.registry.note_dispatch(rep["id"])
        t0 = time.monotonic()
        cell: list = []
        att = self.app.upstream.request(
            rep["id"], self.app.replica_addr(rep["url"]), data,
            timeout_s=remaining,
            on_done=lambda result: self.on_upstream(
                rep, t0, cell[0] if cell else None, result
            ),
        )
        cell.append(att)
        self.pending.append(att)

    @loop_only
    def retry(self, reason: str, failed: dict) -> bool:
        """Pick another replica and re-send; False when the retry budget
        (attempts, candidates, deadline) is exhausted."""
        if self.attempts >= self.app.max_attempts:
            return False
        if time.monotonic() >= self.deadline_mono:
            return False  # the deadline timer is about to answer
        rep = self.app.registry.pick(exclude=self.tried)
        if rep is None:
            return False
        FLEET_RETRIES.inc(reason=reason)
        self.trace.note(retried=reason)
        self.dispatch(rep)
        return True

    # -- timers (loop thread) ------------------------------------------------

    @loop_only
    def on_deadline(self) -> None:
        if not self._claim():
            return
        self.app.finish(
            self, "timeout", 504,
            body=json.dumps({
                "error": f"timed out after {self.deadline_s:g}s "
                "(no replica answered in budget)",
            }).encode(),
        )

    @loop_only
    def on_hedge(self) -> None:
        """Hedge delay expired with no reply: fire a duplicate against a
        replica not yet tried (if one is in rotation). ``pick`` falls
        back to already-tried replicas when nothing else is ready —
        right for retries, wrong here: hedging a slow replica with a
        duplicate to ITSELF would double the load on the one struggling
        server, so an exhausted pool means no hedge. The hedge is an
        upstream attempt like any other and counts against
        ``max_attempts`` — with the cap already spent, firing one would
        exceed the operator's per-request attempt budget exactly when
        the fleet is slow."""
        if self.done or self.hedged:
            return
        if self.attempts >= self.app.max_attempts:
            return
        rep = self.app.registry.pick(exclude=self.tried)
        if rep is None or rep["id"] in self.tried:
            return
        self.hedged = True
        FLEET_HEDGES.inc()
        self.trace.note(hedged=True)
        self.dispatch(rep)

    # -- the upstream completion (loop thread) --------------------------------

    @loop_only
    def on_upstream(self, rep: dict, t0: float, att, result) -> None:
        """One attempt resolved: ``result`` is a ``protocol.
        HttpResponse`` or an ``UpstreamError``. The replica's load
        signals settle first (outstanding always; latency only when it
        actually answered), then the retry/hedge/deadline race."""
        rid = rep["id"]
        answered = not isinstance(result, Exception)
        self.app.registry.note_complete(
            rid, (time.monotonic() - t0) if answered else None
        )
        if att is not None:
            if att in self.pending:
                self.pending.remove(att)
            # One pooled ride per reused attempt; one fresh TCP connect
            # per non-reused start AND per transparent resend (a fresh
            # attempt that got resent opened TWO connections) — kept
            # equal to the pool's own opened/reused totals so /metrics
            # and /healthz tell one story.
            if att.reused:
                _CONN_EVENT["reused"].inc()
            opened = (0 if att.reused else 1) + (1 if att.resent else 0)
            if opened:
                _CONN_EVENT["opened"].inc(opened)
        if not answered:
            self._upstream_result(rep, "conn_error")
            self.app.registry.mark_failure(
                rid, f"{type(result).__name__}: {result}"
            )
            if self.done:
                return
            if not self.retry("conn_error", rep) and self._claim():
                self.app.finish(
                    self, "error", 503,
                    body=json.dumps({
                        "error": "no replica answered "
                        f"(last: {type(result).__name__})",
                    }).encode(),
                    headers={"Retry-After": "1"}, replica=rid,
                )
            return
        code, up_headers, data = result.code, result.headers, result.body
        if code == 200:
            self._upstream_result(rep, "ok")
            self.app.registry.mark_success(rid)
            won_hedge = self.hedged and rid != self.first_replica
            if not self._claim():
                return  # the other attempt (or the deadline) answered
            if won_hedge:
                FLEET_HEDGE_WINS.inc()
            self.app.finish(
                self, "ok", 200, body=data, upstream_headers=up_headers,
                replica=rid,
            )
            return
        if code == 503:
            self._upstream_result(rep, "shed")
            self.last_retry_after = up_headers.get("retry-after")
            # A shedding replica is HEALTHY (explicit admission control
            # or degraded mode) — not a breaker strike; the prober
            # rotates it out if /readyz agrees. Prefer another replica
            # right now.
            if self.done:
                return
            if self.retry("shed", rep):
                return
            if self._try_backoff_retry(rep):
                return
            if self._claim():
                self.app.finish(
                    self, "shed", 503, body=data,
                    upstream_headers=up_headers, replica=rid,
                )
            return
        if code >= 500:
            self._upstream_result(rep, "server_error")
            if code != 504:
                # A 504 is the replica's own deadline verdict on THIS
                # request — most of the budget is gone, and the miss says
                # nothing about the replica's health.
                self.app.registry.mark_failure(rid, f"http_{code}")
                if self.done:
                    return
                if self.retry("server_error", rep):
                    return
            if self._claim():
                self.app.finish(
                    self, "timeout" if code == 504 else "error", code,
                    body=data, upstream_headers=up_headers,
                    replica=rid,
                )
            return
        # 4xx: the client's fault travels back unchanged — a malformed
        # patient stays malformed on every replica; retrying would just
        # burn fleet capacity on garbage.
        self._upstream_result(rep, "client_error")
        if self._claim():
            self.app.finish(
                self, "bad_request", code, body=data,
                upstream_headers=up_headers, replica=rid,
            )

    @loop_only
    def _try_backoff_retry(self, rep: dict) -> bool:
        """Everything in rotation already shed this request: honor the
        upstream ``Retry-After`` (bounded by the remaining budget) and
        try once more — the router-side version of loadgen's patient
        client. False when the budget cannot cover the wait."""
        if self.attempts >= self.app.max_attempts:
            return False
        try:
            wait_s = float(self.last_retry_after or 0.0)
        except ValueError:
            wait_s = 0.0
        wait_s = max(0.05, wait_s)
        if time.monotonic() + wait_s >= self.deadline_mono - 0.05:
            return False
        self.attempts += 1
        FLEET_RETRIES.inc(reason="shed_backoff")

        def fire():
            if self.done:
                return
            target = self.app.registry.pick() or rep
            self._send(target)

        self.app.httpd.call_later(wait_s, fire)
        return True

    @staticmethod
    def _upstream_result(rep: dict, result: str) -> None:
        _UP_RESULT[result].inc()
        _replica_counter(rep["id"], result).inc()


class _RouterApp:
    """The application behind the router's event loop (see module
    docstring for the endpoint map)."""

    def __init__(self, handle: "RouterHandle", request_timeout_s: float,
                 hedge_s: float, max_attempts: int, quiet: bool) -> None:
        self.handle = handle
        self.registry = handle.registry
        self.recorder = handle.recorder
        self.request_timeout_s = float(request_timeout_s)
        self.hedge_s = float(hedge_s)
        self.max_attempts = int(max_attempts)
        self.quiet = quiet
        # Both bound by make_router after the listener exists.
        self.httpd = None
        self.upstream: UpstreamPool | None = None
        self._addrs: dict[str, tuple[str, int]] = {}
        # Monotonic: feeds /healthz uptime_seconds, which is duration
        # arithmetic (rule monotonic-clock).
        self.started_monotonic = time.monotonic()

    def replica_addr(self, url: str) -> tuple[str, int]:
        """Replica url → (host, port), cached — one urlparse per replica
        lifetime instead of one per attempt on the loop."""
        addr = self._addrs.get(url)
        if addr is None:
            u = urllib.parse.urlparse(url)
            addr = self._addrs[url] = (u.hostname or "127.0.0.1",
                                       u.port or 80)
        return addr

    # -- transport interface -------------------------------------------------

    @loop_only
    def handle_request(self, req, rsp) -> None:
        if not self.quiet:
            import sys

            print(f"router {req.method} {req.target}", file=sys.stderr)
        if req.method == "POST":
            if req.path == "/predict":
                self._predict(req, rsp)
            elif req.path == "/fleet/replicas":
                self._post_replicas(req, rsp)
            elif req.path == "/fleet/deploy":
                self._post_deploy(req, rsp)
            else:
                rsp.send_json(
                    404, {"error": f"no such path: {req.target}"},
                    close=True,
                )
        elif req.method == "GET":
            self._get(req, rsp)
        else:
            rsp.send_json(
                501, {"error": f"unsupported method {req.method}"},
                close=True,
            )

    @loop_only
    def handle_protocol_error(self, exc, rsp) -> None:
        rsp.send_json(exc.code, {"error": exc.message}, close=True)

    # -- data path -----------------------------------------------------------

    @loop_only
    def _predict(self, req, rsp) -> None:
        trace = reqtrace.RequestTrace(
            reqtrace.sanitize_request_id(req.get_header("x-request-id"))
        )
        trace.add_phase("parse", trace.t_start, time.perf_counter())
        deadline_s = self.request_timeout_s
        raw_deadline = req.get_header("x-request-deadline-ms")
        if raw_deadline:
            try:
                client_s = float(raw_deadline) / 1000.0
            except ValueError:
                client_s = 0.0
            if client_s > 0.0:
                deadline_s = min(deadline_s, client_s)
        pin = (req.get_header("x-serve-path") or "").strip().lower() or None
        job = _ProxyJob(self, trace, rsp, req.body, pin, deadline_s)
        job.start()

    @loop_only
    def finish(
        self, job: _ProxyJob, outcome: str, code: int, body: bytes,
        upstream_headers: dict[str, str] | None = None,
        headers: dict[str, str] | None = None,
        replica: str | None = None,
    ) -> None:
        """The single exit for a routed request: reply, stamp the trace
        (route = admission → first dispatch is folded into upstream
        here; the phases partition admission → reply), count, record."""
        trace = job.trace
        t_up_end = time.perf_counter()
        trace.add_phase("upstream", job.t_route0, t_up_end)
        out_headers = dict(headers or {})
        if upstream_headers:
            for name in _PASSTHROUGH_HEADERS:
                if name in upstream_headers:
                    out_headers[_canonical(name)] = upstream_headers[name]
            if "retry-after" in upstream_headers and code == 503:
                out_headers["Retry-After"] = upstream_headers["retry-after"]
        if replica is not None:
            out_headers.setdefault("X-Replica", replica)
            trace.note(replica=replica)
        trace.note(attempts=job.attempts)
        job.responder.send(
            code, body, "application/json",
            headers=out_headers, request_id=trace.request_id,
        )
        trace.add_phase("respond", t_up_end, time.perf_counter())
        trace.finish(
            "ok" if outcome == "ok" else outcome,
            error=None if outcome == "ok" else f"http_{code}",
        )
        _REQ_OUTCOME[outcome].inc()
        _LATENCY.observe(trace.total_s)
        if outcome != "bad_request":
            # Fleet-level SLO: burn accounted where clients experience
            # it. A malformed request is the client's fault — it spends
            # no server error budget (same exclusion the replica-side
            # tracker applies to non-admitted requests).
            self.handle.fleet_slo.observe(trace.total_s, outcome == "ok")
        self.recorder.record(trace)
        if self.handle.capture_feed is not None and outcome == "ok":
            # Continual-learning tap (learn.capture): every SERVED row
            # lands in the bounded recent-cohort window. Raw bytes, no
            # parse — validation happens once, at refit time. Queued to
            # the feed's writer thread: the loop never pays a shard
            # rotation's fsync, and capture latency is never client
            # latency.
            self.handle.capture_feed.append(job.body)

    # -- control plane --------------------------------------------------------

    @loop_only
    def _get(self, req, rsp) -> None:
        path = req.path
        if path == "/healthz":
            snap = self.registry.snapshot()
            ready = sum(1 for r in snap if r["in_rotation"])
            rsp.send_json(200, {
                "status": "ok" if ready else "no_ready_replicas",
                "role": "fleet-router",
                "replicas_total": len(snap),
                "replicas_ready": ready,
                "deploy": self.handle.deploy_status,
                # Continual-learning tap state (learn.capture), so `cli
                # learn status` can see the refit's data window from the
                # same probe it already polls. None when capture is off.
                "capture": (
                    self.handle.capture.stats()
                    if self.handle.capture is not None else None
                ),
                # The loop-owned upstream pool: connection reuse is the
                # data plane's health in one glance (opened ≈ replicas
                # means keep-alive held; opened ≈ requests means it
                # didn't).
                "upstream": (
                    self.upstream.stats()
                    if self.upstream is not None else None
                ),
                # Alerting plane summary (obs.alerts): rule counts and
                # the worst firing severity, so the probe every
                # supervisor already polls carries "is anything paging".
                # None when the alert engine is disabled.
                "alerts": (
                    self.handle.alerts.summary()
                    if self.handle.alerts is not None else None
                ),
                "uptime_seconds": round(
                    time.monotonic() - self.started_monotonic, 3
                ),
            })
        elif path == "/readyz":
            ready = self.registry.ready_count()
            rsp.send_json(
                200 if ready else 503,
                {
                    "ready": ready > 0,
                    "reasons": [] if ready else ["no ready replicas"],
                    "replicas_ready": ready,
                },
            )
        elif path == "/fleet/replicas":
            rsp.send_json(200, {"replicas": self.registry.snapshot()})
        elif path == "/fleet/deploy":
            rsp.send_json(200, {"deploy": self.handle.deploy_status})
        elif path == "/debug/requests":
            rid = req.query_param("id", "")
            if rid:
                snap = self.recorder.lookup(rid)
                if snap is None:
                    rsp.send_json(404, {
                        "error": f"request id not indexed: {rid}",
                    })
                else:
                    rsp.send_json(200, {"request": snap})
                return
            try:
                n = int(req.query_param("n", "64"))
            except ValueError:
                rsp.send_json(400, {"error": "n must be an integer"})
                return
            rsp.send_json(200, {
                "stats": self.recorder.stats(),
                "requests": self.recorder.snapshot(n),
            })
        elif path == "/fleet/alerts":
            # In-memory read — inline is fine (the engine state is a
            # handful of dicts under no I/O).
            if self.handle.alerts is None:
                rsp.send_json(200, {
                    "enabled": False, "active": [], "summary": None,
                })
                return
            snap = self.handle.alerts.snapshot()
            rsp.send_json(200, {
                "enabled": True,
                "active": snap["active"],
                "summary": self.handle.alerts.summary(),
                "rules": snap["rules"],
            })
        elif path == "/debug/history":
            store = self.handle.history
            if store is None:
                rsp.send_json(200, {"enabled": False, "families": {}})
                return
            family = req.query_param("family", "")
            if not family:
                rsp.send_json(200, {
                    "enabled": True,
                    "families": store.families(),
                    "stats": store.stats(),
                })
                return
            try:
                window = float(req.query_param("window", "0") or 0)
            except ValueError:
                rsp.send_json(400, {"error": "window must be a number"})
                return
            now = time.time()  # graftcheck: disable=monotonic-clock
            rsp.send_json(200, store.query(
                family, window if window > 0 else None, now,
            ))
        elif path == "/fleet/metrics":
            # The scrape blocks up to timeout_s per replica — on its own
            # short-lived thread (the /debug/profile pattern), never the
            # event loop that carries the data plane.
            threading.Thread(
                target=self._fleet_metrics,
                args=(req.query_param("format", "prometheus"), rsp),
                name="fleet-metrics-scrape", daemon=True,
            ).start()
        elif path == "/fleet/trace":
            try:
                n = int(req.query_param("n", "64"))
            except ValueError:
                rsp.send_json(400, {"error": "n must be an integer"})
                return
            # Same off-loop discipline: the join fetches one replica
            # trace per sampled request over blocking HTTP.
            threading.Thread(
                target=self._fleet_trace, args=(n, rsp),
                name="fleet-trace-join", daemon=True,
            ).start()
        elif path == "/metrics":
            if req.query_param("format", "prometheus") == "json":
                rsp.send_json(200, {
                    "runtime": REGISTRY.snapshot(),
                    "replicas": self.registry.snapshot(),
                })
            else:
                rsp.send(
                    200, REGISTRY.render_prometheus().encode(),
                    "text/plain; version=0.0.4",
                )
        else:
            rsp.send_json(404, {"error": f"no such path: {path}"})

    def _fleet_metrics(self, fmt: str, rsp) -> None:
        """Thread target for GET /fleet/metrics (off-loop; the Responder
        is thread-safe and exactly-once)."""
        try:
            text, summary = self.handle.scraper.render_fleet_page()
        except Exception as exc:
            rsp.send_json(500, {"error": f"fleet scrape failed: {exc}"})
            return
        if fmt == "json":
            rsp.send_json(200, {"summary": summary, "page": text})
        else:
            rsp.send(200, text.encode(), "text/plain; version=0.0.4")

    def _fleet_trace(self, n: int, rsp) -> None:
        """Thread target for GET /fleet/trace: join the router's last
        ``n`` tail-sampled traces with their replica-side phases into
        one Perfetto-loadable export (the response body IS the trace
        JSON — save it to a file and load it)."""
        try:
            samples = self.recorder.snapshot(n)
            urls = {
                r["id"]: r["url"] for r in self.registry.snapshot()
            }
            export = fleettrace.join_fleet_trace(
                samples, urls, self.handle.clock_sync,
            )
        except Exception as exc:
            rsp.send_json(500, {
                "error": f"fleet trace join failed: {exc}",
            })
            return
        rsp.send_json(200, export)

    @loop_only
    def _post_replicas(self, req, rsp) -> None:
        """Registration endpoint (``cli serve --register`` posts here):
        ``{"id", "url"}`` adds a replica, ``{"deregister": id}`` removes
        one, ``{"hold": id}`` / ``{"release": id}`` toggle the admin
        hold — the out-of-process face of ``registry.hold`` the
        lifecycle manager's drain-first retirement needs (an in-process
        deploy controller calls the registry directly). Probing begins
        on the next prober tick; rotation in follows the first ready
        probe — a registered-but-cold replica never receives traffic."""
        try:
            body = json.loads(req.body or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            if "deregister" in body:
                found = self.registry.deregister(str(body["deregister"]))
                rsp.send_json(200, {"deregistered": found})
                return
            if "hold" in body:
                rsp.send_json(200, {
                    "held": self.registry.hold(str(body["hold"])),
                })
                return
            if "release" in body:
                rsp.send_json(200, {
                    "released": self.registry.release(
                        str(body["release"])
                    ),
                })
                return
            rid, url = body.get("id"), body.get("url")
            if not rid or not url:
                raise ValueError(
                    'expected {"id": ..., "url": ...}, {"deregister": id}, '
                    '{"hold": id}, or {"release": id}'
                )
        except (ValueError, json.JSONDecodeError) as exc:
            rsp.send_json(400, {"error": str(exc)})
            return
        rsp.send_json(200, {"replica": self.registry.register(
            str(rid), str(url)
        )})

    @loop_only
    def _post_deploy(self, req, rsp) -> None:
        """Start a rolling deploy (``fleet.deploy.rolling_deploy``) over
        every registered replica; replies when the rollout is DONE.
        Single-flight — a rollout in progress answers 409."""
        try:
            body = json.loads(req.body or b"{}")
            model = body.get("model") if isinstance(body, dict) else None
            if not model or not isinstance(model, str):
                raise ValueError('expected {"model": "checkpoint path"}')
        except (ValueError, json.JSONDecodeError) as exc:
            rsp.send_json(400, {"error": str(exc)})
            return
        if not self.handle._deploy_lock.acquire(blocking=False):
            rsp.send_json(409, {
                "error": "a rolling deploy is already in progress",
                "deploy": self.handle.deploy_status,
            })
            return

        def run():
            from machine_learning_replications_tpu_torch.fleet.deploy import (
                rolling_deploy,
            )

            try:
                report = rolling_deploy(
                    self.registry, model,
                    status_cb=self.handle._set_deploy_status,
                )
            except Exception as exc:
                report = {
                    "result": "failed",
                    "error": f"{type(exc).__name__}: {exc}",
                }
                self.handle._set_deploy_status(report)
            finally:
                self.handle._deploy_lock.release()
            FLEET_DEPLOYS.inc(result=report.get("result", "failed"))
            rsp.send_json(
                200 if report.get("result") == "ok" else 500,
                {"deploy": report},
            )

        threading.Thread(
            target=run, name="fleet-deploy", daemon=True
        ).start()


def _canonical(lower_name: str) -> str:
    """lower-cased wire header name → canonical echo casing."""
    return {
        "x-replica": "X-Replica",
        "x-model-version": "X-Model-Version",
        "x-serve-path": "X-Serve-Path",
    }.get(lower_name, lower_name)


class RouterHandle:
    """A running front-door router: registry + prober + loop-owned
    upstream pool + event-loop HTTP listener."""

    def __init__(self, registry, prober, recorder,
                 httpd=None, capture=None, clock_sync=None,
                 scraper=None, fleet_slo=None) -> None:
        self.registry = registry
        self.prober = prober
        self.recorder = recorder
        self.httpd = httpd
        self.upstream: UpstreamPool | None = None
        # The fleet telemetry plane (obs.fleettrace / obs.fleetmetrics):
        # per-replica clock-offset estimator, /fleet/metrics scraper,
        # and the fleet-level SLO tracker fed from finish().
        self.clock_sync = clock_sync or fleettrace.ClockSync()
        self.scraper = scraper or fleetmetrics.FleetScraper(registry)
        self.fleet_slo = fleet_slo or fleetmetrics.fleet_slo_tracker()
        self.capture = capture  # learn.capture.CohortCapture or None
        self.capture_feed: _CaptureFeed | None = (
            _CaptureFeed(capture) if capture is not None else None
        )
        # The alerting plane (obs.timeseries / obs.alerts /
        # obs.incident): history ring store, its sampler thread, the
        # rule engine the sampler ticks, and the incident capturer
        # firings trigger. All optional; wired by make_router.
        self.history = None
        self.sampler = None
        self.alerts = None
        self.incidents = None
        self.deploy_status: dict | None = None
        self._deploy_lock = threading.Lock()
        self._thread: threading.Thread | None = None

    @cross_thread
    def _set_deploy_status(self, status: dict) -> None:
        self.deploy_status = status

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> "RouterHandle":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="fleet-router",
            daemon=True,
        )
        self._thread.start()
        return self

    @cross_thread
    def shutdown(self) -> None:
        if self.sampler is not None:
            self.sampler.close()
        self.prober.close()
        self.httpd.shutdown()
        self.httpd.server_close()  # teardown closes the upstream pool too
        if self.capture_feed is not None:
            self.capture_feed.close()
        if self.incidents is not None:
            self.incidents.close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def make_router(
    host: str = "127.0.0.1",
    port: int = 8080,
    replicas: list[tuple[str, str]] | None = None,
    request_timeout_s: float = 30.0,
    hedge_ms: float = 0.0,
    max_attempts: int = 3,
    probe_interval_s: float = 0.5,
    probe_timeout_s: float = 2.0,
    fail_threshold: int = 2,
    recover_probes: int = 2,
    breaker_failures: int = 3,
    trace_capacity: int = 256,
    tail_quantile: float = 0.99,
    idle_timeout_s: float = 5.0,
    max_connections: int = 8192,
    backlog: int = 1024,
    reuse_port: bool = False,
    quiet: bool = True,
    start_prober: bool = True,
    capture_dir: str | None = None,
    capture_rows_per_shard: int = 4096,
    capture_max_shards: int = 8,
    history_interval_s: float = 10.0,
    history_fleet_page: bool = True,
    alert_rules: list | None = None,
    alerts_enabled: bool = True,
    incident_dir: str | None = None,
    incident_min_interval_s: float = 60.0,
    incident_retention: int = 8,
) -> RouterHandle:
    """Assemble the front-door router and bind its listener (not yet
    serving — call ``serve_forever`` or ``start_background``).
    ``replicas`` seeds the registry with static ``(id, url)`` members;
    dynamic members register themselves over ``POST /fleet/replicas``
    (``cli serve --register``). ``hedge_ms`` > 0 enables tail hedging;
    ``max_attempts`` bounds retry fan-out per request. ``reuse_port``
    binds with ``SO_REUSEPORT`` for the multi-worker router
    (``cli fleet router --workers N``). ``start_prober`` exists for
    tests that drive ``prober.tick()`` by hand. ``capture_dir`` enables
    the continual-learning cohort tap (``learn.capture``): every served
    /predict body lands in a bounded rotating JSONL window there
    (~``capture_rows_per_shard`` × ``capture_max_shards`` recent rows)
    — the retrain's data source (docs/CONTINUAL.md).

    ``history_interval_s`` > 0 starts the telemetry history sampler
    (``obs.timeseries``): every tick snapshots the router's registry —
    and, with ``history_fleet_page``, the scraped+merged fleet page —
    into the bounded ring store behind ``GET /debug/history``.
    ``alerts_enabled`` evaluates ``alert_rules`` (Rule objects; None →
    ``obs.alerts.default_rules("router")``) on the same tick, served on
    ``GET /fleet/alerts``; ``incident_dir`` additionally captures a
    flight-recorder bundle when a rule fires (``obs.incident``,
    docs/OBSERVABILITY.md "Alerting & incidents")."""
    registry = ReplicaRegistry(
        fail_threshold=fail_threshold,
        recover_probes=recover_probes,
        breaker_failures=breaker_failures,
    )
    for rid, url in replicas or []:
        registry.register(rid, url)
    clock_sync = fleettrace.ClockSync()
    prober = HealthProber(
        registry, interval_s=probe_interval_s, timeout_s=probe_timeout_s,
        clock_sync=clock_sync,
    )
    recorder = reqtrace.FlightRecorder(
        capacity=trace_capacity, tail_quantile=tail_quantile
    )
    capture = None
    if capture_dir is not None:
        from machine_learning_replications_tpu_torch.learn.capture import (
            CohortCapture,
        )

        capture = CohortCapture(
            capture_dir,
            rows_per_shard=capture_rows_per_shard,
            max_shards=capture_max_shards,
        )
    handle = RouterHandle(
        registry, prober, recorder, capture=capture,
        clock_sync=clock_sync,
        scraper=fleetmetrics.FleetScraper(
            registry, timeout_s=probe_timeout_s,
        ),
    )
    # Stale-series hygiene: a deregistered (or replaced) replica's
    # per-replica gauge series retire with it instead of lingering at
    # their last value (docs/OBSERVABILITY.md "Fleet telemetry").
    registry.add_retire_listener(handle.scraper.forget)
    registry.add_retire_listener(clock_sync.forget)
    if history_interval_s > 0:
        handle.history = obs_timeseries.TimeSeriesStore(
            interval_s=history_interval_s,
        )
        if alerts_enabled:
            rules = (
                alert_rules if alert_rules is not None
                else obs_alerts.default_rules("router")
            )
            handle.alerts = obs_alerts.AlertEngine(rules, handle.history)
        if incident_dir is not None and handle.alerts is not None:
            handle.incidents = obs_incident.IncidentCapturer(
                incident_dir,
                store=handle.history,
                collectors={
                    "requests": lambda: recorder.snapshot(64),
                    "replicas": registry.snapshot,
                    "metrics": REGISTRY.snapshot,
                    "fleet_trace": lambda: fleettrace.join_fleet_trace(
                        recorder.snapshot(64),
                        {
                            r["id"]: r["url"]
                            for r in registry.snapshot()
                        },
                        clock_sync,
                    ),
                },
                min_interval_s=incident_min_interval_s,
                retention=incident_retention,
            )
    app = _RouterApp(
        handle, request_timeout_s,
        hedge_s=hedge_ms / 1000.0, max_attempts=max_attempts, quiet=quiet,
    )
    # Backlog 1024, not the replica-side 128: a replica keeps its
    # backlog small so bursts hit the batcher's explicit admission
    # decision (the r6 lesson), but the router IS the front door — a
    # thousand keep-alive clients connecting at once is its normal
    # startup, its admission control is the deadline/shed machinery
    # after accept, and a refused SYN costs the client a ~1 s
    # retransmit stall that reads as router latency.
    try:
        handle.httpd = EventLoopHttpServer(
            (host, port), app,
            idle_timeout_s=idle_timeout_s,
            max_connections=max_connections,
            backlog=backlog,
            reuse_port=reuse_port,
        )
    except BaseException:
        # A bind failure must not leak the already-started capture feed
        # thread and its open shard — a supervisor retrying startup on
        # a contended port would accumulate one orphan per attempt.
        if handle.capture_feed is not None:
            handle.capture_feed.close()
        raise
    app.httpd = handle.httpd
    # The upstream leg lives on the same loop as the listener: one
    # thread owns every socket end to end (module docstring).
    handle.upstream = app.upstream = UpstreamPool(
        handle.httpd, idle_timeout_s=idle_timeout_s,
    )
    journal.event(
        "fleet_router_started",
        address=list(handle.httpd.server_address[:2]),
        replicas=[rid for rid, _ in (replicas or [])],
    )
    if start_prober:
        prober.start()
    if handle.history is not None:
        scraper = handle.scraper
        engine, capturer = handle.alerts, handle.incidents

        def _collect() -> dict:
            fams = obs_timeseries.collect_registry()
            if history_fleet_page:
                # The merged fleet page rides the same tick: summed
                # counters and per-replica appended gauges become
                # history too, and the scrape's staleness marking runs
                # even when nobody polls /fleet/metrics — which is what
                # keeps the fleet_replica_stale rule honest.
                try:
                    pages, _summary = scraper.scrape()
                    merged, _rejected = fleetmetrics.merge_expositions(
                        pages,
                        drop=frozenset(
                            fam.name for fam in REGISTRY.families()
                        ),
                    )
                    fams.update(merged)
                except Exception:
                    pass  # absence IS the signal staleness rules watch
            return fams

        def _tick(now: float) -> None:
            if engine is None:
                return
            for transition in engine.evaluate(now):
                if capturer is not None:
                    capturer.maybe_capture(transition)

        handle.sampler = obs_timeseries.HistorySampler(
            handle.history, _collect,
            interval_s=history_interval_s, on_tick=_tick,
        ).start()
    return handle

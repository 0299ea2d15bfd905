"""Cross-process request tracing: the fleet's joined Perfetto timeline.

Per-process tracing (``obs.reqtrace``) answers "where did this request's
time go *inside this process*"; behind a router that is half the story —
the router's ``upstream`` phase is one opaque interval covering connect,
transit, the replica's whole server side, and the reply. This module
joins the two: for each router tail-sampled request it fetches the
serving replica's trace over the exact-lookup primitive
(``/debug/requests?id=`` — ``FlightRecorder.lookup``) and renders ONE
Chrome-trace timeline where the router's ``upstream`` span *contains*
the replica's server-side phases (parse / queue_wait / batch_assembly /
device_compute | host_compute / respond). "Where did the p99 go: router
queue, network, replica queue, or compute?" becomes a one-screen answer.

**Clock correction.** Router and replica both stamp ``time.perf_counter``
— monotonic clocks with *arbitrary, per-process epochs* (on Linux they
share CLOCK_MONOTONIC, but the contract does not promise it, and the
epochs diverge the moment a replica lives on another host). ``ClockSync``
estimates each replica's offset NTP-style from the probe the rotation
already pays for: the replica echoes its ``clock_perf`` on ``/readyz``,
the prober stamps send/receive, and

    offset = clock_perf_replica − (t_send + t_recv) / 2

maps replica time into router time with error bounded by half the probe
round-trip. Offsets are EWMA-smoothed (``EWMA_ALPHA``) so one delayed
probe cannot teleport a replica's spans, and published per replica on
``fleet_clock_offset_ms{replica=…}``.

**Containment.** A joined request's replica span must land inside its
router ``upstream`` span once offset-corrected — the margins are real
(connect + transit on each side) but can be smaller than the offset
estimate's error, so containment is asserted with ``CONTAINMENT_SLACK_S``
tolerance (docs/OBSERVABILITY.md "Fleet telemetry"). The export's
``otherData`` carries the joined/containment accounting, and every join
attempt lands on ``fleet_trace_joins_total{result=…}`` — a timeline that
silently dropped its misses would read as "everything joined".

Import-safe without jax (stdlib + the obs registry/journal), like the
rest of the fleet tier's dependencies — graftcheck's ``import-purity``
rule proves it transitively.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

from machine_learning_replications_tpu_torch.obs import journal, spans
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

FLEET_CLOCK_OFFSET = REGISTRY.gauge(
    "fleet_clock_offset_ms",
    "EWMA-smoothed replica perf-clock offset relative to this router "
    "(replica minus router, ms), estimated from /readyz probe echoes.",
    labels=("replica",),
)
FLEET_TRACE_JOINS = REGISTRY.counter(
    "fleet_trace_joins_total",
    "Cross-process trace join attempts by result (joined, "
    "no_replica_meta, unknown_replica, no_offset, no_replica_trace, "
    "fetch_error).",
    labels=("result",),
)
for _result in ("joined", "no_replica_meta", "unknown_replica",
                "no_offset", "no_replica_trace", "fetch_error"):
    FLEET_TRACE_JOINS.labels(result=_result)

#: Tolerance for the replica-inside-upstream containment verdict: the
#: offset estimate's error is bounded by half the probe round-trip,
#: which on a loaded loopback can exceed the sub-millisecond connect +
#: transit margins that separate the true intervals.
CONTAINMENT_SLACK_S = 0.001


class ClockSync:
    """Per-replica perf-clock offset estimator (module docstring).

    ``observe`` is called by the health prober once per probe tick per
    replica; ``offset_s`` is read by the join (and anyone mapping a
    replica-side ``perf_counter`` stamp into router time). Thread-safe:
    the prober thread writes, join threads read.
    """

    #: Same smoothing horizon as the registry's latency EWMA: ~the last
    #: 10 probes dominate, so a replica restart (new clock epoch) is
    #: re-learned within seconds while one delayed probe barely moves
    #: the estimate.
    EWMA_ALPHA = 0.2

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # replica id -> (ewma offset s, last rtt s, samples)
        self._state: dict[str, tuple[float, float, int]] = {}

    def observe(
        self, replica_id: str, t_send: float, t_recv: float,
        replica_clock: float,
    ) -> float:
        """One probe echo: fold ``replica_clock − midpoint`` into the
        replica's EWMA offset and return the smoothed value (seconds,
        replica minus router)."""
        raw = float(replica_clock) - (float(t_send) + float(t_recv)) / 2.0
        rtt = max(float(t_recv) - float(t_send), 0.0)
        with self._lock:
            prev = self._state.get(replica_id)
            if prev is None:
                offset = raw
                n = 1
            else:
                offset = prev[0] + self.EWMA_ALPHA * (raw - prev[0])
                n = prev[2] + 1
            self._state[replica_id] = (offset, rtt, n)
        FLEET_CLOCK_OFFSET.set(offset * 1000.0, replica=replica_id)
        return offset

    def forget(self, replica_id: str) -> None:
        """Drop a replica's estimate (it deregistered or was replaced —
        a successor process has a fresh clock epoch and must not inherit
        the old one's offset). The gauge series retires with it: a
        departed replica's last offset frozen on the exposition forever
        reads as a live fact."""
        with self._lock:
            self._state.pop(replica_id, None)
        FLEET_CLOCK_OFFSET.remove(replica=replica_id)

    def offset_s(self, replica_id: str) -> float | None:
        with self._lock:
            st = self._state.get(replica_id)
        return None if st is None else st[0]

    def snapshot(self) -> dict:
        """Per-replica ``{offset_ms, rtt_ms, samples}`` — the export's
        ``otherData.clock_offsets`` and the obs report's evidence that
        the correction was live, not assumed."""
        with self._lock:
            state = dict(self._state)
        return {
            rid: {
                "offset_ms": round(offset * 1000.0, 3),
                "rtt_ms": round(rtt * 1000.0, 3),
                "samples": n,
            }
            for rid, (offset, rtt, n) in sorted(state.items())
        }


def fetch_replica_trace(
    url: str, request_id: str, timeout_s: float = 1.0,
) -> tuple[dict | None, str]:
    """Exact-lookup fetch of one request's replica-side trace:
    ``(snapshot, "ok")``, ``(None, "no_replica_trace")`` on a clean 404
    (completed elsewhere or evicted), ``(None, "fetch_error")`` on
    anything else. Never raises — the join must degrade per-request,
    not abort on the first unreachable replica."""
    target = (
        url.rstrip("/") + "/debug/requests?id="
        + urllib.parse.quote(request_id, safe="")
    )
    try:
        with urllib.request.urlopen(target, timeout=timeout_s) as resp:
            body = json.loads(resp.read())
        snap = body.get("request") if isinstance(body, dict) else None
        if not isinstance(snap, dict):
            return None, "fetch_error"
        return snap, "ok"
    except urllib.error.HTTPError as exc:
        exc.read()
        return None, "no_replica_trace" if exc.code == 404 else "fetch_error"
    except Exception:
        return None, "fetch_error"


def _abs_phases(snap: dict) -> dict[str, tuple[float, float]]:
    """A trace snapshot's phases as absolute perf-clock intervals (its
    own process's clock) off the ``t_start_perf`` anchor."""
    t0 = snap.get("t_start_perf")
    phases = snap.get("phases")
    if t0 is None or not isinstance(phases, dict):
        return {}
    out = {}
    for name, ph in phases.items():
        start = float(t0) + float(ph.get("offset_seconds", 0.0))
        out[name] = (start, start + float(ph.get("seconds", 0.0)))
    return out


def join_fleet_trace(
    router_samples: list[dict],
    replica_urls: dict[str, str],
    clock: ClockSync,
    timeout_s: float = 1.0,
    fetch=fetch_replica_trace,
) -> dict:
    """Join the router's tail samples with their replica-side traces and
    render one Perfetto-loadable Chrome-trace object.

    ``router_samples`` are ``FlightRecorder.snapshot()`` dicts from the
    ROUTER's recorder (each carries ``replica`` / ``attempts`` meta and
    the ``t_start_perf`` anchor); ``replica_urls`` maps replica id →
    base url (``ReplicaRegistry.urls()``). Replica fetches are
    sequential, each bounded by ``timeout_s`` — callers run the whole
    join off the event loop (the ``/debug/profile`` pattern).
    ``fetch`` is injectable for tests.

    All timestamps render on the ROUTER's perf clock; replica intervals
    map through the replica's ``ClockSync`` offset. Every event rides
    one virtual lane per request (``tid``), so the positional-containment
    rule the trace viewers nest by puts the replica's phases inside the
    router's ``upstream`` span — when the offsets are right. The export
    never clamps a misplaced replica span into its parent: containment
    is *measured* (``otherData.containment``), not decorated.
    """
    events: list[dict] = []
    per_request: list[dict] = []
    results = {r: 0 for r in (
        "joined", "no_replica_meta", "unknown_replica", "no_offset",
        "no_replica_trace", "fetch_error",
    )}
    n_contained = 0
    worst_excess_s = 0.0
    anchors = [
        s["t_start_perf"] for s in router_samples
        if s.get("t_start_perf") is not None
    ]
    base = min(anchors) if anchors else 0.0

    def us(t_perf: float) -> float:
        return round((t_perf - base) * 1e6, 3)

    def emit(name, t0, t1, tid, cat, args) -> None:
        events.append({
            "name": name, "ph": "X", "cat": cat, "pid": 1, "tid": tid,
            "ts": us(t0), "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
            "args": args,
        })

    meta_events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1,
        "args": {"name": "fleet-router (joined timeline)"},
    }]
    for lane, sample in enumerate(router_samples, start=1):
        rid = sample.get("request_id", "")
        anchor = sample.get("t_start_perf")
        if anchor is None:
            continue  # a pre-anchor snapshot cannot be placed at all
        replica = sample.get("replica")
        total = float(sample.get("total_seconds") or 0.0)
        meta_events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": lane,
            "args": {"name": f"req {rid} via {replica or '?'}"},
        })
        emit(
            f"request {rid}", anchor, anchor + total, lane, "router",
            {
                "request_id": rid, "status": sample.get("status"),
                "replica": replica, "attempts": sample.get("attempts"),
                "sampled_reason": sample.get("sampled_reason"),
            },
        )
        router_phases = _abs_phases(sample)
        for name, (t0, t1) in router_phases.items():
            emit(name, t0, t1, lane, "router", {"request_id": rid})

        if not replica:
            result = "no_replica_meta"
        elif replica not in replica_urls:
            result = "unknown_replica"
        else:
            offset = clock.offset_s(replica)
            if offset is None:
                result = "no_offset"
            else:
                snap, fetched = fetch(
                    replica_urls[replica], rid, timeout_s=timeout_s
                )
                if snap is None:
                    result = fetched
                else:
                    result = "joined"
        req_summary = {"request_id": rid, "replica": replica,
                       "result": result}
        if result == "joined":
            r_anchor = snap.get("t_start_perf")
            r_total = float(snap.get("total_seconds") or 0.0)
            if r_anchor is None:
                result = req_summary["result"] = "no_replica_trace"
            else:
                r0 = float(r_anchor) - offset
                r1 = r0 + r_total
                emit(
                    f"replica {replica}", r0, r1, lane, "replica",
                    {
                        "request_id": rid, "replica": replica,
                        "status": snap.get("status"),
                        "serve_path": snap.get("path"),
                        "offset_ms": round(offset * 1000.0, 3),
                    },
                )
                for name, (t0, t1) in _abs_phases(snap).items():
                    emit(
                        name, t0 - offset, t1 - offset, lane, "replica",
                        {"request_id": rid},
                    )
                upstream = router_phases.get("upstream")
                if upstream is not None:
                    excess = max(
                        upstream[0] - r0, r1 - upstream[1], 0.0
                    )
                    contained = excess <= CONTAINMENT_SLACK_S
                    n_contained += contained
                    worst_excess_s = max(worst_excess_s, excess)
                    req_summary["contained"] = contained
                    req_summary["containment_excess_ms"] = round(
                        excess * 1000.0, 3
                    )
        results[result] += 1
        FLEET_TRACE_JOINS.inc(result=result)
        per_request.append(req_summary)

    n = len(per_request)
    joined = results["joined"]
    containment_ratio = (n_contained / joined) if joined else None
    journal.event(
        "fleet_trace_export", requests=n, joined=joined,
        containment_ratio=containment_ratio,
    )
    return {
        "traceEvents": meta_events + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "kind": "fleet_trace",
            "requests": n,
            "results": results,
            "joined": joined,
            "containment": {
                "contained": n_contained,
                "ratio": (
                    None if containment_ratio is None
                    else round(containment_ratio, 4)
                ),
                "slack_ms": CONTAINMENT_SLACK_S * 1000.0,
                "worst_excess_ms": round(worst_excess_s * 1000.0, 3),
            },
            "clock_offsets": clock.snapshot(),
            "requests_detail": per_request,
        },
    }


def write_fleet_trace(path: str, export: dict) -> str:
    """Atomically write a joined-timeline export (Perfetto-loadable)."""
    return spans.write_trace(path, export)

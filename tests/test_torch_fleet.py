"""The port's fleet tier (``fleet/``, ``obs/fleet{metrics,trace}``) held to
the JAX package's behaviour tests, and the port's replicas behind it.

The fleet modules are verbatim copies of the JAX package's
(``tests/test_torch_serve_copies.py``), so the JAX suite's behaviour tests
(``tests/test_fleet.py``, ``test_router_dataplane.py``,
``test_autoscale.py``, ``test_fleetobs.py``) run here on the port's copies,
unchanged but for the package name: registry rotation, router retry,
hedging, shedding and deadlines over stub replicas on the real transport,
the rolling deploy's capacity gate, the autoscaler's policy and the
lifecycle manager's arcs on fake clocks and processes, and the fleet
telemetry plane. Left out: the tests that drive the JAX repo's ``tools/``
scripts (``loadgen.py``, ``obs_report.py``).

Rewritten on the port's own parts (the last section): versioned port
checkpoints (``integrity.json``'s version read alike by
``fleet.deploy.manifest_version`` and ``checkpoint.checkpoint_version``),
the replica-side warm swap and a rolling deploy v1 → v2 over two
in-process ``make_server(device="cpu")`` replicas with zero failed or wrong
replies, and the few subprocess tests of ``cli serve --workers 2`` and
``--register``.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import machine_learning_replications_tpu_torch.fleet.lifecycle as lifecycle
from machine_learning_replications_tpu_torch import cli
from machine_learning_replications_tpu_torch.fleet import (
    ReplicaRegistry,
    make_router,
    probe_replica,
    rolling_deploy,
)
from machine_learning_replications_tpu_torch.fleet.autoscale import (
    AUTOSCALE_DECISIONS,
    AutoscaleDaemon,
    AutoscalePolicy,
    AutoscaleThresholds,
)
from machine_learning_replications_tpu_torch.fleet.deploy import manifest_version
from machine_learning_replications_tpu_torch.fleet.lifecycle import (
    LIFECYCLE_TRANSITIONS,
    LifecycleManager,
    ReplicaSpec,
)
from machine_learning_replications_tpu_torch.fleet.registry import FLEET_ROTATIONS
from machine_learning_replications_tpu_torch.fleet.router import (
    FLEET_HEDGE_WINS,
    FLEET_HEDGES,
    FLEET_RETRIES,
    FLEET_UPSTREAM_CONNS,
)
from machine_learning_replications_tpu_torch.obs import fleetmetrics, fleettrace, journal
from machine_learning_replications_tpu_torch.obs.reqtrace import FlightRecorder, RequestTrace
from machine_learning_replications_tpu_torch.resilience import faults
from machine_learning_replications_tpu_torch.serve import protocol
from machine_learning_replications_tpu_torch.serve.transport import (
    EventLoopHttpServer,
    UpstreamError,
    UpstreamPool,
    UpstreamTimeout,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "machine_learning_replications_tpu_torch" / "persist" / "testdata" / \
    "stacking_small.pkl"
sys.path.insert(0, str(REPO / "tools"))
try:
    from validate_metrics import validate
finally:
    sys.path.pop(0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ===========================================================================
# from tests/test_fleet.py
# ===========================================================================


# ---------------------------------------------------------------------------
# stub replicas: the fleet tier is torch-free, so router mechanics are
# tested against programmable HTTP stubs on the real transport
# ---------------------------------------------------------------------------


class _StubReplica:
    """A programmable replica: flip ``ready``/``mode``/``version`` to
    drive the router through its branches. ``mode``: ok | shed | error
    | stall."""

    def __init__(self, rid: str, version: int = 1) -> None:
        self.rid = rid
        self.version = version
        self.ready = True
        self.mode = "ok"
        self.stall_s = 2.0
        self.served = 0
        self.deadline_headers: list[str | None] = []
        # /admin/deploy behavior (the batched-rollout test): hold the
        # "warm swap" for deploy_s, then serve deploy_to.
        self.deploy_s = 0.0
        self.deploy_to = 2

    def handle_request(self, req, rsp) -> None:
        if req.path == "/readyz":
            rsp.send_json(
                200 if self.ready else 503,
                {"ready": self.ready, "reasons": [],
                 "replica": self.rid, "version": self.version},
            )
            return
        if req.path == "/admin/deploy":
            if self.deploy_s:
                time.sleep(self.deploy_s)
            self.version = self.deploy_to
            rsp.send_json(200, {"deploy": {
                "version": self.version, "rolled_back": False,
                "seconds": self.deploy_s,
            }})
            return
        if req.path != "/predict":
            rsp.send_json(404, {"error": "nope"})
            return
        self.deadline_headers.append(
            req.get_header("x-request-deadline-ms")
        )
        if self.mode == "shed":
            rsp.send_json(
                503, {"error": "overloaded"},
                headers={"Retry-After": "1"},
            )
            return
        if self.mode == "error":
            rsp.send_json(500, {"error": "boom"})
            return
        if self.mode == "stall":
            time.sleep(self.stall_s)
        self.served += 1
        rsp.send_json(
            200, {"probability": 0.25, "text": "x"},
            headers={
                "X-Replica": self.rid,
                "X-Model-Version": str(self.version),
                "X-Serve-Path": "host",
            },
            request_id=req.get_header("x-request-id"),
        )

    def handle_protocol_error(self, exc, rsp) -> None:
        rsp.send_json(exc.code, {"error": exc.message}, close=True)


def _start_stub(app):
    httpd = EventLoopHttpServer(("127.0.0.1", 0), app)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stub_fleet(n=2, **router_kw):
    """n stub replicas behind a live router; returns
    (router, stubs, stub_httpds, base_url)."""
    stubs, httpds, members = [], [], []
    for i in range(n):
        stub = _StubReplica(f"r{i + 1}")
        httpd, url = _start_stub(stub)
        stubs.append(stub)
        httpds.append(httpd)
        members.append((stub.rid, url))
    kw = dict(
        port=0, replicas=members, probe_interval_s=0.1,
        request_timeout_s=5.0,
    )
    kw.update(router_kw)
    router = make_router(**kw).start_background()
    deadline = time.monotonic() + 10
    while router.registry.ready_count() < n and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert router.registry.ready_count() == n, router.registry.snapshot()
    return router, stubs, httpds, f"http://{router.address[0]}:{router.address[1]}"


def _teardown(router, httpds):
    router.shutdown()
    for h in httpds:
        h.server_close()


def _post_predict(base, timeout=10.0, **headers):
    req = urllib.request.Request(
        base + "/predict", data=b'{"x": 1}',
        headers={"Content-Type": "application/json", **headers},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


# ---------------------------------------------------------------------------
# registry state machine (pure — no sockets)
# ---------------------------------------------------------------------------


def test_registry_probe_rotation_state_machine():
    reg = ReplicaRegistry(fail_threshold=2, recover_probes=2)
    reg.register("a", "http://x:1")
    assert reg.get("a")["state"] == "probing"
    assert reg.pick() is None  # never-probed replicas get no traffic
    # First ready probe rotates in.
    reg.observe_probe("a", ok=True, ready=True, version=3)
    rep = reg.get("a")
    assert rep["state"] == "ready" and rep["in_rotation"]
    assert rep["version"] == 3
    # One dropped probe is NOT enough to rotate out...
    reg.observe_probe("a", ok=False, ready=False)
    assert reg.get("a")["in_rotation"]
    # ...fail_threshold consecutive ones are.
    reg.observe_probe("a", ok=False, ready=False)
    assert reg.get("a")["state"] == "out"
    # Recovery needs recover_probes CONSECUTIVE ready probes.
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["state"] == "out"
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["in_rotation"]
    # An explicit not-ready (the replica said so) rotates out on the
    # FIRST probe.
    reg.observe_probe("a", ok=True, ready=False)
    assert reg.get("a")["state"] == "out"


def test_registry_breaker_and_admin_hold():
    reg = ReplicaRegistry(breaker_failures=2, recover_probes=1)
    reg.register("a", "http://x:1")
    reg.observe_probe("a", ok=True, ready=True)
    reg.mark_failure("a", "conn reset")
    assert reg.get("a")["in_rotation"]  # one strike is not an outage
    reg.mark_success("a")
    reg.mark_failure("a", "conn reset")
    assert reg.get("a")["in_rotation"]  # success reset the streak
    reg.mark_failure("a", "conn reset")
    reg.mark_failure("a", "conn reset")
    assert reg.get("a")["state"] == "out"  # breaker open
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["in_rotation"]
    # Admin hold is orthogonal to probe state.
    assert reg.hold("a")
    assert not reg.get("a")["in_rotation"]
    assert reg.get("a")["state"] == "ready"  # probes unaffected
    assert reg.pick() is None
    assert reg.release("a")
    assert reg.get("a")["in_rotation"]


def test_registry_breaker_recovery_honors_hysteresis():
    # probe_oks accumulated while READY must not count toward the
    # post-outage recovery gate: a breaker-opened replica re-enters only
    # after recover_probes CONSECUTIVE ready probes from the transition.
    reg = ReplicaRegistry(recover_probes=3, breaker_failures=2)
    reg.register("a", "http://x:1")
    for _ in range(5):
        reg.observe_probe("a", ok=True, ready=True)
    reg.mark_failure("a", "conn reset")
    reg.mark_failure("a", "conn reset")
    assert reg.get("a")["state"] == "out"  # breaker open
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["state"] == "out"  # 1 of 3
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["state"] == "out"  # 2 of 3
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["in_rotation"]


def test_registry_replacement_accounts_rotation_out():
    # Re-registering an id with a NEW url (respawn on another port)
    # replaces an in-rotation replica with a PROBING one — capacity
    # left rotation, so the books must say so like deregister's do.
    reg = ReplicaRegistry()
    reg.register("a", "http://x:1")
    reg.observe_probe("a", ok=True, ready=True)
    out0 = FLEET_ROTATIONS.labels(direction="out").value
    reg.register("a", "http://x:2")
    assert reg.get("a")["state"] == "probing"
    assert reg.get("a")["url"] == "http://x:2"
    assert FLEET_ROTATIONS.labels(direction="out").value == out0 + 1


def test_registry_pick_spreads_cold_fleet_and_exclude():
    # With no load signal yet, power-of-two-choices ties break to the
    # least recently picked of each sampled pair, so a cold fleet still
    # spreads traffic across every replica.
    reg = ReplicaRegistry()
    for rid in ("a", "b", "c"):
        reg.register(rid, f"http://{rid}:1")
        reg.observe_probe(rid, ok=True, ready=True)
    picks = [reg.pick()["id"] for _ in range(64)]
    assert sorted(set(picks)) == ["a", "b", "c"]
    counts = {rid: picks.count(rid) for rid in ("a", "b", "c")}
    assert all(n >= 8 for n in counts.values()), counts
    # exclude prefers untried replicas...
    assert reg.pick(exclude={"a", "b"})["id"] == "c"
    # ...but falls back to a tried one rather than failing the request.
    assert reg.pick(exclude={"a", "b", "c"}) is not None
    # Re-registration with the same url is idempotent (keeps state).
    reg.register("a", "http://a:1")
    assert reg.get("a")["state"] == "ready"
    # Deregistration removes from rotation.
    assert reg.deregister("b")
    assert all(reg.pick()["id"] != "b" for _ in range(6))


# ---------------------------------------------------------------------------
# router data path over stub replicas
# ---------------------------------------------------------------------------


def test_router_least_loaded_rotation_and_identity_passthrough():
    # Least-loaded picking must still EXPLORE: an unsampled replica is
    # preferred until it has a latency measurement, so both replicas see
    # traffic even from a strictly sequential client (a concentration on
    # the faster replica afterwards is the new contract, not a bug —
    # the load-spreading behavior under concurrency is asserted in
    # test_registry_least_loaded_*).
    router, stubs, httpds, base = _stub_fleet(2)
    try:
        stubs[1].version = 2
        seen = set()
        for _ in range(8):
            code, headers, body = _post_predict(base)
            assert code == 200 and body["probability"] == 0.25
            seen.add((headers["X-Replica"], headers["X-Model-Version"]))
            assert headers["X-Serve-Path"] == "host"
            assert "X-Request-Id" in headers
        assert seen == {("r1", "1"), ("r2", "2")}
        assert stubs[0].served >= 1 and stubs[1].served >= 1
        # The remaining deadline rode down to the replicas.
        raw = [h for s in stubs for h in s.deadline_headers if h]
        assert raw and all(0 < float(h) <= 5000 for h in raw)
    finally:
        _teardown(router, httpds)


def test_router_retries_dead_replica_and_breaker_rotates_out():
    router, stubs, httpds, base = _stub_fleet(2)
    retries0 = FLEET_RETRIES.labels(reason="conn_error").value
    try:
        httpds[0].server_close()  # r1 dies
        for _ in range(6):
            code, headers, _ = _post_predict(base)
            assert code == 200
            assert headers["X-Replica"] == "r2"
        assert FLEET_RETRIES.labels(reason="conn_error").value > retries0
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if (router.registry.get("r1") or {}).get("state") == "out":
                break
            time.sleep(0.05)
        assert router.registry.get("r1")["state"] == "out"
    finally:
        _teardown(router, httpds[1:])


def test_router_shed_retries_elsewhere_then_passes_through():
    router, stubs, httpds, base = _stub_fleet(2)
    try:
        # One shedding replica: the other absorbs every request.
        stubs[0].mode = "shed"
        for _ in range(6):
            code, headers, _ = _post_predict(base)
            assert code == 200 and headers["X-Replica"] == "r2"
        # Whole fleet shedding: the 503 + Retry-After passes through
        # (the router cannot conjure capacity).
        stubs[1].mode = "shed"
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post_predict(base, timeout=8.0)
        assert exc_info.value.code == 503
        assert exc_info.value.headers.get("Retry-After")
        exc_info.value.read()
    finally:
        _teardown(router, httpds)


def test_router_deadline_504_never_hangs():
    router, stubs, httpds, base = _stub_fleet(
        1, request_timeout_s=0.5, hedge_ms=0.0, fail_threshold=50,
    )
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 3.0
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post_predict(base, timeout=8.0)
        dt = time.monotonic() - t0
        assert exc_info.value.code == 504
        exc_info.value.read()
        # Bounded by the router deadline, not the replica's stall.
        assert dt < 2.5, dt
    finally:
        _teardown(router, httpds)


def test_router_client_deadline_header_tightens():
    router, stubs, httpds, base = _stub_fleet(
        1, request_timeout_s=30.0, hedge_ms=0.0, fail_threshold=50,
    )
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 3.0
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post_predict(
                base, timeout=8.0, **{"X-Request-Deadline-Ms": "400"}
            )
        assert exc_info.value.code == 504
        exc_info.value.read()
        assert time.monotonic() - t0 < 2.5
    finally:
        _teardown(router, httpds)


def test_router_hedges_around_a_stalled_replica():
    router, stubs, httpds, base = _stub_fleet(
        2, hedge_ms=100.0, request_timeout_s=8.0, fail_threshold=50,
    )
    hedges0 = FLEET_HEDGES.get().value
    wins0 = FLEET_HEDGE_WINS.get().value
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 1.5
        # Two sequential requests: round-robin lands one of them on the
        # stalled replica, whose hedge fires to the fast one.
        for _ in range(2):
            t0 = time.monotonic()
            code, headers, _ = _post_predict(base)
            assert code == 200
            assert time.monotonic() - t0 < 1.2  # never the full stall
        assert FLEET_HEDGES.get().value > hedges0
        assert FLEET_HEDGE_WINS.get().value > wins0
    finally:
        _teardown(router, httpds)


def test_router_never_hedges_to_the_replica_already_tried():
    # One in-rotation replica, stalled: pick(exclude) falls back to the
    # already-tried replica, and hedging it with a duplicate to ITSELF
    # would double the load on the one struggling server — no hedge.
    router, stubs, httpds, base = _stub_fleet(
        1, hedge_ms=50.0, request_timeout_s=8.0, fail_threshold=50,
    )
    hedges0 = FLEET_HEDGES.get().value
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 1.0
        code, headers, _ = _post_predict(base)
        assert code == 200 and headers["X-Replica"] == "r1"
        assert stubs[0].served == 1  # no duplicate arrived
        assert FLEET_HEDGES.get().value == hedges0
    finally:
        _teardown(router, httpds)


def test_router_hedge_counts_against_max_attempts():
    # --max-attempts is the per-request upstream budget, hedges
    # included: with the cap already spent, the hedge timer must not
    # fire a second attempt.
    router, stubs, httpds, base = _stub_fleet(
        2, hedge_ms=50.0, request_timeout_s=8.0, fail_threshold=50,
        max_attempts=1,
    )
    hedges0 = FLEET_HEDGES.get().value
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 1.0
        # Round-robin lands one of these on the stalled replica, whose
        # hedge timer expires — and must stay silent.
        for _ in range(2):
            code, _, _ = _post_predict(base)
            assert code == 200
        assert FLEET_HEDGES.get().value == hedges0
    finally:
        _teardown(router, httpds)


def test_fleet_deploy_cli_409_is_a_refusal_not_success(monkeypatch):
    # The 409 body carries the OTHER rollout's live status (result "ok"
    # from its first publish) — the CLI must refuse, not print success
    # for a deploy that never started.
    import io

    from machine_learning_replications_tpu_torch.cli import _run_fleet_deploy

    def fake_urlopen(req, timeout=None):
        raise urllib.error.HTTPError(
            req.full_url, 409, "conflict", {},
            io.BytesIO(json.dumps({
                "error": "a rolling deploy is already in progress",
                "deploy": {"result": "ok", "state": "warming"},
            }).encode()),
        )

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    import argparse

    args = argparse.Namespace(router="http://r", model="/m", timeout=5)
    with pytest.raises(SystemExit) as exc_info:
        _run_fleet_deploy(args)
    assert "already in progress" in str(exc_info.value)


def test_router_no_ready_replicas_is_an_explicit_503():
    router = make_router(port=0, probe_interval_s=0.1).start_background()
    base = f"http://{router.address[0]}:{router.address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post_predict(base)
        assert exc_info.value.code == 503
        assert exc_info.value.headers.get("Retry-After") == "1"
        exc_info.value.read()
        # /readyz says why.
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(base + "/readyz", timeout=5)
        assert exc_info.value.code == 503
        body = json.loads(exc_info.value.read())
        assert body["reasons"] == ["no ready replicas"]
    finally:
        router.shutdown()


def test_router_4xx_passes_through_without_retry():
    router, stubs, httpds, base = _stub_fleet(2)
    try:
        # The stub 404s any non-predict path; a predict-level 4xx needs
        # a custom mode — reuse "error"→500 for retry and check 400 via
        # a direct stub tweak.
        stubs[0].mode = stubs[1].mode = "bad"

        def handle(req, rsp, _orig=_StubReplica.handle_request):
            rsp.send_json(400, {"error": "bad patient"})

        served0 = stubs[0].served + stubs[1].served
        stubs[0].handle_request = handle
        stubs[1].handle_request = handle
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post_predict(base)
        assert exc_info.value.code == 400
        exc_info.value.read()
        assert stubs[0].served + stubs[1].served == served0
    finally:
        _teardown(router, httpds)


def test_router_http_registration_and_deregistration():
    router = make_router(port=0, probe_interval_s=0.1).start_background()
    base = f"http://{router.address[0]}:{router.address[1]}"
    stub = _StubReplica("dyn")
    httpd, url = _start_stub(stub)
    try:
        req = urllib.request.Request(
            base + "/fleet/replicas",
            data=json.dumps({"id": "dyn", "url": url}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert json.loads(resp.read())["replica"]["id"] == "dyn"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                router.registry.ready_count() < 1:
            time.sleep(0.02)
        code, headers, _ = _post_predict(base)
        assert code == 200 and headers["X-Replica"] == "dyn"
        req = urllib.request.Request(
            base + "/fleet/replicas",
            data=json.dumps({"deregister": "dyn"}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert json.loads(resp.read())["deregistered"]
        assert router.registry.ready_count() == 0
    finally:
        router.shutdown()
        httpd.server_close()


def test_router_metrics_strict_and_debug_requests():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from validate_metrics import validate

    router, stubs, httpds, base = _stub_fleet(2)
    try:
        for _ in range(4):
            _post_predict(base)
        with urllib.request.urlopen(base + "/metrics", timeout=5) as resp:
            page = resp.read().decode()
        assert not validate(page), validate(page)[:5]
        for family in ("fleet_requests_total", "fleet_replicas",
                       "fleet_request_latency_seconds",
                       "fleet_probe_total"):
            assert family in page
        with urllib.request.urlopen(
            base + "/debug/requests", timeout=5
        ) as resp:
            dbg = json.loads(resp.read())
        assert dbg["stats"]["kept_total"] >= 1
        trace = dbg["requests"][0]
        assert "upstream" in trace["phases"]
        assert trace["replica"] in ("r1", "r2")
    finally:
        _teardown(router, httpds)


def test_probe_replica_verdicts():
    stub = _StubReplica("p", version=7)
    httpd, url = _start_stub(stub)
    try:
        v = probe_replica(url)
        # NTP-style clock sampling (obs.fleettrace): the prober stamps
        # t_send/t_recv around the probe; clock_perf is None unless the
        # replica echoes its perf_counter on /readyz (the stub doesn't).
        assert v["t_send"] <= v["t_recv"]
        assert v["clock_perf"] is None
        assert {k: v[k] for k in ("ok", "ready", "version", "queue_depth")} \
            == {"ok": True, "ready": True, "version": 7, "queue_depth": None}
        stub.ready = False
        v = probe_replica(url)
        assert v["ok"] and not v["ready"]
    finally:
        httpd.server_close()
    v = probe_replica(url)  # dead server
    assert not v["ok"] and not v["ready"]


def test_rolling_deploy_batched_holds_respect_capacity_gate():
    """A 4-replica rollout with concurrency 3 —
    warm swaps overlap (observed ≥ 2 concurrent holds) and the number
    of in-rotation replicas never drops below the gate, sampled
    continuously through the rollout."""
    router, stubs, httpds, base = _stub_fleet(4, probe_interval_s=0.05)
    try:
        for s in stubs:
            s.deploy_s = 0.4
            s.deploy_to = 2
        floor_violations: list = []
        max_held = [0]
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                snap = router.registry.snapshot()
                in_rot = sum(1 for r in snap if r["in_rotation"])
                held = sum(1 for r in snap if r["held"])
                max_held[0] = max(max_held[0], held)
                if in_rot < 1:
                    floor_violations.append(snap)
                time.sleep(0.01)

        sampler_thread = threading.Thread(target=sampler, daemon=True)
        sampler_thread.start()
        report = rolling_deploy(
            router.registry, "/nonexistent-ckpt", concurrency=3,
            admin_timeout_s=30.0, ready_timeout_s=30.0,
        )
        stop.set()
        sampler_thread.join(timeout=5)
        assert report["result"] == "ok", report
        assert report["target_version"] == 2
        assert report["concurrency"] == 3
        assert [s["achieved_version"] for s in report["replicas"]] == \
            [2, 2, 2, 2]
        assert not floor_violations, floor_violations[0]
        # The point of batching: the 0.4 s warm swaps really overlapped.
        assert max_held[0] >= 2, max_held
        snap = router.registry.snapshot()
        assert all(r["version"] == 2 and r["in_rotation"] for r in snap)
    finally:
        _teardown(router, httpds)


def test_rolling_deploy_serial_default_unchanged():
    # concurrency=1 keeps the one-at-a-time contract byte-for-byte.
    router, stubs, httpds, base = _stub_fleet(2, probe_interval_s=0.05)
    try:
        for s in stubs:
            s.deploy_to = 2
        report = rolling_deploy(
            router.registry, "/nonexistent-ckpt",
            admin_timeout_s=30.0, ready_timeout_s=30.0,
        )
        assert report["result"] == "ok"
        assert [s["achieved_version"] for s in report["replicas"]] == [2, 2]
    finally:
        _teardown(router, httpds)


def test_router_hold_release_http_ops():
    """The lifecycle manager's drain-first door: {"hold": id} removes a
    replica from routing over HTTP, {"release": id} puts it back."""
    router, stubs, httpds, base = _stub_fleet(2)
    try:
        def post(body):
            req = urllib.request.Request(
                base + "/fleet/replicas", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=5) as resp:
                return json.loads(resp.read())

        assert post({"hold": "r1"})["held"] is True
        assert not router.registry.get("r1")["in_rotation"]
        for _ in range(6):
            code, headers, _ = _post_predict(base)
            assert code == 200 and headers["X-Replica"] == "r2"
        assert post({"hold": "r1"})["held"] is False  # already held
        assert post({"release": "r1"})["released"] is True
        assert router.registry.get("r1")["in_rotation"]
        assert post({"release": "ghost"})["released"] is False
    finally:
        _teardown(router, httpds)


# ---------------------------------------------------------------------------
# registry heartbeat/expiry edges
# ---------------------------------------------------------------------------


def test_registry_probe_expiry_mid_drain_hold():
    """A replica that stops answering mid-drain (held): the OUT
    transition must not double-count the rotation it already left at
    hold time, and release() must NOT put a dead replica back in
    rotation — probes own that door."""
    reg = ReplicaRegistry(fail_threshold=2, recover_probes=2)
    reg.register("a", "http://x:1")
    reg.observe_probe("a", ok=True, ready=True)
    in0 = FLEET_ROTATIONS.labels(direction="in").value
    out0 = FLEET_ROTATIONS.labels(direction="out").value
    assert reg.hold("a")
    assert FLEET_ROTATIONS.labels(direction="out").value == out0 + 1
    # The drain outlives the process: probes start failing while held.
    reg.observe_probe("a", ok=False, ready=False)
    reg.observe_probe("a", ok=False, ready=False)
    assert reg.get("a")["state"] == "out"
    assert FLEET_ROTATIONS.labels(direction="out").value == out0 + 1
    assert reg.release("a")
    assert not reg.get("a")["in_rotation"]
    assert FLEET_ROTATIONS.labels(direction="in").value == in0
    # Recovery is earned through the normal hysteresis, nothing else.
    reg.observe_probe("a", ok=True, ready=True)
    assert not reg.get("a")["in_rotation"]
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["in_rotation"]
    assert FLEET_ROTATIONS.labels(direction="in").value == in0 + 1


def test_registry_hold_of_never_ready_replica_counts_no_rotation():
    reg = ReplicaRegistry()
    reg.register("a", "http://x:1")  # probing: never entered rotation
    out0 = FLEET_ROTATIONS.labels(direction="out").value
    assert reg.hold("a")
    assert FLEET_ROTATIONS.labels(direction="out").value == out0


def test_registry_reenrol_same_id_after_crash_keeps_hysteresis():
    """A crashed replica's replacement re-enrols under the same id and
    url (the lifecycle manager's respawn): the idempotent registration
    must keep the OUT state — re-entering rotation is earned through
    recover_probes, never granted by a registration POST."""
    reg = ReplicaRegistry(fail_threshold=2, recover_probes=2)
    reg.register("a", "http://x:1")
    reg.observe_probe("a", ok=True, ready=True)
    reg.observe_probe("a", ok=False, ready=False)
    reg.observe_probe("a", ok=False, ready=False)
    assert reg.get("a")["state"] == "out"
    # The respawned process's registration heartbeat.
    reg.register("a", "http://x:1")
    assert reg.get("a")["state"] == "out"
    assert reg.pick() is None
    reg.observe_probe("a", ok=True, ready=True)
    assert not reg.get("a")["in_rotation"]  # 1 of 2
    reg.observe_probe("a", ok=True, ready=True)
    assert reg.get("a")["in_rotation"]


def test_registry_expiry_races_concurrent_scale_in():
    """Probe expiry racing a concurrent deregistration (the autoscaler's
    scale-in) and hold/release churn: no exceptions, no resurrection of
    the deregistered replica, registry left consistent."""
    reg = ReplicaRegistry(fail_threshold=1)
    for rid in ("a", "b"):
        reg.register(rid, f"http://{rid}:1")
        reg.observe_probe(rid, ok=True, ready=True)
    stop = threading.Event()
    errors: list = []

    def prober():
        while not stop.is_set():
            try:
                reg.observe_probe("a", ok=False, ready=False)
                reg.observe_probe("a", ok=True, ready=True)
                reg.hold("a")
                reg.release("a")
            except Exception as exc:  # pragma: no cover
                errors.append(exc)
                return

    threads = [threading.Thread(target=prober) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    assert reg.deregister("a")
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not errors
    assert reg.get("a") is None
    assert not reg.deregister("a")
    assert not reg.hold("a") and not reg.release("a")
    reg.observe_probe("a", ok=True, ready=True)  # late expiry: no-op
    assert reg.get("a") is None
    assert [r["id"] for r in reg.snapshot()] == ["b"]
    assert reg.pick()["id"] == "b"


# ===========================================================================
# from tests/test_router_dataplane.py
# ===========================================================================


# ---------------------------------------------------------------------------
# protocol: the response parser and request builder (pure)
# ---------------------------------------------------------------------------


def _resp_bytes(code=200, body=b'{"p": 1}', extra="", keep_alive=True,
                content_length=None):
    cl = len(body) if content_length is None else content_length
    head = (
        f"HTTP/1.1 {code} X\r\nContent-Type: application/json\r\n"
        f"Content-Length: {cl}\r\n{extra}"
    )
    if not keep_alive:
        head += "Connection: close\r\n"
    return head.encode() + b"\r\n" + body


def test_response_parser_single_and_split_reads():
    p = protocol.ResponseParser()
    raw = _resp_bytes(body=b"hello")
    for cut in range(1, len(raw)):
        p = protocol.ResponseParser()
        p.feed(raw[:cut])
        first = p.next_response()
        p.feed(raw[cut:])
        resp = first or p.next_response()
        assert resp is not None
        assert resp.code == 200 and resp.body == b"hello"
        assert resp.keep_alive
        assert p.at_start()


def test_response_parser_connection_close_and_http10():
    p = protocol.ResponseParser()
    p.feed(_resp_bytes(keep_alive=False))
    assert not p.next_response().keep_alive
    p = protocol.ResponseParser()
    p.feed(b"HTTP/1.0 200 OK\r\nContent-Length: 0\r\n\r\n")
    assert not p.next_response().keep_alive  # 1.0 defaults to close


def test_response_parser_missing_content_length_is_unframeable():
    p = protocol.ResponseParser()
    p.feed(b"HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n\r\nbody")
    with pytest.raises(protocol.ProtocolError):
        p.next_response()


def test_response_parser_garbled_status_line():
    p = protocol.ResponseParser()
    p.feed(b"not http at all\r\n\r\n")
    with pytest.raises(protocol.ProtocolError):
        p.next_response()


def test_response_parser_leftover_bytes_visible_via_at_start():
    # An over-long reply (bytes past the declared Content-Length) parses
    # as a complete response PLUS leftover bytes — at_start() is how the
    # transport detects the poisoned framing and refuses to pool.
    p = protocol.ResponseParser()
    p.feed(_resp_bytes(body=b"okGARBAGE", content_length=2))
    resp = p.next_response()
    assert resp.code == 200 and resp.body == b"ok"
    assert not p.at_start()


def test_build_request_framing_roundtrip():
    data = protocol.build_request(
        "POST", "/predict", {"X-Request-Id": "r1"}, b'{"x": 1}',
        host="rep-1",
    )
    rp = protocol.RequestParser()
    rp.feed(data)
    req = rp.next_request()
    assert req.method == "POST" and req.path == "/predict"
    assert req.body == b'{"x": 1}'
    assert req.get_header("x-request-id") == "r1"
    assert req.get_header("host") == "rep-1"
    assert req.keep_alive


# ---------------------------------------------------------------------------
# transport: the loop-owned upstream pool against scripted raw upstreams
# ---------------------------------------------------------------------------


class _NullApp:
    def handle_request(self, req, rsp):
        rsp.send_json(404, {})

    def handle_protocol_error(self, exc, rsp):
        rsp.send_json(exc.code, {"error": exc.message}, close=True)


class _PoolHarness:
    """An event loop + UpstreamPool driven synchronously from the test
    thread: ``call`` posts one attempt onto the loop and waits for its
    completion."""

    def __init__(self, **pool_kw):
        self.server = EventLoopHttpServer(("127.0.0.1", 0), _NullApp())
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()
        self.pool = UpstreamPool(self.server, **pool_kw)

    def call(self, addr, key="r", body=b'{"x": 1}', timeout_s=5.0,
             wait_s=10.0):
        data = protocol.build_request(
            "POST", "/predict", {"Content-Type": "application/json"}, body
        )
        done = threading.Event()
        out = []

        def go():
            self.pool.request(
                key, addr, data, timeout_s,
                lambda res: (out.append(res), done.set()),
            )

        self.server._post(go)
        assert done.wait(wait_s), "upstream attempt never completed"
        return out[0]

    def close(self):
        self.server.server_close()


def _read_request(sock) -> bytes:
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            return buf
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    length = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":")[1])
    while len(rest) < length:
        chunk = sock.recv(65536)
        if not chunk:
            break
        rest += chunk
    return head + b"\r\n\r\n" + rest


class _ScriptedUpstream:
    """A raw-socket upstream whose Nth accepted connection runs the Nth
    script (the last script repeats). Each script gets the accepted
    socket and drives the exchange however the scenario needs."""

    def __init__(self, scripts, rcvbuf=None):
        self.scripts = scripts
        self.accepted = 0
        self.lock = threading.Lock()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if rcvbuf:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = self.sock.getsockname()
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self.lock:
                i = min(self.accepted, len(self.scripts) - 1)
                self.accepted += 1
            threading.Thread(
                target=self._run, args=(conn, self.scripts[i]), daemon=True
            ).start()

    def _run(self, conn, script):
        try:
            script(conn)
        except Exception:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


def _serve_ok(conn, n=1000):
    """Well-behaved keep-alive upstream: parse requests, answer each."""
    for _ in range(n):
        req = _read_request(conn)
        if not req or b"\r\n\r\n" not in req:
            return
        conn.sendall(_resp_bytes(body=b'{"ok": true}'))


def test_upstream_keepalive_reuse_and_stats():
    up = _ScriptedUpstream([_serve_ok])
    h = _PoolHarness()
    try:
        for _ in range(5):
            resp = h.call(up.addr)
            assert not isinstance(resp, Exception)
            assert resp.code == 200 and resp.body == b'{"ok": true}'
        stats = h.pool.stats()
        assert stats["opened_total"] == 1 and stats["reused_total"] == 4
        assert up.accepted == 1
    finally:
        h.close()
        up.close()


def test_upstream_premature_close_mid_headers():
    def mid_headers(conn):
        _read_request(conn)
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Le")
        # close (script returns)

    up = _ScriptedUpstream([mid_headers])
    h = _PoolHarness()
    try:
        res = h.call(up.addr)
        assert isinstance(res, UpstreamError)
        assert "truncated" in str(res)
    finally:
        h.close()
        up.close()


def test_upstream_half_close_mid_body():
    def mid_body(conn):
        _read_request(conn)
        conn.sendall(_resp_bytes(body=b"short", content_length=100))

    up = _ScriptedUpstream([mid_body])
    h = _PoolHarness()
    try:
        res = h.call(up.addr)
        assert isinstance(res, UpstreamError)
        assert "truncated" in str(res)
    finally:
        h.close()
        up.close()


def test_upstream_overlong_reply_poisons_connection_not_next_attempt():
    # Connection 1 replies with bytes PAST its declared Content-Length:
    # the response itself is served, but the connection must close — a
    # reuse would hand the garbage to the next attempt as its status
    # line. Connection 2 serves correctly; the pool must have opened it
    # fresh rather than desyncing.
    def overlong(conn):
        _read_request(conn)
        conn.sendall(_resp_bytes(body=b'{"a": 1}GARBAGE',
                                 content_length=len(b'{"a": 1}')))
        time.sleep(0.5)  # stay open: a naive pool would reuse us

    up = _ScriptedUpstream([overlong, _serve_ok])
    h = _PoolHarness()
    try:
        r1 = h.call(up.addr)
        assert not isinstance(r1, Exception)
        assert r1.code == 200 and r1.body == b'{"a": 1}'
        r2 = h.call(up.addr)
        assert not isinstance(r2, Exception)
        assert r2.code == 200 and r2.body == b'{"ok": true}'
        assert up.accepted == 2, "poisoned connection was reused"
        assert h.pool.stats()["reused_total"] == 0
    finally:
        h.close()
        up.close()


def test_upstream_write_backpressure_slow_reader():
    # A replica that drains its socket slowly: with the send buffers
    # shrunk below the request size, the request CANNOT be written in
    # one send — the loop must ride partial writes + write-interest
    # until the reader catches up, then still parse the reply.
    body = b"x" * 48 * 1024

    def slow_reader(conn):
        time.sleep(0.3)  # let the client's buffers fill first
        req = _read_request(conn)
        assert req.endswith(body)
        conn.sendall(_resp_bytes(body=b'{"got": "all"}'))

    up = _ScriptedUpstream([slow_reader], rcvbuf=4096)
    h = _PoolHarness(configure_sock=lambda s: s.setsockopt(
        socket.SOL_SOCKET, socket.SO_SNDBUF, 8192
    ))
    try:
        res = h.call(up.addr, body=body)
        assert not isinstance(res, Exception), res
        assert res.code == 200 and res.body == b'{"got": "all"}'
    finally:
        h.close()
        up.close()


def test_upstream_reset_mid_reply_fails_instead_of_resending():
    # An RST after reply bytes have arrived is a TRUNCATED reply, not
    # the stale-keep-alive race: a transparent resend here would
    # silently execute the request twice after the replica already
    # started answering it. The send path and the EOF path must agree.
    import struct

    served = []

    def rst_mid_body(conn):
        served.append(1)
        _read_request(conn)
        conn.sendall(_resp_bytes(body=b"0123456789", content_length=100))
        time.sleep(0.1)
        # SO_LINGER 0 + close → RST, not FIN.
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))

    up = _ScriptedUpstream([rst_mid_body])
    h = _PoolHarness()
    try:
        res = h.call(up.addr)
        assert isinstance(res, UpstreamError), res
        assert "truncated" in str(res)
        time.sleep(0.2)
        assert len(served) == 1, "request was re-executed after a mid-reply reset"
    finally:
        h.close()
        up.close()


def test_upstream_stale_pooled_connection_transparent_resend():
    # The keep-alive race every proxy has: the pooled connection dies
    # between requests (idle reap, replica restart). The pool resends
    # ONCE on a fresh connection — the attempt succeeds, the failure
    # never surfaces to the retry policy.
    def serve_one_then_die(conn):
        _read_request(conn)
        conn.sendall(_resp_bytes(body=b'{"n": 1}'))
        # close immediately after the reply WITHOUT Connection: close —
        # the client pools it, then finds it dead.

    up = _ScriptedUpstream([serve_one_then_die, _serve_ok])
    h = _PoolHarness()
    try:
        r1 = h.call(up.addr)
        assert r1.code == 200
        time.sleep(0.1)  # let the server's FIN land
        r2 = h.call(up.addr)
        assert not isinstance(r2, Exception), r2
        assert r2.code == 200 and r2.body == b'{"ok": true}'
        assert up.accepted == 2
    finally:
        h.close()
        up.close()


def test_upstream_attempt_timeout_is_bounded():
    def black_hole(conn):
        _read_request(conn)
        time.sleep(5.0)

    up = _ScriptedUpstream([black_hole])
    h = _PoolHarness()
    try:
        t0 = time.monotonic()
        res = h.call(up.addr, timeout_s=0.4)
        assert isinstance(res, UpstreamTimeout)
        assert time.monotonic() - t0 < 2.0
    finally:
        h.close()
        up.close()


def test_upstream_idle_connections_reaped():
    up = _ScriptedUpstream([_serve_ok])
    h = _PoolHarness(idle_timeout_s=0.3)
    try:
        assert h.call(up.addr).code == 200
        assert h.pool.stats()["idle"] == 1
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and h.pool.stats()["idle"]:
            time.sleep(0.05)
        assert h.pool.stats()["idle"] == 0
        assert h.pool.stats()["connections"] == 0
    finally:
        h.close()
        up.close()


# ---------------------------------------------------------------------------
# registry: least-loaded power-of-two-choices
# ---------------------------------------------------------------------------


def _ready_registry(*rids, **kw):
    reg = ReplicaRegistry(**kw)
    for rid in rids:
        reg.register(rid, f"http://{rid}:1")
        reg.observe_probe(rid, ok=True, ready=True)
    return reg


def test_registry_least_loaded_prefers_fewer_outstanding():
    reg = _ready_registry("a", "b")
    # Equal latency on both; a carries in-flight attempts.
    reg.note_complete("a", 0.010)
    reg.note_dispatch("a")  # net: 1 outstanding after the complete
    reg.note_dispatch("a")
    reg.note_complete("b", 0.010)
    for _ in range(8):
        assert reg.pick()["id"] == "b"


def test_registry_least_loaded_prefers_lower_ewma_latency():
    reg = _ready_registry("a", "b")
    for _ in range(4):
        reg.note_dispatch("a")
        reg.note_complete("a", 0.200)  # slow replica
        reg.note_dispatch("b")
        reg.note_complete("b", 0.002)  # fast replica
    picks = [reg.pick()["id"] for _ in range(10)]
    assert picks.count("b") == 10


def test_registry_queue_depth_probe_signal_folds_into_score():
    reg = _ready_registry("a", "b")
    reg.note_complete("a", 0.010)
    reg.note_complete("b", 0.010)
    # Same observed latency, but a's OWN probe reports a deep queue
    # (e.g. load from another router worker this registry never saw).
    reg.observe_probe("a", ok=True, ready=True, queue_depth=20)
    reg.observe_probe("b", ok=True, ready=True, queue_depth=0)
    for _ in range(8):
        assert reg.pick()["id"] == "b"


def test_registry_ewma_update_and_outstanding_floor():
    reg = _ready_registry("a")
    reg.note_dispatch("a")
    reg.note_complete("a", 0.100)
    load = reg.get("a")["load"]
    assert load["ewma_latency_ms"] == pytest.approx(100.0)
    assert load["outstanding"] == 0
    reg.note_complete("a", 0.200)  # EWMA alpha=0.2: 100 + 0.2*100
    load = reg.get("a")["load"]
    assert load["ewma_latency_ms"] == pytest.approx(120.0)
    assert load["outstanding"] == 0  # never below zero
    # Conn-error completions release the slot without poisoning the EWMA.
    reg.note_dispatch("a")
    reg.note_complete("a", None)
    load = reg.get("a")["load"]
    assert load["ewma_latency_ms"] == pytest.approx(120.0)
    assert load["outstanding"] == 0


def test_registry_snapshot_carries_load_block():
    reg = _ready_registry("a")
    reg.note_dispatch("a")
    snap = reg.snapshot()[0]
    assert snap["load"]["outstanding"] == 1
    assert snap["load"]["ewma_latency_ms"] is None
    assert snap["load"]["last_queue_depth"] is None
    assert snap["load"]["score"] >= 0


def test_router_connection_reuse_across_retries():
    # r1's breaker opens on its first 500; every subsequent request
    # lands on r2 over ONE pooled connection — reuse accounting must
    # show the retried request and its successors riding it.
    router, stubs, httpds, base = _stub_fleet(2, breaker_failures=1)
    reused0 = FLEET_UPSTREAM_CONNS.labels(event="reused").value
    try:
        stubs[0].mode = "error"
        for _ in range(6):
            code, headers, _ = _post_predict(base)
            assert code == 200 and headers["X-Replica"] == "r2"
        assert FLEET_UPSTREAM_CONNS.labels(event="reused").value \
            >= reused0 + 4
        stats = router.upstream.stats()
        assert stats["reused_total"] >= 4, stats
    finally:
        _teardown(router, httpds)


def test_router_connection_reuse_across_hedges():
    # The hedge's winning attempt opens (or reuses) the same pooled
    # connection later direct requests ride: the pool is shared across
    # ordinary attempts, retries, and hedges alike.
    router, stubs, httpds, base = _stub_fleet(
        2, hedge_ms=100.0, request_timeout_s=8.0, fail_threshold=50,
    )
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 1.5
        for _ in range(4):
            code, _, _ = _post_predict(base)
            assert code == 200
        stats = router.upstream.stats()
        # 4 ok replies but far fewer fresh connections than attempts:
        # the hedge target's connection was pooled and reused.
        assert stats["reused_total"] >= 2, stats
    finally:
        _teardown(router, httpds)


def test_router_load_signals_on_control_plane():
    router, stubs, httpds, base = _stub_fleet(2)
    try:
        for _ in range(6):
            assert _post_predict(base)[0] == 200
        import urllib.request

        with urllib.request.urlopen(
            base + "/fleet/replicas", timeout=5
        ) as resp:
            replicas = json.loads(resp.read())["replicas"]
        served = [r for r in replicas if r["load"]["ewma_latency_ms"]]
        assert served, replicas
        for r in replicas:
            assert r["load"]["outstanding"] == 0  # all settled
        with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
            health = json.loads(resp.read())
        assert health["upstream"]["opened_total"] >= 1
    finally:
        _teardown(router, httpds)


def test_cancelled_hedge_loser_releases_outstanding():
    # The losing attempt of a won hedge is CANCELLED (its completion
    # never fires): its replica's outstanding count must be released by
    # the settle path, or every lost hedge leaks +1 forever and the
    # least-loaded score starves the replica monotonically.
    router, stubs, httpds, base = _stub_fleet(
        2, hedge_ms=100.0, request_timeout_s=8.0, fail_threshold=50,
    )
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 2.0
        for _ in range(3):
            code, _, _ = _post_predict(base)
            assert code == 200
        deadline = time.monotonic() + 6
        while time.monotonic() < deadline:
            loads = {
                r["id"]: r["load"]["outstanding"]
                for r in router.registry.snapshot()
            }
            if all(v == 0 for v in loads.values()):
                break
            time.sleep(0.1)
        assert all(v == 0 for v in loads.values()), loads
    finally:
        _teardown(router, httpds)


def test_probe_queue_depth_garbage_does_not_poison_registry():
    # /readyz bodies come from anything that registered itself: a
    # non-numeric queue_depth must be ignored, not raise out of the
    # probe pass (which would freeze probing for every replica behind
    # the bad one).
    reg = _ready_registry("a")
    reg.observe_probe("a", ok=True, ready=True, queue_depth="n/a")
    assert reg.get("a")["load"]["last_queue_depth"] is None
    reg.observe_probe("a", ok=True, ready=True, queue_depth=3)
    assert reg.get("a")["load"]["last_queue_depth"] == 3
    reg.observe_probe("a", ok=True, ready=True, queue_depth=[1])
    assert reg.get("a")["load"]["last_queue_depth"] == 3  # kept, not lost


def test_router_prefers_fast_replica_under_sequential_load():
    # One replica 60 ms slower than the other: once both have a sample,
    # least-loaded picking concentrates sequential traffic on the fast
    # one (round-robin would split 50/50 and pay the slow tax on half).
    router, stubs, httpds, base = _stub_fleet(
        2, hedge_ms=0.0, request_timeout_s=8.0,
    )
    try:
        stubs[0].mode = "stall"
        stubs[0].stall_s = 0.06
        for _ in range(12):
            assert _post_predict(base)[0] == 200
        assert stubs[1].served > stubs[0].served, (
            stubs[0].served, stubs[1].served,
        )
    finally:
        _teardown(router, httpds)


# ===========================================================================
# from tests/test_autoscale.py
# ===========================================================================


# ---------------------------------------------------------------------------
# harness: fake clock/proc/router, journal capture, signal stubs
# ---------------------------------------------------------------------------


@pytest.fixture
def jrn(tmp_path):
    j = journal.RunJournal(tmp_path / "journal.jsonl", command="test")
    journal.set_journal(j)
    yield j
    journal.set_journal(None)
    j.close()


def _events(j, kind=None):
    with open(j.path) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    evs = [e for e in evs if e.get("kind") != "manifest"]
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return evs


class _FakeProc:
    """A controllable child process: tests decide when it dies and
    whether it honors SIGTERM."""

    _next_pid = [1000]

    def __init__(self, cmd, exits_on_term=True):
        self.cmd = cmd
        self._next_pid[0] += 1
        self.pid = self._next_pid[0]
        self.code = None
        self.terminated = False
        self.killed = False
        self.exits_on_term = exits_on_term

    def poll(self):
        return self.code

    def terminate(self):
        self.terminated = True
        if self.exits_on_term:
            self.code = 0

    def kill(self):
        self.killed = True
        self.code = -9

    def die(self, code=1):
        self.code = code


class _FakeRouter:
    """Recording control-plane client; ``registry_snapshot`` drives the
    manager's zombie detection."""

    def __init__(self):
        self.ops = []
        self.registry_snapshot = []

    def snapshot(self):
        return self.registry_snapshot

    def hold(self, rid):
        self.ops.append(("hold", rid))
        return True

    def release(self, rid):
        self.ops.append(("release", rid))
        return True

    def deregister(self, rid):
        self.ops.append(("deregister", rid))
        return True


def _mk_manager(monkeypatch, clk, ready, depths, launcher=None, **kw):
    """A manager on a fake clock whose readiness probes and drain
    queue-depth reads are table-driven (``ready``: set of ready urls;
    ``depths``: url -> queue depth)."""
    monkeypatch.setattr(
        lifecycle, "probe_replica",
        lambda url, timeout_s=2.0: {
            "ok": url in ready, "ready": url in ready, "version": 1,
        },
    )
    monkeypatch.setattr(
        lifecycle, "replica_queue_depth",
        lambda url, timeout_s=2.0: depths.get(url, 0),
    )
    procs = []

    def default_launcher(cmd):
        proc = _FakeProc(cmd)
        procs.append(proc)
        return proc

    router = _FakeRouter()
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("ready_deadline_s", 10.0)
    kw.setdefault("drain_settle_s", 2.0)
    kw.setdefault("term_deadline_s", 5.0)
    kw.setdefault("respawn_backoff_s", 1.0)
    mgr = LifecycleManager(
        ReplicaSpec(model="/ckpt", register_url="http://router"),
        router, launcher=launcher or default_launcher,
        clock=lambda: clk[0], **kw,
    )
    mgr._test_procs = procs
    return mgr, router


def _sig(q=None, lat=None, shed=None, burn=None, alerts=None):
    return {
        "queue_depth": q, "latency_ms": lat, "shed_rate": shed,
        "burn_rate": burn, "alerts_active": alerts,
    }


def _policy(**kw):
    clk = kw.pop("clk", [0.0])
    kw.setdefault("breach_polls", 3)
    kw.setdefault("idle_polls", 3)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    return AutoscalePolicy(clock=lambda: clk[0], **kw), clk


# ---------------------------------------------------------------------------
# policy: debounce, cooldown, bounds
# ---------------------------------------------------------------------------


def test_policy_scale_out_is_debounced(jrn):
    p, _ = _policy()
    assert p.observe(_sig(q=50), desired=2, ready=2) is None
    assert p.observe(_sig(q=50), desired=2, ready=2) is None
    action = p.observe(_sig(q=50), desired=2, ready=2)
    assert action == {
        "decision": "scale_out", "target": 3,
        "reason": "breach: queue_depth",
        "signals": _sig(q=50),
    }
    fired = [
        e for e in _events(jrn, "autoscale_decision") if e.get("decision")
    ]
    assert len(fired) == 1 and fired[0]["target"] == 3
    assert fired[0]["signals"]["queue_depth"] == 50


def test_policy_middle_zone_resets_both_streaks():
    # q=5 sits between the scale-in (1) and scale-out (8) thresholds:
    # neither a breach nor idle — consecutive evidence only.
    p, _ = _policy()
    p.observe(_sig(q=50), 2, 2)
    p.observe(_sig(q=50), 2, 2)
    assert p.observe(_sig(q=5), 2, 2) is None
    assert p.observe(_sig(q=50), 2, 2) is None  # streak restarted at 1
    assert p.observe(_sig(q=50), 2, 2) is None
    assert p.observe(_sig(q=50), 2, 2)["decision"] == "scale_out"


def test_policy_cooldown_suppresses_both_directions():
    p, clk = _policy(cooldown_s=30.0)
    for _ in range(2):
        p.observe(_sig(q=50), 2, 2)
    assert p.observe(_sig(q=50), 2, 2)["decision"] == "scale_out"
    suppressed0 = AUTOSCALE_DECISIONS.labels(
        decision="suppressed_cooldown"
    ).value
    for _ in range(4):
        assert p.observe(_sig(q=50), 3, 3) is None  # cooling down
    assert AUTOSCALE_DECISIONS.labels(
        decision="suppressed_cooldown"
    ).value > suppressed0
    # The quiet tail inside the cooldown cannot scale in either.
    for _ in range(4):
        assert p.observe(_sig(q=0, shed=0.0), 3, 3) is None
    # The idle streak survived the suppressions, so the first poll past
    # the cooldown acts.
    clk[0] = 31.0
    action = p.observe(_sig(q=0, shed=0.0), 3, 3)
    assert action == {
        "decision": "scale_in", "target": 2,
        "reason": "idle: all signals under scale-in thresholds",
        "signals": _sig(q=0, shed=0.0),
    }


def test_policy_bounds_suppression(jrn):
    p, _ = _policy(max_replicas=2)
    at_max0 = AUTOSCALE_DECISIONS.labels(decision="suppressed_at_max").value
    for _ in range(5):
        assert p.observe(_sig(q=50), desired=2, ready=2) is None
    assert AUTOSCALE_DECISIONS.labels(
        decision="suppressed_at_max"
    ).value == at_max0 + 3  # counted each eligible poll...
    suppressed = [
        e for e in _events(jrn, "autoscale_decision")
        if e.get("suppressed_by") == "suppressed_at_max"
    ]
    assert len(suppressed) == 1  # ...journaled once per streak
    at_min0 = AUTOSCALE_DECISIONS.labels(decision="suppressed_at_min").value
    for _ in range(4):
        assert p.observe(_sig(q=0, shed=0.0), desired=1, ready=1) is None
    assert AUTOSCALE_DECISIONS.labels(
        decision="suppressed_at_min"
    ).value > at_min0


def test_policy_scale_in_requires_every_signal_idle():
    p, _ = _policy(idle_polls=2)
    # Queue is quiet but the burn rate sits in the middle zone (above
    # its scale-in twin, below its scale-out threshold): never idle,
    # never scales in.
    for _ in range(6):
        assert p.observe(_sig(q=0, burn=2.0), 2, 2) is None
    assert p.observe(_sig(q=0, burn=0.5), 2, 2) is None
    assert p.observe(_sig(q=0, burn=0.5), 2, 2)["decision"] == "scale_in"


def test_policy_blind_polls_do_not_vote():
    p, _ = _policy(breach_polls=1, idle_polls=1)
    assert p.observe(_sig(), 2, 2) is None  # nothing reachable: no-op


def test_thresholds_validate():
    with pytest.raises(ValueError):
        AutoscaleThresholds(out_queue_depth=2.0, in_queue_depth=5.0)
    with pytest.raises(ValueError):
        AutoscalePolicy(breach_polls=0)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=3, max_replicas=2)


# ---------------------------------------------------------------------------
# lifecycle manager: spawn → ready → retire → replace arcs
# ---------------------------------------------------------------------------


def test_manager_spawn_to_ready_arc(monkeypatch, jrn):
    clk, ready = [0.0], set()
    mgr, router = _mk_manager(monkeypatch, clk, ready, {})
    mgr.scale_to(1)
    mgr.tick()
    rep = mgr.replicas()[0]
    assert rep["state"] == "spawning" and rep["pid"] is not None
    assert json.dumps(mgr._test_procs[0].cmd).count("--register")
    ready.add(rep["url"])
    clk[0] = 3.0
    mgr.tick()
    assert mgr.replicas()[0]["state"] == "ready"
    spawn = _events(jrn, "lifecycle_spawn")
    assert spawn and not spawn[0]["respawn"]
    assert _events(jrn, "lifecycle_ready")[0]["seconds"] == 3.0
    assert mgr.counts()["ready"] == 1


def test_manager_ready_timeout_fails_closed(monkeypatch, jrn):
    clk, ready = [0.0], set()
    mgr, router = _mk_manager(monkeypatch, clk, ready, {},
                              ready_deadline_s=10.0)
    mgr.scale_to(1)
    mgr.tick()
    proc = mgr._test_procs[0]
    clk[0] = 11.0
    mgr.tick()
    assert proc.killed  # the unready child does not linger
    failed = _events(jrn, "lifecycle_spawn_failed")
    assert failed and "not ready within" in failed[0]["reason"]
    assert ("deregister", "as-1") in router.ops
    assert mgr.replicas()[0]["state"] == "pending"
    # The retry respects the backoff gate, then relaunches.
    mgr.tick()
    assert len(mgr._test_procs) == 1
    clk[0] = 12.5  # past next_spawn_at = 11 + 1s backoff
    mgr.tick()
    assert len(mgr._test_procs) == 2
    ready.add(mgr.replicas()[0]["url"])
    mgr.tick()
    assert mgr.replicas()[0]["state"] == "ready"


def test_manager_crash_detection_respawns_with_backoff(monkeypatch, jrn):
    clk, ready = [0.0], set()
    mgr, router = _mk_manager(monkeypatch, clk, ready, {})
    mgr.scale_to(1)
    mgr.tick()
    ready.add(mgr.replicas()[0]["url"])
    mgr.tick()
    crashes0 = LIFECYCLE_TRANSITIONS.labels(event="crash").value
    mgr._test_procs[0].die(-9)
    clk[0] = 5.0
    mgr.tick()
    assert LIFECYCLE_TRANSITIONS.labels(event="crash").value == crashes0 + 1
    assert ("deregister", "as-1") in router.ops
    assert mgr.replicas()[0]["state"] == "pending"
    mgr.tick()  # inside the backoff window: no respawn yet
    assert len(mgr._test_procs) == 1
    clk[0] = 6.1
    mgr.tick()
    assert len(mgr._test_procs) == 2
    respawn = _events(jrn, "lifecycle_spawn")[-1]
    assert respawn["respawn"] and respawn["replica"] == "as-1"
    mgr.tick()
    assert mgr.replicas()[0]["state"] == "ready"  # same id, same url
    # A second crash doubles the backoff (1 → 2s): attempts were reset
    # by readiness, so this is attempt 1 again at 1s... crash twice
    # WITHOUT an intervening ready to see the doubling.
    mgr._test_procs[-1].die(1)
    ready.clear()
    clk[0] = 10.0
    mgr.tick()
    clk[0] = 11.1
    mgr.tick()  # respawn (attempt 1 after reset: 1s backoff)
    mgr._test_procs[-1].die(1)
    clk[0] = 12.0
    mgr.tick()
    clk[0] = 13.5  # 12 + 2s backoff not yet passed
    mgr.tick()
    n = len(mgr._test_procs)
    clk[0] = 14.1
    mgr.tick()
    assert len(mgr._test_procs) == n + 1


def test_manager_drain_first_retirement_order(monkeypatch, jrn):
    clk, ready, depths = [0.0], set(), {}
    mgr, router = _mk_manager(monkeypatch, clk, ready, depths,
                              drain_settle_s=5.0)
    mgr.scale_to(2)
    mgr.tick()
    for rep in mgr.replicas():
        ready.add(rep["url"])
    mgr.tick()
    assert mgr.counts()["ready"] == 2
    retiring = mgr.replicas()[-1]  # newest leaves first
    depths[retiring["url"]] = 3
    mgr.scale_to(1)
    mgr.tick()
    assert ("hold", retiring["id"]) in router.ops
    assert mgr.get(retiring["id"]).state == "draining"
    proc = mgr._test_procs[1]
    assert not proc.terminated  # in-flight work still draining
    clk[0] = 1.0
    mgr.tick()
    assert not proc.terminated  # queue still has 3 entries
    depths[retiring["url"]] = 0
    clk[0] = 2.0
    mgr.tick()
    assert proc.terminated and not proc.killed
    mgr.tick()
    assert mgr.get(retiring["id"]) is None
    assert ("deregister", retiring["id"]) in router.ops
    kinds = [
        e["kind"] for e in _events(jrn)
        if e.get("replica") == retiring["id"]
        and e["kind"].startswith("lifecycle_")
    ]
    drain_on = kinds[kinds.index("lifecycle_drain"):]
    assert drain_on == ["lifecycle_drain", "lifecycle_term",
                        "lifecycle_exit"]
    assert "lifecycle_kill" not in kinds
    # The hold landed before the SIGTERM: drain-first, provably.
    assert router.ops.index(("hold", retiring["id"])) < \
        router.ops.index(("deregister", retiring["id"]))


def test_manager_stuck_drain_escalates_to_kill(monkeypatch, jrn):
    clk, ready, depths = [0.0], set(), {}
    launcher_procs = []

    def launcher(cmd):
        proc = _FakeProc(cmd, exits_on_term=False)  # ignores SIGTERM
        launcher_procs.append(proc)
        return proc

    mgr, router = _mk_manager(
        monkeypatch, clk, ready, depths, launcher=launcher,
        drain_settle_s=2.0, term_deadline_s=5.0,
    )
    mgr.scale_to(2)
    mgr.tick()
    for rep in mgr.replicas():
        ready.add(rep["url"])
    mgr.tick()
    faults.arm("lifecycle.drain:corrupt@once")
    try:
        retiring = mgr.replicas()[-1]["id"]
        mgr.scale_to(1)
        mgr.tick()  # drain (TERM suppressed by the injected fault)
        clk[0] = 3.0
        mgr.tick()  # settle deadline passed → term step
        term = _events(jrn, "lifecycle_term")[-1]
        assert term["delivered"] is False  # the "replica" ignored it
        proc = launcher_procs[1]
        assert not proc.killed
        clk[0] = 9.0
        mgr.tick()  # term deadline passed → SIGKILL escalation
        assert proc.killed
        kill = _events(jrn, "lifecycle_kill")[-1]
        assert kill["replica"] == retiring
        assert kill["reason"] == "term_deadline"
        mgr.tick()
        assert mgr.get(retiring) is None  # reaped, bounded retirement
    finally:
        faults.reset()


def test_manager_injected_spawn_fault_fails_closed(monkeypatch, jrn):
    clk, ready = [0.0], set()
    mgr, router = _mk_manager(monkeypatch, clk, ready, {})
    faults.arm("lifecycle.spawn:raise@once")
    try:
        mgr.scale_to(1)
        mgr.tick()
        failed = _events(jrn, "lifecycle_spawn_failed")
        assert failed and "injected" in failed[0]["reason"]
        assert not mgr._test_procs  # nothing launched
        clk[0] = 1.5
        mgr.tick()  # the retry (fault was @once) launches for real
        assert len(mgr._test_procs) == 1
    finally:
        faults.reset()


def test_manager_corrupt_spawn_launches_an_unready_replica(monkeypatch):
    clk, ready = [0.0], set()
    mgr, router = _mk_manager(monkeypatch, clk, ready, {})
    faults.arm("lifecycle.spawn:corrupt@once")
    try:
        mgr.scale_to(1)
        mgr.tick()
        # The sabotage is a nonexistent checkpoint: the child would die
        # or never warm — either way the ready-deadline branch owns it.
        assert "/ckpt.__corrupt__" in mgr._test_procs[0].cmd
        clk[0] = 11.0
        mgr.tick()
        assert mgr._test_procs[0].killed
        clk[0] = 12.5
        mgr.tick()
        assert mgr._test_procs[1].cmd.count("/ckpt") and \
            "/ckpt.__corrupt__" not in mgr._test_procs[1].cmd
    finally:
        faults.reset()


def test_manager_registry_zombie_is_replaced(monkeypatch, jrn):
    clk, ready = [0.0], set()
    mgr, router = _mk_manager(monkeypatch, clk, ready, {},
                              unresponsive_probe_fails=4)
    mgr.scale_to(1)
    mgr.tick()
    ready.add(mgr.replicas()[0]["url"])
    mgr.tick()
    proc = mgr._test_procs[0]
    # The process lives, but the registry says it stopped answering.
    router.registry_snapshot = [
        {"id": "as-1", "state": "out", "probe_fails": 6},
    ]
    clk[0] = 5.0
    mgr.tick()
    assert proc.killed
    crash = _events(jrn, "lifecycle_crash")[-1]
    assert "unresponsive" in crash["detail"]
    assert mgr.replicas()[0]["state"] == "pending"


def test_manager_scale_bounds_clamped(monkeypatch):
    clk = [0.0]
    mgr, _ = _mk_manager(monkeypatch, clk, set(), {}, min_replicas=2,
                         max_replicas=3)
    assert mgr.scale_to(99) == 3
    assert mgr.scale_to(0) == 2
    with pytest.raises(ValueError):
        _mk_manager(monkeypatch, clk, set(), {}, min_replicas=0)


def test_manager_scale_in_is_numerically_newest_first(monkeypatch, jrn):
    """Retirement order is creation order, not id-string order: with 10+
    slots "as-10" must retire before "as-9" (lexicographic sort would
    retire the veteran)."""
    class _All:
        def __contains__(self, url):
            return True

    clk = [0.0]
    mgr, _ = _mk_manager(monkeypatch, clk, _All(), {}, min_replicas=1,
                         max_replicas=12)
    mgr.scale_to(10)
    mgr.tick()   # spawn as-1..as-10
    mgr.tick()   # all ready
    assert all(r["state"] == "ready" for r in mgr.replicas())
    mgr.scale_to(9)
    mgr.tick()
    draining = [r["id"] for r in mgr.replicas() if r["state"] == "draining"]
    assert draining == ["as-10"]


def test_manager_repeated_spawn_failure_moves_port(monkeypatch, jrn):
    """A port stolen during the backoff window must not wedge the slot
    forever: after 3 consecutive spawn failures the slot re-allocates a
    fresh port (same id — the registry supports same-id-new-url)."""
    clk = [0.0]

    def bad_launcher(cmd):
        raise OSError("address already in use")

    mgr, _ = _mk_manager(monkeypatch, clk, set(), {},
                         launcher=bad_launcher, min_replicas=1)
    mgr.scale_to(1)
    mgr.tick()                       # attempt 1 fails
    rep = mgr.get("as-1")
    port0 = rep.port
    clk[0] += 2.0
    mgr.tick()                       # attempt 2 fails, port unchanged
    assert rep.attempts == 2 and rep.port == port0
    clk[0] += 3.0
    mgr.tick()                       # attempt 3 fails -> port moves
    assert rep.attempts == 3
    assert rep.port != port0
    assert rep.url.endswith(str(rep.port))


# ---------------------------------------------------------------------------
# daemon signal collection + scaling over a live (stub) fleet
# ---------------------------------------------------------------------------


class _SignalStub:
    """A replica stub with the three surfaces the autoscaler polls."""

    def __init__(self, rid):
        self.rid = rid
        self.queue_depth = 0
        self.burn = 0.5

    def handle_request(self, req, rsp):
        if req.path == "/readyz":
            rsp.send_json(200, {"ready": True, "reasons": [],
                                "replica": self.rid, "version": 1})
        elif req.path == "/healthz":
            rsp.send_json(200, {"status": "ok",
                                "queue_depth": self.queue_depth})
        elif req.path == "/metrics":
            rsp.send_json(200, {
                "runtime": {
                    "slo_burn_rate": {"slo=latency": self.burn},
                },
            })
        elif req.path == "/predict":
            rsp.send_json(200, {"probability": 0.25},
                          headers={"X-Replica": self.rid})
        else:
            rsp.send_json(404, {"error": "nope"})

    def handle_protocol_error(self, exc, rsp):
        rsp.send_json(exc.code, {"error": exc.message}, close=True)


class _CountingManager:
    min_replicas, max_replicas = 1, 4

    def __init__(self):
        self.desired = 2
        self.ticks = 0

    def scale_to(self, n):
        self.desired = n

    def tick(self):
        self.ticks += 1


def _signal_fleet(n=2):
    stubs, httpds, members = [], [], []
    for i in range(n):
        stub = _SignalStub(f"r{i + 1}")
        httpd = EventLoopHttpServer(("127.0.0.1", 0), stub)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        stubs.append(stub)
        httpds.append(httpd)
        members.append(
            (stub.rid, f"http://127.0.0.1:{httpd.server_address[1]}")
        )
    router = make_router(
        port=0, replicas=members, probe_interval_s=0.1,
    ).start_background()
    deadline = time.monotonic() + 10
    while router.registry.ready_count() < n and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert router.registry.ready_count() == n
    return router, stubs, httpds, \
        f"http://{router.address[0]}:{router.address[1]}"


def test_daemon_collects_signals_and_scales_live():
    router, stubs, httpds, base = _signal_fleet(2)
    try:
        mgr = _CountingManager()
        daemon = AutoscaleDaemon(
            base, mgr,
            AutoscalePolicy(
                thresholds=AutoscaleThresholds(
                    out_queue_depth=8.0, in_queue_depth=1.0,
                    out_burn_rate=4.0, in_burn_rate=1.0,
                    out_latency_ms=None, in_latency_ms=None,
                ),
                breach_polls=2, idle_polls=3, cooldown_s=0.0,
                min_replicas=1, max_replicas=4,
            ),
        )
        # A couple of routed requests so the router's counters move.
        for _ in range(3):
            req = urllib.request.Request(
                base + "/predict", data=b"{}",
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=5).read()
        stubs[0].queue_depth = 50
        signals = daemon.collect_signals()
        assert signals["queue_depth"] == 50.0  # max across the fleet
        assert signals["burn_rate"] == 0.5
        assert signals["ready"] == 2
        assert daemon.tick() is None          # breach 1 of 2 (delta prime)
        action = daemon.tick()                # breach 2 of 2 → fire
        assert action["decision"] == "scale_out" and mgr.desired == 3
        assert mgr.ticks >= 2                 # the manager ticks every poll
        stubs[0].queue_depth = 0
        for _ in range(2):
            assert daemon.tick() is None
        action = daemon.tick()
        assert action["decision"] == "scale_in" and mgr.desired == 2
        # shed_rate reads 0.0 from the counter deltas (requests flowed,
        # none shed) — a real reading, required for the idle verdict.
    finally:
        router.shutdown()
        for h in httpds:
            h.server_close()


def test_daemon_survives_unreachable_router():
    mgr = _CountingManager()
    daemon = AutoscaleDaemon("http://127.0.0.1:1", mgr,
                             AutoscalePolicy(), poll_timeout_s=0.2)
    assert daemon.tick() is None  # all-None signals: no decision
    assert daemon.collect_signals()["queue_depth"] is None
    assert mgr.ticks >= 1  # crash detection still runs through a blip


# ===========================================================================
# from tests/test_fleetobs.py
# ===========================================================================


# ---------------------------------------------------------------------------
# clock-offset estimator
# ---------------------------------------------------------------------------


def test_clock_sync_recovers_synthetic_skew():
    """A replica whose perf clock runs 5 s ahead: the midpoint estimate
    recovers the skew to within RTT/2 on the first probe."""
    cs = fleettrace.ClockSync()
    # Probe took 10 ms; replica stamped its clock exactly at the
    # midpoint, so the estimate is exact.
    off = cs.observe("r1", t_send=100.0, t_recv=100.010,
                     replica_clock=105.005)
    assert off == pytest.approx(5.0, abs=1e-9)
    assert cs.offset_s("r1") == pytest.approx(5.0, abs=1e-9)

    # EWMA smoothing: a second, slightly-off sample moves the estimate
    # by alpha * innovation, not to the raw value.
    cs.observe("r1", t_send=101.0, t_recv=101.010,
               replica_clock=106.015)  # raw = 5.010
    expected = 5.0 + fleettrace.ClockSync.EWMA_ALPHA * 0.010
    assert cs.offset_s("r1") == pytest.approx(expected, abs=1e-9)

    snap = cs.snapshot()
    assert snap["r1"]["samples"] == 2
    assert snap["r1"]["rtt_ms"] == pytest.approx(10.0, abs=1e-6)

    cs.forget("r1")
    assert cs.offset_s("r1") is None


def test_clock_sync_negative_skew():
    cs = fleettrace.ClockSync()
    cs.observe("r2", t_send=50.0, t_recv=50.002, replica_clock=20.001)
    assert cs.offset_s("r2") == pytest.approx(-30.0, abs=1e-9)


# ---------------------------------------------------------------------------
# flight-recorder exact lookup (the join's fetch primitive)
# ---------------------------------------------------------------------------


def _finished_trace(rid, status="ok"):
    tr = RequestTrace(rid)
    t0 = tr.t_start
    tr.add_phase("parse", t0, t0 + 0.001)
    tr.finish(status)
    return tr


def test_flight_recorder_lookup_indexes_all_completions():
    rec = FlightRecorder(capacity=4, index_capacity=8)
    for i in range(6):
        rec.record(_finished_trace(f"req-{i}"))
    # Every completion is indexed, not just the tail-sampled ring.
    snap = rec.lookup("req-0")
    assert snap is not None and snap["request_id"] == "req-0"
    assert "t_start_perf" in snap and "phases" in snap
    assert rec.lookup("req-never") is None
    stats = rec.stats()
    assert stats["indexed"] == 6
    assert stats["index_capacity"] == 8


def test_flight_recorder_lookup_evicts_fifo():
    rec = FlightRecorder(capacity=4, index_capacity=3)
    for i in range(5):
        rec.record(_finished_trace(f"req-{i}"))
    assert rec.lookup("req-0") is None  # evicted
    assert rec.lookup("req-1") is None  # evicted
    assert rec.lookup("req-4") is not None
    with pytest.raises(ValueError):
        FlightRecorder(index_capacity=0)


# ---------------------------------------------------------------------------
# exposition merge math (goldens)
# ---------------------------------------------------------------------------


PAGE_R1 = """\
# HELP stub_requests_total Requests served.
# TYPE stub_requests_total counter
stub_requests_total{outcome="ok"} 10
stub_requests_total{outcome="shed"} 2
# HELP stub_queue_depth Admission queue depth.
# TYPE stub_queue_depth gauge
stub_queue_depth 3
# HELP stub_latency_seconds Latency.
# TYPE stub_latency_seconds histogram
stub_latency_seconds_bucket{le="0.01"} 4
stub_latency_seconds_bucket{le="0.1"} 9
stub_latency_seconds_bucket{le="+Inf"} 10
stub_latency_seconds_sum 0.5
stub_latency_seconds_count 10
"""

PAGE_R2 = """\
# HELP stub_requests_total Requests served.
# TYPE stub_requests_total counter
stub_requests_total{outcome="ok"} 7
# HELP stub_queue_depth Admission queue depth.
# TYPE stub_queue_depth gauge
stub_queue_depth 5
# HELP stub_latency_seconds Latency.
# TYPE stub_latency_seconds histogram
stub_latency_seconds_bucket{le="0.01"} 1
stub_latency_seconds_bucket{le="0.1"} 6
stub_latency_seconds_bucket{le="+Inf"} 7
stub_latency_seconds_sum 0.8
stub_latency_seconds_count 7
"""


def _merge(pages, **kw):
    parsed = {
        rid: fleetmetrics.parse_exposition(text)
        for rid, text in pages.items()
    }
    return fleetmetrics.merge_expositions(parsed, **kw)


def test_merge_counter_sum_and_gauge_relabel_goldens():
    merged, rejected = _merge({"r1": PAGE_R1, "r2": PAGE_R2})
    assert rejected == []

    counters = merged["stub_requests_total"]["series"]
    assert counters[(("outcome", "ok"),)] == 17  # summed across replicas
    assert counters[(("outcome", "shed"),)] == 2  # present on r1 only

    gauges = merged["stub_queue_depth"]["series"]
    assert gauges[(("replica", "r1"),)] == 3  # re-emitted, never averaged
    assert gauges[(("replica", "r2"),)] == 5

    hist = merged["stub_latency_seconds"]["series"][()]
    assert hist["buckets"] == {"0.01": 5, "0.1": 15, "+Inf": 17}
    assert hist["sum"] == pytest.approx(1.3)
    assert hist["count"] == 17

    text = fleetmetrics.render_merged(merged)
    assert validate(text) == []  # strict-validator clean
    assert 'stub_requests_total{outcome="ok"} 17' in text
    assert 'stub_queue_depth{replica="r2"} 5' in text


def test_merge_rejects_bucket_mismatch():
    page2 = PAGE_R2.replace('le="0.01"', 'le="0.025"')
    merged, rejected = _merge({"r1": PAGE_R1, "r2": page2})
    assert "stub_latency_seconds" not in merged
    assert {"name": "stub_latency_seconds",
            "reason": "bucket_mismatch"} in rejected
    # The other families still merge — one bad family never poisons
    # the page.
    assert merged["stub_requests_total"]["series"][(("outcome", "ok"),)] \
        == 17
    assert validate(fleetmetrics.render_merged(merged)) == []


def test_merge_rejects_kind_and_label_mismatch():
    gauge_as_counter = (
        "# TYPE stub_queue_depth counter\nstub_queue_depth 4\n"
    )
    merged, rejected = _merge({"r1": PAGE_R1, "r2": gauge_as_counter})
    reasons = {r["name"]: r["reason"] for r in rejected}
    assert reasons["stub_queue_depth"] == "kind_mismatch"

    relabeled = (
        "# TYPE stub_requests_total counter\n"
        'stub_requests_total{outcome="ok",shard="a"} 1\n'
    )
    merged, rejected = _merge({"r1": PAGE_R1, "r2": relabeled})
    reasons = {r["name"]: r["reason"] for r in rejected}
    assert reasons["stub_requests_total"] == "label_mismatch"

    # A replica-side gauge already labeled `replica` would collide with
    # the label the merge appends.
    own_replica = (
        "# TYPE stub_queue_depth gauge\n"
        'stub_queue_depth{replica="imposter"} 9\n'
    )
    merged, rejected = _merge({"r1": PAGE_R1, "r2": own_replica})
    reasons = {r["name"]: r["reason"] for r in rejected}
    assert reasons["stub_queue_depth"] == "label_mismatch"


def test_merge_drops_router_owned_families():
    merged, rejected = _merge(
        {"r1": PAGE_R1}, drop=frozenset({"stub_queue_depth"}),
    )
    assert "stub_queue_depth" not in merged
    assert {"name": "stub_queue_depth",
            "reason": "router_owned"} in rejected


def test_parse_exposition_escapes_and_specials():
    page = (
        "# TYPE weird_gauge gauge\n"
        'weird_gauge{msg="a\\"b\\\\c\\nd"} NaN\n'
        'weird_gauge{msg="inf"} +Inf\n'
    )
    fam = fleetmetrics.parse_exposition(page)["weird_gauge"]
    key = (("msg", 'a"b\\c\nd'),)
    assert fam["series"][key] != fam["series"][key]  # NaN
    assert fam["series"][(("msg", "inf"),)] == float("inf")
    # ... and the round-trip re-escapes cleanly.
    merged, _ = _merge({"r1": page})
    assert validate(fleetmetrics.render_merged(merged)) == []


# ---------------------------------------------------------------------------
# the join (synthetic, injected fetch)
# ---------------------------------------------------------------------------


def _router_sample(rid, replica, t0, phases, total):
    return {
        "request_id": rid, "status": "ok", "t_start_perf": t0,
        "total_seconds": total, "replica": replica, "attempts": 1,
        "phases": {
            name: {"offset_seconds": off, "seconds": dur}
            for name, (off, dur) in phases.items()
        },
    }


def test_join_fleet_trace_offset_corrected_containment():
    """Replica clock 5 s ahead: raw replica stamps land nowhere near the
    router's upstream span; offset-corrected they nest inside it."""
    skew = 5.0
    cs = fleettrace.ClockSync()
    cs.observe("r1", t_send=0.0, t_recv=0.0, replica_clock=skew)

    t0 = 1000.0  # router admission (router clock)
    sample = _router_sample(
        "req-j", "r1", t0,
        {"parse": (0.0, 0.001), "upstream": (0.001, 0.050),
         "respond": (0.051, 0.001)},
        total=0.052,
    )
    # Replica-side: starts 10 ms into the upstream window, 30 ms long —
    # stamped on the REPLICA's (skewed) clock.
    replica_snap = {
        "request_id": "req-j", "status": "ok",
        "t_start_perf": t0 + 0.011 + skew, "total_seconds": 0.030,
        "phases": {
            "parse": {"offset_seconds": 0.0, "seconds": 0.002},
            "device_compute": {"offset_seconds": 0.002, "seconds": 0.020},
            "respond": {"offset_seconds": 0.028, "seconds": 0.002},
        },
        "path": "device",
    }

    def fetch(url, rid, timeout_s):
        assert url == "http://rep:1" and rid == "req-j"
        return replica_snap, "ok"

    export = fleettrace.join_fleet_trace(
        [sample], {"r1": "http://rep:1"}, cs, fetch=fetch,
    )
    other = export["otherData"]
    assert other["results"]["joined"] == 1
    assert other["containment"]["contained"] == 1
    assert other["containment"]["ratio"] == 1.0

    by_name = {}
    for ev in export["traceEvents"]:
        if ev.get("ph") == "X":
            by_name[ev["name"]] = ev
    up = by_name["upstream"]
    rep = by_name["replica r1"]
    # Same lane (the viewers nest positionally on one tid)...
    assert rep["tid"] == up["tid"]
    # ...and the replica interval sits inside upstream on the router's
    # timeline despite the 5 s clock skew.
    assert rep["ts"] >= up["ts"]
    assert rep["ts"] + rep["dur"] <= up["ts"] + up["dur"]
    assert by_name["device_compute"]["dur"] == pytest.approx(20_000, rel=0.01)
    assert rep["args"]["offset_ms"] == pytest.approx(5000.0, abs=1.0)


def test_join_fleet_trace_counts_misses_explicitly():
    cs = fleettrace.ClockSync()
    cs.observe("r1", 0.0, 0.0, 0.0)
    samples = [
        _router_sample("req-a", None, 1.0, {}, 0.01),      # no replica meta
        _router_sample("req-b", "ghost", 1.1, {}, 0.01),   # unknown replica
        _router_sample("req-c", "r2", 1.2, {}, 0.01),      # no offset yet
        _router_sample("req-d", "r1", 1.3, {}, 0.01),      # 404 at replica
    ]

    def fetch(url, rid, timeout_s):
        return None, "no_replica_trace"

    export = fleettrace.join_fleet_trace(
        samples, {"r1": "http://rep:1", "r2": "http://rep:2"}, cs,
        fetch=fetch,
    )
    r = export["otherData"]["results"]
    assert r["no_replica_meta"] == 1
    assert r["unknown_replica"] == 1
    assert r["no_offset"] == 1
    assert r["no_replica_trace"] == 1
    assert r["joined"] == 0
    assert export["otherData"]["containment"]["ratio"] is None


# ---------------------------------------------------------------------------
# scraper staleness (real HTTP, stub registry)
# ---------------------------------------------------------------------------


class _PageApp:
    def __init__(self, text):
        self.text = text

    def handle_request(self, req, rsp):
        if req.path == "/metrics":
            rsp.send(200, self.text.encode(), "text/plain; version=0.0.4")
        else:
            rsp.send_json(404, {"error": "nope"})

    def handle_protocol_error(self, exc, rsp):
        rsp.send_json(exc.code, {"error": exc.message}, close=True)


class _StubRegistry:
    def __init__(self, rows):
        self.rows = rows

    def snapshot(self):
        return self.rows


def test_fleet_scraper_marks_stale_replicas():
    httpd = EventLoopHttpServer(("127.0.0.1", 0), _PageApp(PAGE_R1))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        live = f"http://127.0.0.1:{httpd.server_address[1]}"
        dead = "http://127.0.0.1:1"  # nothing listens here
        scraper = fleetmetrics.FleetScraper(
            _StubRegistry([
                {"id": "alive", "url": live, "in_rotation": True},
                {"id": "gone", "url": dead, "in_rotation": True},
                {"id": "benched", "url": dead, "in_rotation": False},
            ]),
            timeout_s=2.0,
        )
        text, summary = scraper.render_fleet_page()
        # The dead replica is marked, never silently omitted; the
        # benched one is not in rotation, so it is not scraped at all.
        assert summary["scraped"] == ["alive"]
        assert summary["stale"] == ["gone"]
        assert validate(text) == []
        assert 'fleet_scrape_stale{replica="gone"} 1' in text
        assert 'fleet_scrape_stale{replica="alive"} 0' in text
        assert 'stub_requests_total{outcome="ok"} 10' in text
    finally:
        httpd.server_close()


# ---------------------------------------------------------------------------
# router endpoints end-to-end (stub replicas, real transport)
# ---------------------------------------------------------------------------


class _ObsStubReplica:
    """A stub replica with the telemetry surfaces the fleet plane
    consumes: /readyz echoing clock_perf, /metrics with a fixed page,
    /predict recording a real trace snapshot served back via
    /debug/requests?id=."""

    def __init__(self, rid):
        self.rid = rid
        self.traces = {}
        self.lock = threading.Lock()

    def handle_request(self, req, rsp):
        if req.path == "/readyz":
            rsp.send_json(200, {
                "ready": True, "reasons": [], "replica": self.rid,
                "version": 1, "queue_depth": 0,
                "clock_perf": time.perf_counter(),
            })
        elif req.path == "/metrics":
            rsp.send(200, PAGE_R1.encode(), "text/plain; version=0.0.4")
        elif req.path == "/debug/requests":
            rid = req.query_param("id", "")
            with self.lock:
                snap = self.traces.get(rid)
            if snap is None:
                rsp.send_json(404, {"error": "not indexed"})
            else:
                rsp.send_json(200, {"request": snap})
        elif req.path == "/predict":
            t0 = time.perf_counter()
            time.sleep(0.005)
            t1 = time.perf_counter()
            rid = req.get_header("x-request-id") or "anon"
            with self.lock:
                self.traces[rid] = {
                    "request_id": rid, "status": "ok",
                    "t_start_perf": round(t0, 6),
                    "total_seconds": round(t1 - t0, 6),
                    "phases": {
                        "parse": {"offset_seconds": 0.0, "seconds": 0.001},
                        "host_compute": {
                            "offset_seconds": 0.001,
                            "seconds": round(t1 - t0 - 0.001, 6),
                        },
                    },
                    "path": "host",
                }
            rsp.send_json(
                200, {"probability": 0.5},
                headers={"X-Replica": self.rid, "X-Model-Version": "1"},
                request_id=rid,
            )
        else:
            rsp.send_json(404, {"error": "nope"})

    def handle_protocol_error(self, exc, rsp):
        rsp.send_json(exc.code, {"error": exc.message}, close=True)


def _get_json(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_router_fleet_telemetry_endpoints():
    stubs, httpds, members = [], [], []
    for i in range(2):
        stub = _ObsStubReplica(f"r{i + 1}")
        httpd = EventLoopHttpServer(("127.0.0.1", 0), stub)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        stubs.append(stub)
        httpds.append(httpd)
        members.append(
            (stub.rid, f"http://127.0.0.1:{httpd.server_address[1]}")
        )
    router = make_router(
        port=0, replicas=members, probe_interval_s=0.1,
        request_timeout_s=5.0,
    ).start_background()
    try:
        deadline = time.monotonic() + 10
        while router.registry.ready_count() < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert router.registry.ready_count() == 2
        base = f"http://{router.address[0]}:{router.address[1]}"

        # Wait for a clock-offset estimate on every replica (one probe
        # tick each).
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(
            router.clock_sync.offset_s(rid) is None for rid, _ in members
        ):
            time.sleep(0.02)

        ids = []
        for i in range(8):
            rid = f"obs-e2e-{i}"
            req = urllib.request.Request(
                base + "/predict", data=b'{"x": 1}',
                headers={"Content-Type": "application/json",
                         "X-Request-Id": rid},
            )
            with urllib.request.urlopen(req, timeout=10.0) as resp:
                assert resp.status == 200
            ids.append(rid)

        # -- /debug/requests?id= on the router ---------------------------
        status, body = _get_json(
            base + f"/debug/requests?id={ids[0]}"
        )
        assert status == 200
        assert body["request"]["request_id"] == ids[0]
        assert body["request"]["replica"] in ("r1", "r2")
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _get_json(base + "/debug/requests?id=never-seen")
        assert exc_info.value.code == 404
        assert "error" in json.loads(exc_info.value.read())

        # -- /fleet/metrics ----------------------------------------------
        with urllib.request.urlopen(
            base + "/fleet/metrics", timeout=10.0
        ) as resp:
            page = resp.read().decode()
        assert validate(page) == []
        # Merged replica families, summed across the two stubs...
        assert 'stub_requests_total{outcome="ok"} 20' in page
        # ...the router's own families appended...
        assert "fleet_requests_total" in page
        # ...including the fleet-level SLO fed from the router's stream
        # and the scrape-health families updated by this very scrape.
        assert 'fleet_slo_requests_total{slo="availability"}' in page
        assert 'fleet_scrape_stale{replica="r1"} 0' in page

        # -- /fleet/trace -------------------------------------------------
        status, export = _get_json(base + "/fleet/trace?n=64")
        assert status == 200
        other = export["otherData"]
        assert other["joined"] >= 1
        assert other["containment"]["contained"] == other["joined"]
        cats = {
            ev.get("cat") for ev in export["traceEvents"]
            if ev.get("ph") == "X"
        }
        assert {"router", "replica"} <= cats
    finally:
        router.shutdown()
        for h in httpds:
            h.server_close()



# ===========================================================================
# the port's own parts: checkpoints, replicas, the CLI
# ===========================================================================


def _fixture_params():
    """v1: the sklearn-layout fixture imported on the CPU; v2: the same
    ensemble with the meta-learner's intercept moved by 1 (its answers
    differ by far more than the parity tolerance)."""
    from machine_learning_replications_tpu_torch.persist import load_inference_params

    p1 = load_inference_params(pkl=str(FIXTURE), device="cpu")
    meta = dataclasses.replace(p1.meta, intercept=p1.meta.intercept + 1.0)
    return p1, dataclasses.replace(p1, meta=meta)


def test_checkpoint_version_monotonic(tmp_path):
    from machine_learning_replications_tpu_torch.persist import checkpoint

    ckpt = str(tmp_path / "m")
    p1, p2 = _fixture_params()
    checkpoint.save_model(ckpt, p1)
    assert checkpoint.checkpoint_version(ckpt) == 1
    checkpoint.save_model(ckpt, p2)
    assert checkpoint.checkpoint_version(ckpt) == 2
    # The previous version is retained — WITH its id.
    assert checkpoint.checkpoint_version(checkpoint.lastgood_path(ckpt)) == 1
    params, info = checkpoint.load_model_versioned(ckpt, device="cpu")
    assert info["version"] == 2 and not info["rolled_back"]
    # The counter never moves backwards across the publish rotation.
    checkpoint.save_model(ckpt, p1)
    assert checkpoint.checkpoint_version(ckpt) == 3


def test_manifest_version_reads_a_port_checkpoint(tmp_path):
    """The router's torch-free reader and the port's checkpoint agree on
    ``integrity.json``'s version, through the publish rotation."""
    from machine_learning_replications_tpu_torch.persist import checkpoint

    ckpt = tmp_path / "m"
    assert manifest_version(ckpt) is None is checkpoint.checkpoint_version(ckpt)
    for params in _fixture_params():
        checkpoint.save_model(str(ckpt), params)
        assert manifest_version(ckpt) == checkpoint.checkpoint_version(ckpt)
        lg = checkpoint.lastgood_path(ckpt)
        assert manifest_version(lg) == checkpoint.checkpoint_version(lg)
    assert manifest_version(ckpt) == 2 and manifest_version(checkpoint.lastgood_path(ckpt)) == 1


def test_load_model_versioned_reports_rollback(tmp_path):
    from machine_learning_replications_tpu_torch.persist import checkpoint

    ckpt = str(tmp_path / "m")
    p1, p2 = _fixture_params()
    checkpoint.save_model(ckpt, p1)
    checkpoint.save_model(ckpt, p2)
    with open(os.path.join(ckpt, "tensors.npz"), "r+b") as f:  # corrupt v2's payload
        f.seek(64)
        f.write(b"\xff" * 16)
    params, info = checkpoint.load_model_versioned(ckpt, device="cpu")
    # The corrupt primary (v2) rolled back to the retained v1 — and the
    # info says so: a deploy must not report the target as shipped.
    assert info["rolled_back"] and info["version"] == 1
    assert float(params.meta.intercept) == float(p1.meta.intercept)


@pytest.fixture(scope="module")
def versioned_ckpt(tmp_path_factory):
    """A versioned port checkpoint holding params v1, plus the v2 params
    to publish mid-test, and per-version golden probabilities from the
    eager ``cli predict`` route."""
    from machine_learning_replications_tpu_torch.data.examples import patient_row
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.serve.engine import oracle_proba1

    ckpt = str(tmp_path_factory.mktemp("fleet_ckpt") / "model")
    p1, p2 = _fixture_params()
    checkpoint.save_model(ckpt, p1)
    goldens = {v: float(oracle_proba1(p, patient_row(), device="cpu")[0])
               for v, p in ((1, p1), (2, p2))}
    assert abs(goldens[1] - goldens[2]) > 1e-3
    return {"ckpt": ckpt, "p2": p2, "goldens": goldens}


def _real_replica(versioned_ckpt, rid):
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.serve import make_server

    params, info = checkpoint.load_model_versioned(versioned_ckpt["ckpt"], device="cpu")
    return make_server(
        params, port=0, buckets=(1, 8), max_wait_ms=2.0,
        model_version=info["version"], replica_id=rid,
        admin_endpoint=True, device="cpu",
    ).start_background()


def test_admin_deploy_requires_opt_in(versioned_ckpt):
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.serve import make_server

    params, info = checkpoint.load_model_versioned(versioned_ckpt["ckpt"], device="cpu")
    handle = make_server(
        params, port=0, buckets=(1,), max_wait_ms=2.0,
        model_version=info["version"], device="cpu",
    ).start_background()
    base = f"http://{handle.address[0]}:{handle.address[1]}"
    try:
        req = urllib.request.Request(
            base + "/admin/deploy",
            data=json.dumps({"model": versioned_ckpt["ckpt"]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=10)
        assert exc_info.value.code == 403
        exc_info.value.read()
    finally:
        handle.shutdown()


def test_rolling_deploy_e2e_zero_downtime(versioned_ckpt):
    """Two port replicas behind the router under continuous traffic →
    publish v2 → rolling deploy → zero failed requests, zero wrong answers
    (each reply equals its version's eager golden at the parity
    tolerance), version crossover observed, both replicas at v2."""
    from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.serve.engine import parity_tolerance

    goldens = versioned_ckpt["goldens"]
    rtol, atol = parity_tolerance(versioned_ckpt["p2"])
    replicas = [(rid, _real_replica(versioned_ckpt, rid)) for rid in ("r1", "r2")]
    router = make_router(
        port=0,
        replicas=[(rid, f"http://{h.address[0]}:{h.address[1]}") for rid, h in replicas],
        probe_interval_s=0.2, request_timeout_s=10.0, hedge_ms=300.0,
    ).start_background()
    base = f"http://{router.address[0]}:{router.address[1]}"
    stop = threading.Event()
    outcomes = {"ok": 0, "err": 0, "wrong": 0}
    versions = set()
    lock = threading.Lock()

    def traffic():
        body = json.dumps(dict(EXAMPLE_PATIENT)).encode()
        while not stop.is_set():
            try:
                req = urllib.request.Request(base + "/predict", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as resp:
                    prob = json.loads(resp.read())["probability"]
                    version = int(resp.headers["X-Model-Version"])
                with lock:
                    versions.add(version)
                    good = abs(prob - goldens[version]) <= atol + rtol * abs(goldens[version])
                    outcomes["ok" if good else "wrong"] += 1
            except Exception:
                with lock:
                    outcomes["err"] += 1
            time.sleep(0.02)

    thread = threading.Thread(target=traffic, daemon=True)
    try:
        deadline = time.monotonic() + 30
        while router.registry.ready_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.registry.ready_count() == 2
        thread.start()
        time.sleep(0.5)
        checkpoint.save_model(versioned_ckpt["ckpt"], versioned_ckpt["p2"])
        report = rolling_deploy(router.registry, versioned_ckpt["ckpt"], admin_timeout_s=300.0)
        assert report["result"] == "ok", report
        assert report["target_version"] == 2
        assert [s["achieved_version"] for s in report["replicas"]] == [2, 2]
        time.sleep(0.5)
        stop.set()
        thread.join(timeout=15)
        assert outcomes["err"] == 0 and outcomes["wrong"] == 0, outcomes
        assert outcomes["ok"] > 0 and versions == {1, 2}, (outcomes, versions)
        snap = router.registry.snapshot()
        assert all(r["version"] == 2 and r["in_rotation"] for r in snap), snap
        for _rid, handle in replicas:
            assert handle.model_version == 2
    finally:
        stop.set()
        router.shutdown()
        for _rid, handle in replicas:
            handle.shutdown()


def test_replica_spec_runs_this_package_on_the_serve_args_device():
    spec = ReplicaSpec(model="/ckpt", register_url="http://router/",
                       serve_args=("--device", "cpu"), journal_dir="/j")
    cmd = spec.command("as-1", 9001)
    assert cmd[1:4] == ["-m", "machine_learning_replications_tpu_torch", "serve"]
    assert cmd[cmd.index("--register") + 1] == "http://router"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[-1] == os.path.join("/j", "replica_as-1.jsonl")
    # the command parses as the port's serve, on the device serve_args name
    args = cli.build_parser().parse_args(cmd[3:])
    assert (args.fn, args.port, args.replica_id, args.device) == (cli.cmd_serve, 9001, "as-1", "cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_proc(*argv):
    env = {**os.environ, "PYTHONPATH": str(REPO), "MLR_TPU_PROGRESS": "0"}
    return subprocess.Popen(
        [sys.executable, "-m", "machine_learning_replications_tpu_torch", "serve", "--device",
         "cpu", "--pkl", str(FIXTURE), "--buckets", "1,8", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))


def _get(url, timeout=2.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_cli_serve_two_workers_share_one_port_and_drain_on_sigterm(tmp_path):
    port = _free_port()
    proc = _serve_proc("--port", str(port), "--workers", "2", "--journal",
                       str(tmp_path / "j.jsonl"))
    url = f"http://127.0.0.1:{port}"
    try:
        seen, deadline = {}, time.monotonic() + 120
        while len(seen) < 2:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            assert time.monotonic() < deadline, f"workers seen: {seen}"
            try:
                health = _get(url + "/healthz")   # a fresh connection each time
            except OSError:
                time.sleep(0.2)
                continue
            seen[health["worker"]] = health
        assert set(seen) == {0, 1}
        page = urllib.request.urlopen(url + "/metrics", timeout=5).read().decode()
        assert "serve_worker_info{worker=" in page
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    line = next(ln for ln in err.splitlines() if "SO_REUSEPORT workers on port" in ln)
    pids = json.loads(line.split("(pids ")[1].rstrip(")"))
    assert len(set(pids)) == 2 and proc.pid not in pids
    assert not any(_pid_alive(p) for p in pids)      # both drained and exited
    for k in (0, 1):
        recs = [json.loads(ln) for ln in open(tmp_path / f"j.jsonl.w{k}")]
        assert recs[0]["kind"] == "manifest" and recs[0]["worker"] == k
        assert recs[0]["workers"] == 2 and recs[-1]["kind"] == "run_done"


def test_cli_serve_register_then_deregister_on_sigterm(tmp_path):
    router = make_router(port=0, probe_interval_s=0.1).start_background()
    rurl = f"http://{router.address[0]}:{router.address[1]}"
    port = _free_port()
    proc = _serve_proc("--port", str(port), "--register", rurl, "--journal",
                       str(tmp_path / "j.jsonl"))
    rid = f"127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while router.registry.ready_count() < 1:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            assert time.monotonic() < deadline, "the replica never entered rotation"
            time.sleep(0.1)
        assert [r["id"] for r in router.registry.snapshot()] == [rid]
        from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT

        req = urllib.request.Request(rurl + "/predict",
                                     data=json.dumps(dict(EXAMPLE_PATIENT)).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200 and resp.headers["X-Replica"] == rid
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        router_snapshot = router.registry.snapshot()
        router.shutdown()
    assert proc.returncode == 0, err[-2000:]
    assert router_snapshot == []                       # deregistered on the way out
    kinds = [json.loads(ln) for ln in open(tmp_path / "j.jsonl")]
    reg = [r for r in kinds if r["kind"] == "replica_registered"]
    assert reg and reg[0]["replica"] == rid and reg[0]["router"] == rurl
    assert kinds[-1]["kind"] == "run_done"


def test_cli_fleet_status_prints_strict_json(capsys):
    router = make_router(port=0, probe_interval_s=0.1).start_background()
    rurl = f"http://{router.address[0]}:{router.address[1]}"
    try:
        def strict(token):
            raise ValueError(f"non-strict JSON token {token}")

        assert cli.main(["fleet", "status", "--router", rurl]) == 0
        status = json.loads(capsys.readouterr().out, parse_constant=strict)
        assert status["router"]["role"] == "fleet-router" and status["replicas"] == []
        assert cli.main(["learn", "status", "--router", rurl]) == 0
        status = json.loads(capsys.readouterr().out, parse_constant=strict)
        assert set(status) == {"router", "capture", "replicas"} and status["replicas"] == {}
    finally:
        router.shutdown()
    with pytest.raises(SystemExit, match="fleet status request"):
        cli.main(["fleet", "status", "--router", rurl])

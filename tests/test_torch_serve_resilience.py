"""Resilience of the port's server on the CPU, mirroring
``tests/test_resilience.py`` and the deploy cases of the JAX suite: the
breaker opens under injected compute faults (503 + ``Retry-After``) and the
supervisor's restart re-warms a fresh engine that gives the same answers;
the watchdog abandons a wedged flush; ``/readyz`` follows warmup and drain;
``/admin/deploy`` swaps versions and rolls back to the last-known-good; and
the checkpoint fallback's telemetry (``checkpoint_rollback``,
``resilience_checkpoint_rollbacks_total``) equals JAX's on the same
corruption.
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.obs import journal as jjournal
from machine_learning_replications_tpu.persist import orbax_io
from machine_learning_replications_tpu.persist import sklearn_import as jimport
from machine_learning_replications_tpu.resilience import lastgood as jlastgood
from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT
from machine_learning_replications_tpu_torch.models import linear
from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.persist import checkpoint
from machine_learning_replications_tpu_torch.resilience import faults, lastgood
from machine_learning_replications_tpu_torch.resilience.supervisor import SupervisedEngine
from machine_learning_replications_tpu_torch.serve import engine, make_server

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "machine_learning_replications_tpu_torch" / "persist" / "testdata" / \
    "stacking_small.pkl"
sys.path.insert(0, str(REPO / "tools"))
import validate_metrics  # noqa: E402

sys.path.pop(0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture()
def run_journal(tmp_path):
    jrn = journal.RunJournal(tmp_path / "journal.jsonl", command="test")
    journal.set_journal(jrn)
    yield jrn.path
    journal.set_journal(None)
    jrn.close()


def _events(path, kind=None):
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    return [e for e in evs if kind is None or e.get("kind") == kind]


@pytest.fixture(scope="module")
def jax_params():
    return jimport.import_stacking(jimport.decode_pickle(str(FIXTURE)))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.stacking_params_from_arrays(jax_params, device="cpu")


def _v2(p, scale=1.5):
    """A distinguishable version: the meta coefficients scaled."""
    return p.__class__(scaler=p.scaler, svc=p.svc, gbdt=p.gbdt, logreg=p.logreg,
                       meta=linear.LinearParams(coef=p.meta.coef * scale,
                                                intercept=p.meta.intercept))


def _post(url, obj, timeout=10.0, headers=None):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _serve(p, **kw):
    kw = {"port": 0, "buckets": (1, 8), "max_wait_ms": 1.0, "flush_deadline_s": 0.5,
          "breaker_failures": 2, "restart_backoff_s": 0.1, "restart_backoff_max_s": 0.5,
          "device": "cpu", **kw}
    handle = make_server(p, **kw).start_background()
    host, port = handle.address
    return handle, f"http://{host}:{port}"


@pytest.fixture()
def chaos_server(params):
    handle, url = _serve(params)
    yield handle, url
    handle.shutdown()


def _until(fn, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = fn()
        if out is not None:
            return out
        time.sleep(0.05)
    raise AssertionError("condition never held")


def test_degraded_mode_sheds_503_then_recovers_with_fresh_engine(chaos_server, run_journal):
    handle, url = chaos_server
    golden = _post(url + "/predict", dict(EXAMPLE_PATIENT))[1]["probability"]
    old = handle.engine._engine
    faults.arm("engine.compute:raise")

    def shed():
        try:
            _post(url + "/predict", dict(EXAMPLE_PATIENT))
        except urllib.error.HTTPError as exc:
            exc.read()
            if exc.code == 503:
                return dict(exc.headers)
            assert exc.code == 500               # pre-breaker failures are explicit
        return None

    headers = _until(shed)
    assert int(headers["Retry-After"]) >= 1
    status, health = _get(url + "/healthz")
    assert status == 200 and health["status"] == "degraded" and health["ready"] is False
    status, ready = _get(url + "/readyz")
    assert status == 503 and "degraded: circuit breaker open" in ready["reasons"]
    faults.reset()

    def recovered():
        try:
            return _post(url + "/predict", dict(EXAMPLE_PATIENT))[1]["probability"]
        except urllib.error.HTTPError as exc:
            exc.read()
            return None

    assert _until(recovered) == golden             # never a wrong answer
    new = handle.engine._engine
    assert new is not old and new.warm and new.trace_counts == {1: 1, 8: 1}
    assert _get(url + "/healthz")[1]["status"] == "ok"
    kinds = [e["kind"] for e in _events(run_journal)]
    assert {"breaker_open", "breaker_close", "fault_injected", "engine_restart"} <= set(kinds)


def test_wedged_flush_is_abandoned_not_hung(chaos_server):
    handle, url = chaos_server
    faults.arm("engine.compute:delay=3.0@n=1")
    t0 = time.monotonic()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/predict", dict(EXAMPLE_PATIENT))
    ei.value.read()
    assert ei.value.code in (503, 504) and time.monotonic() - t0 < 2.5

    def ok():
        try:
            return _post(url + "/predict", dict(EXAMPLE_PATIENT))[0]
        except urllib.error.HTTPError as exc:
            exc.read()
            return None

    assert _until(ok) == 200


def test_resilience_families_on_metrics_pass_strict_validator(chaos_server):
    handle, url = chaos_server
    _post(url + "/predict", dict(EXAMPLE_PATIENT))
    with urllib.request.urlopen(url + "/metrics", timeout=10.0) as resp:
        page = resp.read().decode()
    for family in ("fault_injected_total", "resilience_breaker_state",
                   "resilience_breaker_transitions_total", "resilience_engine_restarts_total",
                   "resilience_watchdog_trips_total", "resilience_degraded_sheds_total",
                   "resilience_checkpoint_rollbacks_total", "serve_warmup_seconds"):
        assert family in page, family
    assert validate_metrics.validate(page) == []


def test_debug_faults_endpoint_guard_and_control(chaos_server, monkeypatch):
    handle, url = chaos_server
    monkeypatch.setattr(faults, "_endpoint_enabled", False)
    assert _get(url + "/debug/faults")[0] == 403
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/debug/faults", {"arm": "engine.compute:raise"})
    assert ei.value.code == 403
    ei.value.read()
    monkeypatch.setattr(faults, "_endpoint_enabled", True)
    status, snap, _ = _post(url + "/debug/faults", {"arm": "batcher.flush:delay=0.001@once"})
    assert status == 200 and "batcher.flush" in snap["armed"]
    assert _post(url + "/debug/faults", {"disarm": "batcher.flush"})[1]["armed"] == {}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/debug/faults", {"arm": "nosuch.site:raise"})
    assert ei.value.code == 400
    ei.value.read()


def test_readyz_tracks_warmup_drain_and_liveness_split(params):
    handle, url = _serve(params, buckets=(1,), warmup=False)
    try:
        status, health = _get(url + "/healthz")
        assert status == 200 and health["status"] == "ok" and health["ready"] is False
        status, ready = _get(url + "/readyz")
        assert status == 503 and "warmup incomplete" in ready["reasons"]
        handle.engine.warmup()
        status, ready = _get(url + "/readyz")
        assert status == 200 and ready["ready"] is True
        handle.draining = True
        status, ready = _get(url + "/readyz")
        assert status == 503 and "draining" in ready["reasons"]
        assert _get(url + "/healthz")[1]["draining"] is True
    finally:
        handle.shutdown()


def _flip_largest_file(path):
    files = [os.path.join(path, f) for f in os.listdir(path)]
    files = [f for f in files if os.path.isfile(f)]
    best = max(files, key=os.path.getsize)
    with open(best, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))


def test_rollback_telemetry_equals_jax(tmp_path, jax_params, params):
    """The same corruption (the primary's largest payload file, first byte
    flipped) on a JAX checkpoint and on a port checkpoint: both load the
    last-known-good, count one rollback and journal one
    ``checkpoint_rollback`` with the same keys."""
    jpath, ppath = tmp_path / "jax_model", tmp_path / "port_model"
    jv2 = jax_params.replace(meta=jax_params.meta.replace(coef=np.asarray(jax_params.meta.coef) * 1.5))
    orbax_io.save_model(jpath, jax_params)
    orbax_io.save_model(jpath, jv2)
    checkpoint.save_model(ppath, params)
    checkpoint.save_model(ppath, _v2(params))
    orbax_io._corrupt_payload(str(jpath))
    _flip_largest_file(str(ppath))

    jj = jjournal.RunJournal(tmp_path / "j.jsonl", command="test")
    pj = journal.RunJournal(tmp_path / "p.jsonl", command="test")
    jjournal.set_journal(jj)
    journal.set_journal(pj)
    jbefore = jlastgood.CHECKPOINT_ROLLBACKS.get().value
    pbefore = lastgood.CHECKPOINT_ROLLBACKS.get().value
    try:
        _, jinfo = orbax_io.load_model_versioned(jpath)
        got, pinfo = checkpoint.load_model_versioned(ppath, device="cpu")
    finally:
        jjournal.set_journal(None)
        journal.set_journal(None)
        jj.close()
        pj.close()
    assert jinfo["rolled_back"] and pinfo["rolled_back"] and jinfo["version"] == pinfo["version"] == 1
    assert torch.equal(got.meta.coef, params.meta.coef)
    assert lastgood.CHECKPOINT_ROLLBACKS.get().value == pbefore + 1
    assert jlastgood.CHECKPOINT_ROLLBACKS.get().value == jbefore + 1
    (je,), (pe,) = _events(jj.path, "checkpoint_rollback"), _events(pj.path, "checkpoint_rollback")
    assert set(je) == set(pe)
    assert pe["path"] == str(ppath) and pe["lastgood"] == str(ppath) + ".lastgood"
    assert je["error"].split(":")[0] == pe["error"].split(":")[0] == "CheckpointIntegrityError"


def test_admin_deploy_swaps_version_then_rolls_back(tmp_path, params, run_journal):
    from machine_learning_replications_tpu_torch.serve.server import DEPLOYS

    # the counter is process-global: other files' deploys may share the worker
    before = {r: DEPLOYS.labels(result=r).value for r in ("ok", "rolled_back", "failed")}
    path = str(tmp_path / "model")
    assert checkpoint.save_model(path, params) == 1
    loaded, info = checkpoint.load_model_versioned(path, device="cpu")
    handle, url = _serve(loaded, model_version=info["version"], admin_endpoint=True,
                         host_path=True)
    try:
        s, v1, h = _post(url + "/predict", dict(EXAMPLE_PATIENT))
        assert h["X-Model-Version"] == "1"
        assert checkpoint.save_model(path, _v2(params)) == 2
        status, body, _ = _post(url + "/admin/deploy", {"model": path}, timeout=60)
        assert status == 200 and body["deploy"]["result"] == "ok" and body["deploy"]["version"] == 2
        s, v2, h = _post(url + "/predict", dict(EXAMPLE_PATIENT))
        assert h["X-Model-Version"] == "2" and v2["probability"] != v1["probability"]
        want = engine.oracle_proba1(_v2(params), np.asarray([list(EXAMPLE_PATIENT.values())]))[0]
        assert v2["probability"] == want
        s, hv2, h = _post(url + "/predict", dict(EXAMPLE_PATIENT), headers={"X-Serve-Path": "host"})
        assert h["X-Serve-Path"] == "host" and hv2["probability"] == want   # host scorer swapped
        # a corrupt v3: the deploy serves the last-known-good (v2), loudly
        assert checkpoint.save_model(path, _v2(params, 2.0)) == 3
        _flip_largest_file(path)
        status, body, _ = _post(url + "/admin/deploy", {"model": path}, timeout=60)
        assert body["deploy"]["result"] == "rolled_back" and body["deploy"]["version"] == 2
        assert _post(url + "/predict", dict(EXAMPLE_PATIENT))[1]["probability"] == want
        # a missing checkpoint fails and the previous engine keeps serving
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/admin/deploy", {"model": str(tmp_path / "nope")}, timeout=60)
        assert ei.value.code == 500
        ei.value.read()
        assert _post(url + "/predict", dict(EXAMPLE_PATIENT))[1]["probability"] == want
        assert _get(url + "/admin/deploy")[1]["model_version"] == 2
        page = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
        for result, n in before.items():
            assert f'serve_deploys_total{{result="{result}"}} {n + 1:g}' in page
    finally:
        handle.shutdown()
    kinds = [e["kind"] for e in _events(run_journal)]
    assert kinds.count("deploy_applied") == 2 and "deploy_failed" in kinds
    assert "checkpoint_rollback" in kinds


def test_admin_deploy_guard_and_parity_gate(tmp_path, params, monkeypatch):
    handle, url = _serve(params)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/admin/deploy", {"model": "x"})
        assert ei.value.code == 403
        ei.value.read()
        assert isinstance(handle.engine, SupervisedEngine)
        path = str(tmp_path / "m")
        checkpoint.save_model(path, _v2(params))
        # a candidate whose engine disagrees with the oracle never swaps in
        from machine_learning_replications_tpu_torch.serve import server

        real = server._oracle_probs
        monkeypatch.setattr(server, "_oracle_probs", lambda p, r: real(p, r) * 1.01)
        with pytest.raises(RuntimeError, match="parity probe"):
            handle.deploy_model(path)
        assert handle.deploy_status["result"] == "failed"
    finally:
        handle.shutdown()

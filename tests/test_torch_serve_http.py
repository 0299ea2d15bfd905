"""The port's HTTP surface (``serve/server.py``, ``cli serve``) vs the JAX
server's, on the CPU.

The two servers serve the same parameters (the committed sklearn-layout
fixture decoded by the JAX package, bridged with ``convert.py``) on a
``(1, 8)`` ladder and get the same requests: valid ones, contract
violations, unknown paths, a 404 with a body, two keep-alive requests in
one segment. They must give equal statuses and equal JSON keys, and equal
probabilities within ``parity_tolerance``. The ``serve_*`` family names on
``/metrics`` must be equal, but for the AOT families of the JAX engine
(``serve_aot_*``: the AOT analogue is not ported yet), and the port's page
must pass ``tools/validate_metrics.py``. The rest mirrors
``tests/test_serve.py`` and ``tests/test_dualpath.py`` where a case
applies: concurrent batching, request ids, the host path and its pinning,
``/debug/profile``'s single flight, ``cli serve`` in a subprocess.
"""

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

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.persist import sklearn_import as jimport
from machine_learning_replications_tpu.serve import make_server as jmake_server
from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT, patient_row
from machine_learning_replications_tpu_torch.resilience import faults
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


@pytest.fixture(scope="module")
def jax_params():
    return jimport.import_stacking(jimport.decode_pickle(str(FIXTURE)))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.stacking_params_from_arrays(jax_params, device="cpu")


def _serve(make, p, **kw):
    kw = {"port": 0, "buckets": (1, 8), "max_wait_ms": 2.0, "max_queue": 32, **kw}
    handle = make(p, **kw).start_background()
    host, port = handle.address
    return handle, f"http://{host}:{port}"


@pytest.fixture(scope="module")
def pair(jax_params, params):
    """``{"jax": (handle, url), "port": (handle, url)}``, host path off."""
    out = {"jax": _serve(jmake_server, jax_params),
           "port": _serve(make_server, params, device="cpu")}
    yield out
    for handle, _ in out.values():
        handle.shutdown()


def _request(url, method="GET", body=None, headers=None, timeout=30.0):
    """``(status, parsed JSON or text, headers)``, HTTP errors included."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        status, raw, hdrs = exc.code, exc.read(), dict(exc.headers)
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw.decode(), hdrs


def _both(pair, path, **kw):
    return {k: _request(url + path, **kw) for k, (_, url) in pair.items()}


def _patient(scale):
    return {k: float(v) * scale for k, v in EXAMPLE_PATIENT.items()}


@pytest.mark.parametrize("scale", [1.0, 0.9, 1.07, 1.2])
def test_predict_replies_equal_jax(pair, params, scale):
    got = _both(pair, "/predict", method="POST", body=_patient(scale),
                headers={"X-Request-Id": f"req-{scale}"})
    (js, jb, jh), (ps, pb, ph) = got["jax"], got["port"]
    assert js == ps == 200 and set(jb) == set(pb) == {"probability", "text"}
    rtol, atol = engine.parity_tolerance(params)
    np.testing.assert_allclose(pb["probability"], jb["probability"], rtol=rtol, atol=atol)
    assert pb["text"] == jb["text"]
    for h in (jh, ph):
        assert h["X-Request-Id"] == f"req-{scale}" and h["X-Serve-Path"] == "device"
    want = engine.oracle_proba1(params, np.asarray([list(_patient(scale).values())]))[0]
    assert pb["probability"] == want


@pytest.mark.parametrize("bad", [
    {"Not_A_Variable": 1},
    {"Dyspnea": 1},
    {**EXAMPLE_PATIENT, "Dyspnea": "severe"},
    {**EXAMPLE_PATIENT, "Ejection_Fraction": float("nan")},
    {**EXAMPLE_PATIENT, "Ejection_Fraction": float("inf")},
    [1, 2, 3],
    b"{not json",
], ids=["unknown", "missing", "non-numeric", "nan", "inf", "array", "torn"])
def test_contract_violations_equal_jax(pair, bad):
    got = _both(pair, "/predict", method="POST", body=bad)
    (js, jb, _), (ps, pb, _) = got["jax"], got["port"]
    assert js == ps == 400 and set(jb) == set(pb) == {"error"}


@pytest.mark.parametrize("path", ["/healthz", "/readyz", "/debug/requests?n=4", "/debug/quality",
                                  "/debug/alerts", "/debug/history", "/debug/history?window=x",
                                  "/debug/requests?n=x", "/debug/requests?id=nosuch",
                                  "/admin/deploy", "/nope"])
def test_get_surface_equal_jax(pair, path):
    got = _both(pair, path)
    (js, jb, _), (ps, pb, _) = got["jax"], got["port"]
    assert js == ps
    assert isinstance(pb, dict) and set(jb) == set(pb)


def test_faults_endpoint_guard_equal_jax(pair, monkeypatch):
    from machine_learning_replications_tpu.resilience import faults as jfaults

    for mod in (faults, jfaults):
        monkeypatch.setattr(mod, "_endpoint_enabled", False)
    get = _both(pair, "/debug/faults")
    post = _both(pair, "/debug/faults", method="POST", body={"arm": "engine.compute:raise"})
    assert get["jax"][0] == get["port"][0] == 403
    assert post["jax"][0] == post["port"][0] == 403
    assert faults.snapshot()["armed"] == {}


def _raw(handle, payload: bytes, until) -> bytes:
    host, port = handle.address
    with socket.create_connection((host, port), timeout=10) as s:
        s.sendall(payload)
        buf = b""
        while not until(buf):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf


def test_404_with_body_closes_connection_like_jax(pair):
    body = json.dumps(dict(EXAMPLE_PATIENT)).encode()
    req = b"POST /predic HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n%b" % (len(body), body)
    for handle, _ in pair.values():
        reply = _raw(handle, req, lambda b: False)       # read to EOF: the server closes
        assert b"404" in reply.split(b"\r\n", 1)[0]


def _bodies(buf: bytes) -> list:
    out = []
    for part in buf.split(b"HTTP/1.1 ")[1:]:
        head, _, rest = part.partition(b"\r\n\r\n")
        n = int(next(h.split(b":")[1] for h in head.split(b"\r\n")
                     if h.lower().startswith(b"content-length")))
        out.append((int(head[:3]), json.loads(rest[:n])))
    return out


def test_keepalive_pipelining_two_requests_one_segment(pair, params):
    body = json.dumps(_patient(1.1)).encode()
    req = b"POST /predict HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n%b" % (len(body), body)
    got = {}
    for name, (handle, _) in pair.items():
        buf = _raw(handle, req + req, lambda b: b.count(b"HTTP/1.1 200") >= 2 and
                   b.rstrip().endswith(b"}") and b.count(b"}") >= 2)
        got[name] = _bodies(buf)
    assert [s for s, _ in got["port"]] == [s for s, _ in got["jax"]] == [200, 200]
    rtol, atol = engine.parity_tolerance(params)
    for (_, p), (_, j) in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(p["probability"], j["probability"], rtol=rtol, atol=atol)


def _families(page: str) -> set:
    return {line.split()[2] for line in page.splitlines() if line.startswith("# TYPE ")}


def test_metrics_families_equal_jax_and_validate(pair):
    _both(pair, "/predict", method="POST", body=dict(EXAMPLE_PATIENT))
    pages = {k: v[1] for k, v in _both(pair, "/metrics").items()}
    assert validate_metrics.validate(pages["port"]) == [], validate_metrics.validate(pages["port"])
    port, jax_ = _families(pages["port"]), _families(pages["jax"])
    serve = lambda names: {n for n in names if n.startswith("serve_")}  # noqa: E731
    assert serve(port) == serve(jax_)        # the AOT families included
    assert {"serve_aot_restore_seconds", "serve_aot_fallback_total"} <= port
    assert "torch_graph_captures_total" in port and not any(n.startswith("jax_") for n in port)
    jsn = {k: v[1] for k, v in _both(pair, "/metrics?format=json").items()}
    assert set(jsn["port"]) == set(jsn["jax"])
    assert "torch_graph_captures_total" in jsn["port"]["runtime"]


def test_concurrent_requests_batch(pair, params):
    handle, url = pair["port"]
    want = engine.oracle_proba1(params, patient_row())[0]
    batches0 = handle.metrics.batches_total.value
    results, errs = [], []

    def one():
        try:
            results.append(_request(url + "/predict", "POST", dict(EXAMPLE_PATIENT))[1]["probability"])
        except Exception as exc:  # pragma: no cover - diagnostic aid
            errs.append(exc)

    threads = [threading.Thread(target=one) for _ in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    rtol, atol = engine.parity_tolerance(params)
    np.testing.assert_allclose(results, [want] * 24, rtol=rtol, atol=atol)
    assert handle.metrics.batches_total.value > batches0
    assert set(handle.engine.trace_counts) <= {1, 8}


@pytest.fixture()
def routed(params):
    handle, url = _serve(make_server, params, host_path=True, device="cpu")
    yield handle, url
    handle.shutdown()


def test_host_path_routing_pinning_and_parity(routed):
    handle, url = routed
    s, host_body, h = _request(url + "/predict", "POST", dict(EXAMPLE_PATIENT))
    assert s == 200 and h["X-Serve-Path"] == "host"
    s, dev_body, h = _request(url + "/predict", "POST", dict(EXAMPLE_PATIENT),
                              headers={"X-Serve-Path": "device"})
    assert s == 200 and h["X-Serve-Path"] == "device"
    assert host_body["probability"] == dev_body["probability"]     # one CPU: same bits
    s, _, h = _request(url + "/predict", "POST", dict(EXAMPLE_PATIENT),
                       headers={"X-Request-Deadline-Ms": "40"})
    assert h["X-Serve-Path"] == "host"
    s, health, _ = _request(url + "/healthz")
    assert health["host_path"] is True
    page = _request(url + "/metrics")[1]
    assert 'serve_path_total{path="host"}' in page and 'serve_path_total{path="device"}' in page


def test_host_failure_falls_back_to_the_device_path(routed):
    handle, url = routed
    golden = _request(url + "/predict", "POST", dict(EXAMPLE_PATIENT))[1]["probability"]
    faults.arm("engine.compute:raise@count=1")
    try:
        s, body, h = _request(url + "/predict", "POST", dict(EXAMPLE_PATIENT))
    finally:
        faults.reset()
    assert s == 200 and body["probability"] == golden and h["X-Serve-Path"] == "device"


def test_debug_profile_single_flight(pair, tmp_path):
    handle, url = pair["port"]
    handle.profile_dir = str(tmp_path)
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        _request(url + "/debug/profile?seconds=1.0"))) for _ in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.2)
    for t in threads:
        t.join()
    codes = sorted(s for s, _, _ in out)
    assert codes == [200, 409]
    art = next(b for s, b, _ in out if s == 200)
    assert art["total_bytes"] > 0 and any(f["path"].endswith("trace.json") for f in art["files"])
    assert _request(url + "/debug/profile?seconds=x")[0] == 400
    page = _request(url + "/metrics")[1]
    assert 'profile_captures_total{outcome="ok"}' in page


def test_make_server_wants_the_card_by_default(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(params, port=0)


def _cli(*argv, **kw):
    env = {**os.environ, "PYTHONPATH": str(REPO), "MLR_TPU_PROGRESS": "0"}
    return subprocess.run([sys.executable, "-m", "machine_learning_replications_tpu_torch", *argv],
                          capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO), **kw)


def test_cli_serve_refuses_unported_options():
    # what JAX's CLI refuses with --workers N, and the pickle the port lacks
    out = _cli("serve", "--device", "cpu", "--pkl", str(FIXTURE), "--workers", "2", "--port", "0")
    assert out.returncode != 0 and "fixed --port" in out.stderr
    out = _cli("serve", "--device", "cpu", "--pkl", str(FIXTURE), "--workers", "2",
               "--port", "18999", "--admin-endpoint")
    assert out.returncode != 0 and "--admin-endpoint is incompatible" in out.stderr
    out = _cli("serve", "--device", "cpu", "--pkl", str(FIXTURE), "--workers", "2",
               "--port", "18999", "--incident-dir", "inc")
    assert out.returncode != 0 and "--incident-dir is not supported" in out.stderr
    out = _cli("serve", "--device", "cpu")
    assert out.returncode != 0 and "hf_predict_model.pkl" in out.stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_subprocess_ready_predict_sigterm(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "MLR_TPU_PROGRESS": "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "machine_learning_replications_tpu_torch", "serve", "--device", "cpu",
         "--pkl", str(FIXTURE), "--port", str(port), "--buckets", "1,8",
         "--journal", str(tmp_path / "j.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            try:
                if _request(url + "/readyz", timeout=2)[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "cli serve never became ready"
            time.sleep(0.2)
        s, body, _ = _request(url + "/predict", "POST", dict(EXAMPLE_PATIENT))
        assert s == 200
        line = _cli("predict", "--device", "cpu", "--pkl", str(FIXTURE)).stdout.strip()
        assert body["text"] == line
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    kinds = [json.loads(line)["kind"] for line in open(tmp_path / "j.jsonl")]
    assert kinds[0] == "manifest" and kinds[-1] == "run_done"

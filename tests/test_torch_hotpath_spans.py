"""Spans on the port's hot paths (``obs.spans.region``), on the CPU.

The fit loop (``models.gbdt``) and the serving engine
(``serve.engine.BucketedPredictEngine``) open a non-blocking region at each
layer boundary. With a tracer installed each fit records its spans with
exact counts, nested under ``gbdt.fit`` and carrying their ``t`` /
``level``; the forests do not change with the tracer on; with no tracer
nothing is made and nothing waits. The engine records its predict, prep and
forward spans per chunk, and its graph path's copies count in
``torch_transfer_bytes_total``. The export keeps the Chrome format and
carries the tracer's two clock anchors.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.models import gbdt
from machine_learning_replications_tpu_torch.obs import spans, torchmon
from machine_learning_replications_tpu_torch.serve import engine

# (rows, depth, stages): host bins at depth 1 and 2; the fused depth-1 path
# (device binning) from gbdt.DEVICE_BINNING_MIN_ROWS rows.
REGIMES = {
    "stumps": (600, 1, 4),
    "stumps_fused": (gbdt.DEVICE_BINNING_MIN_ROWS, 1, 2),
    "depth2": (600, 2, 3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tracer_left():
    yield
    spans.set_tracer(None)


def _cohort(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 17)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 3] + rng.normal(scale=0.7, size=n)) > 0).astype(np.float32)
    return X, y


def _cfg(depth: int, stages: int) -> GBDTConfig:
    return GBDTConfig(n_estimators=stages, max_depth=depth, splitter="hist")


def _traced(fn):
    tracer = spans.Tracer("test")
    spans.set_tracer(tracer)
    try:
        out = fn()
    finally:
        spans.set_tracer(None)
    return out, tracer.export()


def _x_events(doc):
    return [e for e in doc["traceEvents"] if e["ph"] == "X"]


def _ancestors(ev, by_name):
    """The names above ``ev`` by its ``args.parent`` chain."""
    out = []
    parent = ev["args"].get("parent")
    while parent is not None:
        out.append(parent)
        parent = by_name[parent]["args"].get("parent")
    return out


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_fit_records_each_layer_with_exact_counts(regime):
    n, depth, stages = REGIMES[regime]
    X, y = _cohort(n)
    _, doc = _traced(lambda: gbdt.fit(X, y, _cfg(depth, stages), device="cpu"))
    evs = _x_events(doc)
    counts = {}
    for e in evs:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    want = {"gbdt.fit": 1, "gbdt.binning": 1, "gbdt.stage": stages, "gbdt.grad": stages,
            "gbdt.hist": depth * stages, "gbdt.split": depth * stages,
            "gbdt.route": depth * stages, "gbdt.update": stages}
    if depth >= 2:
        want["gbdt.leaf_sums"] = stages
    assert counts == want

    by_name = {e["name"]: e for e in evs}
    (fit,) = [e for e in evs if e["name"] == "gbdt.fit"]
    assert "parent" not in fit["args"]
    for e in evs:
        if e is not fit:
            assert _ancestors(e, by_name)[-1] == "gbdt.fit", e
            assert _inside(e, fit), e
    stage_ts = sorted(e["args"]["t"] for e in evs if e["name"] == "gbdt.stage")
    assert stage_ts == list(range(stages))
    for name in ("gbdt.hist", "gbdt.split", "gbdt.route"):
        levels = sorted(e["args"]["level"] for e in evs if e["name"] == name)
        assert levels == sorted(list(range(depth)) * stages)
        for e in (e for e in evs if e["name"] == name):
            assert e["args"]["parent"] == "gbdt.stage"
    for e in (e for e in evs if e["name"] == "gbdt.stage"):
        assert e["args"]["parent"] == "gbdt.fit"
        inner = [c for c in evs if c["name"] == "gbdt.hist" and _inside(c, e)]
        assert len(inner) == depth


def test_fold_fits_record_the_growers_spans():
    X, y = _cohort(300)
    masks = np.ones((3, 300), np.float32)
    masks[np.arange(3), np.arange(3)] = 0.0
    _, doc = _traced(lambda: gbdt.fit_folds(X, y, masks, _cfg(2, 2), device="cpu"))
    names = [e["name"] for e in _x_events(doc)]
    assert names.count("gbdt.stage") == 2 and names.count("gbdt.hist") == 4
    assert names.count("gbdt.leaf_sums") == 2 and "gbdt.fit" not in names


@pytest.mark.parametrize("regime", list(REGIMES))
def test_forests_are_bitwise_the_same_with_the_tracer_on(regime):
    n, depth, stages = REGIMES[regime]
    X, y = _cohort(n, seed=11)
    cfg = _cfg(depth, stages)
    off_params, off_aux = gbdt.fit(X, y, cfg, device="cpu")
    (on_params, on_aux), _ = _traced(lambda: gbdt.fit(X, y, cfg, device="cpu"))
    for field in ("feature", "threshold", "left", "right", "value", "init_raw",
                  "learning_rate"):
        assert torch.equal(getattr(off_params, field), getattr(on_params, field)), field
    a, b = off_aux["train_deviance"], on_aux["train_deviance"]
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_no_tracer_records_nothing_and_never_waits(regime, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a hot-path scope waited or recorded with no tracer")

    assert spans.get_tracer() is None
    monkeypatch.setattr(spans, "_block_pending", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(spans, "_Region", refuse)
    monkeypatch.setattr(spans, "_perf_ns", refuse)
    n, depth, stages = REGIMES[regime]
    X, y = _cohort(n)
    params, _ = gbdt.fit(X, y, _cfg(depth, stages), device="cpu")
    assert params.feature.shape[0] == stages
    a, b = spans.region("gbdt.stage", t=0), spans.region("engine.replay")
    assert a is b
    with a:
        pass


def _tree_engine(buckets=(1, 8)):
    X, y = _cohort(400, seed=3)
    params, _ = gbdt.fit(X, y, _cfg(2, 3), device="cpu")
    return engine.BucketedPredictEngine(params, buckets=buckets, device="cpu")


def test_engine_cpu_predict_records_per_chunk():
    eng = _tree_engine()
    X, _ = _cohort(11, seed=5)
    plan = eng.plan_batch(11)
    assert len(plan) > 1
    want = engine.oracle_proba1(eng.params, X)
    got, doc = _traced(lambda: eng.predict(X))
    np.testing.assert_array_equal(got, eng.predict(X))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    evs = _x_events(doc)
    names = [e["name"] for e in evs]
    assert names.count("engine.predict") == 1
    assert names.count("engine.prep") == len(plan) == names.count("engine.forward")
    (pred,) = [e for e in evs if e["name"] == "engine.predict"]
    assert all(_inside(e, pred) and e["args"]["parent"] == "engine.predict"
               for e in evs if e is not pred)
    assert sorted(e["args"]["chunk"] for e in evs if e["name"] == "engine.prep") == \
        list(range(len(plan)))
    assert not {"engine.copy_in", "engine.replay", "engine.copy_out"} & set(names)


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for a captured bucket: ``replay`` recomputes the static
    outputs from the static input, as the graph does on the card."""

    def __init__(self, eng, static_in):
        self.eng, self.static_in = eng, static_in
        self.outs = eng._forward(static_in)

    def replay(self):
        self.outs[0].copy_(self.eng._forward(self.static_in)[0])


def test_engine_copies_count_transfer_bytes(monkeypatch):
    """The graph path's copy-in counts its bytes as h2d and its copy-out
    goes through ``device.to_host`` (d2h); the AOT path's copy-in goes
    through ``torchmon.device_put``. Card streams are stubbed on the CPU."""
    eng = _tree_engine(buckets=(8,))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    eng._stream = _FakeStream()
    static_in = torch.zeros((8, 17), dtype=eng._in_dtype)
    graph = _FakeGraph(eng, static_in)
    eng._graphs[8] = engine._Graph(graph, static_in, graph.outs)
    X, _ = _cohort(8, seed=9)
    want = engine.oracle_proba1(eng.params, X)
    moved, copied_out, put = [], [], []
    monkeypatch.setattr(torchmon, "record_transfer", lambda d, n: moved.append((d, n)))
    real_to_host = engine.to_host
    monkeypatch.setattr(engine, "to_host",
                        lambda t: copied_out.append(t.numel() * t.element_size())
                        or real_to_host(t))
    got, doc = _traced(lambda: eng.predict(X))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    assert moved == [("h2d", 8 * 17 * static_in.element_size())]
    assert copied_out == [8 * graph.outs[0].element_size()]
    names = [e["name"] for e in _x_events(doc)]
    assert [n for n in names if n.startswith("engine.")] == [
        "engine.prep", "engine.copy_in", "engine.replay", "engine.copy_out", "engine.predict"]

    real_put = torchmon.device_put
    monkeypatch.setattr(torchmon, "device_put",
                        lambda x, d: put.append(np.asarray(x).nbytes) or real_put(x, d))
    eng._aot_execs[8] = eng._forward
    copied_out.clear()
    got_aot = eng.predict(X)
    np.testing.assert_array_equal(got_aot, got)
    assert put == [8 * 17 * 8]  # the float64 host rows, as they cross
    assert copied_out == [8 * graph.outs[0].element_size()]


def test_export_keeps_the_chrome_format_and_carries_both_anchors():
    before = time.time_ns()
    tr = spans.Tracer("anchors")
    spans.set_tracer(tr)
    with spans.region("outer", t=3):
        with spans.span("inner") as sp:
            sp.note(rows=2)
    spans.set_tracer(None)
    t = time.perf_counter()
    tr.add_complete_event("ext", t, t + 0.001, args={"k": 1})
    doc = tr.export()
    after = time.time_ns()
    assert doc["displayTimeUnit"] == "ms"
    evs = {e["name"]: e for e in _x_events(doc)}
    assert set(evs) == {"outer", "inner", "ext"}
    for e in evs.values():
        assert set(e) == {"name", "ph", "cat", "pid", "tid", "ts", "dur", "args"}
    assert evs["outer"]["args"] == {"t": 3}
    assert evs["inner"]["args"] == {"rows": 2, "parent": "outer"}
    assert _inside(evs["inner"], evs["outer"])
    assert evs["ext"]["dur"] == pytest.approx(1000.0, abs=1.0)
    assert sp.seconds == pytest.approx(evs["inner"]["dur"] * 1e-6, abs=2e-6)
    (p0, u0), (p1, u1) = doc["otherData"]["anchors"]
    assert before <= u0 <= u1 <= after and p0 <= p1
    assert doc["otherData"]["epoch_unix_s"] == u0 / 1e9
    # ts counts from the first anchor's perf_counter_ns, in microseconds
    assert evs["outer"]["ts"] >= 0.0
    assert evs["outer"]["ts"] * 1e3 + p0 <= p1
    (meta,) = [e for e in doc["traceEvents"]
               if e["name"] == "thread_name" and e["tid"] == evs["outer"]["tid"]]
    assert meta["args"]["native_tid"] == threading.get_native_id()
    assert doc["otherData"]["dropped_events"] == 0


def test_region_ring_is_bounded_and_threads_keep_their_stacks():
    tr = spans.Tracer(max_events=8)
    spans.set_tracer(tr)
    barrier = threading.Barrier(2)

    def worker(tag):
        with spans.region(f"root-{tag}"):
            barrier.wait(timeout=5)
            with spans.region(f"leaf-{tag}"):
                pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    evs = {e["name"]: e for e in _x_events(tr.export())}
    assert evs["leaf-0"]["args"]["parent"] == "root-0"
    assert evs["leaf-1"]["args"]["parent"] == "root-1"
    assert evs["leaf-0"]["tid"] != evs["leaf-1"]["tid"]
    for i in range(10):
        with spans.region("r", i=i):
            pass
    doc = tr.export()
    assert [e["args"]["i"] for e in _x_events(doc)] == list(range(2, 10))
    assert doc["otherData"]["dropped_events"] == 6

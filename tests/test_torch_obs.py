"""The port's run-observability layer vs the JAX package's ``obs/`` and
``utils/{trace,plots}``: spans, the registry, the journal, ``torchmon``,
the stage runner's telemetry and the catalog.

Counterparts of ``tests/test_obs.py``: span nesting and Chrome-trace export,
per-thread stacks, a failing device wait, the bounded buffer, the registry's
exposition (byte-equal to the JAX registry's for the same operations, and
accepted by ``tools/validate_metrics.py``), the journal manifest,
``stage_scope``'s stderr lines and events (equal to JAX's but for the
timestamps), and the no-journal no-op. Then what is the port's own: the
catalog held to the code in both directions, ``torchmon``'s hooks, and
``persist.checkpoint.StageCheckpointer`` reporting through ``stage_scope``.
"""

import ast
import hashlib
import json
import os
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.obs import journal as jjournal
from machine_learning_replications_tpu.obs import registry as jregistry
import machine_learning_replications_tpu_torch as port
from machine_learning_replications_tpu_torch.obs import catalog, journal, registry, spans, torchmon
from machine_learning_replications_tpu_torch.persist import checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
try:
    import validate_metrics
finally:
    sys.path.pop(0)

PORT_DIR = Path(port.__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x_events(doc):
    return [e for e in doc["traceEvents"] if e["ph"] == "X"]


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_nesting_and_chrome_trace_export(tmp_path):
    tr = spans.Tracer("test-proc")
    with tr.span("outer", stage="fit") as outer:
        outer.note(rows=128)
        time.sleep(0.002)
        with tr.span("inner"):
            time.sleep(0.002)
        with tr.span("inner2"):
            pass

    doc = json.loads(json.dumps(tr.export()))  # strict JSON round-trip
    evs = {e["name"]: e for e in _x_events(doc)}
    assert set(evs) == {"outer", "inner", "inner2"}
    out, inn = evs["outer"], evs["inner"]
    assert inn["tid"] == out["tid"] and inn["pid"] == out["pid"]
    assert inn["ts"] >= out["ts"]
    assert inn["ts"] + inn["dur"] <= out["ts"] + out["dur"]
    assert inn["args"]["parent"] == "outer"
    assert evs["inner2"]["args"]["parent"] == "outer"
    assert out["args"] == {"stage": "fit", "rows": 128}

    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in meta}

    path = tr.write(tmp_path / "sub" / "trace.json")
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["displayTimeUnit"] == "ms"
    assert len(_x_events(on_disk)) == 3


def test_spans_are_thread_aware():
    tr = spans.Tracer()
    barrier = threading.Barrier(2)

    def worker(tag):
        with tr.span(f"root-{tag}"):
            barrier.wait(timeout=5)
            with tr.span(f"leaf-{tag}"):
                pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = {e["name"]: e for e in _x_events(tr.export())}
    assert evs["leaf-0"]["args"]["parent"] == "root-0"
    assert evs["leaf-1"]["args"]["parent"] == "root-1"
    assert evs["leaf-0"]["tid"] != evs["leaf-1"]["tid"]


def test_span_stack_survives_wait_failure(monkeypatch):
    """A raising device wait must still pop the thread's span stack and
    record the event."""

    def bad_wait(pending):
        if pending:
            raise RuntimeError("device error")

    tr = spans.Tracer()
    monkeypatch.setattr(spans, "_block_pending", bad_wait)
    with pytest.raises(RuntimeError, match="device error"):
        with tr.span("failing") as sp:
            sp.block(torch.ones(2))
    monkeypatch.undo()
    with tr.span("after"):
        pass
    evs = {e["name"]: e for e in _x_events(tr.export())}
    assert set(evs) == {"failing", "after"}
    assert "parent" not in evs["after"]["args"]  # stack was popped


def test_tracer_event_buffer_is_bounded():
    tr = spans.Tracer(max_events=10)
    for i in range(25):
        with tr.span(f"s{i}"):
            pass
    doc = tr.export()
    xs = _x_events(doc)
    assert len(xs) == 10
    assert [e["name"] for e in xs] == [f"s{i}" for i in range(15, 25)]
    assert doc["otherData"]["dropped_events"] == 15
    assert any(e["name"] == "thread_name" for e in doc["traceEvents"])


def test_module_span_no_tracer_still_waits(monkeypatch):
    """Without an active tracer the module-level span records nothing but
    still waits for the registered work at exit; CPU tensors need no
    synchronize."""
    waited = []
    real = spans._block_pending
    monkeypatch.setattr(spans, "_block_pending", lambda p: (waited.append(list(p)), real(p)))
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    assert spans.get_tracer() is None
    with spans.span("unrecorded") as sp:
        out = sp.block(torch.ones(4) * 3)
    assert float(out.sum()) == 12.0
    assert len(waited) == 1 and waited[0][0] is out
    assert synced == []


def test_cuda_devices_of_a_registered_tree():
    """The device wait walks tensors inside dataclasses, mappings and
    sequences; CPU tensors contribute no device."""
    from machine_learning_replications_tpu_torch.models.linear import LinearParams

    found = set()
    spans._cuda_devices([LinearParams(torch.ones(2), torch.zeros(())), {"a": (torch.ones(1),)},
                         3.0, None], found)
    assert found == set()


# ---------------------------------------------------------------------------
# registry: the JAX registry's exposition, byte for byte
# ---------------------------------------------------------------------------


def _exercise(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("demo_bytes_total", "Bytes.", labels=("direction",))
    c.inc(10, direction="h2d")
    c.inc(5, direction="d2h")
    c.inc(0.5, direction="d2h")
    g = reg.gauge("demo_depth", "Depth.")
    g.get().set(3)
    e = reg.gauge("esc", "e\nwith a newline", labels=("k",))
    e.set(1.0, k='a"b\\c\nd')
    e.set(float("nan"), k="nan")
    e.set(float("inf"), k="inf")
    h = reg.histogram("demo_lat_seconds", "Latency.", buckets=(0.1, 1.0), labels=("route",))
    h.observe(0.05, route="a")
    h.observe(2.0, route="a")
    h.labels(route="b").observe_many([0.2, 0.3, 5.0])
    u = reg.histogram("demo_unlabeled_seconds", "U.", buckets=(1.0,))
    u.observe(0.5)
    n = reg.counter("neg_total", "n")
    n.get().inc(2)
    return reg, h.labels(route="b")


def test_registry_exposition_equals_jax():
    (reg, hb), (jreg, jhb) = _exercise(registry), _exercise(jregistry)
    text = reg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert validate_metrics.validate(text) == []
    assert json.dumps(reg.snapshot()) == json.dumps(jreg.snapshot())
    assert 'demo_bytes_total{direction="h2d"} 10' in text
    assert 'esc{k="a\\"b\\\\c\\nd"} 1.0' in text
    assert 'demo_lat_seconds_bucket{route="a",le="+Inf"} 2' in text
    assert hb.quantile(0.5) == jhb.quantile(0.5) and hb.quantile([0.1, 0.9]) == \
        jhb.quantile([0.1, 0.9])


def test_registry_families_and_errors():
    reg = registry.MetricsRegistry()
    c = reg.counter("demo_bytes_total", "Bytes.", labels=("direction",))
    assert reg.counter("demo_bytes_total", "Bytes.", labels=("direction",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("demo_bytes_total", "clash")
    with pytest.raises(ValueError, match="expected labels"):
        c.inc(1, wrong="x")
    with pytest.raises(ValueError):
        reg.counter("0bad", "name")
    with pytest.raises(ValueError):
        reg.counter("neg_total", "n").get().inc(-1)
    snap = reg.snapshot()
    assert snap == {"demo_bytes_total": {}, "neg_total": 0}
    assert registry.MetricsRegistry().render_prometheus() == ""


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------


def test_journal_manifest_first_with_provenance(tmp_path):
    p = tmp_path / "runs" / "run.jsonl"
    with journal.RunJournal(p, command="train", config_json='{"gbdt": 1}') as j:
        j.event("stage_start", stage="impute")
    recs = _read_jsonl(p)
    man = recs[0]
    assert man["kind"] == "manifest" and man["command"] == "train"
    assert len(man["git_sha"]) == 40          # this repo is a git checkout
    assert man["config_hash"] == journal.config_hash('{"gbdt": 1}') == \
        jjournal.config_hash('{"gbdt": 1}')
    assert man["versions"] == {"machine_learning_replications_tpu_torch": port.__version__,
                               "torch": torch.__version__, "cuda": torch.version.cuda}
    assert ("device" in man) == torch.cuda.is_available()
    assert set(jjournal.run_manifest("x")) - {"versions"} <= set(man) | {"device"}
    assert man["ts"].endswith("Z") and "T" in man["ts"]
    assert recs[1]["kind"] == "stage_start"


def test_git_sha_outside_a_checkout_is_empty(tmp_path):
    assert journal._git_sha(str(tmp_path)) == {}


def _stage_lines(mod_journal, mod_spans, tmp_path, capsys):
    j = mod_journal.RunJournal(tmp_path / f"{mod_journal.__name__}.jsonl", command="test")
    mod_journal.set_journal(j)
    tr = mod_spans.Tracer()
    mod_spans.set_tracer(tr)
    try:
        with mod_journal.stage_scope("impute"):
            pass
        with mod_journal.stage_scope("member_gbdt", done_suffix=" (checkpointed)"):
            pass
        with pytest.raises(RuntimeError, match="boom"):
            with mod_journal.stage_scope("select"):
                raise RuntimeError("boom")
    finally:
        mod_spans.set_tracer(None)
        mod_journal.set_journal(None)
        j.close()
    err = capsys.readouterr().err
    stamp = re.compile(r"^\[pipeline \d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}Z\] ")
    lines = err.strip().splitlines()
    assert all(stamp.match(line) for line in lines)
    events = [{k: v for k, v in r.items() if k not in ("ts", "seconds")}
              for r in _read_jsonl(j.path)[1:]]
    return [stamp.sub("", line) for line in lines], events, [e["name"] for e in _x_events(
        tr.export())]


def test_stage_scope_lines_and_events_equal_jax(tmp_path, capsys):
    from machine_learning_replications_tpu.obs import spans as jspans

    got = _stage_lines(journal, spans, tmp_path, capsys)
    want = _stage_lines(jjournal, jspans, tmp_path, capsys)
    assert got == want
    lines, events, names = got
    assert "stage 'impute' done in 0.0s" in lines
    assert "stage 'member_gbdt' done in 0.0s (checkpointed)" in lines
    assert [(e["kind"], e["stage"]) for e in events] == [
        ("stage_start", "impute"), ("stage_done", "impute"),
        ("stage_start", "member_gbdt"), ("stage_done", "member_gbdt"),
        ("stage_start", "select"), ("stage_error", "select"),
    ]
    assert names == ["stage:impute", "stage:member_gbdt", "stage:select"]


def test_stage_say_opt_out(monkeypatch, capsys):
    from machine_learning_replications_tpu_torch.utils.trace import stage_say

    monkeypatch.setenv("MLR_TPU_PROGRESS", "0")
    stage_say("quiet")
    assert capsys.readouterr().err == ""


def test_module_event_noop_without_journal():
    assert journal.get_journal() is None
    journal.event("run_done")  # must not raise


def test_run_manifest_imports_no_jax():
    import subprocess

    code = ("import json, sys\n"
            "before = set(sys.modules)\n"
            "from machine_learning_replications_tpu_torch.obs.journal import run_manifest\n"
            "m = run_manifest(command='bench', config_json='{}')\n"
            "added = set(sys.modules) - before\n"
            "print(json.dumps({'jax': sorted(k for k in added if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax')), 'sha': m['git_sha'], 'hash': m['config_hash']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(PORT_DIR.parent), check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["jax"] == [] and len(got["sha"]) == 40 and got["hash"]


# ---------------------------------------------------------------------------
# torchmon
# ---------------------------------------------------------------------------


def test_torchmon_install_is_idempotent_and_binds_one_registry():
    fams = torchmon.install()
    assert torchmon.install() is fams
    assert torchmon.install(registry.REGISTRY) is fams
    with pytest.raises(ValueError, match="different registry"):
        torchmon.install(registry.MetricsRegistry())
    names = {f.name for f in registry.REGISTRY.families()}
    assert {k for k in catalog.METRICS if k.startswith("torch_")} <= names


def test_torchmon_hooks_feed_the_families():
    torchmon.install()
    before = torchmon.totals()
    torchmon.record_graph_capture()
    torchmon.record_kernel_build(0.25)
    torchmon.record_launch("node_histograms")
    torchmon.record_launch("node_histograms")
    torchmon.record_row_passes("node_histograms", 84)
    torchmon.record_transfer("h2d", 128)
    after = torchmon.totals()
    assert after["torch_graph_captures_total"] == before["torch_graph_captures_total"] + 1
    assert after["torch_kernel_builds_total"] == before["torch_kernel_builds_total"] + 1
    assert after["torch_kernel_build_seconds_total"] >= \
        before["torch_kernel_build_seconds_total"] + 0.249
    launches = before["torch_kernel_launches_total"].get("node_histograms", 0)
    assert after["torch_kernel_launches_total"]["node_histograms"] == launches + 2
    passes = before["torch_kernel_row_passes_total"].get("node_histograms", 0)
    assert after["torch_kernel_row_passes_total"]["node_histograms"] == passes + 84
    h2d = before["torch_transfer_bytes_total"].get("h2d", 0)
    assert after["torch_transfer_bytes_total"]["h2d"] == h2d + 128
    text = registry.REGISTRY.render_prometheus()
    assert 'torch_kernel_launches_total{kernel="node_histograms"}' in text
    assert 'torch_kernel_row_passes_total{kernel="node_histograms"}' in text
    assert validate_metrics.validate(text) == []
    json.dumps(after)


def test_torchmon_hooks_are_noops_before_install_and_never_raise(monkeypatch):
    monkeypatch.setattr(torchmon, "_families", {})
    torchmon.record_graph_capture()
    torchmon.record_launch("stump_histograms")
    torchmon.record_row_passes("stump_histograms", 1)
    assert torchmon.totals() == {
        "torch_graph_captures_total": 0, "torch_kernel_builds_total": 0,
        "torch_kernel_build_seconds_total": 0.0, "torch_kernel_launches_total": {},
        "torch_kernel_row_passes_total": {}, "torch_transfer_bytes_total": {}}

    class Broken:
        def labels(self, **kv):
            raise RuntimeError("broken family")

    monkeypatch.setattr(torchmon, "_families", {"graph_captures": Broken(),
                                                "kernel_launches": Broken(),
                                                "kernel_row_passes": Broken()})
    torchmon.record_graph_capture()
    torchmon.record_launch("stump_histograms")
    torchmon.record_row_passes("stump_histograms", 1)


def test_transfer_helpers_on_the_cpu_count_nothing(monkeypatch):
    seen = []
    monkeypatch.setattr(torchmon, "record_transfer", lambda d, n: seen.append((d, n)))
    t = torchmon.device_put(np.arange(4.0), torch.device("cpu"))
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    a = torchmon.device_get(t)
    assert isinstance(a, np.ndarray) and a.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert torchmon.device_get([1, 2]).tolist() == [1, 2]
    assert seen == []


# ---------------------------------------------------------------------------
# the catalog, both directions
# ---------------------------------------------------------------------------


def _literal(node):
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


def _code_names():
    """Every literal family registration and journal emit site in the port."""
    families, events = {}, []
    for path in sorted(PORT_DIR.rglob("*.py")):
        # the serving layer's fixed instruments render through their own
        # exposition path, outside the catalog (as in the JAX package)
        fixed = path.relative_to(PORT_DIR).as_posix() == "serve/metrics.py"
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            name = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(
                node.func, "id", None)
            first = _literal(node.args[0])
            if not isinstance(first, str):
                continue
            kw = {k.arg: k.value for k in node.keywords}
            where = f"{path.relative_to(PORT_DIR)}:{node.lineno}"
            if name in ("counter", "gauge", "histogram") and not fixed:
                labels = _literal(kw["labels"]) if "labels" in kw else ()
                families[first] = (name, tuple(labels), where)
            elif name == "event":
                spread = None in kw
                events.append((first, set(k for k in kw if k), spread, where))
    return families, events


def test_code_and_catalog_agree():
    cat = ast.literal_eval(ast.parse((PORT_DIR / "obs" / "catalog.py").read_text()).body[2].value)
    assert cat == catalog.METRICS
    families, events = _code_names()
    assert {k: v[:2] for k, v in families.items()} == catalog.METRICS
    emitted = {kind for kind, *_ in events}
    assert emitted == set(catalog.EVENTS), (emitted ^ set(catalog.EVENTS))
    # the AOT bundles' families (serve/engine.py) and events (persist/aot.py,
    # serve/engine.py) are registered and emitted
    assert {"serve_aot_restore_seconds", "serve_aot_fallback_total"} <= set(families)
    assert {"aot_export", "aot_restore", "aot_fallback"} <= emitted
    for kind, keys, spread, where in events:
        missing = set(catalog.EVENTS[kind]) - keys
        assert spread or not missing, f"{where}: {kind} lacks {sorted(missing)}"
    # the catalog's event entries are the JAX catalog's, name and keys; its
    # families are the JAX catalog's (kind and labels) but for the port's
    # own runtime accounting, torch_* where JAX has jax_*
    from machine_learning_replications_tpu.obs import catalog as jcatalog

    assert {k: jcatalog.EVENTS[k] for k in catalog.EVENTS} == catalog.EVENTS
    own = {k for k in catalog.METRICS if k.startswith("torch_")}
    assert not own & set(jcatalog.METRICS)
    shared = set(catalog.METRICS) - own
    assert {k: jcatalog.METRICS[k] for k in shared} == {k: catalog.METRICS[k] for k in shared}


# ---------------------------------------------------------------------------
# the stage runner reports through stage_scope
# ---------------------------------------------------------------------------


def test_stage_checkpointer_telemetry(tmp_path, capsys):
    j = journal.RunJournal(tmp_path / "j.jsonl", command="test")
    journal.set_journal(j)
    tr = spans.Tracer()
    spans.set_tracer(tr)
    try:
        timings = {}
        root = str(tmp_path / "stages")
        ck = checkpoint.StageCheckpointer(root, device="cpu", timings=timings)
        out = ck.run("a", lambda: {"x": torch.arange(3.0)})
        again = checkpoint.StageCheckpointer(root, device="cpu").run("a", lambda: None)
        assert torch.equal(again["x"], out["x"])
        with open(os.path.join(root, "a", checkpoint.SIDECAR_FILE), "w") as f:
            f.write("{")
        checkpoint.StageCheckpointer(root, device="cpu").run("a", lambda: {"x": torch.ones(1)})
        straight = checkpoint.StageCheckpointer(None, device="cpu", timings=timings)
        straight.run("b", lambda: torch.zeros(2))
        checkpoint.save_model(str(tmp_path / "m"), _tiny_linear_stack())
    finally:
        spans.set_tracer(None)
        journal.set_journal(None)
        j.close()
    assert set(timings) == {"a", "b"}
    lines = [re.sub(r"^\[pipeline [^\]]+\] ", "", ln)
             for ln in capsys.readouterr().err.strip().splitlines()]
    done_a = re.compile(r"^stage 'a' done in \d+\.\ds \(checkpointed\)$")
    assert done_a.match(lines[1]) and done_a.match(lines[5])
    assert lines == [
        "stage 'a' ...", lines[1],
        "stage 'a' restored from checkpoint",
        "stage 'a': checkpoint corrupt (CheckpointIntegrityError) — discarded, recomputing",
        "stage 'a' ...", lines[5],
        "stage 'b' ...", f"stage 'b' done in {timings['b']:.1f}s",
    ]
    recs = _read_jsonl(j.path)[1:]
    kinds = [(r["kind"], r.get("stage")) for r in recs]
    assert kinds == [
        ("stage_start", "a"), ("checkpoint_publish", None), ("stage_done", "a"),
        ("checkpoint_restore", "a"),
        ("checkpoint_corrupt", "a"),
        ("stage_start", "a"), ("checkpoint_publish", None), ("stage_done", "a"),
        ("stage_start", "b"), ("stage_done", "b"),
        ("checkpoint_publish", None),
    ]
    assert recs[1]["path"] == os.path.join(root, "a") and recs[1]["version"] == 1
    assert recs[-1]["path"] == str(tmp_path / "m") and recs[-1]["version"] == 1
    assert recs[4]["error"] == "CheckpointIntegrityError"
    assert recs[2]["checkpointed"] is True and recs[9]["checkpointed"] is False
    evs = {e["name"]: e for e in _x_events(tr.export())}
    assert set(evs) == {"stage:a", "stage:b"}


@pytest.mark.parametrize("traced", [True, False])
def test_stage_seconds_are_the_span_seconds(traced, tmp_path, capsys):
    """One clock per stage: the checkpointer's ``timings``, the stderr line,
    ``stage_done``'s seconds and the trace event's ``dur`` are the span's
    own interval (with or without a tracer), and a failing body still gets
    its seconds."""
    j = journal.RunJournal(tmp_path / "j.jsonl", command="test")
    journal.set_journal(j)
    tr = spans.Tracer() if traced else None
    spans.set_tracer(tr)
    timings = {}
    try:
        ck = checkpoint.StageCheckpointer(None, device="cpu", timings=timings)
        ck.run("slow", lambda: (time.sleep(0.03), torch.zeros(2))[1])
        with pytest.raises(RuntimeError, match="boom"):
            with journal.stage_scope("bad") as bad:
                time.sleep(0.01)
                raise RuntimeError("boom")
    finally:
        spans.set_tracer(None)
        journal.set_journal(None)
        j.close()
    assert timings["slow"] >= 0.03 and bad.seconds >= 0.01
    assert f"stage 'slow' done in {timings['slow']:.1f}s" in capsys.readouterr().err
    recs = {r["kind"]: r for r in _read_jsonl(j.path)[1:] if r["kind"] != "stage_start"}
    assert recs["stage_done"]["seconds"] == round(timings["slow"], 3)
    assert recs["stage_error"]["seconds"] == round(bad.seconds, 3)
    if traced:
        evs = {e["name"]: e for e in _x_events(tr.export())}
        assert abs(evs["stage:slow"]["dur"] * 1e-6 - timings["slow"]) < 1e-8
        assert abs(evs["stage:bad"]["dur"] * 1e-6 - bad.seconds) < 1e-8


def _tiny_linear_stack():
    from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams

    z = torch.zeros((1, 3), dtype=torch.int32)
    return TreeEnsembleParams(feature=z, threshold=torch.full((1, 3), torch.inf),
                              left=z, right=z, value=torch.zeros((1, 3)),
                              init_raw=torch.tensor(0.0), learning_rate=torch.tensor(0.1))


def test_boosting_steps_do_not_journal(tmp_path):
    j = journal.RunJournal(tmp_path / "j.jsonl", command="test")
    journal.set_journal(j)
    try:
        checkpoint.save_step(str(tmp_path / "steps"), 3, (torch.ones(2),))
    finally:
        journal.set_journal(None)
        j.close()
    assert [r["kind"] for r in _read_jsonl(j.path)] == ["manifest"]


# ---------------------------------------------------------------------------
# plots: the JAX figures' data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["roc_figure", "pr_figure"])
def test_plots_draw_the_jax_curves(which, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from machine_learning_replications_tpu.utils import plots as jplots
    from machine_learning_replications_tpu_torch.utils import plots

    rng = np.random.default_rng(3)
    y = (rng.random(120) < 0.3).astype(np.float64)
    s = np.clip(0.3 * y + rng.random(120) * 0.8, 0.0, 1.0)
    fig = getattr(plots, which)(y, s, out_path=tmp_path / "p.png")
    jfig = getattr(jplots, which)(y, s)
    try:
        assert (tmp_path / "p.png").stat().st_size > 0
        ax, jax_ = fig.axes[0], jfig.axes[0]
        assert ax.get_title() == jax_.get_title()
        assert ax.get_legend().get_texts()[0].get_text() == \
            jax_.get_legend().get_texts()[0].get_text()
        for got, want in zip(ax.lines, jax_.lines):
            np.testing.assert_allclose(got.get_xydata(), want.get_xydata(), rtol=1e-12, atol=1e-15)
        for got, want in zip(ax.collections, jax_.collections):
            for pg, pw in zip(got.get_paths(), want.get_paths()):
                np.testing.assert_allclose(pg.vertices, pw.vertices, rtol=1e-12, atol=1e-12)
    finally:
        plt.close(fig)
        plt.close(jfig)


def test_importing_plots_needs_no_matplotlib():
    import subprocess

    code = ("import sys\n"
            "import machine_learning_replications_tpu_torch.utils.plots\n"
            "assert 'matplotlib' not in sys.modules\n"
            "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(PORT_DIR.parent))
    assert out.stdout.strip() == "OK", out.stderr


def test_config_hash_of_the_same_config_equals_jax():
    from machine_learning_replications_tpu.config import ExperimentConfig as JExperimentConfig
    from machine_learning_replications_tpu_torch.config import ExperimentConfig

    raw = json.dumps({"gbdt": {"n_estimators": 5}, "svc": {"platt_cv": 2}})
    port_json = ExperimentConfig.from_json(raw).to_json()
    jax_json = JExperimentConfig.from_json(raw).to_json()
    assert port_json == jax_json
    assert journal.config_hash(port_json) == jjournal.config_hash(jax_json) == \
        hashlib.sha256(jax_json.encode()).hexdigest()

"""The manifest, the files it names, and adding a cell and a metric as files."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from hfbench import harness

ROOT = harness.ROOT
MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"][:3] == ["python3", "-m", "hfbench.run"]
    assert MAN["paths"] == ["hfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves_by_name(cell):
    r = harness.resolve(MAN, cell)
    assert r["job_path"].is_file()
    job = harness.load_module(r["job_path"], f"t_{r['config']['job']}")
    assert callable(job.setup)
    names = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert r["per_layer"], "every cell reports a per-layer metric"
    for m in r["per_layer"]:
        assert m["moves"] in names
    cfg = next(c for c in MAN["configs"] if c["name"] == r["entry"]["config"])
    assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("hfbench/")
    assert harness.load_json(ROOT / cfg["file"])["reduced"] == cfg["reduced"]
    assert set(r["cell"]["limits"]) and all(v > 0 for v in r["cell"]["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_every_metric_resolves_by_name(metric):
    read = harness.metric_reader(metric)
    assert read({"unit": "none", "calls": 0, "window_s": 0.0, "busy_s": 0.0}) is None


def _digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(harness.PACKAGE, tmp_path / "hfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "hfbench")
    pkg = tmp_path / "hfbench"
    cell = dict(harness.load_json(pkg / "workloads" / "gbdt_10m.fit_depth3.json"), max_depth=2)
    (pkg / "workloads" / "gbdt_10m.fit_depth2.json").write_text(json.dumps(cell))
    (pkg / "metrics" / "fit.launches_per_fit.py").write_text(
        "def read(s):\n"
        "    n = sum(s.get('launches', {}).values())\n"
        "    return n / s['calls'] if n and s['calls'] else None\n")
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "gbdt_10m.fit_depth2", "config": "gbdt_10m",
                             "traffic": "fit_depth2", "chips": 1, "why": "depth 2"})
    for m in man["end_to_end"]:
        if m["name"] == "fit_s":
            m["workloads"].append("gbdt_10m.fit_depth2")
    man["per_layer"].append({"name": "fit.launches_per_fit", "unit": "launches",
                             "better": "lower", "source": "program_counter",
                             "layer": "kernel", "moves": "fit_s",
                             "workloads": ["gbdt_10m.fit_depth2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    r = harness.resolve(harness.manifest(tmp_path), "gbdt_10m.fit_depth2", pkg)
    assert r["cell"]["max_depth"] == 2 and r["config"]["job"] == "gbdt_fit"
    assert [m["name"] for m in r["per_layer"]] == ["fit.launches_per_fit"]
    assert {m["name"] for m in r["end_to_end"]} == {"setup_s", "fit_s"}
    read = harness.metric_reader("fit.launches_per_fit", pkg)
    assert read({"launches": {"node_histograms": 400}, "calls": 2}) == 200
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "hfbench.run", "--workload",
                           "gbdt_10m.fit_stumps", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_cache_directories_are_fixed_and_inside_the_checkout():
    env = harness.cache_env()
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR"):
        assert Path(env[key]).is_relative_to(ROOT)
    assert env == harness.cache_env()

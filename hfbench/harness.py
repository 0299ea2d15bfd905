"""The benchmark's harness: resolve a cell by name, set it up, run its
window, read its trace, judge its output, and build the result line.

Everything a cell needs is found by name under the package:
``BENCHMARK.json`` (at the checkout's root) names the cell's configuration
and its metrics; ``workloads/<cell>.json`` holds its traffic and the limits
of its output check; ``configs/<config>.json`` its sizes and the ``job`` it
drives; ``jobs/<job>.py`` the driver of that entry; ``metrics/<name>.py``
one reader per per-layer metric. Adding a cell, a configuration or a metric
adds files and edits none.

A job module exposes ``setup(config, cell, seed, device) -> job``; the job
has ``unit`` (what one timed call completes), ``call(i)`` (one call, which
returns once the device has finished it), ``end_to_end(t_start, marks)``,
``trace_extras(summary)``, ``release()``, ``check()`` (each number compared
and its limit, and the count of failed calls), ``control()`` and
``calibration_calls``; the module's ``FAULTS`` name the faults its timed
path can have (``hfbench.calibrate`` and the tests read them).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "machine_learning_replications_tpu")


def cache_env(root: Path = ROOT) -> dict:
    """Every build and kernel cache in a fixed directory of the checkout."""
    base = root / "build" / "hfbench_cache"
    return {
        "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
        "TRITON_CACHE_DIR": str(base / "triton"),
        "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
        "CUDA_CACHE_PATH": str(base / "cuda"),
        "USE_FLAX": "0",
    }


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(man: dict, workload: str, package: Path = PACKAGE) -> dict:
    """Everything a cell needs, by name: its manifest entry, cell file,
    configuration, job module path, and the metric entries it reports."""
    entries = {w["name"]: w for w in man["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[workload]
    cell = load_json(package / "workloads" / f"{workload}.json")
    config = load_json(package / "configs" / f"{entry['config']}.json")
    for key in ("config", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{workload}: {key} is {cell[key]!r} in its cell file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return {"entry": entry, "cell": cell, "config": config,
            "job_path": package / "jobs" / f"{config['job']}.py",
            "end_to_end": e2e, "per_layer": per_layer}


def metric_reader(name: str, package: Path = PACKAGE):
    return load_module(package / "metrics" / f"{name}.py", f"hfbench_metric_{name}").read


def window(job, seconds: float) -> tuple[float, list]:
    """Calls back to back until ``seconds`` have passed: ``(t_start,
    [(start, end), ...])`` on the host's clock. The last call is the first
    to end past the window, so every call is whole."""
    marks = []
    t_start = time.perf_counter()
    end = t_start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        job.call(i)
        t1 = time.perf_counter()
        marks.append((t0, t1))
        i += 1
        if t1 >= end:
            return t_start, marks


def traced_window(job, seconds: float) -> tuple[float, list, dict]:
    """``window`` under the profiler (the card's activity alone), and the
    trace read into a summary."""
    from torch.profiler import ProfilerActivity, profile

    from hfbench import trace

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall0 = time.time_ns()
        t_start, marks = window(job, seconds)
    events = trace.device_events(prof)
    summary = trace.summarize(events, t_start, marks, wall0, job.unit)
    return t_start, marks, summary


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or f"nvidia-smi gave nothing ({out.returncode})"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"power limit not read: {type(exc).__name__}"


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *, device=None,
             overrides: dict | None = None, t_process: float | None = None) -> dict:
    """One run of one cell → the result (the keys of the result line, and
    ``checks``: name → (value, limit)). ``device`` None means the card;
    ``overrides`` replace configuration and cell keys (the tests' small
    sizes)."""
    import torch

    t0 = time.perf_counter() if t_process is None else t_process
    r = resolve(manifest(), workload)
    config, cell = dict(r["config"]), dict(r["cell"])
    for key, value in (overrides or {}).items():
        (cell if key in cell else config)[key] = value
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    job_mod = load_module(r["job_path"], f"hfbench_job_{config['job']}")
    job = job_mod.setup(config, cell, seed, dev)
    setup_s = time.perf_counter() - t0
    summary = None
    if trace_on:
        t_start, marks, summary = traced_window(job, min(seconds, cell["trace_seconds"]))
    else:
        t_start, marks = window(job, seconds)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    metrics: dict = {}
    breakdown = None
    if trace_on:
        job.trace_extras(summary)
        for m in r["per_layer"]:
            value = metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": summary["top_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        values = dict(job.end_to_end(t_start, marks), setup_s=setup_s)
        for m in r["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    job.release()
    t_check = time.perf_counter()
    checks, failed = job.check()
    check_s = time.perf_counter() - t_check
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": int(r["entry"]["chips"]), "memory_peak_bytes": peak}
    if trace_on:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    out = {"correct": bool(correct), "attempted": len(marks), "failed": int(failed),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["window"] = f"{window_summary(t_start, marks)}; the check took {check_s:.3f}s"
    return out


def window_summary(t_start: float, marks: list) -> str:
    """One line on the window's calls: latency quantiles and the median of
    each quarter of the window, in ms."""
    import numpy as np

    lat = np.array([b - a for a, b in marks]) * 1e3
    q = np.percentile(lat, [50, 95, 99, 100])
    quarters = [float(np.median(part)) for part in np.array_split(lat, 4) if part.size]
    return (f"window {marks[-1][1] - t_start:.3f}s, {len(marks)} calls; first call "
            f"{lat[0]:.4f} ms; latency ms p50 "
            f"{q[0]:.4f} p95 {q[1]:.4f} p99 {q[2]:.4f} max {q[3]:.4f}; quarter medians "
            + " ".join(f"{m:.4f}" for m in quarters))


def result_line(result: dict) -> str:
    """The JSON line, ``checks`` last: each number compared and its limit."""
    line = {k: v for k, v in result.items() if k not in ("checks", "window")}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result["checks"].items()}
    return json.dumps(line)


def apply_cache_env(root: Path = ROOT) -> None:
    for key, value in cache_env(root).items():
        os.environ[key] = value
        if key.endswith("_DIR") or key.endswith("_PATH"):
            Path(value).mkdir(parents=True, exist_ok=True)

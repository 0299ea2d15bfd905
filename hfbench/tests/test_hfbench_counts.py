"""The op and byte counts against hand counts at a small shape, and the
per-layer readers on a trace summary."""

from __future__ import annotations

import pytest

from hfbench import harness, trace
from hfbench.counts import gbdt, peaks, pipeline

PEAK = {"bytes": 1e3, "float32": 1e4, "float64": 1e4, "float64_tensor": 2e4}


def test_gbdt_kernel_bytes_by_hand():
    # 10 rows, 3 features, 4 bins: u8 bins 30 B, grad and hess 80 B, sums 2·3·4·4 = 96 B
    assert gbdt.stump_launch_bytes(10, 3, 4) == 30 + 80 + 96
    # node entry, K = 2: + int32 node ids 40 B, sums 4·2·3·4·4 = 384 B
    assert gbdt.node_launch_bytes(10, 3, 4, 2) == 30 + 40 + 80 + 384
    assert gbdt.kernel_bytes_per_fit(10, 3, 4, stages=5, depth=1) == 5 * 206
    assert gbdt.kernel_bytes_per_fit(10, 3, 4, stages=5, depth=2) == 5 * (
        (30 + 40 + 80 + 192) + (30 + 40 + 80 + 384))
    assert gbdt.launches_per_fit(100, 3) == {"stump_histograms": 0, "node_histograms": 300}


def test_gbdt_fit_least_by_hand():
    # binning 10·3·(4 + 1) = 150 B; per stage 3·10·4 = 120 B and, per level, 30 B of bins
    # (+ 80 B of node ids from depth 2)
    one = gbdt.fit_least(10, 3, 4, stages=2, depth=1, peaks=PEAK)
    assert one["bytes"] == 150 + 2 * (120 + 30)
    assert one["ops"] == 2 * (2 * 10 * 3 + 10 * 10)
    three = gbdt.fit_least(10, 3, 4, stages=2, depth=3, peaks=PEAK)
    assert three["bytes"] == 150 + 2 * (120 + 3 * (30 + 80))
    assert three["seconds"] == max(three["bytes"] / 1e3, three["ops"] / 1e4)


def test_pipeline_batch_by_hand():
    shape = dict(present=2, donors=3, masked=1, sv=4, F=2, trees=5, iters=1)
    impute = 3 * 1 * 3 * 2 + 2 * 1 * 3
    svc = 3 * 4 * 2 + 4 + 2 * 4 + 8 + pipeline.COUPLING_OPS
    rest = 2 * 2 + 2 * 5 + 2 * 2 + 2 * 3 + 8
    assert pipeline.batch_ops(1, **shape) == impute + svc + rest
    weights = 3 * 6 + 6 + 4 * 2 + 4 + 4 + 15 + 4 + 3 + 8
    assert pipeline.batch_bytes(1, width=6, donors=3, sv=4, F=2, trees=5) == 8 * (
        weights + 6 + 1)


def test_peaks_by_part():
    assert peaks.part_of("NVIDIA H100 80GB HBM3") == "SXM"
    assert peaks.part_of("NVIDIA H100 PCIe") == "PCIe"
    assert peaks.peaks_for("NVIDIA H100 NVL")["bytes"] == 3.9e12


def _events():
    # busy [0, 5), [7, 10), [13, 20) ms: idle 2 ms inside the first fit and
    # 3 ms inside the second
    ns = 1_000_000
    return [("histogram_kernel<1>", 0, 4 * ns), ("add", 3 * ns, 2 * ns),
            ("Memcpy DtoH", 7 * ns, 1 * ns), ("histogram_kernel<1>", 8 * ns, 2 * ns),
            ("add", 13 * ns, 7 * ns)]


MARKS = [(0.0, 0.009), (0.009, 0.021)]


def test_trace_summary_by_hand():
    s = trace.summarize(_events(), 0.0, MARKS, 10**18, "fit")
    assert s["busy_s"] == pytest.approx(0.015)
    assert s["window_s"] == pytest.approx(0.021)
    assert s["kernel_events"] == 4 and s["hand_kernel_events"] == 2
    assert s["hand_kernel_s"] == pytest.approx(0.006)
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([0.003, 0.002])
    assert [g[0] for g in s["idle_gaps"]] == ["host_in_fit_1_at_0.010000s",
                                              "host_in_fit_0_at_0.005000s"]


def test_readers_on_a_summary():
    s = trace.summarize(_events(), 0.0, MARKS, 10**18, "fit")
    s.update(launches={"stump_histograms": 2, "node_histograms": 0}, bytes_per_s=1e9,
             hand_kernel_bytes=3e6, least_s_per_call=0.001)
    read = {m["name"]: harness.metric_reader(m["name"]) for m in harness.manifest()["per_layer"]}
    assert read["fit.kernels_per_fit"](s) == 2
    assert read["kernel.stump_roofline"](s) == pytest.approx(100 * 0.003 / 0.006)
    assert read["kernel.node_roofline"](s) is None
    assert read["mfu.fit"](s) == pytest.approx(100 * 0.001 / 0.0105)
    assert read["idle_share.fit"](s) == pytest.approx(100 * (1 - 0.015 / 0.021))
    assert read["engine.device_ms_per_batch"](s) is None
    s["unit"] = "batch"
    assert read["engine.device_ms_per_batch"](s) == pytest.approx(7.5)
    assert read["idle_share.engine"](s) == pytest.approx(100 * (1 - 0.015 / 0.021))
    assert read["mfu.engine"](s) == pytest.approx(100 * 0.001 / 0.0105)

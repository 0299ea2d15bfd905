"""Reading the program's spans against the profiler's trace
(``hfbench.spanread``): attribution by correlation and the gap names on a
synthetic trace, the span readers on a summary, and one test on the card
that every hand-kernel launch of a traced stump window lands in
``gbdt.hist``."""

from __future__ import annotations

import pytest
import torch

from hfbench import harness, spanread, trace

P0, U0 = 5_000_000_000, 1_700_000_000_000_000_000   # perf_counter_ns, time_ns
MAIN, OTHER = 0x7F00_B64A_6300, 0x7F00_0000_1200     # threading.get_ident of two threads
SPANS = [  # (name, ts µs, dur µs, tid)
    ("gbdt.fit", 0.0, 1000.0, 1),
    ("gbdt.binning", 100.0, 200.0, 1),
    ("gbdt.stage", 400.0, 500.0, 1),
    ("gbdt.hist", 450.0, 150.0, 1),
    ("engine.replay", 950.0, 20.0, 1),
]


def _export():
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
             "args": {"name": "MainThread", "native_tid": 11, "ident": MAIN}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2,
             "args": {"name": "other", "native_tid": 12, "ident": OTHER}}]
    xs = [{"name": n, "ph": "X", "cat": "span", "pid": 1, "tid": tid, "ts": ts, "dur": dur,
           "args": {}} for n, ts, dur, tid in SPANS]
    return {"traceEvents": meta + xs,
            "otherData": {"anchors": [[P0, U0], [P0 + 10**9, U0 + 10**9]]}}


def us(t: float) -> int:
    """A time ``t`` µs after the trace's zero on the profiler's (wall) clock."""
    return U0 + round(t * 1e3)


KEY = spanread._thread_key(MAIN)
# correlation → (launch time, launching thread)
LAUNCHES = {1: (us(150), KEY), 2: (us(500), KEY), 3: (us(700), KEY), 4: (us(960), KEY),
            5: (us(500), spanread._thread_key(OTHER)), 6: (us(2000), KEY)}
CARD = [  # (name, start, duration, correlation)
    ("binning_kernel", us(160), 50_000, 1),
    ("histogram_kernel", us(520), 80_000, 2),
    ("Memcpy DtoH", us(710), 10_000, 3),
    ("graph_kernel_a", us(970), 5_000, 4),     # two kernels of one graph replay
    ("graph_kernel_b", us(975), 5_000, 4),
    ("side_kernel", us(1000), 1_000, 5),
    ("late_kernel", us(2010), 1_000, 6),
    ("unlaunched", us(2100), 1_000, 99),
]


def test_thread_key_is_the_runtimes_32_bit_id():
    # the CUDA runtime reported 0x7f8db64a6300 as -1236638976 (its low 32 bits, signed)
    assert spanread._thread_key(0x7F8DB64A6300) == -1236638976
    assert spanread._thread_key(0x1234) == 0x1234


def test_attribution_by_correlation_on_a_synthetic_trace():
    clock = spanread.SpanClock(_export(), us(0))
    labels = spanread.attribute(CARD, LAUNCHES, clock)
    assert labels == ["gbdt.binning", "gbdt.hist", "gbdt.stage", "engine.replay",
                      "engine.replay", None, None, None]
    spans, outside = spanread.span_summary(CARD, labels, _export())
    assert spans["gbdt.binning"] == {"count": 1, "host_s": pytest.approx(200e-6),
                                     "kernels": 1, "device_s": pytest.approx(50e-6)}
    assert spans["engine.replay"]["kernels"] == 2
    assert spans["engine.replay"]["device_s"] == pytest.approx(10e-6)
    assert spans["gbdt.stage"]["kernels"] == 0          # a copy, not a kernel
    assert spans["gbdt.stage"]["device_s"] == pytest.approx(10e-6)
    assert spans["gbdt.fit"]["kernels"] == 0 and spans["gbdt.fit"]["count"] == 1
    assert outside == {"kernels": 3, "device_s": pytest.approx(3e-6)}


def test_the_monotonic_clock_needs_no_wall_anchor():
    clock = spanread.SpanClock(_export(), P0)
    assert clock.perf_to_profiler(P0 + 123) == P0 + 123
    assert clock.innermost(KEY, P0 + 460_000) == "gbdt.hist"
    assert clock.innermost(KEY, P0 + 600_000) == "gbdt.stage"   # hist has closed
    assert clock.innermost(KEY, P0 + 999_999) == "gbdt.fit"
    assert clock.innermost(KEY, P0 + 1_000_000) is None


def test_idle_gaps_are_named_by_the_innermost_span():
    clock = spanread.SpanClock(_export(), us(0))
    t_start = P0 / 1e9

    def names(card, call_us):
        marks = [(t_start, (P0 + round(call_us * 1e3)) / 1e9)]
        labels = spanread.attribute(card, LAUNCHES, clock)
        return spanread.named_gaps(card, labels, clock, t_start, marks, "fit")

    # the card ran dry at 210, 720 and 600 µs; the host then issued the
    # histogram, the graph replay and the copy that ended each gap
    gaps = names(CARD[:5], 1500)
    assert [g[0] for g in gaps] == ["host_in_gbdt.hist_fit_0_at_0.000210s",
                                    "host_in_engine.replay_fit_0_at_0.000720s",
                                    "host_in_gbdt.stage_fit_0_at_0.000600s"]
    assert [g[1] for g in gaps] == pytest.approx([310e-6, 250e-6, 110e-6])
    # the events ending these gaps were issued with no span open
    inside = [g[0] for g in names(CARD[:7], 3000)]
    assert "host_outside_spans_fit_0_at_0.000980s" in inside
    assert "host_outside_spans_fit_0_at_0.001001s" in inside
    # a gap after the call's end lies between calls
    assert "host_between_fits_at_0.001001s" in [g[0] for g in names(CARD[:7], 1000.5)]


def test_span_readers_on_a_summary():
    read = {name: harness.metric_reader(name) for name in (
        "fit.binning_ms", "fit.leaf_sums_ms", "fit.split_route_ms",
        "engine.kernels_per_replay", "engine.host_ms_per_batch")}
    bare = {"unit": "fit", "calls": 2, "window_s": 1.0, "busy_s": 0.5}
    assert all(r(bare) is None for r in read.values())
    fit = dict(bare, spans={"gbdt.binning": {"count": 2, "host_s": 0.1, "kernels": 10,
                                             "device_s": 0.6},
                            "gbdt.split": {"count": 8, "host_s": 0.1, "kernels": 8,
                                           "device_s": 0.03},
                            "gbdt.route": {"count": 8, "host_s": 0.1, "kernels": 8,
                                           "device_s": 0.01}})
    assert read["fit.binning_ms"](fit) == pytest.approx(300.0)
    assert read["fit.split_route_ms"](fit) == pytest.approx(20.0)
    assert read["fit.leaf_sums_ms"](fit) is None
    assert read["engine.kernels_per_replay"](fit) is None
    batch = {"unit": "batch", "calls": 4, "window_s": 1.0, "busy_s": 0.5, "spans": {
        "engine.predict": {"count": 4, "host_s": 0.040, "kernels": 0, "device_s": 0.0},
        "engine.copy_out": {"count": 4, "host_s": 0.036, "kernels": 0, "device_s": 0.001},
        "engine.replay": {"count": 4, "host_s": 0.001, "kernels": 10_000, "device_s": 0.02}}}
    assert read["engine.kernels_per_replay"](batch) == 2500
    assert read["engine.host_ms_per_batch"](batch) == pytest.approx(0.75)
    assert read["fit.binning_ms"](batch) is None


@pytest.mark.cuda
def test_every_hand_kernel_launch_lands_in_gbdt_hist():
    """A traced window of small stump fits: every hand-kernel event is
    attributed to ``gbdt.hist``, as many as ``cuda_histogram.LAUNCHES``
    moved, and at most 1% of the card's busy time lies outside the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from machine_learning_replications_tpu_torch.obs import spans
    from machine_learning_replications_tpu_torch.ops import cuda_histogram

    r = harness.resolve(harness.manifest(), "gbdt_10m.fit_stumps")
    config = dict(r["config"], n_rows=200_000, n_estimators=6)
    job = harness.load_module(r["job_path"], "t_span_gbdt_fit").setup(
        config, dict(r["cell"]), 2**31 + 5, torch.device("cuda"))
    before = dict(cuda_histogram.LAUNCHES)
    tracer = spans.Tracer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans.set_tracer(tracer)
        try:
            t_start, marks = harness.window(job, 0.05)
        finally:
            spans.set_tracer(None)
    launched = sum(cuda_histogram.LAUNCHES[k] - before[k] for k in before)
    assert launched == 6 * len(marks)
    export = tracer.export()
    card, launches = spanread.profiler_events(prof)
    clock = spanread.SpanClock(export, min(t for t, _ in launches.values()))
    labels = spanread.attribute(card, launches, clock)
    hand = [label for ev, label in zip(card, labels) if trace.HAND_KERNEL in ev[0]]
    assert len(hand) == launched and set(hand) == {"gbdt.hist"}
    got, outside = spanread.span_summary(card, labels, export)
    assert got["gbdt.fit"]["count"] == len(marks)
    assert got["gbdt.hist"]["count"] == 6 * len(marks)
    busy = sum(e - s for s, e in trace.busy_intervals([ev[:3] for ev in card])) / 1e9
    assert outside["device_s"] <= 0.01 * busy, (outside, busy)

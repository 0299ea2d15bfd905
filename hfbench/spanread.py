"""The program's spans on the profiler's timeline.

The port opens a span (``obs.spans.region``) at each layer boundary of the
fit loop and the serving engine. With a ``spans.Tracer`` installed for a
traced window, each card event is attributed to the innermost span open on
the thread that issued it, at the moment it issued it. Attribution is by
CUDA correlation, not by time on the card: the card event's correlation id
names the runtime's launch record (``cudaLaunchKernel``, ``cudaGraphLaunch``,
``cudaMemcpyAsync``, ...), whose host timestamp and thread are looked up in
the spans. The kernels a CUDA graph replays carry their
``cudaGraphLaunch``'s id, so they land in the span around ``replay()``.

The spans' ``perf_counter_ns`` times are placed on the profiler's clock
through the tracer's two anchor pairs (``otherData.anchors``); the CUDA
runtime names a thread by its ``threading.get_ident`` cut to 32 bits, which
the tracer's thread metadata carries.

``traced_window`` is ``harness.traced_window`` with a tracer installed for
the window: its summary gains ``spans`` (per span name: ``count``,
``host_s``, ``kernels``, ``device_s``), ``spans_outside`` (the card events
no span holds) and idle gaps named by the span that issued the work ending
the gap (``host_in_<span>_<unit>_<i>_at_<t>s``, or
``host_outside_spans_<unit>_<i>_at_<t>s``). Run one cell with it:

    python3 -m hfbench.spanread --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
import heapq
import time

from hfbench import trace


def profiler_events(prof) -> tuple[list, dict]:
    """``(card, launches)``: the card's events as ``[(name, start_ns,
    duration_ns, correlation)]``, and the runtime's launch records as
    ``{correlation: (start_ns, thread)}``."""
    card, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            card.append((e.name(), int(e.start_ns()), int(e.duration_ns()),
                         int(e.correlation_id())))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[int(e.correlation_id())] = (int(e.start_ns()),
                                                 int(e.device_resource_id()))
    if not card:
        raise RuntimeError("the profiler recorded no event on the card")
    return card, launches


def _thread_key(ident: int) -> int:
    """A ``threading.get_ident`` as the CUDA runtime reports it: its low 32
    bits, signed."""
    low = ident & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


class SpanClock:
    """The tracer's spans on the profiler's clock, per launching thread."""

    def __init__(self, export: dict, near_ns: int) -> None:
        (p0, u0), (p1, u1) = export["otherData"]["anchors"]
        self.p0 = p0
        # The profiler stamps either the wall clock or the monotonic one:
        # take the anchor column ``near_ns`` (a profiler stamp) lies near.
        if abs(near_ns - u0) < abs(near_ns - p0):
            self.base, self.rate = u0, (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0
        else:
            self.base, self.rate = p0, 1.0
        keys = {}
        for e in export["traceEvents"]:
            if e["ph"] == "M" and e["name"] == "thread_name" and "ident" in e["args"]:
                keys[e["tid"]] = _thread_key(e["args"]["ident"])
        spans: dict[int, list] = {}
        for e in export["traceEvents"]:
            if e["ph"] == "X" and e.get("cat") == "span" and e["tid"] in keys:
                t0 = self.perf_to_profiler(p0 + round(e["ts"] * 1e3))
                t1 = self.perf_to_profiler(p0 + round((e["ts"] + e["dur"]) * 1e3))
                spans.setdefault(keys[e["tid"]], []).append((t0, t1, e["name"]))
        self._maps = {k: _innermost_map(v) for k, v in spans.items()}

    def perf_to_profiler(self, t_ns: int) -> int:
        return self.base + round((t_ns - self.p0) * self.rate)

    def innermost(self, thread: int, t_ns: int):
        """The innermost span open on ``thread`` at ``t_ns`` (the
        profiler's clock), or None."""
        m = self._maps.get(thread)
        if m is None:
            return None
        i = bisect.bisect_right(m[0], t_ns) - 1
        return m[1][i] if i >= 0 else None


def _innermost_map(spans: list) -> tuple[list, list]:
    """Nested ``[(t0, t1, name)]`` → the times where the innermost open span
    changes, and the span (or None) from each of them on."""
    times, labels, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            labels.append(stack[-1][2] if stack else None)

    for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(t0)
        stack.append((t0, t1, name))
        times.append(t0)
        labels.append(name)
    close_until(float("inf"))
    return times, labels


def attribute(card: list, launches: dict, clock: SpanClock) -> list:
    """Per card event, the innermost span open on its launching thread when
    it was issued, or None."""
    out = []
    for _, _, _, corr in card:
        launch = launches.get(corr)
        out.append(None if launch is None else clock.innermost(launch[1], launch[0]))
    return out


def span_summary(card: list, labels: list, export: dict) -> tuple[dict, dict]:
    """``(spans, outside)``: per span name its ``count`` and ``host_s`` (its
    recorded intervals) and the ``kernels`` and ``device_s`` (busy time) of
    the card events attributed to it; the same two for the events no span
    holds."""
    spans: dict[str, dict] = {}
    for e in export["traceEvents"]:
        if e["ph"] == "X" and e.get("cat") == "span":
            s = spans.setdefault(e["name"], {"count": 0, "host_s": 0.0,
                                             "kernels": 0, "device_s": 0.0})
            s["count"] += 1
            s["host_s"] += e["dur"] / 1e6
    held: dict = {}
    for ev, label in zip(card, labels):
        held.setdefault(label, []).append(ev[:3])
    outside = {"kernels": 0, "device_s": 0.0}
    for label, evs in held.items():
        s = outside if label is None else spans.setdefault(
            label, {"count": 0, "host_s": 0.0, "kernels": 0, "device_s": 0.0})
        s["kernels"] += sum(1 for name, _, _ in evs if trace.is_kernel(name))
        s["device_s"] += sum(e - s0 for s0, e in trace.busy_intervals(evs)) / 1e9
    return spans, outside


def named_gaps(card: list, labels: list, clock: SpanClock, t_start: float, marks: list,
               unit: str) -> list:
    """The breakdown's ``idle_gaps`` (the ``trace.TOP`` longest gaps between
    card events), each named by the span of the event that ended it: the
    host's work the card waited for."""
    order = sorted(range(len(card)), key=lambda i: card[i][1])
    merged = []                 # [start, end, first event's index]
    for i in order:
        s, e = card[i][1], card[i][1] + card[i][2]
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, i])
    origin = clock.perf_to_profiler(round(t_start * 1e9))
    host = [(clock.perf_to_profiler(round(a * 1e9)), clock.perf_to_profiler(round(b * 1e9)))
            for a, b in marks]
    starts = [a for a, _ in host]
    longest = heapq.nlargest(trace.TOP, ((b[0] - a[1], a[1], b[2])
                                         for a, b in zip(merged, merged[1:])))
    gaps = []
    for dur, e0, nxt in longest:
        i = bisect.bisect_right(starts, e0) - 1
        at = f"at_{(e0 - origin) / 1e9:.6f}s"
        if i < 0 or e0 >= host[i][1]:
            name = f"host_between_{unit}s_{at}"
        else:
            where = "outside_spans" if labels[nxt] is None else f"in_{labels[nxt]}"
            name = f"host_{where}_{unit}_{i}_{at}"
        gaps.append([name, dur / 1e9])
    return gaps


def add_spans(summary: dict, card: list, launches: dict, export: dict, t_start: float,
              marks: list) -> None:
    """Add ``spans`` and ``spans_outside`` to a ``trace.summarize`` summary
    and name its idle gaps by span."""
    clock = SpanClock(export, min(t for t, _ in launches.values()) if launches
                      else card[0][1])
    labels = attribute(card, launches, clock)
    summary["spans"], summary["spans_outside"] = span_summary(card, labels, export)
    summary["idle_gaps"] = named_gaps(card, labels, clock, t_start, marks, summary["unit"])


def traced_window(job, seconds: float) -> tuple[float, list, dict]:
    """``harness.traced_window`` with a ``spans.Tracer`` installed for the
    window only; the summary gains the spans (``add_spans``)."""
    from torch.profiler import ProfilerActivity, profile

    from hfbench import harness
    from machine_learning_replications_tpu_torch.obs import spans

    tracer = spans.Tracer(process_name="hfbench window")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall0 = time.time_ns()
        spans.set_tracer(tracer)
        try:
            t_start, marks = harness.window(job, seconds)
        finally:
            spans.set_tracer(None)
    export = tracer.export()
    card, launches = profiler_events(prof)
    summary = trace.summarize([ev[:3] for ev in card], t_start, marks, wall0, job.unit)
    add_spans(summary, card, launches, export, t_start, marks)
    return t_start, marks, summary


def main(argv=None) -> int:
    """One traced run of a cell with the spans read: the harness's result
    line, then a line with the span metrics (``metrics/`` readers that
    read ``spans``), the spans and the card time no span holds."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from hfbench import harness

    harness.apply_cache_env()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("hfbench.spanread: needs a CUDA device", file=sys.stderr)
        return 3
    seen = []

    def window(job, seconds):
        out = traced_window(job, seconds)
        seen.append(out[2])
        return out

    # run_cell's traced path, with the spans read: the harness's own
    # traced_window does not install a tracer
    harness.traced_window = window
    result = harness.run_cell(args.workload, args.seed, args.seconds, True)
    summary = seen[0]
    read = {}
    for path in sorted((harness.PACKAGE / "metrics").glob("*.py")):
        value = harness.metric_reader(path.stem)(summary)
        if value is not None:
            read[path.stem] = value
    print(f"# device: {harness.power_limit()}", flush=True)
    print(harness.result_line(result), flush=True)
    busy = summary["busy_s"]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "read": read,
                      "spans": summary["spans"], "spans_outside": summary["spans_outside"],
                      "outside_share": summary["spans_outside"]["device_s"] / busy
                      if busy else None, "calls": summary["calls"],
                      "launches": summary.get("launches")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

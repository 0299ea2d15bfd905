"""Reading the profiler's trace of a window.

The card's events are read from the raw kineto results: building
``key_averages()`` event trees takes minutes for a trace of a few hundred
thousand kernels, and the raw events hold all that is needed. A trace with
no card event fails: an idle card is never reported for one that was not
traced.
"""

from __future__ import annotations

import bisect
import heapq

HAND_KERNEL = "histogram_kernel"
TOP = 10


def device_events(prof) -> list[tuple[str, int, int]]:
    """``[(name, start_ns, duration_ns)]`` of the card's events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
    if not out:
        raise RuntimeError("the profiler recorded no event on the card")
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_intervals(events) -> list[tuple[int, int]]:
    """The union of the events' intervals, merged and in order."""
    spans = sorted((s, s + d) for _, s, d in events)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarize(events, t_start: float, marks: list, wall0_ns: int, unit: str) -> dict:
    """The traced window's summary, which the per-layer readers read:
    ``window_s`` (host clock, window start to the last call's end),
    ``busy_s`` (the union of the card's event intervals), ``calls``,
    ``kernel_events``, ``device_ops`` (name → [count, seconds]),
    ``hand_kernel_s`` and ``hand_kernel_events``, and the breakdown's
    ``top_ops`` and ``idle_gaps`` (the longest gaps between card events,
    named by the host call the gap falls in)."""
    ops: dict[str, list] = {}
    for name, _, dur in events:
        o = ops.setdefault(name, [0, 0.0])
        o[0] += 1
        o[1] += dur / 1e9
    merged = busy_intervals(events)
    busy = sum(e - s for s, e in merged) / 1e9
    hand = [v for k, v in ops.items() if HAND_KERNEL in k]
    # Device timestamps are the profiler's wall clock: map the host marks
    # onto it, or, where the two clocks disagree by more than a second,
    # pin the first card event to the window's start.
    first = merged[0][0]
    offset = wall0_ns if abs(first - wall0_ns) < 1e9 else first
    host = [((a - t_start) * 1e9 + offset, (b - t_start) * 1e9 + offset) for a, b in marks]
    starts = [a for a, _ in host]
    longest = heapq.nlargest(TOP, ((s1 - e0, e0) for (_, e0), (s1, _) in zip(merged, merged[1:])))
    gaps = []
    for dur, e0 in longest:
        i = bisect.bisect_right(starts, e0) - 1
        where = (f"host_in_{unit}_{i}" if i >= 0 and e0 < host[i][1]
                 else f"host_between_{unit}s")
        gaps.append([f"{where}_at_{(e0 - offset) / 1e9:.6f}s", dur / 1e9])
    return {
        "unit": unit,
        "window_s": marks[-1][1] - t_start,
        "busy_s": busy,
        "calls": len(marks),
        "kernel_events": sum(v[0] for k, v in ops.items() if is_kernel(k)),
        "device_ops": ops,
        "hand_kernel_s": sum(v[1] for v in hand),
        "hand_kernel_events": sum(v[0] for v in hand),
        "top_ops": [[k, v[1]] for k, v in sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": gaps,
    }

"""Phase timing, stage progress lines and device traces.

Port of the JAX package's ``utils/trace.py``:

  * ``PhaseTimer`` — wall-clock accounting per named phase, a thin adapter
    over ``obs.spans``: each phase is a span, and its exit waits for the
    device work the body registered, so a phase's time is real work, not
    launch time;
  * ``stage_say`` — the stage runner's timestamped stderr progress line;
  * ``device_trace`` — a ``torch.profiler`` capture around a region, written
    as a Chrome trace (``trace.json``) into a directory.

Not ported: ``nan_guard``, which switches on ``jax_debug_nans`` (raise at
the first NaN any operation produces). PyTorch has no forward-pass switch
of that kind, so it stays an open item.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator

from machine_learning_replications_tpu_torch.obs import spans


class PhaseTimer:
    """Accumulates named phase durations; phases may repeat (times sum).

    Each phase opens a span (so a run with an active tracer gets the phase
    in its trace, nested under whatever span encloses it) and the span's
    exit waits for the device work the body registered:

    >>> t = PhaseTimer()
    >>> with t.phase("fit") as ph:
    ...     result = ph.block(train())
    >>> print(t.report())
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[spans.SpanHandle]:
        t0 = time.perf_counter()
        try:
            # The span waits for registered work at ITS exit, inside this
            # timing scope.
            with spans.span(name) as ph:
                yield ph
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{'phase':<24} {'calls':>5} {'seconds':>10} {'share':>7}"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            share = s / total if total else 0.0
            lines.append(
                f"{name:<24} {self.counts[name]:>5d} {s:>10.4f} {share:>6.1%}"
            )
        lines.append(f"{'total':<24} {'':>5} {total:>10.4f}")
        return "\n".join(lines)


def stage_say(msg: str) -> None:
    """One timestamped stderr progress line of the stage runner
    (``obs.journal.stage_scope``), flushed, in the JAX package's format:
    ``[pipeline <ISO-8601 UTC>] <msg>``. Opt out with ``MLR_TPU_PROGRESS=0``
    (the JAX package's switch, so one setting quiets both)."""
    if os.environ.get("MLR_TPU_PROGRESS", "1") == "0":
        return
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    print(f"[pipeline {stamp}] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region — host operations,
    and the card's kernels when CUDA is up — and write it as a Chrome trace
    to ``<log_dir>/trace.json`` (load at https://ui.perfetto.dev)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Hierarchical, thread-aware spans with Chrome-trace-event export.

Port of the JAX package's ``obs/spans.py``. A span is a named wall-clock
interval that (a) nests — each thread keeps its own open-span stack, so
concurrent threads and the training main thread interleave without
corrupting each other's hierarchy — and (b) closes *honestly* under CUDA's
asynchronous launches: the body registers device work via the yielded
handle's ``block``, and span exit waits for it before the clock stops, so a
span's duration is real device work, not launch time (``PhaseTimer`` is a
thin adapter over this module).

The one change from the JAX module is that wait. JAX blocks on the
registered arrays themselves; here span exit calls
``torch.cuda.synchronize`` on the CUDA device of every registered tensor,
which waits for all streams of that device, not only the current one —
``ops.steps.run_blocks`` captures its graphs on a side stream, so a wait on
one stream would not cover the work. Tensors on the CPU need no wait.

Export is the Chrome trace-event format (``ph: "X"`` complete events with
microsecond timestamps): write the JSON with ``Tracer.write`` and open it
at https://ui.perfetto.dev (or ``chrome://tracing``). Parent/child
containment is positional — a child's ``[ts, ts+dur]`` lies inside its
parent's on the same ``tid`` — which is exactly how the viewers nest them.

A process-global *active* tracer (``set_tracer`` / ``get_tracer``) lets
call sites instrument unconditionally: the module-level ``span`` records
into the active tracer when one is set and otherwise only performs the
device-waiting contract (so timing semantics of enclosing timers hold
with tracing off, at no event-recording cost).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import sys
import time
from typing import Any, Iterator


def _cuda_devices(x: Any, out: set) -> None:
    """Collect the CUDA devices of every tensor in ``x`` (a tensor, or
    dataclasses, mappings and sequences of them)."""
    torch = sys.modules.get("torch")
    if torch is None:
        # No tensor can exist before torch is imported; the fleet's
        # processes (router, autoscaler) journal through here without it.
        return
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)


def _block_pending(pending: list) -> None:
    """``torch.cuda.synchronize`` each CUDA device that holds a registered
    tensor (once per device); nothing to wait for on the CPU."""
    if not pending:
        return
    devices: set = set()
    for x in pending:
        _cuda_devices(x, devices)
    for d in sorted(devices, key=str):
        sys.modules["torch"].cuda.synchronize(d)


class SpanHandle:
    """Yielded by ``span``: register device work to block on at exit, and
    attach key/value annotations that land in the trace event's ``args``.
    ``seconds`` is None while the span is open and its duration once it has
    closed (the device wait included), from the same clock reads as the
    trace event's ``dur``."""

    __slots__ = ("_pending", "args", "seconds")

    def __init__(self) -> None:
        self._pending: list[Any] = []
        self.args: dict[str, Any] = {}
        self.seconds: float | None = None

    def block(self, x: Any) -> Any:
        """Register ``x`` (a tensor, or a tree of them) to be waited for
        when the span closes, and pass it through."""
        self._pending.append(x)
        return x

    def note(self, **kv: Any) -> None:
        """Attach annotations (JSON-friendly values) to the span."""
        self.args.update(kv)


class Tracer:
    """Collects span events; one instance per run (thread-safe).

    Timestamps are microseconds from tracer construction
    (``time.perf_counter`` based — monotonic, sub-µs resolution), which is
    what the trace viewers expect; the wall-clock epoch is recorded in the
    exported ``otherData`` so events can be correlated with journal lines.

    The event buffer is BOUNDED at ``max_events`` (a ring of the most
    recent events, same bounded-over-unbounded discipline as the metrics
    latency ring): a long-lived traced serving process emits one span per
    flush forever, and an unbounded list would be a slow memory leak that
    ends in a trace file Perfetto cannot load. Evictions are counted and
    reported in the export's ``otherData.dropped_events``.
    """

    def __init__(self, process_name: str = "mlr-torch",
                 max_events: int = 250_000) -> None:
        import collections

        self._lock = threading.Lock()
        self._events: collections.deque[dict] = collections.deque()
        self._dropped = 0
        self.max_events = int(max_events)
        self._t0 = time.perf_counter()
        # Wall-clock epoch anchor for the Chrome-trace export; all
        # span math is monotonic and only display maps through this.
        self._epoch_unix = time.time()
        self._pid = os.getpid()
        self._tids: dict[int, int] = {}  # thread ident -> small stable tid
        self._vtids: dict[str, int] = {}  # virtual track name -> tid
        self._next_tid = 1
        self._meta: list[dict] = []  # process/thread names: tiny, kept whole
        self._tls = threading.local()
        self.process_name = process_name

    # -- internal ----------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = self._next_tid
                self._next_tid += 1
                self._meta.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
        return tid

    # -- merging externally-timed events ------------------------------------

    def current_tid(self) -> int:
        """The calling thread's tid in this trace (allocated on first use).
        Call sites stamp it so events recorded *later* — e.g. a sampled
        request trace emitted at completion — can land on the track where
        the work actually ran (``add_complete_event``)."""
        return self._tid()

    def virtual_tid(self, name: str) -> int:
        """A stable tid for a named *virtual* track (no OS thread behind
        it) — e.g. one lane per in-flight sampled request, so request
        timelines render as their own rows instead of interleaving with
        the handler threads that happened to carry them."""
        with self._lock:
            tid = self._vtids.get(name)
            if tid is None:
                tid = self._vtids[name] = self._next_tid
                self._next_tid += 1
                self._meta.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid, "args": {"name": name},
                })
        return tid

    def to_trace_us(self, t_perf: float) -> float:
        """A raw ``time.perf_counter()`` stamp → this trace's µs timeline."""
        return (t_perf - self._t0) * 1e6

    def add_complete_event(
        self,
        name: str,
        t0_perf: float,
        t1_perf: float,
        tid: int | None = None,
        cat: str = "span",
        args: dict | None = None,
    ) -> None:
        """Record a ``ph: "X"`` event from raw ``perf_counter`` stamps —
        the injection point for work timed outside the ``span`` context
        manager (request phases measured across threads and emitted only
        if the completed request is tail-sampled). ``tid`` defaults to the
        calling thread's track; pass a stamped ``current_tid`` /
        ``virtual_tid`` to place the event where it belongs."""
        ev = {
            "name": name, "ph": "X", "cat": cat, "pid": self._pid,
            "tid": self._tid() if tid is None else int(tid),
            "ts": round(self.to_trace_us(t0_perf), 3),
            "dur": round(max(t1_perf - t0_perf, 0.0) * 1e6, 3),
            "args": dict(args or {}),
        }
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.max_events:
                self._events.popleft()
                self._dropped += 1

    def _stack(self) -> list[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[SpanHandle]:
        handle = SpanHandle()
        handle.args.update(args)
        tid = self._tid()
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        ts = self._now_us()
        try:
            yield handle
        finally:
            # The stack pop and event record must run even when the
            # device wait raises (a CUDA error surfacing at synchronize):
            # a name left on the thread-local stack would corrupt the
            # parentage of every later span on this thread.
            try:
                _block_pending(handle._pending)
            finally:
                dur = self._now_us() - ts
                handle.seconds = dur * 1e-6
                stack.pop()
                ev_args = {
                    k: (v if isinstance(
                        v, (str, int, float, bool, type(None))) else str(v))
                    for k, v in handle.args.items()
                }
                if parent is not None:
                    ev_args.setdefault("parent", parent)
                ev = {
                    "name": name, "ph": "X", "cat": "span",
                    "pid": self._pid, "tid": tid,
                    "ts": round(ts, 3), "dur": round(dur, 3),
                    "args": ev_args,
                }
                with self._lock:
                    self._events.append(ev)
                    if len(self._events) > self.max_events:
                        self._events.popleft()
                        self._dropped += 1

    # -- export ------------------------------------------------------------

    def export(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        with self._lock:
            events = list(self._events)
            meta = list(self._meta)
            dropped = self._dropped
        meta.insert(0, {
            "name": "process_name", "ph": "M", "pid": self._pid,
            "args": {"name": self.process_name},
        })
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix_s": self._epoch_unix,
                "process": self.process_name,
                "dropped_events": dropped,
            },
        }

    def write(self, path: str | os.PathLike) -> str:
        """Write the trace JSON to ``path`` (parent dirs created); returns
        the absolute path."""
        return write_trace(path, self.export())


def write_trace(path: str | os.PathLike, trace: dict) -> str:
    """Atomically write a Chrome-trace JSON object (parent dirs created);
    returns the absolute path."""
    path = os.path.abspath(os.fspath(path))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path


# -- process-global active tracer ------------------------------------------

_active: Tracer | None = None
_active_lock = threading.Lock()


def set_tracer(tracer: Tracer | None) -> None:
    """Install (or clear, with None) the process-global active tracer."""
    global _active
    with _active_lock:
        _active = tracer


def get_tracer() -> Tracer | None:
    return _active


@contextlib.contextmanager
def span(name: str, **args: Any) -> Iterator[SpanHandle]:
    """A span on the active tracer; with no tracer installed, a no-event
    scope that still honors the ``block`` contract at exit (enclosing
    timers keep their block-on-device semantics with tracing off)."""
    tracer = _active
    if tracer is not None:
        with tracer.span(name, **args) as handle:
            yield handle
        return
    handle = SpanHandle()
    handle.args.update(args)
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        try:
            _block_pending(handle._pending)
        finally:
            handle.seconds = time.perf_counter() - t0

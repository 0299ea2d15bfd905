"""Hierarchical, thread-aware spans with Chrome-trace-event export.

Port of the JAX package's ``obs/spans.py``. A span is a named interval on
the host's clock that nests: each thread keeps its own open-span stack, so
concurrent threads and the training main thread interleave without
corrupting each other's hierarchy. Two entry points record into the same
``Tracer``:

  * ``region(name, **ids)`` — the hot-path scope (the fit loop, the serving
    engine). It never waits for the device: under CUDA's asynchronous
    launches its interval is the host's work of issuing the body, which is
    what a profiler's launch records are matched against. With no tracer
    installed it is one global read returning a shared no-op context — no
    clock read, no allocation.
  * ``span(name, **args)`` — the stage scope (``journal.stage_scope``, the
    CLI). It closes *honestly*: the body registers device work via the
    yielded handle's ``block``, and span exit waits for it before the clock
    stops, so a stage's duration is real device work, not launch time. It
    keeps that wait, and its handle's ``seconds``, with no tracer installed.

The one change from the JAX module's wait: JAX blocks on the registered
arrays themselves; here span exit calls ``torch.cuda.synchronize`` on the
CUDA device of every registered tensor, which waits for all streams of that
device, not only the current one — ``ops.steps.run_blocks`` captures its
graphs on a side stream, so a wait on one stream would not cover the work.
Tensors on the CPU need no wait.

A closed scope appends one compact record to the tracer's bounded ring; the
Chrome events are built only by ``Tracer.export`` (``ph: "X"`` complete
events with microsecond timestamps): write the JSON with ``Tracer.write``
and open it at https://ui.perfetto.dev (or ``chrome://tracing``).
Parent/child containment is positional — a child's ``[ts, ts+dur]`` lies
inside its parent's on the same ``tid`` — which is exactly how the viewers
nest them; each event's ``args.parent`` names its enclosing span.

The clock is ``time.perf_counter_ns``. The export carries two anchor pairs
``(perf_counter_ns, time_ns)``, each read back to back — one at the
tracer's construction (the trace's zero) and one at the export — so a
reader can place the spans on another clock's timeline, such as a
profiler's, and each thread's metadata carries its native thread id and its
``threading.get_ident`` (the CUDA runtime names a launching thread by the
latter, cut to 32 bits).

A process-global *active* tracer (``set_tracer`` / ``get_tracer``) lets
call sites instrument unconditionally.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import sys
import time
from collections import deque
from typing import Any, Iterator

_perf_ns = time.perf_counter_ns


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


def _anchor() -> tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read back to back: the wall read
    between two monotonic reads, of three tries the one they hold closest,
    against the midpoint of the two."""
    best = None
    for _ in range(3):
        a, u, b = _perf_ns(), time.time_ns(), _perf_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def _json_args(args: dict, parent: str | None) -> dict:
    out = {k: (v if isinstance(v, (str, int, float, bool, type(None))) else str(v))
           for k, v in args.items()}
    if parent is not None:
        out.setdefault("parent", parent)
    return out


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


class _Region:
    """One scope on a ``Tracer``: enter pushes its name on the thread's
    stack and reads the clock; exit reads the clock, pops, and appends one
    record ``(name, t0_ns, t1_ns, tid, parent, ids, cat)`` to the ring."""

    __slots__ = ("_tracer", "_name", "_ids", "_parent", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, ids: dict) -> None:
        self._tracer = tracer
        self._name = name
        self._ids = ids

    def __enter__(self) -> "_Region":
        stack = self._tracer._thread().stack
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = _perf_ns()
        tracer = self._tracer
        local = tracer._thread()
        local.stack.pop()
        tracer._record((self._name, self.t0, self.t1, local.tid, self._parent, self._ids,
                        "span"))


class Tracer:
    """Collects span records; one instance per run (thread-safe).

    Timestamps are ``time.perf_counter_ns`` reads (monotonic); the export
    gives them in microseconds from the tracer's construction, which is
    what the trace viewers expect, and carries the clock anchors
    (``otherData.anchors``) and the wall-clock epoch of the trace's zero
    (``otherData.epoch_unix_s``), so events can be correlated with journal
    lines and with a profiler's timeline.

    The record buffer is BOUNDED at ``max_events`` (a ring of the most
    recent records, same bounded-over-unbounded discipline as the metrics
    latency ring): a long-lived traced serving process emits one span per
    flush forever, and an unbounded list would be a slow memory leak that
    ends in a trace file Perfetto cannot load. Evictions are counted and
    reported in the export's ``otherData.dropped_events``.
    """

    def __init__(self, process_name: str = "mlr-torch",
                 max_events: int = 250_000) -> None:
        self._lock = threading.Lock()
        self.max_events = int(max_events)
        self._ring: deque[tuple] = deque(maxlen=self.max_events)
        self._recorded = 0
        self._anchor0 = _anchor()
        self._pid = os.getpid()
        self._tids: dict[int, int] = {}  # native thread id -> small stable tid
        self._vtids: dict[str, int] = {}  # virtual track name -> tid
        self._next_tid = 1
        self._meta: list[dict] = []  # process/thread names: tiny, kept whole
        self._tls = threading.local()
        self.process_name = process_name

    # -- internal ----------------------------------------------------------

    def _thread(self) -> threading.local:
        """The calling thread's state: ``stack`` (open span names) and
        ``tid`` (its track in this trace), made on the thread's first use."""
        local = self._tls
        if not hasattr(local, "tid"):
            native = threading.get_native_id()
            with self._lock:
                tid = self._tids.get(native)
                if tid is None:
                    tid = self._tids[native] = self._next_tid
                    self._next_tid += 1
                    self._meta.append({
                        "name": "thread_name", "ph": "M", "pid": self._pid,
                        "tid": tid,
                        "args": {"name": threading.current_thread().name,
                                 "native_tid": native, "ident": threading.get_ident()},
                    })
            local.stack = []
            local.tid = tid
        return local

    def _record(self, rec: tuple) -> None:
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1

    # -- merging externally-timed events ------------------------------------

    def current_tid(self) -> int:
        """The calling thread's tid in this trace (allocated on first use).
        Call sites stamp it so events recorded *later* — e.g. a sampled
        request trace emitted at completion — can land on the track where
        the work actually ran (``add_complete_event``)."""
        return self._thread().tid

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
        return (t_perf * 1e9 - self._anchor0[0]) / 1e3

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
        the injection point for work timed outside the span scopes
        (request phases measured across threads and emitted only if the
        completed request is tail-sampled). ``tid`` defaults to the calling
        thread's track; pass a stamped ``current_tid`` / ``virtual_tid`` to
        place the event where it belongs."""
        t0 = round(t0_perf * 1e9)
        self._record((name, t0, max(round(t1_perf * 1e9), t0),
                      self.current_tid() if tid is None else int(tid), None,
                      dict(args or {}), cat))

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[SpanHandle]:
        handle = SpanHandle()
        handle.args.update(args)
        scope = _Region(self, name, handle.args)
        scope.__enter__()
        try:
            yield handle
        finally:
            # The stack pop and the record must happen even when the device
            # wait raises (a CUDA error surfacing at synchronize): a name
            # left on the thread-local stack would corrupt the parentage of
            # every later span on this thread.
            try:
                _block_pending(handle._pending)
            finally:
                scope.__exit__(None, None, None)
                handle.seconds = (scope.t1 - scope.t0) * 1e-9

    # -- export ------------------------------------------------------------

    def export(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        anchor1 = _anchor()
        with self._lock:
            records = list(self._ring)
            meta = list(self._meta)
            dropped = self._recorded - len(records)
        meta.insert(0, {
            "name": "process_name", "ph": "M", "pid": self._pid,
            "args": {"name": self.process_name},
        })
        zero = self._anchor0[0]
        events = [{
            "name": name, "ph": "X", "cat": cat, "pid": self._pid, "tid": tid,
            "ts": round((t0 - zero) / 1e3, 3), "dur": round((t1 - t0) / 1e3, 3),
            "args": _json_args(ids, parent),
        } for name, t0, t1, tid, parent, ids, cat in records]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix_s": self._anchor0[1] / 1e9,
                "anchors": [list(self._anchor0), list(anchor1)],
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
_NO_REGION = contextlib.nullcontext()


def set_tracer(tracer: Tracer | None) -> None:
    """Install (or clear, with None) the process-global active tracer."""
    global _active
    with _active_lock:
        _active = tracer


def get_tracer() -> Tracer | None:
    return _active


def region(name: str, **ids: Any):
    """A scope on the active tracer that never waits for the device: its
    interval is the host's issuing of the body, recorded with ``ids`` as
    the event's ``args``. With no tracer installed, a shared no-op
    context."""
    tracer = _active
    if tracer is None:
        return _NO_REGION
    return _Region(tracer, name, ids)


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
    t0 = _perf_ns()
    try:
        yield handle
    finally:
        try:
            _block_pending(handle._pending)
        finally:
            handle.seconds = (_perf_ns() - t0) * 1e-9

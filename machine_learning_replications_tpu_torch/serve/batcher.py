"""Thread-safe micro-batcher with bounded admission and graceful drain.

Port of the JAX package's ``serve/batcher.py``; the one change is the
cold-bucket attribution, which reads the port's graph-capture counter
(``obs.torchmon``) where JAX reads its compile counter.

Individual requests arriving within a small window are coalesced into one
batched engine call, because the forward step scales with batch size while
per-call dispatch overhead does not. A batch goes to the engine when it
reaches ``max_batch_size`` rows OR the oldest queued request has waited
``max_wait_ms``.

Admission is BOUNDED: at most ``max_queue`` requests may be waiting. Past
that, ``submit`` raises ``Overloaded`` immediately — the server turns that
into an explicit 503 — instead of converting overload into unbounded
latency for every client.

``close(drain=True)`` stops admission, flushes everything already
admitted, and joins the flush thread: an admitted request is never dropped
by shutdown.

``PathRouter`` (dual-path scoring) also lives here: the routing decision is
a function of batcher state — queue depth and whether a flush is
mid-compute — plus host-path availability and the request's deadline.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from machine_learning_replications_tpu_torch.obs import journal, spans, torchmon
from machine_learning_replications_tpu_torch.resilience import faults
from machine_learning_replications_tpu_torch.resilience.supervisor import BreakerOpen


class Overloaded(RuntimeError):
    """Admission queue full — the request was shed, not queued."""


class _Pending:
    __slots__ = ("row", "future", "t_enqueue", "t_enqueue_perf", "trace")

    def __init__(self, row: np.ndarray, trace=None) -> None:
        self.row = row
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        # perf_counter twin of t_enqueue: request traces stamp every phase
        # on one clock (obs.reqtrace uses perf_counter throughout).
        self.t_enqueue_perf = time.perf_counter()
        self.trace = trace


class MicroBatcher:
    """Coalesce single-row predict requests into engine-sized batches.

    ``engine`` needs ``predict(X[n, F]) -> p[n]``; when it also exposes
    ``bucket_for`` (the bucketed engine does), each flush records its
    padding waste. ``metrics`` is a ``serve.metrics.ServingMetrics`` (or
    None to run unobserved, e.g. in unit tests).
    """

    def __init__(
        self,
        engine,
        max_batch_size: int = 64,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        metrics=None,
    ) -> None:
        if max_batch_size < 1 or max_queue < 1:
            raise ValueError("max_batch_size and max_queue must be >= 1")
        self._engine = engine
        self._max_batch = int(max_batch_size)
        self._max_wait_s = float(max_wait_ms) / 1000.0
        self._max_queue = int(max_queue)
        self._metrics = metrics
        self._cv = threading.Condition()
        self._q: deque[_Pending] = deque()
        self._flush_seq = 0  # flush-thread-only; correlates traces↔flushes
        # Routing signal (PathRouter): True while the flush thread is out
        # of the queue lock running a batch. Written by the flush thread
        # only; racy reads are fine — the router treats it as a hint.
        self._flushing = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="micro-batcher", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(self, row: np.ndarray, trace=None, count: bool = True) -> Future:
        """Enqueue one contract-order feature row; resolves to its
        probability (float). Raises ``Overloaded`` when the admission
        queue is full and ``RuntimeError`` after ``close``.

        ``trace`` is an optional ``obs.reqtrace.RequestTrace``: the flush
        thread stamps its queue-wait / batch-assembly / device-compute
        phases and flush annotations (sequence, bucket, cold-compile) —
        the batcher never *finishes* a trace; request lifecycle stays
        with the caller. ``count=False`` skips the ``requests_total``
        increment: the host-path failure fallback resubmits a request
        that was already counted at its first admission, and one logical
        request must move the counter once."""
        row = np.asarray(row, np.float64).ravel()
        want = getattr(self._engine, "n_features", None)
        if want is not None and row.shape[0] != want:
            # Reject at the door: a mis-shaped row admitted here would
            # only fail later inside a coalesced batch, taking its
            # batchmates down with it.
            raise ValueError(
                f"expected a {want}-feature row, got {row.shape[0]}"
            )
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._q) >= self._max_queue:
                if self._metrics is not None:
                    self._metrics.shed_total.inc()
                raise Overloaded(
                    f"admission queue full ({self._max_queue} waiting)"
                )
            p = _Pending(row, trace=trace)
            self._q.append(p)
            qlen = len(self._q)
            if self._metrics is not None:
                if count:
                    self._metrics.requests_total.inc()
                self._metrics.queue_depth.set(qlen)
            # Wake the flush thread only when it could act on the wake:
            # the first request of an empty queue (it is parked in the
            # outer wait) or a full batch (it may cut the coalescing wait
            # short). Everything in between is covered by the flush
            # loop's own deadline timeout, and an unconditional notify
            # per submit is measurable at event-loop ingest rates.
            if qlen == 1 or qlen >= self._max_batch:
                self._cv.notify()
        return p.future

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def flush_in_progress(self) -> bool:
        """Whether the flush thread is currently running a batch (hint for
        the path router; see ``PathRouter.decide``)."""
        return self._flushing

    # -- consumer side -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q and self._closed:
                    return
                # Wait out the coalescing window (unless the batch is
                # already full, or we are draining a closed batcher —
                # drain flushes at full speed).
                deadline = self._q[0].t_enqueue + self._max_wait_s
                while (
                    len(self._q) < self._max_batch
                    and not self._closed
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = [
                    self._q.popleft()
                    for _ in range(min(len(self._q), self._max_batch))
                ]
                if self._metrics is not None:
                    self._metrics.queue_depth.set(len(self._q))
            self._flushing = True
            try:
                self._flush(batch)
            finally:
                self._flushing = False

    def _note_flush_phases(
        self, batch: list[_Pending], t_claim: float, t_c0: float,
        t_c1: float, annotations: dict,
    ) -> None:
        """Stamp each traced batch member's flush-side phases: queue wait
        (enqueue → claim), batch assembly (claim → engine call, including
        the cancel sweep and np.stack), device compute (the engine call,
        which blocks through np.asarray). ``flush_index`` is the member's
        batch position — the trace-merge slice allocator keys on it."""
        for i, p in enumerate(batch):
            if p.trace is None:
                continue
            # Queue wait starts where the caller's parse phase ended (so
            # the phases partition the request with no gap — submit's
            # lock wait is queueing too), falling back to the enqueue
            # stamp for direct batcher callers with bare traces. All
            # three phases + annotations land under one trace lock.
            q0 = p.trace.phase_end("parse", p.t_enqueue_perf)
            p.trace.add_phases(
                {
                    "queue_wait": (q0, t_claim),
                    "batch_assembly": (t_claim, t_c0),
                    "device_compute": (t_c0, t_c1),
                },
                flush_index=i, **annotations,
            )

    def _flush(self, batch: list[_Pending]) -> None:
        # Claim each entry (queued → running). A False return means the
        # server cancelled it on client-deadline expiry — drop it here so
        # the engine never computes answers nobody will read. A claimed
        # future can no longer be cancelled, so set_result below is safe.
        t_claim = time.perf_counter()
        t_claim_mono = time.monotonic()
        batch = [p for p in batch if p.future.set_running_or_notify_cancel()]
        if not batch:
            return
        self._flush_seq += 1  # flush thread only — no lock needed
        flush_seq = self._flush_seq
        tracer = spans.get_tracer()
        # Batch shape accounting: the engine's plan (the exact chunk
        # sequence predict will run — ``engine.plan_batch``) when it has
        # one, else the legacy single covering bucket. ``bucket`` stays
        # the plan's largest chunk so existing trace/journal consumers
        # keep a scalar; multi-chunk plans additionally carry ``shape``.
        plan_for = getattr(self._engine, "plan_batch", None)
        bucket_for = getattr(self._engine, "bucket_for", None)
        if plan_for is not None:
            plan = tuple(plan_for(len(batch)))
        elif bucket_for is not None:
            plan = (bucket_for(len(batch)),)
        else:
            plan = None
        bucket = max(plan) if plan else None
        padded = (sum(plan) - len(batch)) if plan else 0
        shape = list(plan) if plan and len(plan) > 1 else None
        # Cold-compile attribution: a flush that grows the engine's
        # capture count (or, failing that instrument, the process graph
        # capture counter) paid a cold bucket — THE canonical
        # tail-latency outlier, worth naming on every trace it delayed.
        engine_compiles = getattr(self._engine, "compile_count", None)
        count_compiles = (
            engine_compiles if engine_compiles is not None
            else torchmon.compile_count
        )
        compiles0 = count_compiles()
        if self._metrics is not None:
            # One lock acquisition for the whole batch: at event-loop
            # throughput, per-row histogram locking is measurable.
            self._metrics.queue_wait.observe_many(
                [t_claim_mono - p.t_enqueue for p in batch]
            )
        t_c0 = t_c1 = None
        try:
            # np.stack inside the try: a mis-shaped row slipping past
            # submit must fail its batch's futures, not kill the flush
            # thread (which would wedge the batcher permanently). The
            # faultpoint rides inside the same try for the same reason —
            # an injected flush fault fails THIS batch's futures
            # explicitly, never the loop.
            with spans.span("serve:flush", rows=len(batch)) as sp:
                faults.fire("batcher.flush")
                X = np.stack([p.row for p in batch])
                t_c0 = time.perf_counter()
                # predict_tagged (supervised engines) pairs the probs
                # with the computing engine's model version, captured
                # atomically with the engine reference — around a warm
                # swap, reply headers must name the version of THESE
                # bits, not whatever the handle says at respond time.
                # Unsupervised engines cannot be swapped (deploys require
                # supervision), so a plain attribute read is exact there.
                tagged = getattr(self._engine, "predict_tagged", None)
                if tagged is not None:
                    out, model_version = tagged(X)
                else:
                    out = self._engine.predict(X)
                    model_version = getattr(
                        self._engine, "model_version", None
                    )
                probs = np.asarray(out, np.float64)
                t_c1 = time.perf_counter()
                cold = count_compiles() > compiles0
                sp.note(flush_seq=flush_seq, bucket=bucket,
                        cold_compile=cold)
        except Exception as exc:
            # A BreakerOpen from the supervised engine is a degraded-mode
            # SHED of requests admitted before the breaker opened — the
            # engine was never invoked and the client gets the same
            # explicit 503 + Retry-After as the pre-admission path. It
            # must count in shed_total, not errors_total ('failed inside
            # the engine'), or every degraded window fires error-rate
            # alerts for contract-conforming sheds while the shed rate
            # under-reports.
            shed = isinstance(exc, BreakerOpen)
            if self._metrics is not None:
                counter = (
                    self._metrics.shed_total if shed
                    else self._metrics.errors_total
                )
                counter.inc(len(batch))
            journal.event(
                "flush", seq=flush_seq, rows=len(batch), ok=False,
                shed=shed, error=f"{type(exc).__name__}: {exc}",
            )
            # Partial phase record: queue wait and assembly happened, and
            # the compute interval ends where the engine raised — a
            # sampled failure trace still says where the time went.
            t_err = time.perf_counter()
            self._note_flush_phases(
                batch, t_claim, t_c0 if t_c0 is not None else t_err,
                t_c1 if t_c1 is not None else t_err,
                {
                    "flush_seq": flush_seq, "batch_rows": len(batch),
                    "bucket": bucket,
                    "flush_tid": (
                        tracer.current_tid() if tracer is not None else None
                    ),
                },
            )
            for p in batch:
                p.future.set_exception(exc)
            return
        now = time.monotonic()
        journal.event(
            "flush", seq=flush_seq, rows=len(batch), ok=True,
            bucket=bucket, cold_compile=cold,
            oldest_wait_s=round(now - batch[0].t_enqueue, 6),
            **({"shape": shape} if shape is not None else {}),
        )
        self._note_flush_phases(batch, t_claim, t_c0, t_c1, {
            "flush_seq": flush_seq, "batch_rows": len(batch),
            "bucket": bucket, "cold_compile": cold,
            "padded_rows": max(padded, 0),
            **({"shape": shape} if shape is not None else {}),
            **({"model_version": model_version}
               if model_version is not None else {}),
            "flush_tid": tracer.current_tid() if tracer is not None else None,
        })
        if self._metrics is not None:
            self._metrics.batches_total.inc()
            self._metrics.batch_size.observe(len(batch))
            if plan is not None:
                self._metrics.padding_waste.observe(max(padded, 0))
            self._metrics.latency.observe_many(
                [now - p.t_enqueue for p in batch]
            )
        for p, prob in zip(batch, probs):
            p.future.set_result(float(prob))

    # -- shutdown ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: float | None = 30.0) -> None:
        """Stop admission; with ``drain`` (default) flush every admitted
        request before returning, otherwise fail them fast."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._q:
                    p = self._q.popleft()
                    if p.future.set_running_or_notify_cancel():
                        p.future.set_exception(
                            RuntimeError("server shutting down")
                        )
                if self._metrics is not None:
                    self._metrics.queue_depth.set(0)
            self._cv.notify_all()
        self._thread.join(timeout)


class PathRouter:
    """The dual-path routing decision (docs/SERVING.md "Dual-path
    scoring"): host fast path or device micro-batch, per request.

    The policy is deliberately small and fully deterministic given the
    observed state — every branch is unit-testable by forcing that state:

      * no host path (unsupported family, disabled, not warm) → device;
      * host saturated (every ``HostPath`` slot busy) → device — at
        saturation the batcher's coalescing is the whole throughput
        story, and the host path self-limits by its slot bound;
      * a *tight* request deadline (``deadline_s`` at or under
        ``tight_deadline_s``) → host: such a request cannot afford the
        coalescing window plus a possibly-mid-flight flush ahead of it;
      * queued rows already coalescing (``queue_depth`` ≥
        ``burst_depth``) → device: joining a forming batch costs no
        extra wait and buys the batch economics;
      * otherwise (idle queue — even with a flush mid-compute, which a
        new device request would serialize behind) → host.

    ``decide`` returns ``(path, reason)``; the caller counts the path it
    actually dispatched (a ``HostBusy`` race falls back to device) in
    ``serve_path_total`` and stamps both on the request trace.
    """

    def __init__(
        self,
        batcher: MicroBatcher,
        host,
        burst_depth: int = 1,
        tight_deadline_s: float = 0.05,
    ) -> None:
        if burst_depth < 1:
            raise ValueError("burst_depth must be >= 1")
        self.batcher = batcher
        self.host = host
        self.burst_depth = int(burst_depth)
        self.tight_deadline_s = float(tight_deadline_s)

    def decide(self, deadline_s: float | None = None) -> tuple[str, str]:
        host = self.host
        if host is None:
            return "device", "no_host_path"
        if not getattr(host, "available", True):
            return "device", "host_unavailable"
        if host.saturated:
            return "device", "host_saturated"
        if deadline_s is not None and deadline_s <= self.tight_deadline_s:
            return "host", "tight_deadline"
        depth = self.batcher.queue_depth
        if depth >= self.burst_depth:
            return "device", "coalescing"
        if self.batcher.flush_in_progress:
            return "host", "flush_in_progress"
        return "host", "idle"

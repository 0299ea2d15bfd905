"""Host-side fast path — the other half of adaptive dual-path scoring.

Port of the JAX package's ``serve/hostpath.py``. A lone request on an idle
server would otherwise wait out the batcher's coalescing window and pay
the card's round trip; the host path answers it on the CPU instead.

``HostScorer`` is deliberately NOT a reimplementation of the blend math (a
second code path would drift from the served model the first time anyone
touches ``models/``): it is the SAME ``BucketedPredictEngine`` — the same
``pipeline.contract_rows_to_x64`` → imputer block → stacked ensemble
composition, the same pre-resolved imputer block — over a CPU copy of the
parameters (``convert.params_to(params, "cpu")``), warmed at a tiny ladder
(default ``1/8``). On a CPU deployment both paths run the same torch
program, so they agree bit for bit; next to a card they agree at the
engine's parity tolerance.

``HostPath`` is the execution side: a small pool of daemon worker threads
fed through a bounded hand-off (one slot per worker by default — queueing
here would re-create exactly the latency the path exists to remove).
``submit`` returns the same ``Future`` shape as ``MicroBatcher.submit`` so
the server's in-flight machinery (deadline timer, done-callback,
504-cancel) is shared verbatim; when every slot is busy it raises
``HostBusy`` and the caller falls back to the device path — saturation
routes itself. Routing policy lives in ``serve.batcher.PathRouter``; the
taken path is exported as ``serve_path_total{path=host|device}`` and
annotated on every request trace (``path``, plus a ``host_compute`` phase
in place of the device path's queue/assembly/compute phases).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.serve.engine import (
    BucketedPredictEngine,
)

#: The routing decision, counted per served request at the moment the
#: request is actually dispatched (a HostBusy fallback counts as device).
PATHS = REGISTRY.counter(
    "serve_path_total",
    "Predict requests by scoring path: host = synchronous CPU fast path "
    "(no batching delay, no accelerator round trip), device = the "
    "micro-batched bucketed engine.",
    labels=("path",),
)
# Materialize both series at import so the first scrape shows the split
# even before traffic (and a zero host count is visible, not absent).
PATHS.labels(path="host")
PATHS.labels(path="device")

#: Host-path computes that failed and were transparently resubmitted
#: through the supervised device path (serve.server._InFlight.on_done):
#: the fallback keeps engine faults flowing into the breaker/watchdog
#: machinery instead of surfacing raw host 500s.
HOST_FALLBACKS = REGISTRY.counter(
    "serve_host_fallback_total",
    "Host fast-path failures retried once through the device path "
    "before any client-visible error.",
)
HOST_FALLBACKS.get()

DEFAULT_HOST_BUCKETS = (1, 8)


class HostBusy(RuntimeError):
    """Every host-path slot is occupied — the caller should take the
    device path (this is load-adaptive routing, not an error)."""


class HostScorer(BucketedPredictEngine):
    """The warmed CPU scorer: a ``BucketedPredictEngine`` over a CPU copy
    of the parameters, sharing every line of the device path's math.

    ``quality`` is the same feed object the device engine holds, so
    host-scored rows reach the drift monitor exactly like device-scored
    ones. ``aot`` is the bundle's ``cpu`` view (``persist.aot``): the
    scorer restores its buckets from it, as the device engine does.
    """

    def __init__(self, params, buckets=DEFAULT_HOST_BUCKETS, quality=None,
                 aot=None) -> None:
        from machine_learning_replications_tpu_torch import convert

        super().__init__(convert.params_to(params, "cpu"), buckets=buckets, quality=quality,
                         device="cpu", aot=aot, aot_role="host")


class _HostPending:
    __slots__ = ("row", "future", "trace", "t_enqueue", "t_enqueue_perf")

    def __init__(self, row, future, trace) -> None:
        self.row = row
        self.future = future
        self.trace = trace
        self.t_enqueue = time.monotonic()
        self.t_enqueue_perf = time.perf_counter()


class HostPath:
    """Bounded worker pool executing single-row host-path predictions.

    ``submit`` raises ``HostBusy`` the instant all ``max_inflight`` slots
    (default: one per worker) are taken — the host path never queues
    meaningfully, because a queued host request would pay exactly the
    wait the path exists to avoid while the device path would have
    batched it for free. ``metrics`` (a ``ServingMetrics``) receives the
    same latency/queue-wait observations the batcher records, so the
    serving histograms describe all traffic regardless of path.
    """

    def __init__(
        self,
        scorer,
        workers: int = 1,
        max_inflight: int | None = None,
        metrics=None,
    ) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self._scorer = scorer
        self._metrics = metrics
        self._max_inflight = int(max_inflight or workers)
        if self._max_inflight < workers:
            raise ValueError("max_inflight must be >= workers")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: deque[_HostPending | None] = deque()
        self._inflight = 0
        self._closed = False
        self._threads = [
            threading.Thread(
                target=self._loop, name=f"host-path-{i}", daemon=True
            )
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -- producer ----------------------------------------------------------

    @property
    def scorer(self):
        return self._scorer

    def swap_scorer(self, scorer) -> None:
        """Rolling-deploy promotion for the fast path: replace the scorer
        with an already-warm one. A bare reference swap — workers read
        ``self._scorer`` once per compute, so in-flight host scores
        finish on the old scorer and the next submission runs the new
        one, mirroring ``SupervisedEngine.swap_engine``."""
        self._scorer = scorer

    @property
    def available(self) -> bool:
        """Router gate: open for submissions and backed by a warm scorer
        (a cold host path would make the first routed single pay a
        compile — worse than the batching delay it was avoiding)."""
        return not self._closed and getattr(self._scorer, "warm", True)

    @property
    def saturated(self) -> bool:
        with self._lock:
            return self._inflight >= self._max_inflight

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def submit(self, row: np.ndarray, trace=None):
        """Enqueue one contract-order row for host scoring; returns a
        ``Future`` resolving to its probability (float). Raises
        ``HostBusy`` when every slot is taken and ``RuntimeError`` after
        ``close``."""
        from concurrent.futures import Future

        row = np.asarray(row, np.float64).ravel()
        with self._lock:
            if self._closed:
                raise RuntimeError("host path is closed")
            if self._inflight >= self._max_inflight:
                raise HostBusy(
                    f"all {self._max_inflight} host-path slots busy"
                )
            self._inflight += 1
            p = _HostPending(row, Future(), trace)
            self._q.append(p)
            self._cv.notify()
        return p.future

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return  # closed and drained
                p = self._q.popleft()
            if p is None:
                return
            self._run_one(p)

    def _run_one(self, p: _HostPending) -> None:
        t_claim = time.perf_counter()
        t_claim_mono = time.monotonic()
        try:
            # Claimed → can no longer be cancelled by the deadline timer;
            # a cancelled entry is dropped here unserved, same as the
            # batcher's flush-time cancel sweep.
            if not p.future.set_running_or_notify_cancel():
                return
            # ONE read of the swappable scorer reference: the version
            # noted on the trace below must belong to the scorer that
            # produced the bits, even when swap_scorer lands mid-call.
            scorer = self._scorer
            try:
                prob = float(scorer.predict(p.row[None, :])[0])
            except BaseException as exc:
                # No error counter here: the server retries a failed host
                # compute through the device path, whose flush accounts
                # the terminal outcome — counting both would double-book
                # one request.
                self._stamp(p, t_claim, time.perf_counter())
                p.future.set_exception(exc)
                return
            t_done = time.perf_counter()
            self._stamp(p, t_claim, t_done)
            version = getattr(scorer, "model_version", None)
            if version is not None and p.trace is not None:
                p.trace.note(model_version=version)
            if self._metrics is not None:
                now = time.monotonic()
                self._metrics.queue_wait.observe(
                    t_claim_mono - p.t_enqueue
                )
                self._metrics.latency.observe(now - p.t_enqueue)
            p.future.set_result(prob)
        finally:
            with self._lock:
                self._inflight -= 1

    def _stamp(self, p: _HostPending, t_claim: float, t_done: float) -> None:
        """Request-trace phases for the host path: queue_wait is the slot
        wait (parse end → worker claim — near zero unless racing another
        host request), host_compute is the synchronous scorer call. The
        respond phase starts where host_compute ends (``serve.server``),
        so the phases partition the request like the device path's do."""
        if p.trace is None:
            return
        q0 = p.trace.phase_end("parse", p.t_enqueue_perf)
        p.trace.add_phases(
            {"queue_wait": (q0, t_claim), "host_compute": (t_claim, t_done)},
        )

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop admission, let in-flight work finish, join the workers.
        Anything still queued unclaimed is failed fast."""
        with self._lock:
            self._closed = True
            while self._q:
                p = self._q.pop()
                self._inflight -= 1
                if p.future.set_running_or_notify_cancel():
                    p.future.set_exception(
                        RuntimeError("server shutting down")
                    )
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout)

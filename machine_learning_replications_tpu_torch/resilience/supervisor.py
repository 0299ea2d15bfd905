"""Supervised serving engine: watchdog, circuit breaker, backoff restart.

The serving failure mode the batcher alone cannot survive is a *wedged*
engine: a device computation that never returns (driver hang, injected
``engine.compute:delay``) blocks the flush thread forever — the queue
fills, every client stalls to its timeout, and ``/predict`` is down while
``/healthz`` still says ok. The second-worst is a *repeatedly failing*
engine: each flush burns a batch of requests with 500s while the server
keeps admitting more.

``SupervisedEngine`` wraps ``serve.engine.BucketedPredictEngine`` with the
standard production trio:

  * **Watchdog** — every ``predict`` runs on a dedicated worker thread
    with a per-flush deadline. A compute that misses it is abandoned
    (the thread is daemonic and unreachable; the engine is presumed
    wedged) and the caller gets ``ComputeDeadlineExceeded`` — an explicit
    failure in bounded time instead of an unbounded hang.
  * **Circuit breaker** — a deadline miss, or ``breaker_failures``
    consecutive compute failures, opens the breaker. While open,
    ``predict`` raises ``BreakerOpen`` immediately (no device call): the
    server turns that into 503 + ``Retry-After`` — *degraded mode*, load
    shed explicitly while recovery runs off the request path.
  * **Supervised restart** — a daemon restarter rebuilds the engine via
    the factory (fresh executor, fresh jit cache, re-warmed buckets)
    under bounded exponential backoff. Success closes the breaker and —
    if the model-quality feed had been quarantined
    (``quality_feed_disabled``) — re-enables it, journaled
    (``quality_feed_reenabled``). Failure (warmup raising, an armed
    ``engine.warmup`` fault) retries at the capped backoff forever: the
    process stays alive, shedding, until the engine heals.

Every transition is journaled (``breaker_open`` / ``engine_restart`` /
``breaker_close``) and exported through the process-global registry
(``resilience_*`` families), so a chaos run can assert the
open -> shed -> recover arc from the journal and ``/metrics`` alone.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

# Registered at import: the families (and their exposition metadata) must
# exist on the first scrape, before any fault ever trips the breaker.
BREAKER_STATE = REGISTRY.gauge(
    "resilience_breaker_state",
    "Serving circuit breaker: 0 closed (healthy), 1 open (degraded, "
    "shedding while the engine restarts).",
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    "resilience_breaker_transitions_total",
    "Circuit-breaker transitions by destination state.",
    labels=("to",),
)
ENGINE_RESTARTS = REGISTRY.counter(
    "resilience_engine_restarts_total",
    "Supervised engine rebuild attempts by result.",
    labels=("result",),
)
WATCHDOG_TRIPS = REGISTRY.counter(
    "resilience_watchdog_trips_total",
    "Flush computations abandoned for missing the per-flush deadline "
    "(wedged-engine detections).",
)
DEGRADED_SHEDS = REGISTRY.counter(
    "resilience_degraded_sheds_total",
    "Requests shed with 503 + Retry-After because the breaker was open.",
)
BREAKER_STATE.get().set(0.0)


class BreakerOpen(RuntimeError):
    """The breaker is open: the request was shed, not computed. Carries
    the server's ``Retry-After`` estimate."""

    def __init__(self, retry_after_s: float) -> None:
        super().__init__(
            "engine degraded: circuit breaker open, restart in progress "
            f"(retry after ~{retry_after_s:.0f}s)"
        )
        self.retry_after_s = retry_after_s


class ComputeDeadlineExceeded(RuntimeError):
    """The flush's device computation missed the watchdog deadline and was
    abandoned (the engine is presumed wedged; the breaker is now open)."""


class _Worker:
    """One daemon thread executing submitted calls in order.

    Deliberately NOT ``ThreadPoolExecutor``: its threads are non-daemonic
    and joined at interpreter exit, so one wedged computation would hang
    process shutdown forever — the exact failure this module exists to
    bound. A wedged ``_Worker`` is simply abandoned (daemon threads die
    with the process) and replaced on restart."""

    def __init__(self) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, name="engine-worker", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # Stop: fail anything that raced in behind the sentinel —
                # a silently unexecuted future would stall its caller the
                # full watchdog deadline for nothing.
                while True:
                    try:
                        leftover = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if leftover is None:
                        continue
                    _fn, _args, fut = leftover
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(
                            RuntimeError("engine worker stopped")
                        )
            fn, args, fut = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as exc:  # delivered, never kills the loop
                fut.set_exception(exc)

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._q.put((fn, args, fut))
        return fut

    def stop(self) -> None:
        self._q.put(None)


class SupervisedEngine:
    """Watchdog + circuit breaker + backoff-restart wrapper around a
    bucketed predict engine. Drop-in for the batcher/server: ``predict``,
    ``bucket_for``, ``warmup``, ``compile_count`` and the introspection
    attributes all delegate to the current engine.

    ``engine`` is the initial (possibly still cold — ``make_server`` warms
    after binding) engine; ``factory()`` must build **and warm** a
    replacement, and is only ever called off the request path by the
    restarter thread.
    """

    def __init__(
        self,
        engine,
        factory,
        flush_deadline_s: float = 20.0,
        breaker_failures: int = 3,
        restart_backoff_s: float = 0.5,
        restart_backoff_max_s: float = 30.0,
    ) -> None:
        if flush_deadline_s <= 0:
            raise ValueError("flush_deadline_s must be > 0")
        if breaker_failures < 1:
            raise ValueError("breaker_failures must be >= 1")
        if restart_backoff_s <= 0 or restart_backoff_max_s < restart_backoff_s:
            raise ValueError(
                "need 0 < restart_backoff_s <= restart_backoff_max_s"
            )
        self._engine = engine
        self._factory = factory
        self._deadline_s = float(flush_deadline_s)
        self._breaker_failures = int(breaker_failures)
        self._backoff_s = float(restart_backoff_s)
        self._backoff_max_s = float(restart_backoff_max_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._fail_streak = 0
        self._opened_at: float | None = None
        self._open_reason: str | None = None
        self._restart_attempts = 0
        self._restarts_completed = 0
        self._next_attempt_at: float | None = None
        self._closed = False
        self._worker = _Worker()
        # NO gauge reset here: the breaker-state series is process-global
        # and initialized once at module import — a second in-process
        # server constructing its supervisor must not publish a phantom
        # 'closed' over another server's open breaker.

    # -- delegation ---------------------------------------------------------
    # The current engine can be swapped by the restarter at any moment, so
    # every delegate reads self._engine exactly once (reference swap is
    # atomic under the GIL).

    @property
    def params(self):
        return self._engine.params

    @property
    def buckets(self):
        return self._engine.buckets

    @property
    def warm(self) -> bool:
        return self._engine.warm

    @property
    def n_features(self) -> int:
        return self._engine.n_features

    @property
    def quality(self):
        return self._engine.quality

    @property
    def trace_counts(self):
        return self._engine.trace_counts

    def bucket_for(self, n: int) -> int:
        return self._engine.bucket_for(n)

    def plan_batch(self, n: int) -> tuple[int, ...]:
        inner = getattr(self._engine, "plan_batch", None)
        if inner is not None:
            return inner(n)
        # Test doubles without shaping: one covering bucket, the
        # pre-shaping contract.
        return (self._engine.bucket_for(n),)

    def compile_count(self) -> int:
        return self._engine.compile_count()

    def warmup(self, say=None):
        """Initial warmup (make_server, after the listener binds) — not
        deadline-guarded: startup compiles are legitimately long."""
        return self._engine.warmup(say=say)

    # -- breaker ------------------------------------------------------------

    @property
    def breaker_open(self) -> bool:
        return self._state == "open"

    def retry_after_s(self) -> float:
        """The degraded-mode ``Retry-After`` estimate: time to the next
        restart attempt (floor 1 s — clients should not stampede)."""
        with self._lock:
            if self._state != "open":
                return 0.0
            eta = (
                self._next_attempt_at - time.monotonic()
                if self._next_attempt_at is not None else self._backoff_s
            )
        return max(1.0, eta)

    def snapshot(self) -> dict:
        """Breaker/restart state for ``/healthz`` and chaos assertions."""
        with self._lock:
            open_for = (
                round(time.monotonic() - self._opened_at, 3)
                if self._opened_at is not None and self._state == "open"
                else None
            )
            return {
                "state": self._state,
                "fail_streak": self._fail_streak,
                "open_reason": self._open_reason,
                "open_for_seconds": open_for,
                "restart_attempts": self._restart_attempts,
                "restarts_completed": self._restarts_completed,
                "flush_deadline_seconds": self._deadline_s,
            }

    def _trip(self, reason: str, wedged: bool = False) -> None:
        with self._lock:
            if self._state == "open":
                return  # already degraded; the restarter is running
            self._state = "open"
            self._opened_at = time.monotonic()
            self._open_reason = reason
            self._restart_attempts = 0
            if wedged:
                # The worker thread is stuck inside the computation:
                # abandon it and give the restarter a fresh one. The
                # sentinel lets the old loop exit once the stuck call
                # finally returns — without it, every wedge recovery
                # would leak an idle thread (and its captured engine)
                # for the process lifetime.
                self._worker.stop()
                self._worker = _Worker()
            # State gauge/journal emitted INSIDE the lock: an open and a
            # close racing on the lock boundary must publish in the order
            # they happened, or /metrics could read 'closed' (and the
            # journal end on breaker_close) while the breaker is open.
            BREAKER_STATE.get().set(1.0)
            BREAKER_TRANSITIONS.inc(to="open")
            journal.event("breaker_open", reason=reason, wedged=wedged)
        threading.Thread(
            target=self._restart_loop, name="engine-restarter", daemon=True
        ).start()

    def _restart_loop(self) -> None:
        attempt = 0
        while not self._closed:
            # Exponent clamped: the cap is reached within ~30 doublings,
            # and an unbounded 2**attempt would eventually overflow float
            # range and kill the restarter — leaving the breaker open
            # forever with nobody retrying.
            delay = min(
                self._backoff_max_s,
                self._backoff_s * (2 ** min(attempt, 30)),
            )
            with self._lock:
                self._next_attempt_at = time.monotonic() + delay
            time.sleep(delay)
            if self._closed:
                return  # supervisor shut down mid-backoff: stop rebuilding
            attempt += 1
            with self._lock:
                self._restart_attempts = attempt
            t0 = time.monotonic()
            try:
                # factory() builds AND warms; warming doubles as the probe
                # (it runs a blocked predict per bucket), so a closed
                # breaker means real computes succeeded.
                engine = self._factory()
            except BaseException as exc:
                ENGINE_RESTARTS.inc(result="failed")
                journal.event(
                    "engine_restart", attempt=attempt, ok=False,
                    seconds=round(time.monotonic() - t0, 3),
                    error=f"{type(exc).__name__}: {exc}",
                )
                continue
            with self._lock:
                self._engine = engine
                self._state = "closed"
                self._fail_streak = 0
                self._restarts_completed += 1
                opened_at = self._opened_at
                self._opened_at = None
                self._next_attempt_at = None
                # Close bookkeeping under the lock, mirroring _trip: a
                # flush that re-trips the instant the state flips must
                # serialize AFTER these, so the published order is always
                # close-then-open and the gauge never reads 0 while open.
                ENGINE_RESTARTS.inc(result="ok")
                BREAKER_STATE.get().set(0.0)
                BREAKER_TRANSITIONS.inc(to="closed")
                journal.event(
                    "engine_restart", attempt=attempt, ok=True,
                    seconds=round(time.monotonic() - t0, 3),
                )
                journal.event(
                    "breaker_close", attempts=attempt,
                    open_seconds=(
                        round(time.monotonic() - opened_at, 3)
                        if opened_at is not None else None
                    ),
                )
            # Supervised quality-feed re-enable: the engine quarantines a
            # crashing feed (sets engine.quality = None, monitor disabled).
            # The rebuilt engine holds a fresh reference; clear the
            # monitor's quarantine so monitoring resumes instead of
            # latching dead until process restart.
            monitor = getattr(engine, "quality", None)
            reenable = getattr(monitor, "reenable", None)
            if reenable is not None and reenable():
                journal.event("quality_feed_reenabled", after="engine_restart")
            return

    # -- rolling deploy -------------------------------------------------------

    def swap_engine(self, engine, factory=None) -> None:
        """Atomically replace the live engine with an already-built,
        already-WARM one — the rolling-deploy promotion step
        (``serve.server`` /admin/deploy; docs/FLEET.md). The swap is a
        reference assignment under the breaker lock, so in-flight flushes
        finish on the engine they were submitted to and the next flush
        runs the new one: no request ever observes a half-switched state.

        ``factory`` (when given) also becomes the supervised-restart
        rebuild path — without this, a post-deploy breaker trip would
        "recover" by resurrecting the PREVIOUS model version.

        Refused while the breaker is open: the restarter is concurrently
        rebuilding the OLD engine and the two swaps would race; a
        degraded replica is out of rotation anyway, so the deploy
        controller retries it after recovery."""
        with self._lock:
            if self._state == "open":
                raise RuntimeError(
                    "cannot swap engines while the breaker is open "
                    "(supervised restart in progress)"
                )
            self._engine = engine
            if factory is not None:
                self._factory = factory
            self._fail_streak = 0
            journal.event("engine_swap", warm=bool(engine.warm))

    # -- the guarded compute path -------------------------------------------

    def predict(self, X):
        """``engine.predict`` behind the watchdog and breaker. Raises
        ``BreakerOpen`` instantly while degraded and
        ``ComputeDeadlineExceeded`` on a wedged compute; engine exceptions
        propagate unchanged (after feeding the failure streak)."""
        return self.predict_tagged(X)[0]

    def predict_tagged(self, X):
        """``predict`` plus the ``model_version`` of the engine that ran
        the compute, captured under the same lock ``swap_engine`` takes —
        the ONLY read that is guaranteed consistent with the bits. Around
        a rolling deploy, handle-level version state can already name the
        next version while an in-flight flush finishes on the old engine;
        reply headers must be built from this tag, not that state."""
        with self._lock:
            # Check + submit under ONE lock acquisition: a wedge trip
            # swapping workers serializes against this, so a submit can
            # never land on a worker after its stop sentinel (the
            # lost-future would otherwise stall its flush the full
            # deadline against a healthy post-restart engine).
            if self._state == "open":
                retry_after = (
                    self._next_attempt_at - time.monotonic()
                    if self._next_attempt_at is not None
                    else self._backoff_s
                )
                raise BreakerOpen(max(1.0, retry_after))
            engine = self._engine
            fut = self._worker.submit(engine.predict, X)
        try:
            out = fut.result(timeout=self._deadline_s)
        except FuturesTimeout:
            WATCHDOG_TRIPS.inc()
            msg = (
                f"compute exceeded the {self._deadline_s:g}s flush "
                "deadline; engine presumed wedged"
            )
            self._trip(msg, wedged=True)
            raise ComputeDeadlineExceeded(msg) from None
        except BaseException as exc:
            with self._lock:
                self._fail_streak += 1
                streak = self._fail_streak
            if streak >= self._breaker_failures:
                self._trip(
                    f"{streak} consecutive compute failures "
                    f"(last: {type(exc).__name__}: {exc})"
                )
            raise
        with self._lock:
            self._fail_streak = 0
        return out, getattr(engine, "model_version", None)

    def close(self) -> None:
        """Stop the worker thread AND any in-flight restarter (idempotent).
        Without the flag, a supervisor shut down while the breaker is
        open would keep rebuilding and re-warming engines — full jit
        compiles every backoff interval — for the process lifetime,
        serving nobody."""
        self._closed = True
        self._worker.stop()

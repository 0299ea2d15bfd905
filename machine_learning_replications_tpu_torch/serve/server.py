"""HTTP front end for the serving layer — application logic over the
event-loop transport.

Port of the JAX package's ``serve/server.py``: the same endpoints, status
codes, JSON bodies and headers. What differs is underneath: the engine is
the port's ``BucketedPredictEngine`` (one CUDA graph per bucket on the
card), ``make_server`` takes ``device=`` (default: the card), ``/metrics``
appends the port's runtime accounting (``obs.torchmon``), ``/debug/profile``
captures with ``torch.profiler`` and ``/admin/deploy`` loads port
checkpoints (``persist.checkpoint``). Not ported yet: the pre-fork
``SO_REUSEPORT`` workers and the AOT executable bundles.

The stack is three layers since the transport refactor (docs/SERVING.md
"Transport architecture"):

  ``serve.protocol``   pure HTTP parse/respond rules (Content-Length
                       framing guards, keep-alive/pipelining, desync
                       closes) — no sockets, unit-testable.
  ``serve.transport``  the non-blocking ``selectors`` event loop: one
                       thread owns every socket, keep-alive pipelining,
                       bounded read buffers, idle/slow-loris reaping,
                       explicit backpressure (a socket with a request in
                       flight is not read), ``SO_REUSEPORT`` pre-fork
                       sharding for ``cli serve --workers N``.
  this module          the endpoints below, plus request tracing, SLO
                       accounting, quality monitoring, and degraded-mode
                       shedding — unchanged semantics behind the new
                       transport; the batcher/engine/supervisor stack
                       behind it is untouched.

Endpoints:

  POST /predict   body = the 17-variable patient JSON (``predict_hf.py:5-27``,
                  same validation as ``cli.py predict --patient``) → 200
                  ``{"probability": p, "text": "Probability of progressive
                  HF is: XX.XX %"}``. 400 on contract violations, 413 on
                  oversized bodies (never read into memory), 431 on
                  oversized headers, 503
                  ``{"error": "overloaded"}`` when admission control sheds,
                  504 when an admitted request misses the request deadline
                  (it is cancelled, so the engine never computes it).
                  Every reply carries an ``X-Request-Id`` header — the
                  inbound header's value when the client sent one (so
                  upstream trace ids propagate, Dapper-style), a fresh id
                  otherwise — and the whole request records a per-phase
                  trace (``obs.reqtrace``): parse → queue wait → batch
                  assembly → device compute (cold-compile flagged) →
                  respond (host-path requests: parse → queue wait → host
                  compute → respond). With dual-path scoring enabled the
                  request is routed (``PathRouter``): host fast path for
                  singles on an idle server, device micro-batches for
                  bursts; the taken path is echoed as ``X-Serve-Path``
                  (an inbound ``X-Serve-Path: host|device`` header pins
                  it), counted in ``serve_path_total``, and a client
                  ``X-Request-Deadline-Ms`` header tightens the reply
                  deadline and biases routing toward the host path.
  GET  /healthz   LIVENESS (always 200 while the process can answer) plus
                  the load signal an external prober wants: params family,
                  bucket ladder, warm flag, queue depth, uptime, the run
                  id from the journal manifest when one is active, the
                  worker id in multi-worker mode, a compact model-quality
                  block (``{"status": ok|warn|alert|disabled,
                  "worst_feature", "worst_psi"}``), and — when the engine
                  is supervised — the circuit breaker's state (``status``
                  reads ``degraded`` while the breaker is open). Liveness
                  and readiness are split deliberately: a recovering
                  replica must be rotated OUT (readiness false) without
                  being KILLED (liveness true).
  GET  /readyz    READINESS: 200 only when the engine is warm, the server
                  is not draining, and the breaker is closed; 503 with the
                  blocking reasons otherwise — the signal a load balancer
                  acts on.
  GET  /metrics   Prometheus text exposition (``?format=json`` for the
                  same data as JSON) — ``serve.metrics``, with the
                  process-global ``obs`` registry's exposition appended
                  (graph captures, kernel launches and transfer bytes
                  from ``obs.torchmon``, installed at ``make_server``; SLO burn
                  gauges from ``obs.slo``; flight-recorder sampling
                  counters; ``serve_worker_info{worker=…}`` in
                  multi-worker mode so scrapes through the shared
                  ``SO_REUSEPORT`` port stay attributable).
  GET  /debug/requests
                  the flight recorder's tail-sampled request traces
                  (every failure + the p99-slowest completions), newest
                  first, with recorder stats and per-SLO state. ``?n=K``
                  caps the trace count (default 64). ``?id=<request-id>``
                  is an exact lookup over the recorder's all-completions
                  index (JSON 404 when the id aged out) — the fetch
                  primitive behind the router's fleet trace join.
  GET  /debug/profile?seconds=N
                  on-demand ``torch.profiler`` capture of N wall seconds
                  (default 1) while traffic keeps flowing; replies with
                  the artifact file list. Single-flight: a capture in
                  progress makes concurrent calls fail fast with 409.
                  (Runs on its own short-lived thread — a blocking capture
                  must not stall the event loop.)
  GET  /debug/quality
                  the model-quality monitor's full snapshot
                  (``obs.quality``): drift status vs the training
                  reference profile, per-feature PSI/KS sorted worst
                  first, score-distribution PSI, calibration bins, and
                  windowed ensemble disagreement. ``{"enabled": false}``
                  when the served params carry no reference profile or
                  the server started with ``--no-quality``.
  GET/POST /debug/faults
                  the fault-injection registry (``resilience.faults``):
                  GET snapshots armed sites and their call/fire counts;
                  POST ``{"arm": SPEC}`` / ``{"disarm": SITE}`` /
                  ``{"reset": true}`` drives a chaos run over HTTP. 403
                  unless the process opted in (``cli serve --inject`` /
                  ``--fault-endpoint``) — a production server must not be
                  chaos-drivable by whoever can reach its port.

Degraded mode (``resilience.supervisor``, docs/RESILIENCE.md): while the
supervised engine's circuit breaker is open, ``/predict`` sheds with 503 +
``Retry-After`` instead of queueing into a dead engine, ``/healthz``
reports ``degraded`` (still 200 — the process is alive), and ``/readyz``
goes 503 so load balancers rotate the replica out while the supervisor
rebuilds and re-warms the engine off the request path.

``ServerHandle.shutdown`` is the graceful path: mark draining (readiness
drops), stop accepting, drain the batcher (admitted requests are never
dropped), flush every queued reply, then stop the listener.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import threading
import time

from machine_learning_replications_tpu_torch.obs import (
    journal,
    profiler,
    reqtrace,
    slo,
    timeseries,
    torchmon,
)
from machine_learning_replications_tpu_torch.obs import alerts as alertsmod
from machine_learning_replications_tpu_torch.obs import incident as incidentmod
from machine_learning_replications_tpu_torch.obs import quality as qualitymod
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.resilience import faults
from machine_learning_replications_tpu_torch.resilience.supervisor import (
    DEGRADED_SHEDS,
    BreakerOpen,
    ComputeDeadlineExceeded,
    SupervisedEngine,
)
from machine_learning_replications_tpu_torch.serve.batcher import (
    MicroBatcher,
    Overloaded,
    PathRouter,
)
from machine_learning_replications_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    BucketedPredictEngine,
)
from machine_learning_replications_tpu_torch.serve.hostpath import (
    DEFAULT_HOST_BUCKETS,
    HOST_FALLBACKS,
    PATHS,
    HostBusy,
    HostPath,
    HostScorer,
)
from machine_learning_replications_tpu_torch.serve.metrics import ServingMetrics
from machine_learning_replications_tpu_torch.serve.transport import (
    EventLoopHttpServer,
)

#: On the CPU mid-size flushes padding into the big buckets are pure
#: waste, so flushes there are capped at the 64-row bucket (the JAX
#: server's CPU default); on the card the top bucket stays (big batches
#: are the whole point of an accelerator).
CPU_DEFAULT_MAX_BATCH = 64

# predict_hf.py:38-40 — the single-patient CLI prints exactly this line;
# the HTTP reply carries it verbatim so the serving layer inherits the
# output contract.
OUTPUT_CONTRACT = "Probability of progressive HF is: {:.2f} %"

#: Rolling-deploy accounting (docs/FLEET.md): ok = the target version
#: swapped in; rolled_back = the checkpoint failed to restore and the
#: retained last-known-good was served instead; failed = nothing swapped
#: (load/warmup/parity failure — the previous engine keeps serving).
DEPLOYS = REGISTRY.counter(
    "serve_deploys_total",
    "In-place model deploys (/admin/deploy) by result.",
    labels=("result",),
)
#: The served checkpoint's monotonic version id (0 when unversioned —
#: pickle-imported params or a pre-versioning checkpoint). The loadgen
#: crossover evidence reads the per-reply X-Model-Version header; this
#: gauge is the same fact on the scrape side.
MODEL_VERSION = REGISTRY.gauge(
    "serve_model_version",
    "Monotonic checkpoint version currently served (0 = unversioned).",
)
#: Pre-fork worker attribution through the shared SO_REUSEPORT port:
#: constant 1, the worker label carries the id (registered at import,
#: rule metrics-catalog; a single-worker process never sets a child).
WORKER_INFO = REGISTRY.gauge(
    "serve_worker_info",
    "Serving worker identity (pre-fork multi-worker mode); constant 1, "
    "the worker label carries the id.",
    labels=("worker",),
)


def _retry_after(seconds: float) -> dict[str, str]:
    """``Retry-After`` header for degraded-mode sheds: integer seconds,
    floor 1 (RFC 7231 delta-seconds; a 0 would invite an instant retry
    stampede against a still-restarting engine)."""
    return {"Retry-After": str(max(1, math.ceil(seconds)))}


class ServerHandle:
    """A running serving stack: engine + batcher + metrics + request-trace
    recorder + SLO tracker + event-loop HTTP listener."""

    def __init__(
        self, engine, batcher, metrics, httpd,
        recorder=None, slo_tracker=None, profile_dir: str | None = None,
        quality=None, worker_id: int | None = None,
        host=None, router=None, quality_feed=None,
        model_version: int | None = None, replica_id: str | None = None,
        admin_enabled: bool = False, live=None, say=None, device=None,
    ) -> None:
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics
        self.httpd = httpd  # transport.EventLoopHttpServer
        self.recorder = recorder
        self.slo_tracker = slo_tracker
        self.profile_dir = profile_dir
        self.quality = quality  # obs.quality.QualityMonitor or None
        self.worker_id = worker_id  # multi-worker id (cli serve --workers N), or None
        self.host = host            # hostpath.HostPath or None
        self.router = router        # batcher.PathRouter or None
        self.quality_feed = quality_feed  # AsyncQualityFeed or None
        # Fleet identity (docs/FLEET.md): the checkpoint version this
        # replica serves and the id it registered under — echoed on every
        # reply (X-Model-Version / X-Replica) so the rolling-deploy
        # crossover is provable from client artifacts alone.
        self.model_version = model_version
        self.replica_id = replica_id
        self.admin_enabled = admin_enabled  # /admin/deploy opt-in
        # Where the engine runs: deploys load the new checkpoint there.
        self.device = device
        # The live-params holder the supervised-restart factory reads
        # through (make_server) — deploys update it so a post-deploy
        # restart rebuilds the CURRENT model, not the boot-time one.
        self.live = live if live is not None else {"params": None}
        # The alerting plane (obs.timeseries / obs.alerts /
        # obs.incident), wired by make_server; all optional.
        self.history = None
        self.sampler = None
        self.alerts = None
        self.incidents = None
        self._say = say
        self._deploy_lock = threading.Lock()
        self.deploy_status: dict | None = None
        # Graceful-drain marker: set FIRST in shutdown so /readyz drops
        # before admission closes — a load balancer stops routing here
        # while in-flight requests finish.
        self.draining = False
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> "ServerHandle":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self, drain: bool = True) -> None:
        """Graceful stop: mark draining (readiness goes false), close
        admission (draining by default — every in-flight reply is still
        written through the live event loop), then stop and flush the
        transport. Safe to call more than once."""
        self.draining = True
        if self.sampler is not None:
            self.sampler.close()
        self.batcher.close(drain=drain)
        if self.host is not None:
            # In-flight host-path work finishes (its computes are
            # single-digit ms); anything unclaimed fails fast — same
            # admitted-work contract as the batcher drain.
            self.host.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        close_engine = getattr(self.engine, "close", None)
        if close_engine is not None:  # supervised: stop the worker thread
            close_engine()
        if self.quality_feed is not None:
            # Drain-then-stop: rows already handed off still reach the
            # monitor so a post-shutdown snapshot reflects all traffic.
            self.quality_feed.close()
        if self.incidents is not None:
            self.incidents.close()

    # -- fleet identity ------------------------------------------------------

    def identity_headers(self) -> dict[str, str]:
        """Per-reply fleet identity: which replica answered, serving which
        checkpoint version. The front-door router passes these through,
        so a client artifact (loadgen's ``fleet`` block) can prove the
        rolling-deploy crossover without touching a single scrape."""
        h: dict[str, str] = {}
        if self.replica_id is not None:
            h["X-Replica"] = self.replica_id
        if self.model_version is not None:
            h["X-Model-Version"] = str(self.model_version)
        return h

    # -- in-place model deploy ----------------------------------------------

    def deploy_model(self, model_path: str) -> dict:
        """Warm-swap this replica onto the checkpoint at ``model_path``
        (docs/FLEET.md "Deploy lifecycle"). Runs on the caller's thread —
        the /admin/deploy handler spawns one — entirely off the request
        path: the live engine keeps serving while the new version loads,
        builds, warms, and proves parity; only then does the atomic swap
        happen. Single-flight (``RuntimeError`` when one is already in
        progress). Steps:

          1. ``load_model_versioned``: integrity-verified restore with
             the last-known-good rollback net — a corrupt checkpoint
             deploys the PREVIOUS version, loudly (``rolled_back``).
          2. Build + warm a fresh engine (and host scorer, when the fast
             path is on) via the supervisor's rebuild machinery.
          3. Parity probe: the new engine's probabilities must equal the
             eager oracle composition bit-for-bit on probe rows — the
             same contract the serve parity suite pins.
          4. ``SupervisedEngine.swap_engine`` (+ host scorer swap): a
             reference swap, atomic at flush granularity; the restart
             factory now rebuilds the new version.

        Any failure before step 4 leaves the previous engine serving and
        reports ``result="failed"`` — a bad deploy can degrade a replica
        to its previous model, never to a dead server."""
        from machine_learning_replications_tpu_torch.persist import checkpoint
        from machine_learning_replications_tpu_torch.resilience.supervisor import (
            SupervisedEngine,
        )

        if not isinstance(self.engine, SupervisedEngine):
            raise RuntimeError(
                "in-place deploy requires a supervised engine "
                "(serve without --no-supervise)"
            )
        if not self._deploy_lock.acquire(blocking=False):
            raise RuntimeError("a deploy is already in progress")
        t0 = time.monotonic()
        status: dict = {
            "state": "loading", "target": model_path,
            "from_version": self.model_version,
            # Display timestamp in the deploy-status payload; durations
            # come from the monotonic t0 above.
            "started": time.time(),  # graftcheck: disable=monotonic-clock
        }
        self.deploy_status = status
        journal.event(
            "deploy_start", path=model_path,
            from_version=self.model_version, replica=self.replica_id,
        )
        try:
            params, info = checkpoint.load_model_versioned(
                model_path, device=self.device
            )
            status.update(
                state="warming", to_version=info["version"],
                rolled_back=info["rolled_back"],
            )
            engine_buckets = self.engine.buckets
            # The new engine keeps feeding the SAME quality monitor only
            # when the input space is unchanged; a different family (or
            # lasso support) would feed rows the reference profile cannot
            # bin, so monitoring detaches, journaled.
            quality = (
                self.engine.quality
                if _same_input_space(self.live.get("params"), params)
                else None
            )
            if quality is None and self.engine.quality is not None:
                journal.event("deploy_quality_detached", path=model_path)
                if self.quality is not None:
                    # The kept monitor will never be fed again — left
                    # enabled it would serve its PRE-deploy status (e.g.
                    # a frozen 'alert') forever, which an unattended
                    # continual-learning daemon would read as "the
                    # promotion never recovered" and retrain in a loop.
                    # Disabled, /debug/quality says so and the trigger
                    # treats this replica as non-voting.
                    self.quality.disable(
                        "detached by deploy: the new checkpoint's input "
                        "space does not match the reference profile"
                    )

            def factory():
                # Captures the new engine's graphs while the old engine
                # keeps replaying its own (thread_local capture mode, one
                # stream and one lock per engine).
                eng = BucketedPredictEngine(
                    params, buckets=engine_buckets, quality=quality,
                    device=self.device,
                )
                # The version tags the engine (not just handle state) so
                # replies name the version of the bits they carry even
                # across the swap instant — and so a post-deploy
                # supervised restart rebuilds a correctly-tagged engine.
                eng.model_version = info["version"]
                eng.warmup(say=self._say)
                return eng

            new_engine = factory()
            new_scorer = None
            if self.host is not None:
                new_scorer = HostScorer(
                    params, buckets=self.host.scorer.buckets,
                    quality=quality,
                )
                new_scorer.model_version = info["version"]
                new_scorer.warmup(say=self._say)
            status["state"] = "verifying"
            _verify_parity(params, new_engine, new_scorer)
            self.engine.swap_engine(new_engine, factory)
            if new_scorer is not None:
                self.host.swap_scorer(new_scorer)
            self.live["params"] = params
            if quality is not None and self.quality is not None:
                # Continual-learning rebase (docs/CONTINUAL.md): when the
                # new checkpoint ships its OWN reference profile (a
                # retrained candidate fit on the shifted cohort), the
                # kept monitor must judge traffic against THAT baseline
                # — keeping the superseded model's profile would hold
                # the fleet in alert forever on exactly the traffic the
                # refit was promoted to match. Same-width is guaranteed
                # here (_same_input_space passed); the recovery to ok is
                # earned by post-swap traffic, journaled as a real
                # quality_status transition. A profile-less checkpoint
                # keeps the existing baseline unchanged, as before.
                new_profile = getattr(params, "quality", None)
                if new_profile is not None:
                    try:
                        self.quality.rebase(new_profile)
                    except Exception as exc:
                        # The engine swap above already committed — the
                        # replica IS serving the new version. Raising
                        # here would report a 'failed' deploy for a
                        # model that is live (the rollback rail would
                        # then reason from wrong state). A profile the
                        # monitor can't adopt detaches monitoring
                        # instead, loudly, on every surface.
                        journal.event(
                            "deploy_quality_detached", path=model_path,
                            error=str(exc),
                        )
                        self.quality.disable(
                            f"rebase failed after deploy: {exc}"
                        )
            self.model_version = info["version"]
            if info["version"] is not None:
                MODEL_VERSION.get().set(float(info["version"]))
            result = "rolled_back" if info["rolled_back"] else "ok"
            status.update(
                state="done", result=result, version=info["version"],
                restored_from=info["path"],
                seconds=round(time.monotonic() - t0, 3),
            )
            DEPLOYS.inc(result=result)
            journal.event(
                "deploy_applied", path=model_path,
                from_version=status["from_version"],
                to_version=info["version"],
                rolled_back=info["rolled_back"], replica=self.replica_id,
                seconds=status["seconds"],
            )
            return status
        except BaseException as exc:
            status.update(
                state="done", result="failed",
                error=f"{type(exc).__name__}: {exc}",
                seconds=round(time.monotonic() - t0, 3),
            )
            DEPLOYS.inc(result="failed")
            journal.event(
                "deploy_failed", path=model_path, replica=self.replica_id,
                error=status["error"], seconds=status["seconds"],
            )
            raise
        finally:
            self._deploy_lock.release()


def _same_input_space(old_params, new_params) -> bool:
    """True when the new checkpoint scores the same input space the
    quality monitor was built over: same param family, same lasso
    support (when the family selects columns)."""
    if old_params is None or type(old_params) is not type(new_params):
        return False
    old_mask = getattr(old_params, "support_mask", None)
    new_mask = getattr(new_params, "support_mask", None)
    if (old_mask is None) != (new_mask is None):
        return False
    if old_mask is not None:
        import numpy as np

        from machine_learning_replications_tpu_torch.device import to_host

        if not np.array_equal(to_host(old_mask), to_host(new_mask)):
            return False
    return True


def _oracle_probs(params, rows):
    """The eager single-request composition — the exact route
    ``cli predict`` takes — as the deploy parity oracle (shared with the
    engine's warmup probe: ``serve.engine.oracle_proba1``)."""
    from machine_learning_replications_tpu_torch.serve.engine import oracle_proba1

    return oracle_proba1(params, rows)


def _verify_parity(params, engine, scorer=None, n_rows: int = 4) -> None:
    """Probe-row parity gate for a deploy candidate: the warmed engine
    (and host scorer) must reproduce the eager oracle at the engine
    parity contract (``parity_tolerance`` of the parameters' dtype: rtol
    1e-12 in float64, 1e-5 in float32; wrong weights differ at 1e-1) —
    and the host and device paths must agree with EACH OTHER on the
    single-row program, bit for bit when both run on the CPU and at the
    parity tolerance when the engine runs on the card, before the
    candidate may swap into rotation. A wrong-weights candidate can never
    serve a single wrong answer."""
    import numpy as np

    from machine_learning_replications_tpu_torch.data.examples import patient_row
    from machine_learning_replications_tpu_torch.serve.engine import (
        parity_tolerance,
    )

    base = np.asarray(patient_row(), np.float64)
    rng = np.random.default_rng(0)
    rows = np.concatenate(
        [base] + [
            base * (1.0 + 0.05 * rng.standard_normal(base.shape))
            for _ in range(n_rows - 1)
        ],
        axis=0,
    )
    rtol, atol = parity_tolerance(params)
    want = _oracle_probs(params, rows)
    got = np.asarray(engine.predict(rows), np.float64)
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise RuntimeError(
            "deploy candidate failed the parity probe: engine "
            f"probabilities {got.tolist()} != oracle {want.tolist()}"
        )
    if scorer is not None:
        got_host = np.asarray(
            [float(scorer.predict(r[None, :])[0]) for r in rows], np.float64
        )
        # Host vs device: same composition, same SINGLE-ROW program
        # shape on both sides (hostpath.py). On one CPU the two are the
        # same torch program and must agree bit for bit; the card's
        # kernels sum in their own order, so there they agree at the
        # parity tolerance.
        got_single = np.asarray(
            [float(engine.predict(r[None, :])[0]) for r in rows],
            np.float64,
        )
        on_cpu = getattr(engine, "device", None) is None or \
            engine.device.type == "cpu"
        same = (
            np.array_equal(got_host, got_single) if on_cpu
            else np.allclose(got_host, got_single, rtol=rtol, atol=atol)
        )
        if not same:
            raise RuntimeError(
                "deploy candidate failed the host-path parity probe: "
                f"{got_host.tolist()} != device {got_single.tolist()}"
            )


class _InFlight:
    """One admitted /predict request: the race between the batcher's
    completion (any flush thread) and the deadline timer (loop thread) is
    resolved under a lock — exactly one of them replies."""

    __slots__ = ("app", "trace", "responder", "future", "timer", "path",
                 "deadline_s", "row", "fell_back", "_done", "_lock")

    def __init__(self, app, trace, responder, future, path: str = "device",
                 deadline_s: float | None = None, row=None) -> None:
        self.app = app
        self.trace = trace
        self.responder = responder
        self.future = future
        self.timer = None
        self.path = path
        self.deadline_s = (
            deadline_s if deadline_s is not None else app.request_timeout_s
        )
        # Host-path requests keep their row for the one-shot fallback
        # resubmission through the device path (see on_done).
        self.row = row
        self.fell_back = False
        self._done = False
        self._lock = threading.Lock()

    def _claim(self) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            return True

    def on_deadline(self) -> None:
        """The request missed its reply deadline (loop thread)."""
        if not self._claim():
            return
        app, trace = self.app, self.trace
        # Cancel so a still-queued request is dropped at flush time (the
        # batcher skips cancelled entries) — otherwise every deadline miss
        # still burns an engine slot computing an answer nobody reads,
        # compounding the overload.
        cancelled = self.future.cancel()
        app.metrics.timeouts_total.inc()
        msg = f"timed out after {self.deadline_s:g}s"
        if cancelled:
            # Truly unclaimed: the wait WAS the request — attribute it as
            # queue time. When cancel LOSES the claim race the flush
            # thread is stamping its own phases concurrently, so leave the
            # trace to it.
            trace.add_phase(
                "queue_wait",
                trace.phase_end("parse", trace.t_start),
                time.perf_counter(),
            )
        # Freeze BEFORE replying: a finished trace rejects late
        # flush-thread stamps, so the published phases can never overlap
        # each other or extend past t_end.
        trace.finish("timeout", error=msg)
        app._fail(self.responder, trace, "timeout", 504, msg)

    def on_done(self, future) -> None:
        """The batcher/host pool resolved the future (flush or host-path
        worker thread — or inline when already resolved at callback
        registration)."""
        exc0 = None if future.cancelled() else future.exception()
        if exc0 is not None and self.path == "host" and self.row is not None:
            # Host fast-path failure: ONE transparent resubmission through
            # the device path before anything reaches the client. The
            # supervised engine owns failure semantics — its watchdog,
            # breaker streak, and restart machinery must see engine
            # faults, and the host path is an optimization, not a second
            # failure domain (a persistently broken engine then degrades
            # exactly as it would without routing: device 500s feed the
            # breaker, the breaker sheds, the supervisor restarts).
            with self._lock:
                retry = not self._done and not self.fell_back
                if retry:
                    self.fell_back = True
            if retry:
                HOST_FALLBACKS.inc()
                self.path = "device"
                self.trace.note(path="device",
                                path_reason="host_error_fallback")
                # The failed attempt's phases would overlap the device
                # path's fresh stamps (its queue_wait restarts at parse
                # end); drop them so the published phases still
                # partition the request — the abandoned host time reads
                # as queueing, which is what it was to the client.
                self.trace.drop_phases("queue_wait", "host_compute")
                try:
                    # count=False: this logical request was counted at
                    # its host admission; the resubmission must not move
                    # requests_total again.
                    new_future = self.app.batcher.submit(
                        self.row, trace=self.trace, count=False
                    )
                except BaseException as sub_exc:
                    if not self._claim():
                        return
                    if self.timer is not None:
                        self.timer.cancel()
                    if isinstance(sub_exc, Overloaded):
                        self.trace.note(shed=True)
                        self.app._fail(self.responder, self.trace, "shed",
                                       503, "overloaded")
                    else:
                        self.app._fail(self.responder, self.trace, "error",
                                       500, str(exc0))
                    return
                self.future = new_future
                new_future.add_done_callback(self.on_done)
                return
        if not self._claim():
            return  # the deadline path already answered (and cancelled us)
        if self.timer is not None:
            self.timer.cancel()
        app, trace, responder = self.app, self.trace, self.responder
        exc = future.exception()
        if exc is not None:
            if isinstance(exc, BreakerOpen):
                # The breaker opened after this request was admitted (its
                # flush ran while degraded): same explicit shed contract
                # as the pre-admission check.
                DEGRADED_SHEDS.inc()
                trace.note(shed=True, degraded=True)
                app._fail(
                    responder, trace, "shed", 503, str(exc),
                    headers=_retry_after(exc.retry_after_s),
                )
            elif isinstance(exc, ComputeDeadlineExceeded):
                # The watchdog abandoned a wedged compute: the request is
                # dead in bounded time — 504, never a hang.
                app._fail(responder, trace, "timeout", 504, str(exc))
            else:
                app._fail(responder, trace, "error", 500, str(exc))
            return
        prob = future.result()
        # Respond phase starts at compute end (device_compute for the
        # batched path, host_compute for the fast path), so the phases
        # partition the whole server-side interval: completion-callback
        # scheduling delay is response-path latency, not dead time.
        t_resp0 = trace.phase_end(
            "device_compute",
            trace.phase_end("host_compute", time.perf_counter()),
        )
        try:
            # Faultpoint on the respond path: an injected fault here drops
            # the connection with NOTHING written — the client sees an
            # explicit transport error. A partial/garbled 200 body would
            # be the one unforgivable failure mode (a wrong answer); a
            # dead socket is not.
            faults.fire("server.respond")
        except faults.InjectedFault as exc:
            responder.abort()
            trace.add_phase("respond", t_resp0, time.perf_counter())
            trace.finish("error", error=str(exc))
            if app.slo_tracker is not None:
                app.slo_tracker.observe(trace.total_s, ok=False)
            app.recorder.record(trace)
            return
        # The taken path rides every reply so clients (loadgen's `paths`
        # block) can account the routing split without a /metrics scrape
        # — and the fleet identity (replica id + model version) rides
        # with it for the deploy crossover. The version comes from the
        # compute-time tag when one was stamped (batcher flush / host
        # worker note it from the engine that ran): handle state at
        # respond time can already name the NEXT version for bits an
        # in-flight flush computed on the old engine mid-deploy.
        identity = {"X-Serve-Path": self.path,
                    **app.handle.identity_headers()}
        computed_version = trace.meta.get("model_version")
        if computed_version is not None:
            identity["X-Model-Version"] = str(computed_version)
        responder.send_json(200, {
            "probability": prob,
            "text": OUTPUT_CONTRACT.format(100.0 * prob),
        }, request_id=trace.request_id, headers=identity)
        trace.add_phase("respond", t_resp0, time.perf_counter())
        trace.finish("ok")
        if app.slo_tracker is not None:
            app.slo_tracker.observe(trace.total_s, ok=True)
        app.recorder.record(trace)


class _App:
    """The application the transport dispatches into. Handlers run ON the
    event-loop thread and never block: /predict completes through the
    batcher future's done-callback, /debug/profile on its own thread —
    everything else is fast enough to answer inline."""

    def __init__(self, handle: ServerHandle, request_timeout_s: float,
                 quiet: bool) -> None:
        self.handle = handle
        self.request_timeout_s = float(request_timeout_s)
        self.quiet = quiet
        # Captured once (same lifetime as the old closure-captured
        # handler): tests may swap batcher internals, never these slots.
        self.batcher = handle.batcher
        self.metrics = handle.metrics
        self.engine = handle.engine
        self.recorder = handle.recorder
        self.slo_tracker = handle.slo_tracker
        self.host = handle.host          # HostPath or None
        self.router = handle.router      # PathRouter or None

    # -- transport interface -----------------------------------------------

    def handle_request(self, req, rsp) -> None:
        if not self.quiet:
            print(f"{req.method} {req.target}", file=sys.stderr)
        if req.method == "GET":
            self._get(req, rsp)
        elif req.method == "POST":
            self._post(req, rsp)
        else:
            rsp.send_json(
                501, {"error": f"unsupported method {req.method}"},
                close=True,
            )

    def handle_protocol_error(self, exc, rsp) -> None:
        """An unframeable request (bad Content-Length, oversized body or
        headers, malformed line). The reply always closes the connection
        — the parser no longer knows where the next request starts. A
        /predict failure still gets a trace (client-fault: it never
        reaches the SLO — a malformed body is not a served request the
        availability objective can lose)."""
        if exc.path == "/predict":
            trace = reqtrace.RequestTrace(
                reqtrace.sanitize_request_id(exc.headers.get("x-request-id"))
            )
            self._fail(
                rsp, trace, "bad_request", exc.code, exc.message,
                observe_slo=False, close=True,
            )
        else:
            rsp.send_json(exc.code, {"error": exc.message}, close=True)

    # -- failure path ------------------------------------------------------

    def _fail(
        self, rsp, trace, status: str, code: int, message: str,
        observe_slo: bool = True,
        headers: dict[str, str] | None = None,
        close: bool = False,
    ) -> None:
        """Terminal error path for a traced /predict request: reply
        (respond phase stamped around the enqueue), finish + record the
        trace, and feed the SLO tracker (client-fault 4xx paths pass
        ``observe_slo=False``). The responder never raises — a client
        that already hung up cannot exempt its request from the burn
        gauges or the flight recorder (the transport accounts the write
        failure separately)."""
        t0 = time.perf_counter()
        rsp.send_json(
            code, {"error": message}, request_id=trace.request_id,
            headers={**self.handle.identity_headers(), **(headers or {})},
            close=close,
        )
        trace.add_phase("respond", t0, time.perf_counter())
        trace.finish(status, error=message)
        if self.slo_tracker is not None and observe_slo:
            self.slo_tracker.observe(trace.total_s, ok=False)
        self.recorder.record(trace)

    # -- GET ----------------------------------------------------------------

    def _readiness_blockers(self) -> list[str]:
        """Why this replica should NOT receive traffic right now (empty =
        ready). The three non-ready states are exactly the ones a load
        balancer must react to without killing the process: still
        compiling, draining out, or degraded."""
        reasons = []
        if not self.engine.warm:
            reasons.append("warmup incomplete")
        if self.handle.draining:
            reasons.append("draining")
        if getattr(self.engine, "breaker_open", False):
            reasons.append("degraded: circuit breaker open")
        return reasons

    def _get(self, req, rsp) -> None:
        path, handle, engine = req.path, self.handle, self.engine
        if path == "/healthz":
            jrn = journal.get_journal()
            breaker = (
                engine.snapshot()
                if isinstance(engine, SupervisedEngine) else None
            )
            degraded = getattr(engine, "breaker_open", False)
            blockers = self._readiness_blockers()
            rsp.send_json(200, {
                # Liveness stays 200 even degraded: the process is alive
                # and must NOT be restarted by a prober — the supervisor
                # is already rebuilding the engine, and a kill would just
                # add a cold start on top.
                "status": "degraded" if degraded else "ok",
                "ready": not blockers,
                "draining": handle.draining,
                "breaker": breaker,
                "params": type(engine.params).__name__,
                "buckets": list(engine.buckets),
                "warm": engine.warm,
                "queue_depth": self.batcher.queue_depth,
                # Dual-path scoring: whether the host fast path is live
                # (the per-path traffic split is serve_path_total on
                # /metrics and the per-reply X-Serve-Path header).
                "host_path": handle.host is not None,
                "uptime_seconds": round(
                    self.metrics.uptime_seconds(), 3
                ),
                "run_id": (
                    jrn.manifest.get("run_id") if jrn is not None else None
                ),
                "worker": handle.worker_id,
                # Fleet identity: which replica this is and which
                # checkpoint version it serves (docs/FLEET.md).
                "replica": handle.replica_id,
                "model_version": handle.model_version,
                # Compact drift signal so an orchestrator can act on
                # model-quality degradation from the same probe it
                # already polls (full detail: /debug/quality).
                "quality": (
                    handle.quality.health()
                    if handle.quality is not None
                    else {"status": "disabled"}
                ),
                # Alerting plane summary (obs.alerts): rule counts and
                # the worst firing severity; None when disabled.
                "alerts": (
                    handle.alerts.summary()
                    if handle.alerts is not None else None
                ),
            })
        elif path == "/readyz":
            blockers = self._readiness_blockers()
            rsp.send_json(
                200 if not blockers else 503,
                {
                    "ready": not blockers, "reasons": blockers,
                    # The fleet prober reads identity off the same probe
                    # it rotates on: one GET per replica per tick.
                    "replica": handle.replica_id,
                    "version": handle.model_version,
                    # ... and the admission-queue depth: the router's
                    # least-loaded score and the autoscaler both read
                    # replica load without an extra request.
                    "queue_depth": self.batcher.queue_depth,
                    # This process's monotonic clock, echoed so the
                    # router's ClockSync can estimate the per-replica
                    # offset (NTP-style midpoint) and place replica-side
                    # trace phases on the router's timeline.
                    "clock_perf": time.perf_counter(),
                },
            )
        elif path == "/admin/deploy":
            if not handle.admin_enabled:
                rsp.send_json(403, {
                    "error": "admin deploy endpoint disabled "
                    "(start serve with --admin-endpoint)",
                })
            else:
                rsp.send_json(200, {
                    "deploy": handle.deploy_status,
                    "model_version": handle.model_version,
                })
        elif path == "/debug/faults":
            if not faults.endpoint_enabled():
                rsp.send_json(403, {
                    "error": "fault-injection endpoint disabled "
                    "(start serve with --inject or --fault-endpoint)",
                })
            else:
                rsp.send_json(200, faults.snapshot())
        elif path == "/debug/quality":
            if handle.quality is None:
                rsp.send_json(200, qualitymod.disabled_snapshot(
                    "no reference profile in the served params "
                    "(or started with --no-quality)"
                ))
            elif handle.quality_feed is not None:
                # Async feed: drain what is already handed off so a
                # snapshot taken right after traffic reflects that
                # traffic. The bounded wait runs on its own short-lived
                # thread (the /debug/profile pattern) — the event loop
                # must never block behind the feed.
                threading.Thread(
                    target=self._quality_snapshot, args=(rsp,),
                    name="serve-quality-snap", daemon=True,
                ).start()
            else:
                rsp.send_json(200, handle.quality.snapshot(detail=True))
        elif path == "/debug/requests":
            rid = req.query_param("id", "")
            if rid:
                # Exact lookup by request id (the fleet trace join's
                # fetch primitive): every completed request is indexed,
                # not just the tail-sampled ring, since the router and
                # replica sample independently.
                snap = self.recorder.lookup(rid)
                if snap is None:
                    rsp.send_json(404, {
                        "error": f"request id not indexed: {rid}",
                    })
                else:
                    rsp.send_json(200, {"request": snap})
                return
            try:
                n = int(req.query_param("n", "64"))
            except ValueError:
                rsp.send_json(400, {"error": "n must be an integer"})
                return
            rsp.send_json(200, {
                "stats": self.recorder.stats(),
                "slo": (
                    self.slo_tracker.snapshot()
                    if self.slo_tracker is not None else []
                ),
                "requests": self.recorder.snapshot(n),
            })
        elif path == "/debug/alerts":
            # In-memory read — inline is fine.
            if handle.alerts is None:
                rsp.send_json(200, {
                    "enabled": False, "active": [], "summary": None,
                })
                return
            snap = handle.alerts.snapshot()
            rsp.send_json(200, {
                "enabled": True,
                "active": snap["active"],
                "summary": handle.alerts.summary(),
                "rules": snap["rules"],
            })
        elif path == "/debug/history":
            store = handle.history
            if store is None:
                rsp.send_json(200, {"enabled": False, "families": {}})
                return
            family = req.query_param("family", "")
            if not family:
                rsp.send_json(200, {
                    "enabled": True,
                    "families": store.families(),
                    "stats": store.stats(),
                })
                return
            try:
                window = float(req.query_param("window", "0") or 0)
            except ValueError:
                rsp.send_json(400, {"error": "window must be a number"})
                return
            now = time.time()  # graftcheck: disable=monotonic-clock
            rsp.send_json(200, store.query(
                family, window if window > 0 else None, now,
            ))
        elif path == "/debug/profile":
            try:
                seconds = float(req.query_param("seconds", "1"))
            except ValueError:
                rsp.send_json(400, {"error": "seconds must be a number"})
                return
            # The capture blocks for its whole window — on a dedicated
            # short-lived thread, never the event loop (a 10 s capture
            # inline would stall every connection for 10 s).
            threading.Thread(
                target=self._profile_capture, args=(seconds, rsp),
                name="serve-profile", daemon=True,
            ).start()
        elif path == "/metrics":
            fmt = req.query_param("format", "prometheus")
            if fmt == "json":
                snap = self.metrics.snapshot()
                snap["runtime"] = REGISTRY.snapshot()
                rsp.send_json(200, snap)
            else:
                # serve_* exposition first, byte-identical to the
                # standalone render; the global registry (graph-capture,
                # kernel and transfer accounting) appended as its own
                # families.
                text = self.metrics.render_prometheus() + \
                    REGISTRY.render_prometheus()
                rsp.send(
                    200, text.encode(), "text/plain; version=0.0.4",
                )
        else:
            rsp.send_json(404, {"error": f"no such path: {path}"})

    def _quality_snapshot(self, rsp) -> None:
        try:
            self.handle.quality_feed.drain(timeout=2.0)
            snap = self.handle.quality.snapshot(detail=True)
        except Exception as exc:
            rsp.send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        rsp.send_json(200, snap)

    def _profile_capture(self, seconds: float, rsp) -> None:
        try:
            artifact = profiler.capture(seconds, self.handle.profile_dir)
        except profiler.ProfilerBusy as exc:
            rsp.send_json(409, {"error": str(exc)})
            return
        except ValueError as exc:
            rsp.send_json(400, {"error": str(exc)})
            return
        except Exception as exc:  # profiler backend failure
            rsp.send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        rsp.send_json(200, artifact)

    # -- POST ---------------------------------------------------------------

    def _post(self, req, rsp) -> None:
        if req.path == "/debug/faults":
            self._post_faults(req, rsp)
            return
        if req.path == "/admin/deploy":
            self._post_deploy(req, rsp)
            return
        if req.path != "/predict":
            # The body was framed and consumed, but a POST to an unknown
            # path keeps the threaded server's contract: reply 404 and
            # close.
            rsp.send_json(
                404, {"error": f"no such path: {req.target}"}, close=True,
            )
            return
        self._predict(req, rsp)

    def _post_deploy(self, req, rsp) -> None:
        """POST /admin/deploy ``{"model": PATH}``: warm-swap this replica
        onto a new checkpoint version (``ServerHandle.deploy_model``).
        Guarded like /debug/faults — a production server must not be
        model-swappable by whoever can reach its port. The reply comes
        when the deploy is DONE (load + warm + parity + swap), so the
        fleet controller's per-replica step is one long POST; progress is
        observable meanwhile on GET /admin/deploy. Runs on a dedicated
        thread — warmup captures must never stall the event loop."""
        if not self.handle.admin_enabled:
            rsp.send_json(403, {
                "error": "admin deploy endpoint disabled "
                "(start serve with --admin-endpoint)",
            }, close=True)
            return
        try:
            body = json.loads(req.body or b"{}")
            model = body.get("model") if isinstance(body, dict) else None
            if not model or not isinstance(model, str):
                raise ValueError('expected {"model": "checkpoint path"}')
        except (ValueError, json.JSONDecodeError) as exc:
            rsp.send_json(400, {"error": str(exc)})
            return

        def run():
            try:
                status = self.handle.deploy_model(model)
            except RuntimeError as exc:
                busy = "already in progress" in str(exc)
                rsp.send_json(
                    409 if busy else 500,
                    {"error": str(exc),
                     "deploy": self.handle.deploy_status},
                )
                return
            except Exception as exc:
                rsp.send_json(500, {
                    "error": f"{type(exc).__name__}: {exc}",
                    "deploy": self.handle.deploy_status,
                })
                return
            rsp.send_json(200, {"deploy": status})

        threading.Thread(
            target=run, name="serve-deploy", daemon=True
        ).start()

    def _post_faults(self, req, rsp) -> None:
        """POST /debug/faults: arm/disarm/reset the injection registry
        over HTTP (the chaos driver's control plane). Guarded — see
        ``faults.enable_endpoint``."""
        if not faults.endpoint_enabled():
            rsp.send_json(403, {
                "error": "fault-injection endpoint disabled "
                "(start serve with --inject or --fault-endpoint)",
            }, close=True)
            return
        try:
            body = json.loads(req.body or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            if "arm" in body:
                faults.arm(str(body["arm"]))
            elif "disarm" in body:
                faults.disarm(str(body["disarm"]))
            elif body.get("reset"):
                faults.reset()
            else:
                raise ValueError(
                    'expected {"arm": SPEC}, {"disarm": SITE}, '
                    'or {"reset": true}'
                )
        except (ValueError, json.JSONDecodeError) as exc:
            rsp.send_json(400, {"error": str(exc)})
            return
        rsp.send_json(200, faults.snapshot())

    def _predict(self, req, rsp) -> None:
        from machine_learning_replications_tpu_torch.data.examples import (
            validate_patient,
        )

        # Request identity at admission: honor an inbound X-Request-Id
        # (sanitized — a hostile header must not inject into logs/replies),
        # mint one otherwise; every reply below echoes it.
        trace = reqtrace.RequestTrace(
            reqtrace.sanitize_request_id(req.get_header("x-request-id"))
        )
        try:
            # Faultpoint at admission, before the body is parsed: an
            # injected parse fault replies an explicit 500 and closes.
            faults.fire("server.parse")
        except faults.InjectedFault as exc:
            self._fail(rsp, trace, "error", 500, str(exc), close=True)
            return
        try:
            patient = json.loads(req.body or b"{}")
            row = validate_patient(patient)
        except (ValueError, json.JSONDecodeError) as exc:
            self._fail(
                rsp, trace, "bad_request", 400, str(exc), observe_slo=False
            )
            return
        trace.add_phase("parse", trace.t_start, time.perf_counter())
        # Degraded mode: while the breaker is open the engine cannot
        # answer, so shed HERE — an explicit 503 with a Retry-After
        # derived from the restart schedule — instead of admitting into a
        # queue that can only fail or time the client out.
        if getattr(self.engine, "breaker_open", False):
            # Both shed families move, once each: serve_shed_total is THE
            # shed-rate metric (overload + degraded alike — same
            # explicit-503 contract), resilience_degraded_sheds_total
            # attributes the degraded subset.
            self.metrics.shed_total.inc()
            DEGRADED_SHEDS.inc()
            trace.note(shed=True, degraded=True)
            self._fail(
                rsp, trace, "shed", 503, "degraded: engine restarting",
                headers=_retry_after(self.engine.retry_after_s()),
            )
            return
        # Per-request deadline: the server-wide --request-timeout, tightened
        # by an optional client X-Request-Deadline-Ms header (never
        # loosened — the server's bound is the contract). The router sees
        # the effective value: a tight deadline is a routing signal.
        deadline_s = self.request_timeout_s
        raw_deadline = req.get_header("x-request-deadline-ms")
        if raw_deadline:
            try:
                client_s = float(raw_deadline) / 1000.0
            except ValueError:
                client_s = 0.0
            if client_s > 0.0:
                deadline_s = min(deadline_s, client_s)
        # Dual-path routing (PathRouter, docs/SERVING.md): host fast path
        # for singles on an idle server, device micro-batches for bursts.
        # A HostBusy race (a slot vanished between decide and submit)
        # falls back to the device path; the counted path is the one the
        # request actually took. An inbound X-Serve-Path header pins the
        # request (device: always honored — the drill/bench escape hatch
        # for exercising the supervised engine directly; host: honored
        # when the fast path can take it) — pinning selects an execution
        # strategy, both of which serve the same bits.
        pin = (req.get_header("x-serve-path") or "").strip().lower()
        if self.router is None:
            path, reason = "device", "no_host_path"
        elif pin == "device":
            path, reason = "device", "client_pinned"
        elif pin == "host":
            # A zero deadline makes decide() prefer the host whenever it
            # can take the request; saturation/unavailability still fall
            # back with their own reason.
            path, reason = self.router.decide(0.0)
            if path == "host":
                reason = "client_pinned"
        else:
            path, reason = self.router.decide(deadline_s)
        future = None
        if path == "host":
            try:
                future = self.host.submit(row[0], trace=trace)
                self.metrics.requests_total.inc()
            except HostBusy:
                path, reason = "device", "host_saturated"
            except RuntimeError as exc:  # closed during shutdown
                self._fail(rsp, trace, "shed", 503, str(exc))
                return
        if future is None:
            try:
                future = self.batcher.submit(row[0], trace=trace)
            except Overloaded:
                trace.note(shed=True)
                self._fail(rsp, trace, "shed", 503, "overloaded")
                return
            except RuntimeError as exc:  # closed during shutdown
                self._fail(rsp, trace, "shed", 503, str(exc))
                return
        PATHS.inc(path=path)
        trace.note(path=path, path_reason=reason)
        ctx = _InFlight(
            self, trace, rsp, future, path=path, deadline_s=deadline_s,
            row=row[0] if path == "host" else None,
        )
        # Deadline on the loop clock; the done-callback and the timer race
        # under the ctx lock, so exactly one replies. add_done_callback
        # runs inline when the future already resolved.
        ctx.timer = self.handle.httpd.call_later(
            deadline_s, ctx.on_deadline
        )
        future.add_done_callback(ctx.on_done)


def make_server(
    params,
    host: str = "127.0.0.1",
    port: int = 8000,
    buckets=DEFAULT_BUCKETS,
    max_batch_size: int | None = None,
    max_wait_ms: float = 5.0,
    max_queue: int = 1024,  # above the top default bucket (512): a full
    # largest-bucket batch must be formable under saturation, or the top
    # bucket's executable only ever runs padded
    warmup: bool = True,
    request_timeout_s: float = 30.0,
    quiet: bool = True,
    say=None,
    slos=None,
    recorder=None,
    trace_capacity: int = 256,
    tail_quantile: float = 0.99,
    profile_dir: str | None = None,
    quality_profile=None,
    no_quality: bool = False,
    drift_warn_psi: float = qualitymod.DEFAULT_WARN_PSI,
    drift_alert_psi: float = qualitymod.DEFAULT_ALERT_PSI,
    quality_window: int = 2048,
    supervise: bool = True,
    flush_deadline_s: float = 20.0,
    breaker_failures: int = 3,
    restart_backoff_s: float = 0.5,
    restart_backoff_max_s: float = 30.0,
    fault_endpoint: bool = False,
    idle_timeout_s: float = 5.0,
    max_connections: int = 8192,
    host_path: bool = False,
    host_buckets=DEFAULT_HOST_BUCKETS,
    host_workers: int = 1,
    burst_depth: int = 1,
    tight_deadline_s: float = 0.05,
    quality_async: bool = True,
    model_version: int | None = None,
    replica_id: str | None = None,
    admin_endpoint: bool = False,
    history_interval_s: float = 10.0,
    alert_rules: list | None = None,
    alerts_enabled: bool = True,
    incident_dir: str | None = None,
    incident_min_interval_s: float = 60.0,
    incident_retention: int = 8,
    reuse_port: bool = False,
    worker_id: int | None = None,
    *,
    device=None,
) -> ServerHandle:
    """Assemble the serving stack around fitted ``params`` on ``device``
    (default: the card; without CUDA this raises — pass ``device="cpu"``
    to serve on the CPU) and bind the listener (not yet serving — call
    ``serve_forever`` or ``start_background``). ``max_batch_size``
    defaults to ``CPU_DEFAULT_MAX_BATCH`` (64) on the CPU, where big
    flushes are pure padded waste, and to the largest bucket on the
    card, where a full top bucket pads nothing.

    Dual-path scoring: with ``host_path=True`` (the ``cli serve``
    default; off here so embedded and test callers opt in) a
    ``HostScorer`` — the SAME engine composition over a CPU copy of the
    parameters at ``host_buckets`` — answers requests the ``PathRouter``
    routes away from the batcher: singles and small groups on an idle
    server skip both the coalescing window and the card's round trip. ``host_workers`` bounds the pool (a busy host path
    self-routes back to the device); ``burst_depth`` is the batcher
    queue depth at which coalescing wins; requests whose effective
    deadline is at or under ``tight_deadline_s`` prefer the host path.
    The split is exported as ``serve_path_total{path=…}``, echoed
    per-reply as ``X-Serve-Path``, and annotated on every trace.

    ``history_interval_s`` > 0 starts the telemetry history sampler
    (``obs.timeseries``) behind ``GET /debug/history``;
    ``alerts_enabled`` evaluates ``alert_rules`` (None →
    ``obs.alerts.default_rules("replica")``) each tick, served on
    ``GET /debug/alerts`` and summarized on ``/healthz``;
    ``incident_dir`` captures a flight-recorder bundle when a rule
    fires (docs/OBSERVABILITY.md "Alerting & incidents").

    ``quality_async`` (default) feeds the drift monitor through
    ``obs.quality.AsyncQualityFeed`` — a bounded hand-off serviced by a
    background thread, sampling then shedding (counted) under pressure —
    instead of running binning and PSI refreshes on the flush thread
    (measured at ~30% of saturated throughput in r11).

    Request-scoped observability: ``recorder`` (default a fresh
    ``reqtrace.FlightRecorder(trace_capacity, tail_quantile)``) receives
    every completed /predict trace under tail sampling; ``slos`` (default
    ``slo.default_slos()``; pass ``[]`` to disable) declares the
    objectives whose burn gauges ride ``/metrics``; ``profile_dir``
    (default a per-process dir under the system temp dir) receives
    ``/debug/profile`` captures.

    Model-quality monitoring (``obs.quality``): ``quality_profile`` is the
    training-time reference profile — by default the one the served
    ``PipelineParams`` carries (``params.quality``); pass one explicitly to
    monitor a bare imported ensemble, or ``no_quality=True`` to disable.
    When a profile is available, every flushed batch streams into a
    ``QualityMonitor`` (PSI/KS drift vs the reference under the
    ``drift_warn_psi``/``drift_alert_psi`` thresholds, over a
    ``quality_window``-row sliding window) exported on ``/metrics``
    (``quality_*``), ``/debug/quality``, and ``/healthz``. Without one,
    quality monitoring is simply off (``/healthz`` says ``disabled``) —
    pre-profile checkpoints keep serving.

    Resilience (``resilience.supervisor``, docs/RESILIENCE.md): with
    ``supervise`` (the default) the engine runs behind a watchdog
    (``flush_deadline_s`` per flush) and a circuit breaker
    (``breaker_failures`` consecutive failures, or one wedged compute,
    open it); while open, ``/predict`` sheds 503 + ``Retry-After`` and a
    supervised restart rebuilds + re-warms the engine under bounded
    exponential backoff (``restart_backoff_s``..``restart_backoff_max_s``).
    ``fault_endpoint`` opts the process into ``/debug/faults`` chaos
    control (``resilience.faults``).

    Transport (``serve.transport``): a non-blocking event loop serves
    every connection from one thread — keep-alive pipelining, bounded
    buffers, idle/slow-loris reaping after ``idle_timeout_s``, at most
    ``max_connections`` concurrent sockets. ``reuse_port`` binds with
    ``SO_REUSEPORT`` for the multi-worker mode (``cli serve --workers N``:
    each worker a process of its own, with its own CUDA context);
    ``worker_id`` threads the worker's identity into ``/healthz``,
    ``/metrics`` (``serve_worker_info{worker=…}``), and — via the CLI — the
    journal manifest, so scrapes and journals through the shared port stay
    attributable to a specific worker process.

    Fleet (docs/FLEET.md): ``model_version`` is the served checkpoint's
    monotonic version id (``persist.checkpoint_version``) and
    ``replica_id`` the identity this replica registered under — both are
    echoed per reply (``X-Model-Version`` / ``X-Replica``) and on the
    health probes. ``admin_endpoint`` opts into the guarded
    ``/admin/deploy`` warm-swap endpoint (``ServerHandle.deploy_model``)
    — off by default for the same reason ``/debug/faults`` is.

    The listener BINDS before warmup runs: a port conflict fails in
    milliseconds instead of after the captures. Warmup still completes
    before this returns (warm standby — the first served request never
    pays a capture); start serving first and call ``engine.warmup``
    yourself for observable warm=false readiness. On ANY failure (warmup
    included) the bound port is released."""
    from machine_learning_replications_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    # Capture/transfer accounting BEFORE the engine exists, so every
    # warmup capture lands in the /metrics counters.
    torchmon.install()
    quality_monitor = None
    if not no_quality:
        prof = (
            quality_profile if quality_profile is not None
            else getattr(params, "quality", None)
        )
        if prof is not None:
            # Full-pipeline checkpoints profile the model's OWN
            # lasso-selected columns (ascending schema order) — NOT the
            # 17-variable contract order a bare ensemble scores — so the
            # monitor's feature labels must come from the support mask,
            # or every quality_feature_psi series (and the /debug/quality
            # worst-offender table) names the wrong variable.
            feature_names = None
            if getattr(params, "support_mask", None) is not None:
                from machine_learning_replications_tpu_torch.models.pipeline import (
                    support_feature_names,
                )

                feature_names = support_feature_names(params)
            # Fail at startup, not on the first flush: a profile whose
            # width doesn't match the rows the engine will feed (e.g. one
            # built over a pre-selection 64-column matrix attached to a
            # bare 17-column ensemble) would otherwise fail every served
            # batch's observe call. Checked on the RAW profile, before
            # the monitor exists — constructing it first would register
            # phantom series in the process-global registry that no
            # rejection can remove.
            expected_width = (
                len(feature_names) if feature_names is not None else 17
            )
            if isinstance(prof, dict) and "bin_counts" in prof:
                width = int(prof["bin_counts"].shape[0])
                if width != expected_width:
                    raise ValueError(
                        f"quality profile is {width} features wide but "
                        f"the served model scores {expected_width}-feature "
                        "rows; build the profile over the model's own "
                        "input space"
                    )
            quality_monitor = qualitymod.QualityMonitor(
                prof,
                warn_psi=drift_warn_psi,
                alert_psi=drift_alert_psi,
                window=quality_window,
                feature_names=feature_names,
            )
    # The engine (and the host scorer) feed rows through the async
    # hand-off by default: drift math must not tax the flush thread.
    quality_feed = None
    engine_quality = quality_monitor
    if quality_monitor is not None and quality_async:
        quality_feed = qualitymod.AsyncQualityFeed(quality_monitor)
        engine_quality = quality_feed
    if fault_endpoint:
        faults.enable_endpoint()
    engine = BucketedPredictEngine(
        params, buckets=buckets, quality=engine_quality, device=dev
    )
    # Fleet identity rides ON the computing engine, not just the handle:
    # around a warm swap (/admin/deploy), in-flight flushes finish on the
    # engine they were submitted to, so the version a reply claims must
    # come from that engine — handle state at respond time can already
    # name the NEXT version for bits the old engine computed.
    engine.model_version = model_version
    if supervise:
        engine_buckets = engine.buckets

        def rebuild_engine():
            # Restart path (supervisor thread, off the request path):
            # fresh graphs, ALWAYS re-captured at warmup — a restarted
            # engine that made the first post-recovery requests pay the
            # captures would turn recovery into a tail-latency incident.
            eng = BucketedPredictEngine(
                params, buckets=engine_buckets, quality=engine_quality,
                device=dev,
            )
            eng.model_version = model_version
            eng.warmup(say=say)
            return eng

        engine = SupervisedEngine(
            engine, rebuild_engine,
            flush_deadline_s=flush_deadline_s,
            breaker_failures=breaker_failures,
            restart_backoff_s=restart_backoff_s,
            restart_backoff_max_s=restart_backoff_max_s,
        )
    if max_batch_size is None:
        max_batch_size = (
            min(CPU_DEFAULT_MAX_BATCH, engine.buckets[-1])
            if dev.type == "cpu" else engine.buckets[-1]
        )
    metrics = ServingMetrics(batch_buckets=engine.buckets)
    batcher = MicroBatcher(
        engine,
        max_batch_size=max_batch_size,
        max_wait_ms=max_wait_ms,
        max_queue=max_queue,
        metrics=metrics,
    )
    host_pool = router = None
    if host_path:
        scorer = HostScorer(
            params, buckets=host_buckets, quality=engine_quality,
        )
        scorer.model_version = model_version
        host_pool = HostPath(scorer, workers=host_workers, metrics=metrics)
        router = PathRouter(
            batcher, host_pool,
            burst_depth=burst_depth, tight_deadline_s=tight_deadline_s,
        )
    if recorder is None:
        recorder = reqtrace.FlightRecorder(
            capacity=trace_capacity, tail_quantile=tail_quantile
        )
    if slos is None:
        slos = slo.default_slos()
    slo_tracker = slo.SLOTracker(slos) if slos else None
    if profile_dir is None:
        profile_dir = os.path.join(
            tempfile.gettempdir(), f"mlr_profiles_{os.getpid()}"
        )
    if worker_id is not None:
        # Attribution through the shared SO_REUSEPORT port: every scrape
        # names the worker process it landed on.
        WORKER_INFO.set(1, worker=str(worker_id))
    if model_version is not None:
        MODEL_VERSION.get().set(float(model_version))
    handle = ServerHandle(
        engine, batcher, metrics, None,
        recorder=recorder, slo_tracker=slo_tracker, profile_dir=profile_dir,
        quality=quality_monitor, worker_id=worker_id,
        host=host_pool, router=router, quality_feed=quality_feed,
        model_version=model_version, replica_id=replica_id,
        admin_enabled=admin_endpoint, live={"params": params}, say=say,
        device=dev,
    )
    if history_interval_s > 0:
        handle.history = timeseries.TimeSeriesStore(
            interval_s=history_interval_s,
        )
        if alerts_enabled:
            handle.alerts = alertsmod.AlertEngine(
                alert_rules if alert_rules is not None
                else alertsmod.default_rules("replica"),
                handle.history,
            )
        if incident_dir is not None and handle.alerts is not None:
            handle.incidents = incidentmod.IncidentCapturer(
                incident_dir,
                store=handle.history,
                collectors={
                    "requests": lambda: recorder.snapshot(64),
                    "metrics": REGISTRY.snapshot,
                    "slo": (
                        slo_tracker.snapshot if slo_tracker is not None
                        else dict
                    ),
                    "quality": (
                        quality_monitor.health
                        if quality_monitor is not None else dict
                    ),
                },
                min_interval_s=incident_min_interval_s,
                retention=incident_retention,
            )
    app = _App(handle, request_timeout_s, quiet)
    try:
        handle.httpd = EventLoopHttpServer(
            (host, port), app,
            idle_timeout_s=idle_timeout_s,
            max_connections=max_connections,
            reuse_port=reuse_port,
        )
        if warmup:
            engine.warmup(say=say)
            if host_pool is not None:
                # The fast path's tiny ladder warms in a fraction of
                # the device warmup; until it is warm the router keeps
                # every request on the device path (with --no-warmup the
                # host path stays parked the same way).
                host_pool.scorer.warmup(say=say)
    except BaseException:
        batcher.close(drain=False, timeout=1.0)
        if host_pool is not None:
            host_pool.close(timeout=1.0)
        if quality_feed is not None:
            quality_feed.close(timeout=1.0)
        close_engine = getattr(engine, "close", None)
        if close_engine is not None:
            close_engine()
        if handle.httpd is not None:
            # The listener bound before warmup failed: release the port so
            # a caller that catches and retries doesn't hit EADDRINUSE.
            handle.httpd.server_close()
        raise
    if handle.history is not None:
        # Started only after the stack assembled: a bind/warmup failure
        # must not leak a sampler thread.
        engine_ref, capturer = handle.alerts, handle.incidents

        def _tick(now: float) -> None:
            if engine_ref is None:
                return
            for transition in engine_ref.evaluate(now):
                if capturer is not None:
                    capturer.maybe_capture(transition)

        handle.sampler = timeseries.HistorySampler(
            handle.history, timeseries.collect_registry,
            interval_s=history_interval_s, on_tick=_tick,
        ).start()
    return handle

"""The overlapped ingest→device scoring pipeline.

Port of the JAX package's ``score/pipeline.py``. Sequentially, scoring a
streamed cohort is four serialized stages per chunk — read, parse/prep
(host), device (transfer + compute), write — and the card sits idle during
every host stage. This module runs them as a software pipeline instead:

  * one **reader** thread slices the input into fixed-size raw blocks and
    feeds a bounded prefetch queue (backpressure: ingest can never run
    more than ``prefetch`` chunks ahead of the device);
  * ``parse_workers`` **parse threads** do the per-chunk host work — JSON
    parse, contract validation with malformed-row quarantine, and the
    host half of the impute route (``contract_rows_to_x64``: numpy only;
    the parse threads never touch the card) — and hand chunks to a
    reorder buffer (workers finish out of order; everything downstream is
    strictly ordered);
  * one **device** thread double-buffers (``ChunkScorer``): chunk N+1 is
    copied into a pinned host buffer, sent to the card on a copy stream
    and its compute queued on the scorer's compute stream before chunk N's
    result is fetched, so host work, host→device transfer and the card's
    compute overlap. Every chunk is padded to ONE shape
    (``data.sharding.pad_rows_to``, edge mode — the serving engine's
    padding), so the device stage's work is the same for every chunk of a
    run;
  * one **writer** thread drains results in order into the sharded output
    (``score/writer.py``), feeds the cohort-level quality monitor, and
    commits the progress manifest per chunk (``score/progress.py``) — the
    durable unit a killed run resumes at.

``parse_procs > 0`` swaps the parse threads for spawned worker
*processes* (JSONL sources only; ``_run_overlapped_procs``): ingest
parsing then runs free of the parent's GIL. The workers import only
``score.reader`` (stdlib + numpy), so they never initialise CUDA.

The sequential path (``overlap=False``) runs the identical stage
functions in one loop with no threads — the ablation the overlap is
measured against, and the honest fallback for debugging.

Telemetry: per-stage spans (``score:read`` / ``score:parse`` /
``score:device`` / ``score:write``), ``score_*`` families on the global
registry, a ``score_chunk`` journal event per committed chunk, and
``score_resume`` / ``score_done`` run events.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.obs import journal, spans
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.persist.atomicio import (
    atomic_json_write,
)
from machine_learning_replications_tpu_torch.score.progress import (
    ScoreProgress,
    make_fingerprint,
)
from machine_learning_replications_tpu_torch.score.reader import ParsedChunk
from machine_learning_replications_tpu_torch.score.writer import (
    QuarantineWriter,
    ShardedScoreWriter,
)

DEFAULT_CHUNK_ROWS = 2048
DEFAULT_PREFETCH = 4
DEFAULT_PARSE_WORKERS = 2
DEFAULT_ROWS_PER_SHARD = 500_000
DEFAULT_MAX_BAD_ROWS = 1000
#: Cohort-scale quality window: drift/calibration judged over the whole
#: scored population (bounded at ~60 MB of rings), not a serving window.
DEFAULT_QUALITY_WINDOW = 1 << 20

_M_ROWS = REGISTRY.counter(
    "score_rows_total", "Cohort rows scored and committed to output shards."
)
_M_QUAR = REGISTRY.counter(
    "score_quarantined_rows_total",
    "Malformed cohort rows quarantined to the sidecar instead of scored.",
)
_M_CHUNKS = REGISTRY.counter(
    "score_chunks_total", "Scoring chunks committed to the progress manifest."
)
_M_CHUNK_S = REGISTRY.histogram(
    "score_chunk_seconds",
    "Wall seconds from a chunk leaving the reader to its durable commit.",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
_M_QDEPTH = REGISTRY.gauge(
    "score_queue_depth",
    "Chunks queued between pipeline stages (bounded by the prefetch "
    "budget).",
    labels=("stage",),
)
_M_STAGE_S = REGISTRY.counter(
    "score_stage_seconds_total",
    "Busy seconds per pipeline stage (read/parse/device/write); in "
    "overlapped mode stages run concurrently, so the sum can exceed wall "
    "time.",
    labels=("stage",),
)


class ScoreBudgetExceeded(RuntimeError):
    """The malformed-row error budget ran out: the cohort is garbage at a
    rate no quarantine policy should paper over. ``bad_rows`` carries the
    triggering chunk's quarantine entries so the abort path can flush
    them to the sidecar the operator is pointed at (they would otherwise
    be dropped with the uncommitted chunk)."""

    def __init__(self, message: str, bad_rows=None) -> None:
        super().__init__(message)
        self.bad_rows = list(bad_rows or [])


class ScoreInterrupted(RuntimeError):
    """Test hook: simulated preemption right after a chunk commit (the
    ``StageCheckpointer._interrupt_after`` idiom at chunk granularity)."""


class _StageClock:
    """Per-stage busy-seconds accounting shared by both modes; every
    timed scope is also a span on the active tracer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, **span_args):
        t0 = time.perf_counter()
        with spans.span(f"score:{name}", **span_args):
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
        _M_STAGE_S.inc(dt, stage=name)

    def add(self, name: str, dt: float) -> None:
        """Account externally-timed work (process-pool parse workers
        report their own elapsed seconds)."""
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
        _M_STAGE_S.inc(dt, stage=name)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {k: round(v, 3) for k, v in sorted(self.seconds.items())}


class _Slot:
    """The buffers of one in-flight chunk on the card: pinned host input
    (the padded rows, and for a pipeline the incomplete rows' indices),
    their resident device copies, pinned host outputs, and two events —
    ``copied`` (the H2D copies landed) and ``done`` (compute and the D2H
    copies finished). A slot is reused only after ``finish`` has waited on
    ``done``, so neither a pinned buffer nor a device input is rewritten
    while a chunk still reads it."""

    __slots__ = ("x_host", "x_dev", "rows_host", "rows_dev", "outs", "copied", "done")

    def __init__(self, rows: int, width: int, dev: torch.device, copy, compute) -> None:
        self.x_host = torch.empty((rows, width), dtype=torch.float64, pin_memory=True)
        self.rows_host = torch.empty(rows, dtype=torch.int64, pin_memory=True)
        # Allocated on the stream that writes them, marked as read by the
        # compute stream, so the allocator never hands their memory to
        # anything else while either stream may still touch it.
        with torch.cuda.stream(copy):
            self.x_dev = torch.empty((rows, width), dtype=torch.float64, device=dev)
            self.rows_dev = torch.empty(rows, dtype=torch.int64, device=dev)
        self.x_dev.record_stream(compute)
        self.rows_dev.record_stream(compute)
        self.outs: list | None = None  # pinned p1 / members / rows, shaped on first use
        self.copied = torch.cuda.Event()
        self.done = torch.cuda.Event()


class _Pending:
    """One submitted chunk: its slot on the card (None on the CPU, where
    ``outs`` already holds the host results), its real row count and the
    prepped rows."""

    __slots__ = ("slot", "outs", "X", "n")

    def __init__(self, slot, outs, X, n):
        self.slot = slot
        self.outs = outs
        self.X = X
        self.n = n


class ChunkScorer:
    """Fixed-shape, double-buffered scoring of streamed chunks through THE
    predict tail ``cli predict`` runs, on ``device`` (default: the card).

    ``submit`` pads the prepped chunk to the run's one ``[chunk_rows, W]``
    shape (``pad_rows_to``, edge mode) and, on the card, returns without
    waiting: the rows go into a pinned host buffer, a non-blocking H2D copy
    on the scorer's copy stream moves them to the slot's resident device
    buffer, the compute stream waits on that copy's event, runs the eager
    forward and queues non-blocking D2H copies of ``p1``, the members and
    the model-space rows into pinned output buffers, then records the
    slot's ``done`` event. ``finish`` waits on that event and slices the
    padding off. The caller overlaps by submitting chunk N+1 before
    finishing chunk N; any number of chunks may be in flight (each holds a
    slot; slots are pooled, two in the pipeline's steady state).

    **The imputer runs in the device stage.** JAX imputes in the parse
    workers (its dispatch is thread-safe and asynchronous). Here a parse
    thread that launched the imputer and read its result back would
    synchronize the card under the device thread's in-flight compute, so
    the parse side does only the numpy half (``contract_rows_to_x64``) and
    the device stage runs ``knn_impute.impute_rows`` on the card. What the
    host must know about a chunk — which rows are incomplete, and the
    imputer block for their NaN pattern — is read from the host copy of the
    rows; the donors' NaN flags and the support columns are resolved once
    per scorer, and each pattern's block is kept with its distance columns
    on the card (``ImputeBlock.on_device``). Nothing in the device stage
    reads device memory back before ``finish``.

    **Why the compute is eager, not a graph.** It runs the same kernels, in
    the same order and at the same shapes, as
    ``pipeline_predict_proba1[_contract]`` (or ``stacking.predict_proba1``,
    ``tree.predict_proba1``) on the same padded chunk, so a chunk's ``p1``
    equals that eager call bit for bit on the same device — the JAX
    package's acceptance gate ("bit-identical to ``cli predict``"), which
    its own re-jitted program broke by 1–2 ulp. A CUDA graph per run is
    later work. The fixed chunk shape means a run captures no graph and
    builds no kernel (``obs.torchmon`` counts both).

    On the CPU ``submit`` computes synchronously; ``finish`` only slices.
    """

    def __init__(self, params, chunk_rows: int, route: str, mesh=None, *, device=None):
        from machine_learning_replications_tpu_torch import convert
        from machine_learning_replications_tpu_torch.device import resolve_device
        from machine_learning_replications_tpu_torch.models import (
            knn_impute, pipeline, stacking, tree,
        )

        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        if mesh is not None:
            raise NotImplementedError(
                "a row-sharded scoring tail (mesh=) is not ported yet: the reader, "
                "parse workers and writer live on one rank while rows scatter to "
                "the others, which needs its own design — the remaining piece of "
                "ROADMAP item 7"
            )
        self.chunk_rows = int(chunk_rows)
        self.route = route

        is_pipeline = isinstance(params, pipeline.PipelineParams)
        if route == "x64" and not is_pipeline:
            raise TypeError(
                f"a 64-wide raw cohort needs a full PipelineParams "
                f"checkpoint (impute → select → ensemble); got "
                f"{type(params).__name__}"
            )
        if route not in ("contract", "x64"):
            raise ValueError(f"unknown route {route!r}")
        if not isinstance(params, (pipeline.PipelineParams, tree.TreeEnsembleParams,
                                   stacking.StackingParams)):
            raise TypeError(
                f"cannot score params of type {type(params).__name__}; "
                "expected PipelineParams, TreeEnsembleParams, or "
                "StackingParams"
            )

        # Bare ensembles (no imputer) score contract rows verbatim: a NaN
        # row would flow through the SVM kernel to a NaN probability,
        # which repr-serializes as invalid JSON in the shards. The
        # pipeline quarantines such rows (the .mat route is the only one
        # that can produce them — JSONL validation already rejects
        # non-finite values) instead of silently corrupting output.
        self.requires_finite_rows = route == "contract" and not is_pipeline
        self.device = resolve_device(device)
        # Parameters on the device once (a no-op when they already are).
        self.params = p = convert.params_to(params, self.device)
        self.family = ("pipeline" if is_pipeline
                       else "tree" if isinstance(p, tree.TreeEnsembleParams) else "stacking")
        if is_pipeline:
            self._cols = pipeline.support_columns(p)
            self._donor_nan = knn_impute.donor_nan_columns(p.imputer)
            self._blocks: dict = {}
            self._imp_dtype = torch.promote_types(torch.float64, p.imputer.donors.dtype)
            self._dtype = p.ensemble.meta.coef.dtype
            self.width = int(p.support_mask.shape[0])
        else:
            self._dtype = (p.threshold.dtype if self.family == "tree"
                           else p.meta.coef.dtype)
            self.width = 17
        self._on_card = self.device.type == "cuda"
        if self._on_card:
            self._copy = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)
            for s in (self._copy, self._compute):   # after whatever the caller queued
                s.wait_stream(torch.cuda.current_stream(self.device))
        self._free: list[_Slot] = []   # finished slots, reused before a new one is pinned
        self._lock = threading.Lock()

    def prep(self, X: np.ndarray) -> np.ndarray:
        """Host work for one chunk's raw rows (numpy only — safe from parse
        worker threads, and it never touches the card): contract rows are
        embedded at their schema positions for a pipeline checkpoint."""
        if self.family == "pipeline" and self.route == "contract":
            from machine_learning_replications_tpu_torch.models import pipeline

            return pipeline.contract_rows_to_x64(self.params, X)
        return np.asarray(X, np.float64)

    def _block_for(self, X_rows: np.ndarray):
        """The imputer block for these incomplete rows' NaN pattern,
        resolved on the host (the donors' NaN flags were fetched once) and
        kept per pattern with its distance columns on the device."""
        from machine_learning_replications_tpu_torch.models import knn_impute

        blk = knn_impute.resolve_block_fn(self.params.imputer, X_rows, donor_nan=self._donor_nan)
        cached = self._blocks.get(blk)
        if cached is None:
            cached = self._blocks[blk] = blk.on_device(self.device)
        return cached

    def _forward(self, X: torch.Tensor, rows: "torch.Tensor | None", block):
        """``(p1, members | None, model-space rows | None)`` of the padded
        chunk ``X`` (float64, on the device): the eager composition of the
        ``cli predict`` route for the scorer's family."""
        from machine_learning_replications_tpu_torch.models import knn_impute, stacking, tree

        p = self.params
        if self.family == "pipeline":
            out = X.to(self._imp_dtype, copy=True)
            if rows is not None:
                knn_impute.impute_rows(p.imputer, out, rows, block)
            X17 = out.index_select(1, self._cols)
            p1, m = stacking.predict_proba1_with_members(
                p.ensemble, X17.to(self._dtype), device=self.device)
            return p1, m, X17
        if self.family == "tree":
            return tree.predict_proba1(p, X.to(self._dtype)), None, None
        p1, m = stacking.predict_proba1_with_members(p, X.to(self._dtype), device=self.device)
        return p1, m, None

    def _take_slot(self) -> _Slot:
        with self._lock:
            if self._free:
                return self._free.pop()
        return _Slot(self.chunk_rows, self.width, self.device, self._copy, self._compute)

    def submit(self, X_prepped: np.ndarray) -> _Pending:
        """Pad to the run's one shape, move to the device, queue the
        compute and the copies back; returns without waiting on the card."""
        from machine_learning_replications_tpu_torch.data.sharding import pad_rows_to
        from machine_learning_replications_tpu_torch.obs import torchmon

        n = int(X_prepped.shape[0])
        if n == 0:
            return _Pending(None, None, X_prepped, 0)
        Xp, _ = pad_rows_to(np.asarray(X_prepped, np.float64), self.chunk_rows, mode="edge")
        rows = block = None
        if self.family == "pipeline":
            incomplete = np.flatnonzero(np.isnan(Xp).any(axis=1))
            if incomplete.size:
                rows, block = incomplete, self._block_for(Xp[incomplete])
        if not self._on_card:
            outs = self._forward(torch.from_numpy(Xp),
                                 None if rows is None else torch.from_numpy(rows), block)
            return _Pending(None, [None if t is None else t.numpy() for t in outs], X_prepped, n)

        slot = self._take_slot()
        np.copyto(slot.x_host.numpy(), Xp)
        k = 0 if rows is None else rows.size
        if k:
            slot.rows_host.numpy()[:k] = rows
        with torch.cuda.stream(self._copy):
            slot.x_dev.copy_(slot.x_host, non_blocking=True)
            if k:
                slot.rows_dev[:k].copy_(slot.rows_host[:k], non_blocking=True)
            slot.copied.record(self._copy)
        torchmon.record_transfer("h2d", Xp.nbytes + 8 * k)
        with torch.cuda.stream(self._compute):
            self._compute.wait_event(slot.copied)
            outs = self._forward(slot.x_dev, slot.rows_dev[:k] if k else None, block)
            if slot.outs is None:
                slot.outs = [None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                                                pin_memory=True)
                             for t in outs]
            for host, t in zip(slot.outs, outs):
                if t is not None:
                    host.copy_(t, non_blocking=True)
            slot.done.record(self._compute)
        return _Pending(slot, None, X_prepped, n)

    def finish(self, pending: _Pending):
        """Wait for a submitted chunk; returns ``(p1[n], members[n, M] |
        None, X[n])`` as float64 host arrays, pad rows sliced off before
        anything downstream can see them. ``X`` is the chunk in the model's
        input space (the quality monitor's rows): post-impute post-select
        for a pipeline, the contract rows themselves otherwise."""
        from machine_learning_replications_tpu_torch.obs import torchmon

        n = pending.n
        if n == 0:
            return np.empty(0, np.float64), None, pending.X
        slot = pending.slot
        if slot is None:
            outs = pending.outs
        else:
            slot.done.synchronize()
            outs = [None if t is None else t.numpy() for t in slot.outs]
            torchmon.record_transfer("d2h", sum(a.nbytes for a in outs if a is not None))
        p1, members, rows = (None if a is None else a[:n].astype(np.float64) for a in outs)
        if slot is not None:
            with self._lock:
                self._free.append(slot)   # its outputs were copied out above
        return p1, members, (pending.X if rows is None else rows)


class _PipeControl:
    """The stop/error/bounded-queue protocol BOTH overlapped modes run on
    (one definition so a fix to the shutdown semantics cannot silently
    diverge the two): any stage failure stops every stage; queue puts and
    gets poll with a short timeout so no thread can block forever on a
    dead peer; ``run`` starts, joins, and re-raises the first failure."""

    STOPPED = object()  # returned by get() when the pipeline is stopping

    def __init__(self) -> None:
        self.stop = threading.Event()
        self._lock = threading.Lock()
        self._errors: list[BaseException] = []

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            self._errors.append(exc)
        self.stop.set()

    def put(self, q: queue.Queue, item) -> bool:
        """Bounded put honoring stop; False means the caller should exit."""
        while not self.stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def get(self, q: queue.Queue):
        """Bounded get honoring stop; ``STOPPED`` means exit."""
        while not self.stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return _PipeControl.STOPPED

    def run(self, threads: list[threading.Thread]) -> None:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            if self._errors:
                raise self._errors[0]


class _OrderedBuffer:
    """Reorder point between out-of-order parse workers and the strictly
    ordered device stage. Capacity is bounded transitively (the raw-block
    queue upstream is bounded), so this holds at most
    ``prefetch + parse_workers`` chunks."""

    def __init__(self, next_seq: int, n_producers: int,
                 stop: threading.Event) -> None:
        self._cond = threading.Condition()
        self._items: dict[int, Any] = {}
        self._next = next_seq
        self._eof = 0
        self._n_producers = n_producers
        self._stop = stop

    def put(self, seq: int, item) -> None:
        with self._cond:
            self._items[seq] = item
            self._cond.notify_all()

    def producer_done(self) -> None:
        with self._cond:
            self._eof += 1
            self._cond.notify_all()

    def get(self):
        """Next chunk in sequence order; None at end-of-stream or stop."""
        with self._cond:
            while True:
                if self._stop.is_set():
                    return None
                if self._next in self._items:
                    item = self._items.pop(self._next)
                    self._next += 1
                    _M_QDEPTH.set(float(len(self._items)), stage="device")
                    return item
                if self._eof >= self._n_producers and not self._items:
                    return None
                self._cond.wait(timeout=0.1)


class ScorePipeline:
    """One bulk-scoring run over a cohort source into an output directory.

    ``run()`` returns the machine-readable summary (also written to
    ``<out>/summary.json``): rows, chunks, per-stage seconds, end-to-end
    rows/s, resume provenance, the rolling output sha256, and the cohort
    quality snapshot digest. Raises ``ScoreBudgetExceeded`` /
    ``ScoreResumeError`` / ``ScoreInterrupted``; an interrupted run leaves
    a resumable output directory behind.
    """

    def __init__(
        self,
        params,
        source,
        out_dir: str,
        *,
        overlap: bool = True,
        parse_workers: int = DEFAULT_PARSE_WORKERS,
        parse_procs: int = 0,
        prefetch: int = DEFAULT_PREFETCH,
        rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
        max_bad_rows: int = DEFAULT_MAX_BAD_ROWS,
        mesh=None,
        fresh: bool = False,
        durable: bool = True,
        quality: bool = True,
        quality_window: int = DEFAULT_QUALITY_WINDOW,
        drift_warn_psi: float | None = None,
        drift_alert_psi: float | None = None,
        model_digest: str = "",
        device=None,
        _interrupt_after_chunks: int | None = None,
    ) -> None:
        if parse_workers < 1 or prefetch < 1:
            raise ValueError("parse_workers and prefetch must be >= 1")
        if max_bad_rows < 0:
            raise ValueError("max_bad_rows must be >= 0")
        self.params = params
        self.source = source
        self.out_dir = os.path.abspath(out_dir)
        self.overlap = overlap
        self.parse_workers = int(parse_workers)
        # Process-pool ingest parsing (JSONL sources only): spawned
        # workers do the GIL-bound JSON/validate work, so it stops
        # competing with the parent's device thread for the one
        # interpreter lock.
        self.parse_procs = int(parse_procs) if getattr(
            source, "supports_process_parse", False
        ) else 0
        self.prefetch = int(prefetch)
        self.rows_per_shard = int(rows_per_shard)
        self.max_bad_rows = int(max_bad_rows)
        self.mesh = mesh
        self.fresh = fresh
        self.durable = durable
        self.quality = quality
        self.quality_window = int(quality_window)
        self.drift_warn_psi = drift_warn_psi
        self.drift_alert_psi = drift_alert_psi
        self.model_digest = model_digest
        self.device = device
        self._interrupt_after_chunks = _interrupt_after_chunks
        self._clock = _StageClock()
        self._bad_lock = threading.Lock()
        self._monitor = None

    # -- construction helpers ----------------------------------------------

    def _build_monitor(self):
        """Cohort-level quality: the model's own reference profile over a
        population-sized window, statistics computed once at the end
        (``snapshot()`` forces a refresh; the huge interval keeps per-chunk
        PSI math off the run)."""
        if not self.quality:
            return None
        prof = getattr(self.params, "quality", None)
        if prof is None:
            return None
        from machine_learning_replications_tpu_torch.models.pipeline import (
            support_feature_names,
        )
        from machine_learning_replications_tpu_torch.obs import quality as qmod

        kwargs: dict[str, Any] = {}
        if self.drift_warn_psi is not None:
            kwargs["warn_psi"] = self.drift_warn_psi
        if self.drift_alert_psi is not None:
            kwargs["alert_psi"] = self.drift_alert_psi
        return qmod.QualityMonitor(
            prof,
            window=self.quality_window,
            feature_names=support_feature_names(self.params),
            refresh_interval_s=3600.0,
            **kwargs,
        )

    # -- the run ------------------------------------------------------------

    def run(self) -> dict:
        t_run0 = time.perf_counter()
        fingerprint = make_fingerprint(
            self.source.path, self.source.kind, self.model_digest,
            self.source.chunk_rows, self.rows_per_shard, self.source.limit,
        )
        progress = ScoreProgress(self.out_dir, fingerprint)
        resumed = progress.load(fresh=self.fresh)
        writer = ShardedScoreWriter(
            self.out_dir, self.rows_per_shard, durable=self.durable
        )
        quarantine = QuarantineWriter(self.out_dir, durable=self.durable)
        from machine_learning_replications_tpu_torch.obs import torchmon

        # Capture/build/transfer accounting before the first device op:
        # the run summary states the process's graph captures and kernel
        # builds, the fixed chunk shape's no-new-work witness.
        torchmon.install()
        resumed_chunks = resumed_rows = 0
        if resumed:
            writer.restore(progress.shards)
            quarantine.restore(progress.quarantine_bytes)
            resumed_chunks, resumed_rows = progress.chunks, progress.rows
            journal.event(
                "score_resume", chunks=resumed_chunks, rows=resumed_rows,
                lines=progress.lines, bad_rows=progress.bad_rows,
            )
        scorer = ChunkScorer(
            self.params, self.source.chunk_rows, self.source.kind,
            mesh=self.mesh, device=self.device,
        )
        self._monitor = self._build_monitor()
        self._progress = progress
        self._writer = writer
        self._quarantine = quarantine
        self._scorer = scorer
        self._committed_this_run = 0
        self._bad_seen = progress.bad_rows  # committed prefix incl. resume
        try:
            if self.overlap and self.parse_procs > 0:
                self._run_overlapped_procs()
            elif self.overlap:
                self._run_overlapped()
            else:
                self._run_sequential()
        except ScoreBudgetExceeded as exc:
            # The triggering chunk never reaches a commit, but the abort
            # message points the operator at the sidecar — flush the rows
            # that blew the budget there (single-threaded here: every
            # pipeline thread has exited). They sit past the committed
            # quarantine_bytes, so a later resume truncates them cleanly.
            try:
                quarantine.append(exc.bad_rows)
                quarantine.sync()
            except OSError:
                pass  # best-effort: the abort itself must surface
            raise
        finally:
            writer.close()
            quarantine.close()
        wall = time.perf_counter() - t_run0
        rows_this_run = progress.rows - resumed_rows
        totals = torchmon.totals()
        summary = {
            "kind": "score_run",
            "route": self.source.kind,
            "overlap": self.overlap,
            "chunk_rows": self.source.chunk_rows,
            "parse_workers": (
                self.parse_workers
                if self.overlap and not self.parse_procs else 0
            ),
            "parse_procs": self.parse_procs if self.overlap else 0,
            "prefetch": self.prefetch if self.overlap else 0,
            "mesh": self.mesh is not None,
            "resumed": resumed,
            "resumed_chunks": resumed_chunks,
            "resumed_rows": resumed_rows,
            "rows": progress.rows,
            "chunks": progress.chunks,
            "bad_rows": progress.bad_rows,
            "rows_this_run": rows_this_run,
            "wall_seconds": round(wall, 3),
            "rows_per_second": (
                round(rows_this_run / wall, 1) if wall > 0 else None
            ),
            "stage_seconds": self._clock.snapshot(),
            "shards": progress.shards,
            "output_sha256": progress.output_sha256(),
            "quality": self._quality_summary(),
            # The port's counterpart of JAX's jax_compiles /
            # jax_compile_seconds: the process's graph captures and
            # hand-kernel builds so far.
            "torch_graph_captures": totals["torch_graph_captures_total"],
            "torch_kernel_builds": totals["torch_kernel_builds_total"],
            "torch_kernel_build_seconds": totals["torch_kernel_build_seconds_total"],
        }
        jrn = journal.get_journal()
        summary["manifest"] = (
            jrn.manifest if jrn is not None
            else journal.run_manifest(command="score")
        )
        progress.finish({
            k: summary[k] for k in (
                "wall_seconds", "rows_per_second", "stage_seconds", "overlap",
            )
        })
        atomic_json_write(
            os.path.join(self.out_dir, "summary.json"), summary
        )
        journal.event(
            "score_done", rows=progress.rows, chunks=progress.chunks,
            bad_rows=progress.bad_rows, wall_seconds=summary["wall_seconds"],
            rows_per_second=summary["rows_per_second"],
            output_sha256=summary["output_sha256"],
        )
        return summary

    def _quality_summary(self) -> dict | None:
        if self._monitor is None:
            return None
        try:
            snap = self._monitor.snapshot(detail=True)
        except Exception as exc:  # telemetry must not fail the run
            return {"enabled": False, "reason": f"snapshot failed: {exc}"}
        atomic_json_write(os.path.join(self.out_dir, "quality.json"), snap)
        worst = (snap.get("features") or [{}])[0]
        return {
            "enabled": snap.get("enabled", True),
            "status": snap.get("status"),
            "rows": snap.get("rows_total"),
            "window_rows": snap.get("window_rows"),
            "score_psi": snap.get("score_psi"),
            "worst_feature": worst.get("name"),
            "worst_psi": worst.get("psi"),
            "snapshot": "quality.json",
        }

    # -- shared stage bodies -------------------------------------------------

    def _check_budget(self, chunk: ParsedChunk) -> None:
        """Enforce the malformed-row error budget at parse time (before
        hours of compute happen behind a rotting input), counting the
        committed prefix plus everything parsed this run — parse workers
        race, so the tally is locked."""
        if not chunk.bad:
            return
        with self._bad_lock:
            self._bad_seen += len(chunk.bad)
            total = self._bad_seen
        if total > self.max_bad_rows:
            first = chunk.bad[0]
            raise ScoreBudgetExceeded(
                f"malformed-row budget exhausted: {total} quarantined rows "
                f"exceed max_bad_rows={self.max_bad_rows} (latest: line "
                f"{first[0]}: {first[1]})",
                bad_rows=chunk.bad,
            )

    def _sanitize_chunk(self, chunk: ParsedChunk) -> ParsedChunk:
        """Route-level row validation the format parser cannot do: when
        the scorer requires finite rows (bare-ensemble contract route —
        see ``ChunkScorer.requires_finite_rows``), non-finite rows are
        quarantined with their line numbers instead of flowing through to
        NaN probabilities and invalid JSON shard lines."""
        if not self._scorer.requires_finite_rows or not chunk.n_rows:
            return chunk
        finite = np.isfinite(chunk.X).all(axis=1)
        if finite.all():
            return chunk
        for line in chunk.line_nos[~finite]:
            chunk.bad.append((
                int(line),
                "non-finite values: a bare-ensemble checkpoint scores "
                "contract rows verbatim (no imputer); NaN/Inf inputs "
                "need a full pipeline checkpoint",
                "",
            ))
        chunk.bad.sort(key=lambda entry: entry[0])  # keep input order
        chunk.X = chunk.X[finite]
        chunk.line_nos = chunk.line_nos[finite]
        return chunk

    def _parse_and_prep(self, block) -> tuple[ParsedChunk, np.ndarray]:
        chunk = self._sanitize_chunk(self.source.parse(block))
        self._check_budget(chunk)
        X = self._scorer.prep(chunk.X) if chunk.n_rows else chunk.X
        return chunk, X

    def _commit_chunk(self, chunk: ParsedChunk, p1, members, X, t0) -> None:
        """The writer-stage transaction: append output + quarantine, flush
        durable, advance the manifest, account, journal — then (and only
        then) feed the quality monitor and honor the interrupt hook."""
        self._writer.append_chunk(self._progress.rows, chunk.line_nos, p1)
        self._quarantine.append(chunk.bad)
        shards, data = self._writer.sync()
        qbytes = self._quarantine.sync()
        self._progress.absorb_output(data)
        self._progress.commit(
            rows=len(p1), lines=chunk.lines_consumed,
            bad_rows=len(chunk.bad), shards=shards, quarantine_bytes=qbytes,
        )
        _M_ROWS.get().inc(len(p1))
        if chunk.bad:
            _M_QUAR.get().inc(len(chunk.bad))
        _M_CHUNKS.get().inc(1)
        dt = time.perf_counter() - t0
        _M_CHUNK_S.get().observe(dt)
        journal.event(
            "score_chunk", seq=chunk.seq, rows=len(p1),
            bad=len(chunk.bad), seconds=round(dt, 4),
        )
        if self._monitor is not None and len(p1):
            try:
                self._monitor.observe_batch(X, p1, members)
            except Exception as exc:
                # The engine's quarantine contract: telemetry must never
                # take the workload down.
                msg = f"{type(exc).__name__}: {exc}"
                journal.event("quality_feed_disabled", error=msg)
                self._monitor.disable(f"feed quarantined: {msg}")
                self._monitor = None
        self._committed_this_run += 1
        if (
            self._interrupt_after_chunks is not None
            and self._committed_this_run >= self._interrupt_after_chunks
        ):
            raise ScoreInterrupted(
                f"after {self._committed_this_run} committed chunks"
            )

    # -- sequential mode -----------------------------------------------------

    def _run_sequential(self) -> None:
        blocks = self.source.blocks(
            skip_lines=self._progress.lines, start_seq=self._progress.chunks
        )
        while True:
            t0 = time.perf_counter()
            with self._clock.stage("read"):
                block = next(blocks, None)
            if block is None:
                return
            with self._clock.stage("parse", seq=block.seq):
                chunk, X = self._parse_and_prep(block)
            with self._clock.stage("device", seq=block.seq):
                p1, members, X = self._scorer.finish(self._scorer.submit(X))
            with self._clock.stage("write", seq=block.seq):
                self._commit_chunk(chunk, p1, members, X, t0)

    # -- overlapped modes: shared plumbing -----------------------------------

    def _finish_to_writer(self, ctl: "_PipeControl", write_q, pending) -> bool:
        """Block on an in-flight device chunk and hand it to the writer;
        False when the pipeline is stopping (the caller exits)."""
        chunk, handle, t0 = pending
        with self._clock.stage("device", seq=chunk.seq):
            out = self._scorer.finish(handle)
        if not ctl.put(write_q, (chunk, out, t0)):
            return False
        _M_QDEPTH.set(float(write_q.qsize()), stage="write")
        return True

    def _writer_thread(self, ctl: "_PipeControl", write_q) -> threading.Thread:
        """The one writer stage both overlapped modes share: drain results
        in order, commit each chunk durably."""

        def writer_loop() -> None:
            try:
                while True:
                    item = ctl.get(write_q)
                    if item is _PipeControl.STOPPED or item is None:
                        return
                    chunk, (p1, members, X), t0 = item
                    with self._clock.stage("write", seq=chunk.seq):
                        self._commit_chunk(chunk, p1, members, X, t0)
            except BaseException as exc:
                ctl.fail(exc)

        return threading.Thread(
            target=writer_loop, name="score-write", daemon=True
        )

    # -- overlapped mode, in-process parse threads ---------------------------

    def _run_overlapped(self) -> None:
        ctl = _PipeControl()
        raw_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        ready = _OrderedBuffer(
            self._progress.chunks, self.parse_workers, ctl.stop
        )
        write_q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def reader() -> None:
            try:
                blocks = self.source.blocks(
                    skip_lines=self._progress.lines,
                    start_seq=self._progress.chunks,
                )
                while True:
                    with self._clock.stage("read"):
                        block = next(blocks, None)
                    if block is None:
                        break
                    block._t0 = time.perf_counter()
                    if not ctl.put(raw_q, block):
                        return
                    _M_QDEPTH.set(float(raw_q.qsize()), stage="parse")
                for _ in range(self.parse_workers):
                    if not ctl.put(raw_q, None):
                        return
            except BaseException as exc:
                ctl.fail(exc)

        def parser() -> None:
            try:
                while True:
                    block = ctl.get(raw_q)
                    if block is _PipeControl.STOPPED:
                        return
                    if block is None:
                        ready.producer_done()
                        return
                    with self._clock.stage("parse", seq=block.seq):
                        chunk, X = self._parse_and_prep(block)
                    ready.put(block.seq, (chunk, X, block._t0))
            except BaseException as exc:
                ctl.fail(exc)
                ready.producer_done()

        def device() -> None:
            pending: tuple | None = None
            try:
                while True:
                    item = ready.get()
                    if item is None:
                        break
                    chunk, X, t0 = item
                    # Double buffer: N+1's transfer + dispatch BEFORE
                    # blocking on N's result.
                    with self._clock.stage("device", seq=chunk.seq):
                        handle = self._scorer.submit(X)
                    if pending is not None and not self._finish_to_writer(
                        ctl, write_q, pending
                    ):
                        return
                    pending = (chunk, handle, t0)
                if pending is not None and not ctl.stop.is_set():
                    if not self._finish_to_writer(ctl, write_q, pending):
                        return
                ctl.put(write_q, None)
            except BaseException as exc:
                ctl.fail(exc)

        ctl.run([
            threading.Thread(target=reader, name="score-read", daemon=True),
            *[
                threading.Thread(
                    target=parser, name=f"score-parse-{i}", daemon=True
                )
                for i in range(self.parse_workers)
            ],
            threading.Thread(target=device, name="score-device", daemon=True),
            self._writer_thread(ctl, write_q),
        ])

    # -- overlapped mode, process-pool ingest --------------------------------

    def _run_overlapped_procs(self) -> None:
        """The GIL-free ingest variant (``parse_procs > 0``, JSONL
        sources): spawned worker processes run the JSON/validate stage
        (``reader.parse_patient_lines`` — pure stdlib+numpy, no device
        contact), so the interpreter lock stops serializing ingest
        against the parent's device thread. The host prep moves into the
        device thread, which still double-buffers submit-ahead-of-finish;
        reader-submission order makes the future stream inherently
        ordered, so no reorder buffer is needed. Worker spawn (not fork: a
        process that has initialised CUDA must never be forked) costs a
        few seconds once per run — amortized at cohort scale, which is the
        only scale this mode targets."""
        import concurrent.futures as cf
        import multiprocessing as mp

        from machine_learning_replications_tpu_torch.score.reader import (
            parse_patient_lines_timed,
        )

        ctl = _PipeControl()
        fut_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        write_q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        pool = cf.ProcessPoolExecutor(
            max_workers=self.parse_procs,
            mp_context=mp.get_context("spawn"),
        )

        def reader() -> None:
            try:
                blocks = self.source.blocks(
                    skip_lines=self._progress.lines,
                    start_seq=self._progress.chunks,
                )
                while True:
                    with self._clock.stage("read"):
                        block = next(blocks, None)
                    if block is None:
                        break
                    block._t0 = time.perf_counter()
                    fut = pool.submit(
                        parse_patient_lines_timed, block.lines,
                        block.start_line,
                    )
                    block._n_lines = len(block.lines)
                    block.lines = None  # the worker owns the payload now
                    if not ctl.put(fut_q, (block, fut)):
                        return
                    _M_QDEPTH.set(float(fut_q.qsize()), stage="parse")
                ctl.put(fut_q, None)
            except BaseException as exc:
                ctl.fail(exc)

        def device() -> None:
            pending: tuple | None = None
            try:
                while True:
                    item = ctl.get(fut_q)
                    if item is _PipeControl.STOPPED:
                        return
                    if item is None:
                        break
                    block, fut = item
                    X, line_nos, bad, parse_s = fut.result()
                    self._clock.add("parse", parse_s)
                    chunk = self._sanitize_chunk(ParsedChunk(
                        seq=block.seq, start_line=block.start_line, X=X,
                        line_nos=line_nos,
                        lines_consumed=block._n_lines, bad=bad,
                    ))
                    self._check_budget(chunk)
                    with self._clock.stage("device", seq=chunk.seq):
                        Xp = (
                            self._scorer.prep(chunk.X)
                            if chunk.n_rows else chunk.X
                        )
                        handle = self._scorer.submit(Xp)
                    if pending is not None and not self._finish_to_writer(
                        ctl, write_q, pending
                    ):
                        return
                    pending = (chunk, handle, block._t0)
                if pending is not None and not ctl.stop.is_set():
                    if not self._finish_to_writer(ctl, write_q, pending):
                        return
                ctl.put(write_q, None)
            except BaseException as exc:
                ctl.fail(exc)

        try:
            ctl.run([
                threading.Thread(
                    target=reader, name="score-read", daemon=True
                ),
                threading.Thread(
                    target=device, name="score-device", daemon=True
                ),
                self._writer_thread(ctl, write_q),
            ])
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

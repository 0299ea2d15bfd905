"""Warm bucketed predict engine — the device half of the serving layer.

Port of the JAX package's ``serve/engine.py``. A server whose batcher
flushes whatever batch size traffic happens to form would pay a new
per-shape cost for every size it sees. The engine pads every batch up to
a fixed ladder of bucket sizes (default ``1/8/32/64/128/256/512``) and
``warmup()`` pays each bucket's one-time cost at startup, so the first
real request never does.

**One CUDA graph per bucket.** JAX bounds the per-shape cost with one XLA
compile per bucket; the port's counterpart is one CUDA-graph capture per
bucket. On a CUDA device ``warmup()`` captures, for each bucket ``b``, the
forward step from a static device input (``[b, 17]`` contract rows, or
``[b, 64]`` raw rows for a full pipeline) to static outputs (``p1``, the
member probabilities, the quality rows). ``predict`` copies each chunk into
its bucket's static input, replays the graph and copies the outputs to the
host before the lock that guards the bucket is released, so the flush
thread, a deploy warming a new engine and the supervisor's rebuild can
share the card. The graph replays the kernels the eager route launches,
so the served numbers are the port's own. ``trace_counts[b]`` counts
captures; on the CPU nothing is captured and a bucket's first run counts
once as its "compile", so ``compile_count()`` stays bounded by the ladder
on both. A capture or replay that fails raises: nothing moves to the CPU
or to the eager route behind the caller's back. With a published AOT
bundle (``persist.aot``) warmup restores each bucket's compiled program
instead of capturing it; a restore that fails falls back, journaled and
counted, to the capture on the same device.

What a graph may not do, and what the engine does about it:

  * no host sync and no host-to-device copy inside the capture — the
    lasso support columns and the imputer's contract-pattern block
    (``pipeline.resolve_contract_block_fn``, its distance columns as a
    device index: ``ImputeBlock.on_device``) are resolved once per engine;
  * contract rows miss exactly the 47 non-schema columns, so every served
    row is incomplete and the block runs on the whole bucket; a direct
    ``predict()`` caller whose contract values hold a NaN takes the eager
    per-call route on the same device, as the JAX engine does;
  * the input is already the static device tensor, in the dtype the eager
    ``cli predict`` route casts to (the ensemble's; float64 raw rows for a
    pipeline, whose float64 imputer runs in float64 inside the graph too).

**Batch shaping.** ``plan_batch`` decomposes each flush into the cheapest
covering sequence of ladder buckets (a memoized DP minimizing
``padded_rows + split_penalty_rows × extra_chunks``), exactly as in JAX.
Padding is row replication (edge mode); every family is a per-row map, so
pad rows cannot perturb real rows, and only real rows reach the quality
monitor.

**Spans** (``obs.spans.region``: free with no tracer installed, and never a
wait): ``engine.predict`` per call; per chunk ``engine.prep`` (``chunk``:
the host rows, the pad and the NaN test); then on the graph path
``engine.copy_in``, ``engine.replay`` (the ``graph.replay()`` call) and
``engine.copy_out`` (the host reads, which hold the wait for the replay),
and on the eager and AOT-restored paths one ``engine.forward``. The copies
of the graph and AOT paths count in ``torch_transfer_bytes_total`` (h2d at
the copy-in, d2h through ``device.to_host``).

The engine serves the three families of ``cli predict``:
``stacking.StackingParams`` (rows are the 17-variable contract),
``tree.TreeEnsembleParams`` (``sweep --save``) and
``pipeline.PipelineParams`` (contract rows embedded in NaN-padded 64-wide
rows, imputed, cut to the model's support and scored).
"""

from __future__ import annotations

import bisect
import functools
import threading
import time
from typing import Sequence

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device, to_host
from machine_learning_replications_tpu_torch.obs import journal, torchmon
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.obs.spans import region
from machine_learning_replications_tpu_torch.persist.aot import GraphInputs, outputs_to_step
from machine_learning_replications_tpu_torch.resilience import faults

DEFAULT_BUCKETS = (1, 8, 32, 64, 128, 256, 512)

#: Per-bucket warmup wall seconds, per scoring path (device engine vs the
#: host fast-path scorer), set by every warmup.
WARMUP_SECONDS = REGISTRY.gauge(
    "serve_warmup_seconds",
    "Engine warmup wall seconds per bucket (labels: path=device|host, "
    "bucket).",
    labels=("path", "bucket"),
)
#: Per-bucket AOT package restore wall seconds (the load of the published
#: package — the cost that replaces the bucket's capture when a checkpoint
#: ships a bundle, ``persist.aot``).
AOT_RESTORE_SECONDS = REGISTRY.gauge(
    "serve_aot_restore_seconds",
    "AOT executable restore wall seconds per bucket (labels: "
    "path=device|host, bucket).",
    labels=("path", "bucket"),
)
#: AOT restore failures that fell back to capturing the bucket, by reason:
#: a replica that started correctly but slowly.
AOT_FALLBACKS = REGISTRY.counter(
    "serve_aot_fallback_total",
    "AOT restore failures that fell back to tracing, by reason "
    "(fingerprint_mismatch, missing_backend, family_mismatch, "
    "missing_bucket, deserialize_error, exec_error, parity_mismatch, "
    "manifest_unreadable).",
    labels=("reason",),
)
# Every reason gets a zero-baseline series at import: an alert must tell
# "never happened" from a scrape that predates the first firing.
for _reason in (
    "fingerprint_mismatch", "missing_backend", "family_mismatch",
    "missing_bucket", "deserialize_error", "exec_error",
    "parity_mismatch", "manifest_unreadable",
):
    AOT_FALLBACKS.labels(reason=_reason)

#: Extra-dispatch cost of one more sub-batch, in padded-row equivalents
#: (the JAX engine's default; a split must save at least this much padding
#: per extra chunk to win).
DEFAULT_SPLIT_PENALTY_ROWS = 24

#: Sub-batches per flush are capped: each chunk is its own device call,
#: and an unbounded decomposition (worst case: a run of 1-buckets) would
#: trade padding waste for dispatch-overhead waste.
DEFAULT_MAX_SPLIT = 4


@functools.lru_cache(maxsize=4096)
def _tail_plan(
    n: int, buckets: tuple[int, ...], penalty: int, max_chunks: int
) -> tuple[int, ...]:
    """Cheapest covering decomposition of ``n`` rows (0 < n ≤ top bucket)
    into ladder buckets: minimizes ``padded_rows + penalty × (chunks−1)``
    under the chunk cap, ties broken toward fewer chunks. Full chunks come
    first; only the final, covering chunk can pad."""
    cover = buckets[bisect.bisect_left(buckets, n)]
    best_plan = (cover,)
    best_cost = cover - n
    if max_chunks > 1:
        for b in reversed(buckets):
            if b >= n:
                continue
            sub = _tail_plan(n - b, buckets, penalty, max_chunks - 1)
            cost = (b + sum(sub) - n) + penalty * len(sub)
            if cost < best_cost or (
                cost == best_cost and 1 + len(sub) < len(best_plan)
            ):
                best_plan = (b,) + sub
                best_cost = cost
    return best_plan


def _stacked_with_members(ens, X: torch.Tensor):
    """``(p1, members)`` of the stacked ensemble on rows already on its
    device — ``stacking.predict_proba1_with_members`` without the device
    resolution, so it can run inside a capture."""
    from machine_learning_replications_tpu_torch.models import linear, stacking

    m = stacking.member_probas(ens, X)
    return linear.predict_proba1(ens.meta, m), m


def family_core(params):
    """``(family, core)``: the per-family forward ``core(arg, X)``
    the engine runs once per bucket, where ``arg`` is the ensemble for
    pipeline checkpoints and the parameters otherwise and ``X`` lies on
    their device in their dtype."""
    from machine_learning_replications_tpu_torch.models import pipeline, stacking, tree

    if isinstance(params, pipeline.PipelineParams):
        return "pipeline", _stacked_with_members
    if isinstance(params, tree.TreeEnsembleParams):
        return "tree", tree.predict_proba1
    if isinstance(params, stacking.StackingParams):
        return "stacking", _stacked_with_members
    raise TypeError(
        f"cannot serve params of type {type(params).__name__}; "
        "expected PipelineParams, TreeEnsembleParams, or StackingParams"
    )


def forward_step(family: str, core, dtype, p, cols, block, Xs: torch.Tensor):
    """``(p1, members | None, qrows)`` of one bucket from ``Xs`` on the
    parameters' device: the body each bucket's graph captures, the CPU runs
    directly and ``persist.aot`` compiles (there every tensor argument is a
    graph input). ``cols``/``block`` are a pipeline's pre-resolved support
    columns and imputer block."""
    if family == "pipeline":
        X17 = block(p.imputer, Xs).index_select(1, cols)
        p1, m = core(p.ensemble, X17.to(dtype))
        return p1, m, X17
    if family == "tree":
        return core(p, Xs), None, Xs
    p1, m = core(p, Xs)
    return p1, m, Xs


def _ensemble(params):
    from machine_learning_replications_tpu_torch.models import pipeline

    return params.ensemble if isinstance(params, pipeline.PipelineParams) else params


def params_dtype(params) -> torch.dtype:
    """The dtype the eager route scores in: the ensemble's (the meta-LR's),
    or the forest's thresholds for a bare GBDT."""
    from machine_learning_replications_tpu_torch.models import tree

    if isinstance(params, tree.TreeEnsembleParams):
        return params.threshold.dtype
    return _ensemble(params).meta.coef.dtype


def params_device(params) -> torch.device:
    """The device the parameters lie on."""
    from machine_learning_replications_tpu_torch.models import pipeline, tree

    if isinstance(params, pipeline.PipelineParams):
        return params.imputer.donors.device
    if isinstance(params, tree.TreeEnsembleParams):
        return params.threshold.device
    return params.meta.coef.device


def oracle_proba1(params, rows, *, device=None) -> np.ndarray:
    """The eager composition ``cli predict`` runs, on many rows: the parity
    oracle of the engine's warmup, of deploy candidates
    (``serve.server._verify_parity``) and of the tests. Runs where the
    parameters lie unless ``device`` says otherwise (they must lie there)."""
    from machine_learning_replications_tpu_torch.models import pipeline, stacking, tree

    dev = params_device(params) if device is None else resolve_device(device)
    rows = np.asarray(rows, np.float64)
    if isinstance(params, pipeline.PipelineParams):
        out = pipeline.pipeline_predict_proba1_contract(params, rows, device=dev)
    elif isinstance(params, tree.TreeEnsembleParams):
        out = tree.predict_proba1(
            params, torch.as_tensor(rows, device=dev).to(params.threshold.dtype))
    else:
        xt = torch.as_tensor(rows, device=dev).to(params.meta.coef.dtype)
        out = stacking.predict_proba1(params, xt, device=dev)
    return to_host(out).astype(np.float64)


def parity_tolerance(params=None) -> tuple[float, float]:
    """``(rtol, atol)`` for engine-vs-eager-oracle parity, keyed on the
    dtype the parameters score in (``params_dtype``; without parameters,
    torch's default dtype): 1e-12 relative in float64, 1e-5 in float32.
    The engine runs the oracle's kernels, but at the bucket's row count,
    where a library may pick another product kernel and sum in another
    order."""
    dt = torch.get_default_dtype() if params is None else params_dtype(params)
    return (1e-12, 1e-15) if dt == torch.float64 else (1e-5, 1e-8)


class _Graph:
    """One bucket's capture: the graph and its static input and outputs."""

    __slots__ = ("graph", "static_in", "p1", "members", "qrows")

    def __init__(self, graph, static_in, outs) -> None:
        self.graph = graph
        self.static_in = static_in
        self.p1, self.members, self.qrows = outs


class BucketedPredictEngine:
    """Batched predict over a bounded, warm bucket ladder, on ``device``
    (default: the card; the parameters are moved there).

    ``trace_counts`` maps bucket size → the number of times that bucket was
    captured as a CUDA graph (on the CPU: first run), so tests can assert
    the bound directly.

    ``aot`` (a ``persist.aot.AotView``) lets ``warmup`` restore the
    published package instead of capturing: a restored bucket runs the
    loaded program on the engine's stream, under its lock, and counts no
    capture. Restores fail open per bucket: any failure (fingerprint,
    structure, a torn package, a program that disagrees with the eager
    oracle) is journaled (``aot_fallback``), counted
    (``serve_aot_fallback_total``) and that bucket is captured on the same
    device as without a bundle. ``aot_role`` labels the telemetry
    (``device`` for the batch engine, ``host`` for the fast-path scorer).
    """

    def __init__(
        self,
        params,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        quality=None,
        split_penalty_rows: int = DEFAULT_SPLIT_PENALTY_ROWS,
        max_split: int = DEFAULT_MAX_SPLIT,
        *,
        device=None,
        aot=None,
        aot_role: str = "device",
    ) -> None:
        from machine_learning_replications_tpu_torch import convert
        from machine_learning_replications_tpu_torch.models import pipeline

        buckets = sorted({int(b) for b in buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket ladder must be positive ints, got {buckets!r}")
        if split_penalty_rows < 0 or max_split < 1:
            raise ValueError(
                "need split_penalty_rows >= 0 and max_split >= 1"
            )
        self.buckets = tuple(buckets)
        self.split_penalty_rows = int(split_penalty_rows)
        self.max_split = int(max_split)
        self.device = resolve_device(device)
        self.params = convert.params_to(params, self.device)
        self.trace_counts: dict[int, int] = {}
        self.warm = False
        self.n_features = 17  # the predict_hf.py:5-27 contract width
        self.aot = aot
        self.aot_role = str(aot_role)
        # bucket -> restored runner (``X -> (p1, members, qrows)``), filled
        # by warmup; a bucket not in here is captured (or run, on the CPU).
        self._aot_execs: dict = {}
        # obs.quality.QualityMonitor (or a feed, or None): every predict()
        # feeds it the batch's REAL rows in the model's input space —
        # post-impute post-select for the pipeline route, the contract rows
        # themselves for bare ensembles — plus blended and member
        # probabilities. Warmup bypasses predict(), so warmup rows never
        # touch the drift window.
        self.quality = quality
        self.family, self._core = family_core(self.params)
        self._dtype = params_dtype(self.params)
        self._graphs: dict[int, _Graph] = {}
        # One lock per engine around copy-in → replay → copy-out (and
        # capture): the flush thread, a deploy and the supervisor's
        # restarter may all reach the same engine.
        self._lock = threading.Lock()
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        p = self.params
        if isinstance(p, pipeline.PipelineParams):
            # Resolved once: the support columns as a device index (the
            # eager impute_select fetches the mask per call) and the
            # imputer's contract-pattern block, whose resolution reduces
            # the donors' NaN flags on the device and fetches them.
            self._cols = pipeline.support_columns(p)
            self._block = pipeline.resolve_contract_block_fn(p).on_device(self.device)
            self._in_dtype = torch.promote_types(torch.float64, p.imputer.donors.dtype)
        else:
            self._cols = self._block = None
            self._in_dtype = self._dtype

    # -- the forward step ----------------------------------------------------

    def _forward(self, Xs: torch.Tensor):
        """``(p1, members | None, qrows)`` from ``Xs`` on the device: the
        body each bucket's graph captures (and the CPU runs directly)."""
        return forward_step(self.family, self._core, self._dtype, self.params,
                            self._cols, self._block, Xs)

    def _eager_nan_route(self, X17: np.ndarray):
        """A direct caller's contract rows holding a NaN widen the imputer's
        pattern past the pre-resolved block: the eager per-call route, on
        the same device (never an unimputed NaN, never the CPU)."""
        from machine_learning_replications_tpu_torch.models import pipeline

        x64 = pipeline.contract_rows_to_x64(self.params, X17)
        X17sel = pipeline.impute_select(self.params, x64)
        p1, m = self._core(self.params.ensemble, X17sel.to(self._dtype))
        return p1, m, X17sel

    def _host_rows(self, X17: np.ndarray) -> np.ndarray:
        if self.family == "pipeline":
            from machine_learning_replications_tpu_torch.models import pipeline

            return pipeline.contract_rows_to_x64(self.params, X17)
        return X17

    def _note_trace(self, rows: int) -> None:
        self.trace_counts[rows] = self.trace_counts.get(rows, 0) + 1

    def _capture(self, b: int) -> _Graph:
        """Capture bucket ``b``'s forward as a CUDA graph (under the lock):
        one eager run on the engine's stream first — cuBLAS allocates its
        workspace there, outside the capture — then the capture, in
        ``thread_local`` mode so other threads replaying other engines are
        not disturbed. Refused inside ``utils.trace.nan_guard``."""
        from machine_learning_replications_tpu_torch.data.examples import patient_row
        from machine_learning_replications_tpu_torch.utils.trace import refuse_capture

        refuse_capture(f"the serving engine's capture of bucket {b}")
        dev, s = self.device, self._stream
        rows = np.repeat(self._host_rows(patient_row()), b, axis=0)
        static_in = torch.as_tensor(rows, device=dev).to(self._in_dtype)
        s.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s):
            self._forward(static_in)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = self._forward(static_in)
            finally:
                graph.capture_end()
        s.synchronize()
        torchmon.record_graph_capture()
        self._note_trace(b)
        g = self._graphs[b] = _Graph(graph, static_in, outs)
        return g

    def _run_bucket(self, Xb: np.ndarray, feed: bool):
        """One ladder bucket: ``(p1, members, qrows)`` as host arrays
        (``members``/``qrows`` only when ``feed``)."""
        b = Xb.shape[0]
        restored = self._aot_execs.get(b)
        if self._stream is None:
            with region("engine.forward"):
                if restored is not None:
                    outs = restored(torch.as_tensor(Xb).to(self._in_dtype))
                else:
                    if b not in self.trace_counts:
                        self._note_trace(b)
                    outs = self._forward(torch.as_tensor(Xb).to(self._in_dtype))
                return tuple(
                    None if t is None or (i and not feed) else to_host(t)
                    for i, t in enumerate(outs)
                )
        if restored is not None:
            with self._lock, region("engine.forward"):
                self._stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self._stream):
                    p1, members, qrows = restored(
                        torchmon.device_put(Xb, self.device).to(self._in_dtype))
                    p1 = to_host(p1)
                    members = to_host(members) if feed and members is not None else None
                    qrows = to_host(qrows) if feed else None
            return p1, members, qrows
        with self._lock:
            g = self._graphs.get(b)
            if g is None:
                g = self._capture(b)
            with torch.cuda.stream(self._stream):
                with region("engine.copy_in"):
                    g.static_in.copy_(torch.from_numpy(Xb).to(self._in_dtype))
                    torchmon.record_transfer(
                        "h2d", g.static_in.numel() * g.static_in.element_size())
                with region("engine.replay"):
                    g.graph.replay()
                # Copied out (and waited for) before the lock is released:
                # the next replay overwrites the static outputs.
                with region("engine.copy_out"):
                    p1 = to_host(g.p1)
                    members = to_host(g.members) if feed and g.members is not None else None
                    qrows = to_host(g.qrows) if feed else None
        return p1, members, qrows

    # -- the engine interface ------------------------------------------------

    def compile_count(self) -> int:
        """Total bucket captures (CPU: first runs) so far. The batcher
        samples this around each flush: a flush that moves it paid a cold
        bucket — the attribution request traces carry as ``cold_compile``."""
        return sum(self.trace_counts.values())

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket holding ``n`` rows (the largest bucket
        for anything bigger — ``predict`` chunks such batches)."""
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def plan_batch(self, n: int) -> tuple[int, ...]:
        """The bucket sequence an ``n``-row batch will actually run as:
        whole top-bucket chunks for anything oversize, then the cheapest
        covering decomposition of the remainder. ``sum(plan) − n`` is the
        flush's padded-row count; only the final chunk pads."""
        if n <= 0:
            return ()
        top = self.buckets[-1]
        q, r = divmod(n, top)
        plan = (top,) * q
        if r:
            plan += _tail_plan(
                r, self.buckets, self.split_penalty_rows, self.max_split
            )
        return plan

    def predict(self, X: np.ndarray) -> np.ndarray:
        """P(class 1) for ``X[n, 17]`` contract-order rows; any ``n`` ≥ 0.

        The batch runs as the ``plan_batch`` chunk sequence (order
        preserving): batches beyond the largest bucket become sequential
        top-bucket chunks, mid-size remainders split into best-fit
        sub-batches. Every chunk is a ladder bucket, so the number of
        captures stays bounded whatever the caller hands in."""
        with region("engine.predict"):
            X = np.asarray(X, np.float64)
            if X.ndim != 2 or X.shape[1] != self.n_features:
                raise ValueError(
                    f"expected [n, {self.n_features}] contract rows, got "
                    f"{X.shape}"
                )
            n = X.shape[0]
            if n == 0:
                return np.empty((0,), np.float64)
            # Faultpoint: the device-compute injection site. A raise here is a
            # failing compute (feeds the supervisor's breaker streak); a delay
            # is a wedged device. Free when nothing is armed.
            faults.fire("engine.compute")
            feed = self.quality is not None
            probs_parts: list[np.ndarray] = []
            member_parts: list[np.ndarray] | None = [] if feed else None
            qrow_parts: list[np.ndarray] = []
            off = 0
            for chunk, b in enumerate(self.plan_batch(n)):
                with region("engine.prep", chunk=chunk):
                    take = min(b, n - off)
                    Xc = X[off:off + take]
                    if take < b:
                        Xc = np.pad(Xc, ((0, b - take), (0, 0)), mode="edge")
                    eager = self.family == "pipeline" and np.isnan(Xc).any()
                    if not eager:
                        Xc = self._host_rows(Xc)
                if eager:
                    with region("engine.forward"):
                        p1, members, qrows = (
                            None if t is None else to_host(t) for t in self._eager_nan_route(Xc))
                else:
                    p1, members, qrows = self._run_bucket(Xc, feed)
                probs_parts.append(np.asarray(p1, np.float64)[:take])
                if feed:
                    # Pad rows sliced off BEFORE anything downstream sees them:
                    # edge-replicated rows would double-weight the last real
                    # patient in the drift window.
                    qrow_parts.append(np.asarray(qrows)[:take])
                    if members is None:
                        member_parts = None
                    elif member_parts is not None:
                        member_parts.append(np.asarray(members, np.float64)[:take])
                off += take
            probs = (
                probs_parts[0] if len(probs_parts) == 1
                else np.concatenate(probs_parts)
            )
            if self.quality is not None:
                try:
                    self.quality.observe_batch(
                        qrow_parts[0] if len(qrow_parts) == 1
                        else np.concatenate(qrow_parts),
                        probs,
                        None if member_parts is None
                        else (
                            member_parts[0] if len(member_parts) == 1
                            else np.concatenate(member_parts)
                        ),
                    )
                except Exception as exc:
                    # Telemetry must never take serving down: the prediction
                    # already succeeded, so a monitor failure quarantines the
                    # feed — journaled once — instead of failing every batch.
                    msg = f"{type(exc).__name__}: {exc}"
                    journal.event("quality_feed_disabled", error=msg)
                    disable = getattr(self.quality, "disable", None)
                    if disable is not None:
                        disable(f"feed quarantined: {msg}")
                    self.quality = None
            return probs

    def warmup(self, say=None) -> dict[int, float]:
        """Make every ladder bucket hot up front (example-patient rows):
        restore it from the ``aot`` bundle, or capture its graph on a CUDA
        device, or run it once on the CPU, then hold every lane of the
        bucket's output to the eager oracle at ``parity_tolerance``. A
        restored bucket that fails (or disagrees) falls back, journaled, to
        a capture; a captured bucket that disagrees raises instead of
        serving. Returns per-bucket wall seconds (also the
        ``serve_warmup_seconds`` gauge; ``say`` is kept for interface
        compatibility)."""
        from machine_learning_replications_tpu_torch.data.examples import patient_row

        # Faultpoint: a raise here makes a supervised restart attempt fail
        # (the factory re-warms), exercising the bounded-backoff retry.
        faults.fire("engine.warmup")
        row = patient_row()
        if self.aot is not None and not self._aot_execs:
            self._restore_aot()
        want = float(oracle_proba1(self.params, row)[0])
        times: dict[int, float] = {}
        for b in self.buckets:
            times[b] = self._warm_bucket(b, row, want)
        self.warm = True
        return times

    def _restore_aot(self) -> None:
        """Load the bundle's package for every bucket (fails open per
        bucket: a failed load journals and counts a fallback and leaves the
        bucket to be captured). The bundle-level gate — fingerprint,
        family, backend coverage — runs once."""
        try:
            bad = self.aot.unusable_reason(self.family, dtype=self._dtype)
        except Exception as exc:  # a torn manifest must not kill warmup
            bad = ("manifest_unreadable", f"{type(exc).__name__}: {exc}")
        if bad is not None:
            code, detail = bad
            self._aot_fallback(code, detail=detail)
            return
        gi = GraphInputs(self)
        for b in self.buckets:
            t0 = time.monotonic()
            try:
                model = self.aot.load_exec(b, gi.structure, self.device)
            except Exception as exc:
                self._aot_fallback("deserialize_error", bucket=b,
                                   detail=f"{type(exc).__name__}: {exc}")
                continue
            if model is None:
                self._aot_fallback("missing_bucket", bucket=b)
                continue
            dt = time.monotonic() - t0
            self._aot_execs[b] = functools.partial(
                _run_restored, model, gi.inputs, self.family)
            AOT_RESTORE_SECONDS.set(dt, path=self.aot_role, bucket=str(b))
            journal.event("aot_restore", role=self.aot_role, bucket=b,
                          seconds=round(dt, 4))

    def _aot_fallback(self, reason: str, bucket=None, detail=None) -> None:
        # Journal key is `role` (device|host), not `path`: persist.aot's
        # emits carry `path` as a filesystem path.
        AOT_FALLBACKS.inc(reason=reason)
        journal.event("aot_fallback", reason=reason, role=self.aot_role,
                      bucket=bucket, detail=detail)

    def _warm_bucket(self, b: int, row, want: float) -> float:
        """One bucket's warmup: run the restored program (or capture), hold
        every lane to the oracle, and on a restored bucket's failure fall
        back to a capture. Returns the bucket's wall seconds, fallback
        included."""
        rows = np.repeat(self._host_rows(row), b, axis=0)
        rtol, atol = parity_tolerance(self.params)
        via_aot = b in self._aot_execs
        t0 = time.monotonic()
        p1 = None
        with journal.stage_scope(f"serve_warmup:{self.aot_role}:b{b}"):
            try:
                if not via_aot and self._stream is not None and b not in self._graphs:
                    with self._lock:
                        self._capture(b)
                p1 = self._run_bucket(rows, False)[0]
            except Exception:
                if not via_aot:
                    raise  # a capture that fails is a real engine failure
        if via_aot:
            # Whole-vector check: the warmup rows are b copies of one
            # patient, so EVERY lane must equal the oracle.
            reason = ("exec_error" if p1 is None else None if (
                np.shape(p1) == (b,) and np.allclose(p1, want, rtol=rtol, atol=atol)
            ) else "parity_mismatch")
            if reason is not None:
                self._aot_fallback(reason, bucket=b)
                del self._aot_execs[b]
                with journal.stage_scope(f"serve_warmup:{self.aot_role}:b{b}:retrace"):
                    if self._stream is not None:
                        with self._lock:
                            self._capture(b)
                    p1 = self._run_bucket(rows, False)[0]
        if p1.shape != (b,) or not np.allclose(p1, want, rtol=rtol, atol=atol):
            raise RuntimeError(
                f"bucket {b} does not reproduce the eager oracle: "
                f"{np.asarray(p1).tolist()[:4]} vs {want}"
            )
        dt = time.monotonic() - t0
        WARMUP_SECONDS.set(dt, path=self.aot_role, bucket=str(b))
        return dt


def _run_restored(model, inputs, family: str, X: torch.Tensor):
    """A restored bucket: the loaded package on the engine's inputs and
    ``X`` → ``(p1, members, qrows)``."""
    return outputs_to_step(family, model(inputs, X), X)

"""Command line of the PyTorch port.

    python -m machine_learning_replications_tpu_torch train \\
        [--develop MAT --select MAT | --synthetic N] [--missing-rate R] \\
        [--seed S] [--config JSON] [--save DIR] [--resume-dir DIR] \\
        [--plots DIR] [--trace-dir DIR] [--journal JSONL] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch predict \\
        [--model DIR | --pkl PICKLE] [--patient JSON] \\
        [--trace-dir DIR] [--journal JSONL] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch sweep \\
        [cohort flags as train] [--n-estimators M ...] [--max-depth D ...] \\
        [--folds K] [--save DIR] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch import-sklearn \\
        --pkl PICKLE --out DIR [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch serve \\
        [--model DIR | --pkl PICKLE] [--host H] [--port P] [--buckets LADDER] \\
        [serving, resilience, alerting flags as the JAX CLI's] \\
        [--trace-dir DIR] [--journal JSONL] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch score \\
        (--model DIR | --pkl PICKLE) --cohort JSONL|MAT --out DIR \\
        [--chunk-rows N] [--prefetch N] [--parse-workers N] [--parse-procs N] \\
        [the JAX CLI's other score flags] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch learn retrain|shadow \\
        --model DIR --capture DIR [--candidate DIR] [the JAX CLI's learn flags] \\
        [--device cpu|cuda]

``train`` is ``train_ensemble_public.py``: it fits the full pipeline
(impute → LassoCV top-17 → stacking ensemble → quality profile) on the
development cohort, scores the model-select cohort, prints the
classification report at threshold 0.5 and the ``AUC-ROC … average
precision …`` line, with ``--plots`` writes ``roc.png`` and ``pr.png``, and
with ``--save`` writes a port checkpoint. Without ``.mat`` paths the two
cohorts are the disjoint halves of ``make_cohort(2 · --synthetic)``.
``--resume-dir`` checkpoints every stage so a re-run with the same inputs
resumes.

``predict`` loads a port checkpoint (``--model``, ``persist/checkpoint.py``)
or a sklearn pickle (``--pkl``; one of the two is needed: the reference's
shipped model lies outside the checkout, so unlike the JAX CLI there is no
default), scores one patient — the reference's example patient
(``predict_hf.py:5-27``) unless ``--patient`` names a JSON object of the 17
contract variables — and prints ``Probability of progressive HF is: XX.XX
%`` (``predict_hf.py:38-40``).

``sweep`` runs the 5-fold CV grid over ``n_estimators × max_depth`` of the
GBDT member (``bench.py`` config 4) on the development cohort's 17 contract
columns, prints the mean-AUC grid and the ``best:`` cell, and with
``--save`` refits the best cell on all rows into a port checkpoint that
``predict --model`` scores as a bare GBDT. ``import-sklearn`` decodes a
sklearn pickle (no sklearn needed, no pickled code run) into a port
checkpoint.

``serve`` is the JAX CLI's micro-batched HTTP server (``/predict``,
``/healthz``, ``/readyz``, ``/metrics``, ``/debug/*``, ``/admin/deploy``) on
the port's engine: one CUDA graph per bucket on the card, the host fast
path on the CPU, supervised, drained on SIGTERM. Like ``predict`` it needs
``--model`` or ``--pkl``. Not ported yet (ROADMAP item 8b): ``--workers``
above 1, ``--register``/``--advertise``, ``--no-aot`` and
``--xla-intra-op-threads``.

``score`` streams a cohort file (JSONL patient dicts or a reference-layout
``.mat``) through the overlapped ingest → device pipeline (``score/``) into
sharded, resumable output, as the JAX CLI's does; its ``--mesh`` and
``--distributed`` exit naming ROADMAP item 7, and ``--xla-intra-op-threads
N`` bounds torch's host threads (``torch.set_num_threads``). ``learn
retrain`` refits the live checkpoint's family on captured traffic into a
versioned candidate, ``learn shadow`` replays the capture through both and
prints the verdict; ``learn run``, ``promote`` and ``status`` talk to a
fleet router and exit naming ROADMAP item 8b.

``--trace-dir`` and ``--journal`` (``train``, ``predict``, ``serve``,
``score``, ``learn``) write the run's
spans as a Chrome trace (``<dir>/trace.json``) and a JSONL journal (a
manifest first, then stage and checkpoint events, ``run_done`` last, with
the run's ``obs.torchmon`` totals). Every command runs on the card unless
``--device cpu`` is given; without CUDA it exits with an error instead of
moving to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device


def _device(args, command: str) -> torch.device:
    """``--device`` resolved, or exit naming the command (no CUDA)."""
    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"{command}: {exc}")


def _load_patient(path: str | None) -> np.ndarray:
    """Patient JSON path → the validated ``(1, 17)`` contract row (the
    example patient without a path). A patient that fails validation exits
    with the validator's message: silently defaulting a clinical input would
    be unsafe."""
    from machine_learning_replications_tpu_torch.data.examples import (
        patient_row,
        validate_patient,
    )

    if not path:
        return patient_row()
    with open(path) as f:
        patient = json.load(f)
    try:
        return validate_patient(patient)
    except ValueError as exc:
        raise SystemExit(str(exc))


def predict_proba1(params, x: np.ndarray, dev: torch.device) -> float:
    """P(class 1) of one contract row, routed by the checkpoint's family as
    the JAX ``cli predict`` routes it: a full pipeline embeds the row and
    imputes the 47 other variables; a bare GBDT (a sweep's refit) and a
    stacked ensemble take the 17 contract columns as they are, in the
    parameters' dtype (``serve.engine.oracle_proba1``, the serving parity
    oracle, is this route on many rows)."""
    from machine_learning_replications_tpu_torch.serve.engine import oracle_proba1

    return float(oracle_proba1(params, x, device=dev)[0])


def _load_cohort(args, which: str):
    """``(X64, y)`` of the ``develop`` or ``select`` cohort: its ``.mat`` when
    given, else that half of ``make_cohort(2 · --synthetic)`` (two
    deterministic disjoint halves; default 713 rows each, the reference's
    fit-split size)."""
    from machine_learning_replications_tpu_torch import data

    path = getattr(args, which, None)
    if path:
        X, y, _ = data.load_data(path)
        return X, y
    n = args.synthetic
    X, y, _ = data.make_cohort(n=2 * n, seed=args.seed, missing_rate=args.missing_rate)
    half = slice(0, n) if which == "develop" else slice(n, 2 * n)
    return X[half], y[half]


def _config(args):
    from machine_learning_replications_tpu_torch.config import ExperimentConfig

    if args.config:
        with open(args.config) as f:
            return ExperimentConfig.from_json(f.read())
    return ExperimentConfig()


@contextlib.contextmanager
def _observed(args, command: str, config_json: str | None = None):
    """The observability layer for one CLI run: ``obs.torchmon`` accounting
    into the global registry, an active tracer when ``--trace-dir`` is given
    (``trace.json`` written on exit), an active journal when ``--journal``
    is given (manifest first, then structured events, ``run_done`` with the
    torchmon totals or ``run_error`` last), and a root span named after the
    command, so every stage nests under it."""
    from machine_learning_replications_tpu_torch.obs import journal, spans, torchmon

    tracer = jrn = None
    if args.trace_dir or args.journal:
        torchmon.install()
    # Construct everything that can fail (the journal's open) before
    # touching the process-global slots: a failed setup must not leave a
    # stale global absorbing later spans in in-process callers.
    if args.journal:
        jrn = journal.RunJournal(args.journal, command=command, config_json=config_json)
    if args.trace_dir:
        tracer = spans.Tracer(process_name=f"mlr-torch {command}")
    if jrn is not None:
        journal.set_journal(jrn)
    if tracer is not None:
        spans.set_tracer(tracer)
    try:
        with spans.span(command):
            yield
    except BaseException as exc:
        if jrn is not None:
            jrn.event("run_error", error=f"{type(exc).__name__}: {exc}")
        raise
    else:
        if jrn is not None:
            jrn.event("run_done", **torchmon.totals())
    finally:
        if jrn is not None:
            journal.set_journal(None)
            jrn.close()
            print(f"journal written to {jrn.path}", file=sys.stderr)
        if tracer is not None:
            spans.set_tracer(None)
            path = tracer.write(os.path.join(args.trace_dir, "trace.json"))
            print(f"trace written to {path} (load at https://ui.perfetto.dev)", file=sys.stderr)


def cmd_train(args) -> int:
    dev = _device(args, "train")
    cfg = _config(args)
    with _observed(args, "train", config_json=cfg.to_json()):
        return _run_train(args, cfg, dev)


def _run_train(args, cfg, dev: torch.device) -> int:
    from machine_learning_replications_tpu_torch.device import to_host
    from machine_learning_replications_tpu_torch.models import pipeline
    from machine_learning_replications_tpu_torch.obs import spans
    from machine_learning_replications_tpu_torch.utils import metrics

    X_dev, y_dev = _load_cohort(args, "develop")
    X_sel, y_sel = _load_cohort(args, "select")
    with spans.span("fit_pipeline", rows=int(X_dev.shape[0])):
        params, info = pipeline.fit_pipeline(X_dev, y_dev, cfg, checkpoint_dir=args.resume_dir,
                                             device=dev)
    print(f"selected {info['n_selected']} features", file=sys.stderr)
    with spans.span("evaluate") as sp:
        p1 = sp.block(pipeline.pipeline_predict_proba1(params, X_sel, device=dev))
    p1 = to_host(p1)
    yy = (p1 > 0.5).astype(np.float64)  # train_ensemble_public.py:63
    print(metrics.report_text(metrics.classification_report(y_sel, yy)))
    auc = float(metrics.roc_auc(y_sel, p1))
    ap = float(metrics.average_precision(y_sel, p1))
    print(f"AUC-ROC {auc:.4f}   average precision {ap:.4f}")
    if args.plots:
        from machine_learning_replications_tpu_torch.utils import plots

        os.makedirs(args.plots, exist_ok=True)
        plots.roc_figure(y_sel, p1, out_path=os.path.join(args.plots, "roc.png"))
        plots.pr_figure(y_sel, p1, out_path=os.path.join(args.plots, "pr.png"))
        print(f"plots written to {args.plots}", file=sys.stderr)
    if args.save:
        from machine_learning_replications_tpu_torch.persist import checkpoint

        checkpoint.save_model(args.save, params)
        print(f"model checkpointed to {args.save}", file=sys.stderr)
    return 0


def cmd_predict(args) -> int:
    dev = _device(args, "predict")
    with _observed(args, "predict"):
        return _run_predict(args, dev)


def _run_predict(args, dev: torch.device) -> int:
    from machine_learning_replications_tpu_torch.obs import spans
    from machine_learning_replications_tpu_torch.persist import (
        load_inference_params,
        sklearn_import,
    )

    x = _load_patient(args.patient)
    if not (args.model or args.pkl):
        raise SystemExit(f"predict: {sklearn_import.NO_DEFAULT_PKL}")
    with spans.span("load_params") as sp:
        try:
            params = load_inference_params(model=args.model, pkl=args.pkl, device=dev)
        except FileNotFoundError as exc:
            raise SystemExit(f"predict: {exc}")
        sp.note(family=type(params).__name__)
    with spans.span("predict_proba"):
        prob = predict_proba1(params, x, dev)
    print(f"Probability of progressive HF is: {100.0 * prob:.2f} %")  # predict_hf.py:38-40
    return 0


def cmd_serve(args) -> int:
    """Micro-batched HTTP inference serving (the JAX CLI's ``serve``)."""
    dev = _device(args, "serve")
    if args.workers > 1:
        raise SystemExit(
            "serve: --workers above 1 (pre-fork SO_REUSEPORT workers) is not "
            "ported yet (ROADMAP item 8b): a fork after CUDA is initialised is "
            "undefined; run one worker per process"
        )
    if not (args.model or args.pkl):
        from machine_learning_replications_tpu_torch.persist import sklearn_import

        raise SystemExit(f"serve: {sklearn_import.NO_DEFAULT_PKL}")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # The knobs that shape serving behaviour, for the manifest's config hash.
    serve_cfg = json.dumps({
        "buckets": list(buckets), "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms, "max_queue": args.max_queue,
        "request_timeout_s": args.request_timeout,
        "warmup": not args.no_warmup,
        "model": args.model, "pkl": args.pkl,
        "slo_latency_ms": args.slo_latency_ms,
        "slo_latency_target": args.slo_latency_target,
        "slo_availability_target": args.slo_availability_target,
        "no_slo": args.no_slo,
        "trace_capacity": args.trace_capacity,
        "tail_quantile": args.tail_quantile,
        "profile_dir": args.profile_dir,
        "no_quality": args.no_quality,
        "drift_warn_psi": args.drift_warn_psi,
        "drift_alert_psi": args.drift_alert_psi,
        "supervise": not args.no_supervise,
        "flush_deadline_s": args.flush_deadline_s,
        "breaker_failures": args.breaker_failures,
        "restart_backoff_s": args.restart_backoff_s,
        "restart_backoff_max_s": args.restart_backoff_max_s,
        "inject": sorted(args.inject or []),
        "fault_endpoint": bool(args.inject or args.fault_endpoint),
        "workers": args.workers,
        "idle_timeout_s": args.idle_timeout,
        "max_connections": args.max_connections,
        "host_path": not args.no_host_path,
        "host_workers": args.host_workers,
        "replica_id": args.replica_id,
        "admin_endpoint": args.admin_endpoint,
        "history_interval_s": args.history_interval,
        "alert_rules": args.alert_rules,
        "no_alerts": args.no_alerts,
        "incident_dir": args.incident_dir,
        "device": str(dev),
    }, sort_keys=True)
    with _observed(args, "serve", config_json=serve_cfg):
        return _run_serve(args, buckets, dev)


def _load_alert_rules(path):
    """Parse a ``--alert-rules`` JSON file, turning the rule engine's
    validation errors into the CLI's usage-error exit."""
    from machine_learning_replications_tpu_torch.obs import alerts

    try:
        return alerts.load_rules(path)
    except (OSError, ValueError) as exc:
        raise SystemExit(f"--alert-rules: {exc}")


def _run_serve(args, buckets, dev: torch.device) -> int:
    import gc
    import signal
    import threading

    from machine_learning_replications_tpu_torch.obs import slo
    from machine_learning_replications_tpu_torch.persist import load_inference_params
    from machine_learning_replications_tpu_torch.resilience import faults
    from machine_learning_replications_tpu_torch.serve import make_server

    # Arm injections BEFORE the model loads or the engine warms: the
    # engine.warmup faultpoint is part of the chaos surface.
    for spec in args.inject or []:
        try:
            armed = faults.arm(spec)
        except ValueError as exc:
            raise SystemExit(f"--inject: {exc}")
        print(f"fault armed: {armed.describe()}", file=sys.stderr)
    # The checkpoint's monotonic version rides every reply as
    # X-Model-Version, from the directory that ACTUALLY loaded (a corrupt
    # primary rolls back to its last-known-good); a pickle is unversioned.
    model_version = None
    try:
        if args.model:
            from machine_learning_replications_tpu_torch.persist import checkpoint

            params, info = checkpoint.load_model_versioned(args.model, device=dev)
            model_version = info["version"]
        else:
            params = load_inference_params(pkl=args.pkl, device=dev)
    except FileNotFoundError as exc:
        raise SystemExit(f"serve: {exc}")
    handle = make_server(
        params,
        host=args.host,
        port=args.port,
        buckets=buckets,
        max_batch_size=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        warmup=not args.no_warmup,
        request_timeout_s=args.request_timeout,
        quiet=not args.verbose,
        say=lambda m: print(m, file=sys.stderr),
        slos=(
            [] if args.no_slo else slo.default_slos(
                latency_ms=args.slo_latency_ms,
                latency_target=args.slo_latency_target,
                availability_target=args.slo_availability_target,
            )
        ),
        trace_capacity=args.trace_capacity,
        tail_quantile=args.tail_quantile,
        profile_dir=args.profile_dir,
        no_quality=args.no_quality,
        drift_warn_psi=args.drift_warn_psi,
        drift_alert_psi=args.drift_alert_psi,
        supervise=not args.no_supervise,
        flush_deadline_s=args.flush_deadline_s,
        breaker_failures=args.breaker_failures,
        restart_backoff_s=args.restart_backoff_s,
        restart_backoff_max_s=args.restart_backoff_max_s,
        fault_endpoint=bool(args.inject or args.fault_endpoint),
        idle_timeout_s=args.idle_timeout,
        max_connections=args.max_connections,
        host_path=not args.no_host_path,
        host_workers=args.host_workers,
        model_version=model_version,
        replica_id=args.replica_id,
        admin_endpoint=args.admin_endpoint,
        history_interval_s=args.history_interval,
        alert_rules=(
            _load_alert_rules(args.alert_rules) if args.alert_rules else None
        ),
        alerts_enabled=not args.no_alerts,
        incident_dir=args.incident_dir,
        incident_min_interval_s=args.incident_min_interval,
        incident_retention=args.incident_retention,
        device=dev,
    )
    # The warm startup heap (torch, the parameters, the captured graphs)
    # is permanent: freeze it out of the collector once, after warmup.
    gc.collect()
    gc.freeze()
    host, port = handle.address
    print(
        f"serving {type(params).__name__} on http://{host}:{port} "
        f"(device {dev}, buckets {buckets}, max_wait {args.max_wait_ms}ms, "
        f"queue bound {args.max_queue})",
        file=sys.stderr, flush=True,
    )

    def _graceful(signum, frame):
        print("draining and shutting down ...", file=sys.stderr)
        # shutdown() must not run on the signal-handling main thread while
        # serve_forever is blocked in it — hand it to a helper thread.
        threading.Thread(target=handle.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        handle.serve_forever()
    finally:
        handle.shutdown()
    return 0


def cmd_sweep(args) -> int:
    from machine_learning_replications_tpu_torch.config import SweepConfig
    from machine_learning_replications_tpu_torch.data import selected_indices
    from machine_learning_replications_tpu_torch.device import to_host
    from machine_learning_replications_tpu_torch.models import knn_impute, sweep

    dev = _device(args, "sweep")
    X64, y = _load_cohort(args, "develop")
    if np.isnan(X64).any():
        _, X64 = knn_impute.fit_transform(X64, device=dev)
        X64 = to_host(X64)
    X = X64[:, selected_indices()]
    cfg = SweepConfig(
        n_estimators_grid=tuple(args.n_estimators),
        max_depth_grid=tuple(args.max_depth),
        cv_folds=args.folds,
    )
    res = sweep.cv_sweep(X, y, cfg, device=dev)
    print(f"{'depth':>6} " + " ".join(f"m={m:>5d}" for m in res.n_estimators_grid))
    for di, d in enumerate(res.max_depth_grid):
        print(f"{d:>6} " + " ".join(f"{a:7.4f}" for a in res.mean_auc[di]))
    print(f"best: n_estimators={res.best_n_estimators} "
          f"max_depth={res.best_max_depth} mean AUC={res.best_mean_auc:.4f}")
    if args.save:
        from machine_learning_replications_tpu_torch.persist import checkpoint

        params, _ = sweep.refit_best(X, y, res, device=dev)
        checkpoint.save_model(args.save, params)
        print(f"refit best model checkpointed to {args.save}", file=sys.stderr)
    return 0


def cmd_import_sklearn(args) -> int:
    from machine_learning_replications_tpu_torch.persist import (
        checkpoint,
        load_inference_params,
        sklearn_import,
    )

    dev = _device(args, "import-sklearn")
    if not args.pkl:
        raise SystemExit(f"import-sklearn: {sklearn_import.NO_DEFAULT_PKL}")
    try:
        params = load_inference_params(pkl=args.pkl, device=dev)
    except FileNotFoundError as exc:
        raise SystemExit(f"import-sklearn: {exc}")
    checkpoint.save_model(args.out, params)
    print(f"imported {args.pkl} -> {args.out}")
    return 0


def cmd_score(args) -> int:
    """Population-scale bulk scoring: stream a cohort file through the
    overlapped ingest → device pipeline into sharded, resumable output."""
    dev = _device(args, "score")
    if args.mesh or args.distributed:
        raise SystemExit(
            "score: --mesh/--distributed (row-sharded device meshes) are not ported "
            "yet: they come with data-parallel training (ROADMAP item 7)"
        )
    if args.xla_intra_op_threads is not None and args.xla_intra_op_threads < 0:
        raise SystemExit("--xla-intra-op-threads must be >= 0")
    if args.xla_intra_op_threads:
        # The JAX CLI bounds XLA's CPU pool; the port's host-side math
        # (parse, impute prep, the CPU engine) runs on torch's intra-op pool.
        torch.set_num_threads(args.xla_intra_op_threads)
        print(f"torch intra-op threads: {args.xla_intra_op_threads}", file=sys.stderr)
    if not (args.model or args.pkl):
        from machine_learning_replications_tpu_torch.persist import sklearn_import

        raise SystemExit(f"score: {sklearn_import.NO_DEFAULT_PKL}")
    score_cfg = json.dumps({
        "cohort": args.cohort, "format": args.format, "out": args.out,
        "model": args.model, "pkl": args.pkl,
        "chunk_rows": args.chunk_rows, "prefetch": args.prefetch,
        "parse_workers": args.parse_workers,
        "parse_procs": args.parse_procs,
        "rows_per_shard": args.rows_per_shard,
        "max_bad_rows": args.max_bad_rows,
        "sequential": args.sequential, "fresh": args.fresh,
        "limit": args.limit, "mesh": args.mesh,
        "no_quality": args.no_quality,
        "quality_window": args.quality_window,
        "drift_warn_psi": args.drift_warn_psi,
        "drift_alert_psi": args.drift_alert_psi,
        "no_fsync": args.no_fsync,
        "xla_intra_op_threads": args.xla_intra_op_threads,
        "device": str(dev),
    }, sort_keys=True)
    with _observed(args, "score", config_json=score_cfg):
        return _run_score(args, dev)


def _run_score(args, dev: torch.device) -> int:
    from machine_learning_replications_tpu_torch.persist import load_inference_params
    from machine_learning_replications_tpu_torch.score import (
        ScoreBudgetExceeded,
        ScorePipeline,
        ScoreResumeError,
        open_cohort,
    )
    from machine_learning_replications_tpu_torch.score.progress import params_digest

    source = open_cohort(args.cohort, args.chunk_rows, fmt=args.format, limit=args.limit)
    try:
        params = load_inference_params(model=args.model, pkl=args.pkl, device=dev)
    except FileNotFoundError as exc:
        raise SystemExit(f"score: {exc}")
    pipe = ScorePipeline(
        params,
        source,
        args.out,
        overlap=not args.sequential,
        parse_workers=args.parse_workers,
        parse_procs=args.parse_procs,
        prefetch=args.prefetch,
        rows_per_shard=args.rows_per_shard,
        max_bad_rows=args.max_bad_rows,
        fresh=args.fresh,
        durable=not args.no_fsync,
        quality=not args.no_quality,
        quality_window=args.quality_window,
        drift_warn_psi=args.drift_warn_psi,
        drift_alert_psi=args.drift_alert_psi,
        model_digest=params_digest(model=args.model, pkl=args.pkl),
        device=dev,
    )
    try:
        summary = pipe.run()
    except ScoreResumeError as exc:
        raise SystemExit(f"score: {exc}")
    except ScoreBudgetExceeded as exc:
        print(f"score: ABORTED — {exc}", file=sys.stderr)
        print(f"quarantine sidecar: {os.path.join(args.out, 'quarantine.jsonl')}",
              file=sys.stderr)
        _write_score_metrics(args)
        return 2
    mode = "sequential" if args.sequential else (
        f"overlapped (parse_workers={args.parse_workers}, prefetch={args.prefetch})"
    )
    stage = summary["stage_seconds"]
    print(
        f"scored {summary['rows']} rows in {summary['chunks']} chunks "
        f"({summary['bad_rows']} quarantined) — "
        f"{summary['rows_per_second']} rows/s end-to-end over "
        f"{summary['wall_seconds']}s wall, {mode}",
    )
    print("stage busy seconds: " + ", ".join(f"{k} {v}" for k, v in stage.items()),
          file=sys.stderr)
    if summary.get("resumed"):
        print(f"resumed at chunk {summary['resumed_chunks']} "
              f"({summary['resumed_rows']} rows already committed)", file=sys.stderr)
    q = summary.get("quality")
    if q and q.get("enabled", True):
        print(
            f"cohort quality: {q['status']} (score PSI "
            f"{q['score_psi']}, worst feature {q['worst_feature']} PSI "
            f"{q['worst_psi']}, {q['rows']} rows) — "
            f"{os.path.join(args.out, 'quality.json')}",
            file=sys.stderr,
        )
    print(f"output: {len(summary['shards'])} shard(s) in {args.out} "
          f"(sha256 {summary['output_sha256'][:16]}…)", file=sys.stderr)
    _write_score_metrics(args)
    return 0


def _write_score_metrics(args) -> None:
    """--metrics-out: the run's final Prometheus exposition (score_*,
    quality_*, torch_* families)."""
    if not args.metrics_out:
        return
    from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

    with open(args.metrics_out, "w") as f:
        f.write(REGISTRY.render_prometheus())
    print(f"metrics written to {args.metrics_out}", file=sys.stderr)


def _learn_thresholds(args):
    from machine_learning_replications_tpu_torch.learn.shadow import ShadowThresholds

    return ShadowThresholds(
        max_divergence_mean=args.max_divergence_mean,
        max_divergence_p95=args.max_divergence_p95,
        max_flip_rate=args.max_flip_rate,
        max_score_psi=args.max_score_psi,
        max_candidate_psi=args.max_candidate_psi,
        max_disagreement_delta=args.max_disagreement_delta,
        min_rows=args.shadow_min_rows,
        require_candidate_profile=not args.allow_no_profile,
    )


def _candidate_default(model: str) -> str:
    return os.path.abspath(model).rstrip(os.sep) + ".candidate"


def cmd_learn(args) -> int:
    """Continual learning, the offline half: ``retrain`` and ``shadow``."""
    if args.role in ("run", "promote", "status"):
        raise SystemExit(
            f"learn {args.role}: not ported yet — it talks to a fleet router "
            "(learn/{trigger,promote,loop}.py), which comes with the fleet "
            "slice (ROADMAP item 8b)"
        )
    dev = _device(args, f"learn {args.role}")
    cfg = _config(args) if getattr(args, "config", None) else None
    learn_cfg = json.dumps({
        "role": args.role,
        "model": args.model,
        "capture": args.capture,
        "candidate": args.candidate,
        "device": str(dev),
    }, sort_keys=True)
    with _observed(args, f"learn {args.role}", config_json=learn_cfg):
        if args.role == "retrain":
            return _run_learn_retrain(args, cfg, dev)
        return _run_learn_shadow(args, dev)


def _run_learn_retrain(args, cfg, dev: torch.device) -> int:
    from machine_learning_replications_tpu_torch.learn import capture as capmod
    from machine_learning_replications_tpu_torch.learn.retrain import warm_refit
    from machine_learning_replications_tpu_torch.persist import checkpoint

    X17, n_bad = capmod.load_recent(args.capture, max_rows=args.rows)
    print(f"captured cohort: {X17.shape[0]} rows ({n_bad} malformed dropped)",
          file=sys.stderr)
    live = checkpoint.load_model(args.model, device=dev)
    out = args.candidate or _candidate_default(args.model)
    try:
        _params, info = warm_refit(live, X17, out, cfg=cfg, resume_dir=args.resume_dir,
                                   min_rows=args.min_rows, device=dev)
    except (ValueError, TypeError) as exc:
        raise SystemExit(f"learn retrain: {exc}")
    print(json.dumps(info, indent=1))
    return 0


def _run_learn_shadow(args, dev: torch.device) -> int:
    from machine_learning_replications_tpu_torch.learn import capture as capmod
    from machine_learning_replications_tpu_torch.learn import shadow as shadowmod
    from machine_learning_replications_tpu_torch.persist import checkpoint

    X17, _n_bad = capmod.load_recent(args.capture, max_rows=args.rows)
    live = checkpoint.load_model(args.model, device=dev)
    candidate_dir = args.candidate or _candidate_default(args.model)
    candidate = checkpoint.load_model(candidate_dir, device=dev)
    verdict = shadowmod.evaluate(
        live, candidate, X17,
        thresholds=_learn_thresholds(args),
        candidate_version=checkpoint.checkpoint_version(candidate_dir),
        device=dev,
    )
    line = json.dumps(verdict, indent=1)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
        print(f"verdict written to {args.out}", file=sys.stderr)
    return 0 if verdict["pass"] else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m machine_learning_replications_tpu_torch",
                                 description="PyTorch port of the heart-failure ensemble")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_cohort_flags(p):
        p.add_argument("--develop", help=".mat path of the development cohort")
        p.add_argument("--select", help=".mat path of the model-select cohort")
        p.add_argument("--synthetic", type=int, default=713,
                       help="rows per cohort when no .mat is given: two disjoint halves of "
                       "this size (default 713, the reference's fit-split size)")
        p.add_argument("--missing-rate", type=float, default=0.03)
        p.add_argument("--seed", type=int, default=2020)
        p.add_argument("--config", help="ExperimentConfig JSON path")

    def add_obs_flags(p):
        p.add_argument("--trace-dir", default=None,
                       help="write a Chrome-trace JSON of this run's spans to <dir>/trace.json "
                       "(load at https://ui.perfetto.dev)")
        p.add_argument("--journal", default=None,
                       help="JSONL run-journal path: first record is a run manifest (run id, "
                       "git sha, torch/CUDA versions, the card, config hash), then stage and "
                       "checkpoint events, run_done last")

    def add_device_flag(p):
        p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                       help="where to run (default: the card; without CUDA this is an error)")

    t = sub.add_parser("train", help="fit the full pipeline and evaluate it")
    add_cohort_flags(t)
    t.add_argument("--save", help="port checkpoint directory to write")
    t.add_argument("--plots", help="directory for roc.png / pr.png")
    t.add_argument("--resume-dir", default=None,
                   help="stage-checkpoint directory: each pipeline stage is published on "
                   "completion, so a re-run with the same data and config resumes (the "
                   "directory is fingerprinted against its inputs)")
    add_obs_flags(t)
    add_device_flag(t)
    t.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="single-patient inference")
    p.add_argument("--model", help="port checkpoint directory (persist/checkpoint.py)")
    p.add_argument("--pkl", help="legacy sklearn pickle (no default: give this or --model)")
    p.add_argument("--patient", help="patient JSON file (default: the predict_hf.py example)")
    add_obs_flags(p)
    add_device_flag(p)
    p.set_defaults(fn=cmd_predict)

    s = sub.add_parser("sweep", help="5-fold CV grid sweep of the GBDT member (config 4)")
    add_cohort_flags(s)
    s.add_argument("--n-estimators", type=int, nargs="+", default=[25, 50, 100, 200])
    s.add_argument("--max-depth", type=int, nargs="+", default=[1, 2, 3])
    s.add_argument("--folds", type=int, default=5)
    s.add_argument("--save", help="checkpoint the refit best model here")
    add_device_flag(s)
    s.set_defaults(fn=cmd_sweep)

    i = sub.add_parser("import-sklearn", help="legacy sklearn pickle → port checkpoint")
    i.add_argument("--pkl", help="pickle path (no default; the reference's "
                   "hf_predict_model.pkl lies outside the checkout)")
    i.add_argument("--out", required=True, help="port checkpoint directory")
    add_device_flag(i)
    i.set_defaults(fn=cmd_import_sklearn)

    v = sub.add_parser(
        "serve",
        help="micro-batched HTTP inference server (/predict, /healthz, /metrics)",
    )
    add_serve_flags(v)
    add_alerting_flags(v)
    add_obs_flags(v)
    add_device_flag(v)
    v.set_defaults(fn=cmd_serve)

    add_learn_parser(sub, add_obs_flags, add_device_flag)
    add_score_parser(sub, add_obs_flags, add_device_flag)
    return ap


def add_learn_parser(sub, add_obs_flags, add_device_flag) -> None:
    """The JAX CLI's whole ``learn`` parser, ``--device`` added to the roles
    that load a model."""
    ln = sub.add_parser(
        "learn",
        help="continual learning: warm refit on captured traffic and shadow "
        "evaluation (run, promote and status need a fleet router: ROADMAP item 8b)",
    )
    lsub = ln.add_subparsers(dest="role", required=True)

    def add_shadow_threshold_flags(p):
        p.add_argument(
            "--max-divergence-mean", type=float, default=0.15,
            help="shadow gate: max mean |p_candidate - p_live| over the "
            "replay (a refit should recalibrate, not reinvent)",
        )
        p.add_argument(
            "--max-divergence-p95", type=float, default=0.35,
            help="shadow gate: max p95 |p_candidate - p_live|",
        )
        p.add_argument(
            "--max-flip-rate", type=float, default=0.10,
            help="shadow gate: max fraction of replay rows whose "
            "0.5-threshold decision flips",
        )
        p.add_argument(
            "--max-score-psi", type=float, default=2.0,
            help="shadow gate: max PSI between candidate and live score "
            "distributions over the replay",
        )
        p.add_argument(
            "--max-candidate-psi", type=float, default=0.25,
            help="shadow gate: max per-feature PSI of the replay vs the "
            "CANDIDATE's own reference profile (the refit exists to make "
            "this small)",
        )
        p.add_argument(
            "--max-disagreement-delta", type=float, default=0.15,
            help="shadow gate: max increase in mean pairwise ensemble "
            "disagreement, candidate minus live",
        )
        p.add_argument(
            "--shadow-min-rows", type=int, default=64,
            help="shadow gate: minimum replay rows before a verdict may "
            "pass (fails closed below)",
        )
        p.add_argument(
            "--allow-no-profile", action="store_true",
            help="let a candidate without its own quality reference "
            "profile pass the gate (default: refuse — a promoted model "
            "must ship its drift baseline)",
        )

    def add_learn_common(p, router_required: bool, cohort: bool = True):
        p.add_argument(
            "--model", required=True,
            help="the LIVE checkpoint directory (the fleet's deploy "
            "target; the candidate is judged against, and published "
            "into, this path)",
        )
        p.add_argument(
            "--candidate", default=None, metavar="DIR",
            help="candidate checkpoint directory "
            "(default: <model>.candidate)",
        )
        if cohort:  # promote applies a verdict — it never reads rows
            p.add_argument(
                "--capture", required=True, metavar="DIR",
                help="the router's cohort-capture directory "
                "(`cli fleet router --capture DIR`)",
            )
            p.add_argument(
                "--rows", type=int, default=8192,
                help="max captured rows to load (newest first)",
            )
            p.add_argument(
                "--min-rows", type=int, default=200,
                help="refuse to act on fewer captured rows",
            )
        if router_required:
            p.add_argument(
                "--router", required=True, help="fleet router base URL"
            )

    lr = lsub.add_parser(
        "run",
        help="the closed-loop daemon: poll fleet quality, debounce, "
        "retrain on sustained alert, shadow-evaluate, promote through "
        "the fleet deploy rail",
    )
    add_learn_common(lr, router_required=True)
    lr.add_argument(
        "--alert-streak", type=int, default=3,
        help="consecutive alert polls before the trigger fires "
        "(debounce)",
    )
    lr.add_argument(
        "--cooldown", type=float, default=600.0,
        help="seconds between trigger fires",
    )
    lr.add_argument(
        "--schedule", type=float, default=None,
        help="also fire every N seconds regardless of drift (subject to "
        "the cooldown); default: alert-only",
    )
    lr.add_argument(
        "--poll-interval", type=float, default=2.0,
        help="seconds between quality polls",
    )
    lr.add_argument(
        "--recovery-timeout", type=float, default=120.0,
        help="seconds to wait for fleet quality to return to ok after a "
        "promotion (the cycle's closing assertion, journaled either way)",
    )
    lr.add_argument(
        "--settle-timeout", type=float, default=300.0,
        help="post-trigger capture turnover bound: wait (up to this many "
        "seconds) until --rows NEW rows were captured after the trigger "
        "fired, so the refit sees only post-drift traffic — a refit on "
        "the mixed pre/post-drift window learns a blend whose reference "
        "profile matches neither population (0 disables)",
    )
    lr.add_argument(
        "--max-cycles", type=int, default=None,
        help="exit after N completed cycles (drills/CI; default: run "
        "until signalled)",
    )
    lr.add_argument("--config", help="ExperimentConfig JSON for the refit")
    add_shadow_threshold_flags(lr)
    add_obs_flags(lr)
    add_device_flag(lr)
    lr.set_defaults(fn=cmd_learn)

    lt = lsub.add_parser(
        "retrain",
        help="one warm-start refit on the captured cohort -> a versioned "
        "candidate checkpoint (stage-resumable)",
    )
    add_learn_common(lt, router_required=False)
    lt.add_argument("--config", help="ExperimentConfig JSON for the refit")
    lt.add_argument(
        "--resume-dir", default=None,
        help="StageCheckpointer directory: a preempted refit re-entered "
        "with the same captured cohort resumes instead of restarting",
    )
    add_obs_flags(lt)
    add_device_flag(lt)
    lt.set_defaults(fn=cmd_learn)

    lw = lsub.add_parser(
        "shadow",
        help="replay the captured cohort through live + candidate and "
        "print the machine-readable verdict (exit 1 on fail)",
    )
    add_learn_common(lw, router_required=False)
    lw.add_argument(
        "--out", default=None,
        help="write the verdict JSON here (the input `learn promote` "
        "requires)",
    )
    add_shadow_threshold_flags(lw)
    add_obs_flags(lw)
    add_device_flag(lw)
    lw.set_defaults(fn=cmd_learn)

    lp = lsub.add_parser(
        "promote",
        help="apply a shadow verdict: publish the candidate into the "
        "live path and drive the fleet's rolling deploy (pass), or park "
        "it with a REFUSED.json (fail)",
    )
    add_learn_common(lp, router_required=True, cohort=False)
    lp.add_argument(
        "--verdict", required=False, default=None,
        help="verdict JSON from `learn shadow --out` (required: "
        "promotion without a verdict is the unguarded swap the gate "
        "exists to prevent)",
    )
    lp.add_argument(
        "--no-aot", action="store_true",
        help="publish the promoted model WITHOUT the AOT executable "
        "bundle (kept for the JAX CLI's parser; promote is not ported yet)",
    )
    lp.add_argument(
        "--timeout", type=float, default=1800.0,
        help="end-to-end rollout timeout (seconds)",
    )
    add_obs_flags(lp)
    add_device_flag(lp)
    lp.set_defaults(fn=cmd_learn)

    ls = lsub.add_parser(
        "status",
        help="fleet quality + capture-window + candidate state in one "
        "snapshot",
    )
    ls.add_argument("--router", required=True, help="fleet router base URL")
    ls.add_argument(
        "--candidate", default=None,
        help="also report this candidate dir's version/parked state",
    )
    ls.set_defaults(fn=cmd_learn)


def add_score_parser(sub, add_obs_flags, add_device_flag) -> None:
    """The JAX CLI's ``score`` flags, ``--device`` added."""
    c = sub.add_parser(
        "score",
        help="bulk-score a streamed cohort file (JSONL patients or .mat) "
        "into sharded, resumable output",
    )
    c.add_argument("--model", help="port checkpoint directory (persist/checkpoint.py)")
    c.add_argument(
        "--pkl", help="legacy sklearn pickle (no default: give this or --model)"
    )
    c.add_argument(
        "--cohort", required=True,
        help="cohort path: JSONL (one 17-variable patient object per "
        "line, the loadgen --patients format) or a reference-layout .mat "
        "(64 raw schema columns routed through impute → select → "
        "ensemble; a trailing outcome column is ignored)",
    )
    c.add_argument(
        "--format", choices=("auto", "jsonl", "mat"), default="auto",
        help="cohort format (default: by file extension)",
    )
    c.add_argument(
        "--out", required=True,
        help="output directory: scores-NNNNN.jsonl shards, "
        "quarantine.jsonl, progress.json (the resume manifest), "
        "summary.json, quality.json",
    )
    c.add_argument(
        "--chunk-rows", type=int, default=2048,
        help="rows per streamed chunk — the device stage's one padded "
        "shape AND the durable commit/resume granularity",
    )
    c.add_argument(
        "--prefetch", type=int, default=4,
        help="bounded prefetch budget: how many chunks ingest may run "
        "ahead of the device stage",
    )
    c.add_argument(
        "--parse-workers", type=int, default=2,
        help="parse/validate/impute-route worker THREADS feeding the "
        "device stage (used when --parse-procs is 0, and always for "
        ".mat cohorts)",
    )
    c.add_argument(
        "--parse-procs", type=int, default=0,
        help="ingest-parse worker PROCESSES for JSONL cohorts (spawned; "
        "the JSON/validate stage then runs free of the parent's GIL — "
        "worth it on many-core hosts where ingest parsing, not total "
        "CPU, is the ceiling; 0 = in-process threads, the default)",
    )
    c.add_argument(
        "--rows-per-shard", type=int, default=500_000,
        help="output shard rotation size",
    )
    c.add_argument(
        "--max-bad-rows", type=int, default=1000,
        help="malformed-row error budget: bad rows are quarantined to "
        "quarantine.jsonl with line numbers and the run continues, until "
        "this many — then it aborts (exit 2) instead of silently scoring "
        "a garbage cohort's parseable minority",
    )
    c.add_argument(
        "--sequential", action="store_true",
        help="disable the overlapped pipeline: read → parse → device → "
        "write strictly serialized (the bench ablation and the debugging "
        "fallback)",
    )
    c.add_argument(
        "--fresh", action="store_true",
        help="discard any resumable progress in --out and start over "
        "(default: a matching progress.json resumes at the last "
        "committed chunk)",
    )
    c.add_argument(
        "--limit", type=int, default=None,
        help="score only the first N input rows (bench/CI convenience)",
    )
    c.add_argument(
        "--no-quality", action="store_true",
        help="skip the cohort-level quality snapshot even when the "
        "checkpoint carries a reference profile",
    )
    c.add_argument(
        "--quality-window", type=int, default=1 << 20,
        help="quality-monitor window over the scored population (rows)",
    )
    c.add_argument("--drift-warn-psi", type=float, default=None)
    c.add_argument("--drift-alert-psi", type=float, default=None)
    c.add_argument(
        "--no-fsync", action="store_true",
        help="skip per-commit fsync (faster on slow disks; a crash may "
        "then lose the last chunks to the page cache, though resume "
        "still recovers consistently from what reached disk)",
    )
    c.add_argument(
        "--metrics-out", default=None,
        help="write the run's final Prometheus exposition (score_*, "
        "quality_*, torch_* families) to this path",
    )
    c.add_argument(
        "--xla-intra-op-threads", type=int, default=None,
        help="bound torch's host intra-op thread pool "
        "(torch.set_num_threads; default and 0: leave it alone — bulk "
        "scoring is throughput-bound)",
    )
    c.add_argument(
        "--mesh", default=None,
        help="device-mesh shape DATA[,MODEL] or 'auto' (not ported yet: "
        "ROADMAP item 7)",
    )
    c.add_argument(
        "--distributed", action="store_true",
        help="bring up a multi-host runtime first (not ported yet: ROADMAP item 7)",
    )
    add_obs_flags(c)
    add_device_flag(c)
    c.set_defaults(fn=cmd_score)


def add_alerting_flags(p) -> None:
    """The JAX CLI's alerting flags (history sampler, alert rules, incident
    bundles), for ``serve``."""
    p.add_argument("--history-interval", type=float, default=10.0, metavar="SECONDS",
                   help="in-process metrics history sampling interval for /debug/history "
                   "and alert evaluation (0 disables the whole history/alerting plane)")
    p.add_argument("--alert-rules", default=None, metavar="FILE",
                   help="JSON alert-rule file (list of rule specs) replacing the built-in "
                   "replica defaults")
    p.add_argument("--no-alerts", action="store_true",
                   help="sample history but evaluate no alert rules")
    p.add_argument("--incident-dir", default=None, metavar="DIR",
                   help="capture an incident bundle into DIR when a rule fires")
    p.add_argument("--incident-min-interval", type=float, default=60.0, metavar="SECONDS",
                   help="minimum seconds between incident captures")
    p.add_argument("--incident-retention", type=int, default=8,
                   help="complete incident bundles retained in --incident-dir")


def add_serve_flags(v) -> None:
    """The JAX CLI's ``serve`` flags, but for the ones not ported yet
    (ROADMAP item 8b: ``--register``, ``--advertise``, ``--no-aot``,
    ``--xla-intra-op-threads``; ``--workers`` takes only 1)."""
    v.add_argument("--model", help="port checkpoint directory (persist/checkpoint.py)")
    v.add_argument("--pkl", help="legacy sklearn pickle (no default: give this or --model)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8000)
    v.add_argument("--buckets", default="1,8,32,64,128,256,512",
                   help="batch-size ladder (comma-separated, ascending): one CUDA graph "
                   "per bucket on the card; every flush runs as the cheapest covering "
                   "sequence of buckets")
    v.add_argument("--max-batch", type=int, default=None,
                   help="micro-batch flush size (default: 64 on the CPU, the largest "
                   "bucket on the card)")
    v.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time the oldest queued request waits for batch-mates")
    v.add_argument("--max-queue", type=int, default=1024,
                   help="admission-queue bound; requests beyond it are shed with an "
                   "explicit 503 'overloaded' reply")
    v.add_argument("--request-timeout", type=float, default=30.0,
                   help="per-request reply deadline (seconds)")
    v.add_argument("--no-warmup", action="store_true",
                   help="skip the startup capture of every bucket (first requests then "
                   "pay the captures)")
    v.add_argument("--workers", type=int, default=1,
                   help="worker processes; only 1 is ported (ROADMAP item 8b)")
    v.add_argument("--idle-timeout", type=float, default=5.0,
                   help="seconds a keep-alive connection may sit idle before it is reaped")
    v.add_argument("--max-connections", type=int, default=8192,
                   help="concurrent-connection cap")
    v.add_argument("--slo-latency-ms", type=float, default=250.0,
                   help="latency SLO threshold in milliseconds")
    v.add_argument("--slo-latency-target", type=float, default=0.99,
                   help="latency SLO target fraction (0, 1)")
    v.add_argument("--slo-availability-target", type=float, default=0.999,
                   help="availability SLO target fraction")
    v.add_argument("--no-slo", action="store_true", help="disable SLO tracking")
    v.add_argument("--trace-capacity", type=int, default=256,
                   help="flight-recorder bound for /debug/requests")
    v.add_argument("--tail-quantile", type=float, default=0.99,
                   help="tail-sampling threshold of ok requests")
    v.add_argument("--profile-dir", default=None,
                   help="directory for /debug/profile captures (default: a per-process "
                   "dir under the system temp dir)")
    v.add_argument("--no-quality", action="store_true",
                   help="disable model-quality drift monitoring")
    v.add_argument("--drift-warn-psi", type=float, default=0.1,
                   help="PSI at or above which drift status becomes 'warn'")
    v.add_argument("--drift-alert-psi", type=float, default=0.25,
                   help="PSI at or above which drift status becomes 'alert'")
    v.add_argument("--no-supervise", action="store_true",
                   help="run the engine bare: no watchdog, no circuit breaker, no restart")
    v.add_argument("--flush-deadline-s", type=float, default=20.0,
                   help="watchdog deadline per flushed compute")
    v.add_argument("--breaker-failures", type=int, default=3,
                   help="consecutive compute failures that open the circuit breaker")
    v.add_argument("--restart-backoff-s", type=float, default=0.5,
                   help="initial supervised-restart backoff (doubles per attempt)")
    v.add_argument("--restart-backoff-max-s", type=float, default=30.0,
                   help="supervised-restart backoff cap")
    v.add_argument("--inject", action="append", metavar="SPEC", default=None,
                   help="arm a faultpoint (repeatable): SITE:MODE[=ARG][@OPTS]; also "
                   "enables /debug/faults")
    v.add_argument("--fault-endpoint", action="store_true",
                   help="enable the guarded /debug/faults chaos endpoint")
    v.add_argument("--no-host-path", action="store_true",
                   help="disable the host fast path: every request goes through the "
                   "micro-batcher and the device engine")
    v.add_argument("--host-workers", type=int, default=1,
                   help="host fast-path worker threads")
    v.add_argument("--replica-id", default=None,
                   help="fleet identity echoed on every reply as X-Replica")
    v.add_argument("--admin-endpoint", action="store_true",
                   help="enable the guarded /admin/deploy warm-swap endpoint")
    v.add_argument("--verbose", action="store_true", help="log each request")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the PyTorch port.

    python -m machine_learning_replications_tpu_torch train \\
        [--develop MAT --select MAT | --synthetic N] [--missing-rate R] \\
        [--seed S] [--config JSON] [--save DIR] [--resume-dir DIR] \\
        [--plots DIR] [--trace-dir DIR] [--journal JSONL] [--device cpu|cuda] \\
        [--mesh DATA[,MODEL]|auto] [--distributed]
    python -m machine_learning_replications_tpu_torch predict \\
        [--model DIR | --pkl PICKLE] [--patient JSON] \\
        [--trace-dir DIR] [--journal JSONL] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch sweep \\
        [cohort flags as train] [--n-estimators M ...] [--max-depth D ...] \\
        [--folds K] [--save DIR] [--device cpu|cuda] [--mesh ...] [--distributed]
    python -m machine_learning_replications_tpu_torch import-sklearn \\
        --pkl PICKLE --out DIR [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch serve \\
        [--model DIR | --pkl PICKLE] [--host H] [--port P] [--buckets LADDER] \\
        [--workers N] [--register ROUTER_URL] [--advertise URL] \\
        [serving, resilience, alerting flags as the JAX CLI's] \\
        [--trace-dir DIR] [--journal JSONL] [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch fleet router|deploy|autoscale|status \\
        [the JAX CLI's fleet flags]
    python -m machine_learning_replications_tpu_torch score \\
        (--model DIR | --pkl PICKLE) --cohort JSONL|MAT --out DIR \\
        [--chunk-rows N] [--prefetch N] [--parse-workers N] [--parse-procs N] \\
        [the JAX CLI's other score flags] [--device cpu|cuda] [--mesh ...] [--distributed]
    python -m machine_learning_replications_tpu_torch learn run|retrain|shadow|promote|status \\
        --model DIR [--capture DIR] [--router URL] [--candidate DIR] \\
        [the JAX CLI's learn flags] [--device cpu|cuda]

``train`` is ``train_ensemble_public.py``: it fits the full pipeline
(impute → LassoCV top-17 → stacking ensemble → quality profile) on the
development cohort, scores the model-select cohort, prints the
classification report at threshold 0.5 and the ``AUC-ROC … average
precision …`` line, with ``--plots`` writes ``roc.png`` and ``pr.png``, and
with ``--save`` writes a port checkpoint. Without ``.mat`` paths the two
cohorts are the disjoint halves of ``make_cohort(2 · --synthetic)``.
``--resume-dir`` checkpoints every stage so a re-run with the same inputs
resumes.

``--mesh DATA[,MODEL]`` (or ``auto``: every rank on the data axis) runs
``train`` and ``sweep`` data-parallel over a mesh of ranks (``parallel/``),
one process per rank; ``--distributed`` first joins the process group from
torch's launcher variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``): NCCL where each rank has a card of its own, gloo
on the CPU or where ranks share a card. Every rank computes and prints its
report; only rank 0 writes ``--save``, ``--plots`` and ``--trace-dir``, and
rank k > 0 journals to ``<--journal>.rank<k>``, not into rank 0's file.

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
``--model`` or ``--pkl``. ``--workers N`` runs N ``SO_REUSEPORT`` workers on
one port, each a fresh interpreter with its own CUDA context (the parent
never touches the card); ``--register`` announces the replica to a fleet
router and deregisters it on SIGTERM. A checkpoint published with
``train --aot`` or ``import-sklearn --aot`` ships an AOT executable bundle
(``persist/aot.py``): ``serve`` restores every bucket from it instead of
capturing, unless ``--no-aot``.

``fleet router|deploy|autoscale|status`` are the JAX CLI's fleet tier: a
front-door router over registered replicas (retries, hedging, shedding,
the capture tap), rolling deploys through it, an autoscaler that spawns
and retires ``serve`` replicas of this package, and a status snapshot.
None of them imports torch or touches the card.

``score`` streams a cohort file (JSONL patient dicts or a reference-layout
``.mat``) through the overlapped ingest → device pipeline (``score/``) into
sharded, resumable output, as the JAX CLI's does; under ``--mesh`` every
rank reads and parses the cohort, each chunk's rows are scored sharded over
the ranks, and rank 0 alone writes ``--out``; ``--xla-intra-op-threads
N`` bounds torch's host threads (``torch.set_num_threads``). ``learn
retrain`` refits the live checkpoint's family on captured traffic into a
versioned candidate, ``learn shadow`` replays the capture through both and
prints the verdict, ``learn promote`` applies a verdict (publish and roll
out through the router, or park), ``learn run`` is the closed loop over
all three, and ``learn status`` reports the fleet's quality and capture.

``--trace-dir`` and ``--journal`` (``train``, ``predict``, ``serve``,
``score``, ``learn``; ``fleet router|autoscale`` journal only) write the run's
spans as a Chrome trace (``<dir>/trace.json``) and a JSONL journal (a
manifest first, then stage and checkpoint events, ``run_done`` last, with
the run's ``obs.torchmon`` totals). Every command that computes runs on the
card unless ``--device cpu`` is given; without CUDA it exits with an error
instead of moving to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np


def _device(args, command: str) -> torch.device:
    """``--device`` resolved, or exit naming the command (no CUDA). torch is
    imported here, not at the module's top: the fleet's router, autoscaler
    and status commands run without it."""
    from machine_learning_replications_tpu_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"{command}: {exc}")


def _bring_up(args) -> bool:
    """``--distributed``: join the process group before anything touches
    the card (a CUDA rank's card is set by the bring-up). True when this
    call brought a process group up."""
    if not getattr(args, "distributed", False):
        return False
    import torch.distributed as dist

    from machine_learning_replications_tpu_torch.parallel import distributed

    if dist.is_initialized():  # the caller's group: it is the caller's to end
        return False
    if distributed.initialize_distributed(device=args.device):
        return True
    print("distributed runtime unavailable (single host)", file=sys.stderr)
    return False


def _build_mesh(args, dev: torch.device):
    """``--mesh DATA[,MODEL]`` or ``auto`` → a mesh of the process group's
    ranks on ``dev`` (None without the flag), announced on stderr. A rank
    other than 0 leaves ``--save``, ``--plots``, ``--trace-dir`` and
    ``--metrics-out`` to rank 0 and journals to ``<--journal>.rank<k>``;
    every rank reads ``--resume-dir``, which rank 0 alone writes (as it
    alone writes ``score --out``)."""
    if not args.mesh:
        return None
    from machine_learning_replications_tpu_torch.parallel import make_mesh

    if args.mesh == "auto":
        parts = [None, 1]
    else:
        try:
            parts = [int(p) for p in args.mesh.split(",")]
        except ValueError:
            parts = []
        if len(parts) == 1:
            parts.append(1)
        if len(parts) != 2:
            raise SystemExit(f"--mesh expects DATA[,MODEL] or 'auto', got {args.mesh!r}")
    try:
        mesh = make_mesh(data=parts[0], model=parts[1], device=dev)
    except ValueError as exc:
        raise SystemExit(f"--mesh {args.mesh}: {exc}")
    print(f"mesh {mesh.shape}", file=sys.stderr)
    if mesh.rank != 0:
        for name in ("save", "plots", "trace_dir", "metrics_out"):
            if hasattr(args, name):
                setattr(args, name, None)
        if getattr(args, "journal", None):
            args.journal = f"{args.journal}.rank{mesh.rank}"
    return mesh


def _mesh_manifest(mesh) -> "dict | None":
    """The run journal's record of the mesh and the bring-up's backend choice."""
    if mesh is None:
        return None
    from machine_learning_replications_tpu_torch.parallel import distributed

    return {"mesh": dict(mesh.shape), "rank": mesh.rank,
            "distributed": dict(distributed.BRINGUP) or None}


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
def _observed(args, command: str, config_json: str | None = None,
              manifest_extra: dict | None = None):
    """The observability layer for one CLI run: ``obs.torchmon`` accounting
    into the global registry, an active tracer when ``--trace-dir`` is given
    (``trace.json`` written on exit), an active journal when ``--journal``
    is given (manifest first, then structured events, ``run_done`` with the
    torchmon totals or ``run_error`` last), and a root span named after the
    command, so every stage nests under it. The body may add fields to
    ``run_done`` through the dict it is given."""
    from machine_learning_replications_tpu_torch.obs import journal, spans, torchmon

    tracer = jrn = None
    if args.trace_dir or args.journal:
        torchmon.install()
    # Construct everything that can fail (the journal's open) before
    # touching the process-global slots: a failed setup must not leave a
    # stale global absorbing later spans in in-process callers.
    if args.journal:
        jrn = journal.RunJournal(args.journal, command=command, config_json=config_json,
                                 extra=manifest_extra)
    if args.trace_dir:
        tracer = spans.Tracer(process_name=f"mlr-torch {command}")
    if jrn is not None:
        journal.set_journal(jrn)
    if tracer is not None:
        spans.set_tracer(tracer)
    done: dict = {}
    try:
        with spans.span(command):
            yield done
    except BaseException as exc:
        if jrn is not None:
            jrn.event("run_error", error=f"{type(exc).__name__}: {exc}")
        raise
    else:
        if jrn is not None:
            jrn.event("run_done", **torchmon.totals(), **done)
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
    brought_up = _bring_up(args)
    try:
        dev = _device(args, "train")
        mesh = _build_mesh(args, dev)
        cfg = _config(args)
        with _observed(args, "train", config_json=cfg.to_json(),
                       manifest_extra=_mesh_manifest(mesh)) as done:
            rc = _run_train(args, cfg, dev, mesh)
            if dev.type == "cuda":
                import torch

                done["cuda_max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
            return rc
    finally:
        if brought_up:
            from machine_learning_replications_tpu_torch.parallel import distributed

            distributed.shutdown()


def _run_train(args, cfg, dev: torch.device, mesh=None) -> int:
    from machine_learning_replications_tpu_torch.device import to_host
    from machine_learning_replications_tpu_torch.models import pipeline
    from machine_learning_replications_tpu_torch.obs import spans
    from machine_learning_replications_tpu_torch.utils import metrics

    X_dev, y_dev = _load_cohort(args, "develop")
    X_sel, y_sel = _load_cohort(args, "select")
    with spans.span("fit_pipeline", rows=int(X_dev.shape[0])):
        params, info = pipeline.fit_pipeline(X_dev, y_dev, cfg, checkpoint_dir=args.resume_dir,
                                             mesh=mesh, device=dev)
    print(f"selected {info['n_selected']} features", file=sys.stderr)
    with spans.span("evaluate") as sp:
        p1 = sp.block(pipeline.pipeline_predict_proba1(params, X_sel, mesh=mesh, device=dev))
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

        checkpoint.save_model(args.save, params, aot=args.aot)
        print(f"model checkpointed to {args.save}"
              f"{' (with AOT executable bundle)' if args.aot else ''}", file=sys.stderr)
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


def _intra_op_threads(requested: int | None) -> int | None:
    """The JAX CLI's ``--xla-intra-op-threads`` policy for serving, applied
    to torch's host intra-op pool (``torch.set_num_threads``; the host path
    and the CPU engine run there): a host-sized default, ``min(4, cores/2)``
    with a floor of 1, so a flush's burst across every core does not starve
    the event loop; ``0`` leaves torch alone. Returns the count applied (the
    serve manifest journals it), or None."""
    if requested is not None and requested < 0:
        raise SystemExit("--xla-intra-op-threads must be >= 0")
    if requested == 0:
        return None
    import torch

    n = requested if requested else max(1, min(4, (os.cpu_count() or 2) // 2))
    torch.set_num_threads(n)
    return n


def cmd_serve(args) -> int:
    """Micro-batched HTTP inference serving (the JAX CLI's ``serve``)."""
    worker_id = args.worker_id
    if args.workers > 1 and args.admin_endpoint:
        # A deploy POST through the shared SO_REUSEPORT port would land
        # on ONE worker and leave the others on the old version — a
        # silently mixed-version replica. Multi-worker replicas deploy by
        # rolling restart.
        raise SystemExit(
            "--admin-endpoint is incompatible with --workers N: an "
            "in-place deploy would reach only one SO_REUSEPORT worker; "
            "deploy multi-worker replicas by rolling restart instead"
        )
    if args.workers > 1 and args.incident_dir:
        # N worker processes sharing one bundle directory would race the
        # timestamped dir names and each other's retention pruning.
        raise SystemExit(
            "--incident-dir is not supported with --workers > 1: the "
            "capture directory is single-writer (run one worker, or "
            "capture at the router)"
        )
    if args.workers > 1 and worker_id is None:
        # Before anything touches the card: the parent only supervises and
        # must own no CUDA context.
        return _run_multiworker(args)
    dev = _device(args, "serve")
    if not (args.model or args.pkl):
        from machine_learning_replications_tpu_torch.persist import sklearn_import

        raise SystemExit(f"serve: {sklearn_import.NO_DEFAULT_PKL}")
    threads = _intra_op_threads(args.xla_intra_op_threads)
    if threads is not None:
        print(f"torch intra-op threads: {threads} (override with "
              "--xla-intra-op-threads, 0 leaves torch alone)", file=sys.stderr)
    if worker_id is not None:
        if args.journal:
            args.journal = f"{args.journal}.w{worker_id}"
        if args.trace_dir:
            args.trace_dir = os.path.join(args.trace_dir, f"w{worker_id}")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # The knobs that shape serving behaviour, for the manifest's config
    # hash. The worker id is NOT part of it — all workers of one deployment
    # share a config hash; identity rides the manifest extra instead.
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
        "no_aot": args.no_aot,
        "replica_id": args.replica_id,
        "register": args.register,
        "admin_endpoint": args.admin_endpoint,
        "xla_intra_op_threads": threads,
        "history_interval_s": args.history_interval,
        "alert_rules": args.alert_rules,
        "no_alerts": args.no_alerts,
        "incident_dir": args.incident_dir,
        "device": str(dev),
    }, sort_keys=True)
    extra = {}
    if worker_id is not None:
        extra.update(worker=worker_id, workers=args.workers)
    if threads is not None:
        extra["xla_intra_op_threads"] = threads
    with _observed(args, "serve", config_json=serve_cfg, manifest_extra=extra or None) as done:
        rc = _run_serve(args, buckets, dev)
        if dev.type == "cuda":
            # This process's peak allocation on the card (parameters, the
            # graphs' memory pools, staging buffers), for sizing a fleet.
            import torch

            done["cuda_max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        return rc


def _run_multiworker(args) -> int:
    """``SO_REUSEPORT`` multi-worker serving: N workers, each a fresh
    interpreter running this same ``serve`` command with a private
    ``--worker-id K``, bind the same port; the kernel spreads connections
    across them. Each worker loads the checkpoint, creates its own CUDA
    context and captures its own graphs — the JAX CLI forks instead, which
    a process that initialised CUDA cannot do, so the parent here never
    touches the card. The parent only supervises: it forwards SIGTERM and
    SIGINT (each worker drains) and stops the rest if any worker dies
    unexpectedly, so a half-dead deployment never lingers. Per-worker
    journals get a ``.wK`` suffix and trace dirs a ``wK`` subdirectory;
    ``/metrics`` carries ``serve_worker_info{worker=K}``."""
    import signal
    import subprocess
    import time

    if args.port == 0:
        # Port 0 would give every worker a DIFFERENT ephemeral port;
        # SO_REUSEPORT sharding needs one concrete shared port.
        raise SystemExit("--workers requires a fixed --port (not 0): "
                         "all workers bind the same SO_REUSEPORT port")
    # The workers import this very package, wherever the parent was started.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    children = [
        subprocess.Popen(
            [sys.executable, "-m", "machine_learning_replications_tpu_torch", *args.argv,
             "--worker-id", str(k)],
            env=env, preexec_fn=_term_with_parent,
        )
        for k in range(args.workers)
    ]
    print(
        f"serving with {args.workers} SO_REUSEPORT workers on port "
        f"{args.port} (pids {[c.pid for c in children]})",
        file=sys.stderr, flush=True,
    )
    shutting_down = False

    def _forward(signum, frame):
        nonlocal shutting_down
        shutting_down = True
        for c in children:
            if c.poll() is None:
                c.send_signal(signal.SIGTERM)

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)
    rc = 0
    alive = set(children)
    while alive:
        for c in list(alive):
            code = c.poll()
            if code is None:
                continue
            alive.discard(c)
            code = code if code >= 0 else 128 - code
            rc = max(rc, code)
            if code != 0 and not shutting_down and alive:
                # One worker died outside a deliberate shutdown: take the
                # rest down too — a silently shrunken replica would serve at
                # reduced capacity while looking healthy from the port.
                print(f"worker pid {c.pid} exited {code}; stopping the fleet",
                      file=sys.stderr)
                _forward(None, None)
        time.sleep(0.05)
    return rc


def _term_with_parent() -> None:
    """In a worker, before it runs: ask Linux to SIGTERM it when the parent
    dies, so a parent killed outright (SIGKILL) leaves no worker holding
    the port and the card. Elsewhere a no-op."""
    if not sys.platform.startswith("linux"):
        return
    import ctypes
    import signal

    PR_SET_PDEATHSIG = 1
    prctl = ctypes.CDLL(None, use_errno=True).prctl
    prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    prctl.restype = ctypes.c_int
    prctl(PR_SET_PDEATHSIG, int(signal.SIGTERM), 0, 0, 0)


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
    # The AOT bundle comes from that same directory, so a rollback restores
    # the last-known-good's packages, never the corrupt target's.
    model_version = None
    aot_bundle = None
    try:
        if args.model:
            from machine_learning_replications_tpu_torch.persist import checkpoint

            params, info = checkpoint.load_model_versioned(args.model, device=dev)
            model_version = info["version"]
            if not args.no_aot:
                # Published packages: warmup restores instead of capturing.
                # A checkpoint without a bundle serves exactly as before.
                from machine_learning_replications_tpu_torch.persist import aot

                aot_bundle = aot.load_bundle(info["path"])
        else:
            params = load_inference_params(pkl=args.pkl, device=dev)
    except FileNotFoundError as exc:
        raise SystemExit(f"serve: {exc}")
    replica_id = args.replica_id
    worker_id = args.worker_id
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
        # Multi-worker mode: every worker binds the same port with
        # SO_REUSEPORT; the kernel spreads connections across them.
        reuse_port=args.workers > 1,
        worker_id=worker_id,
        host_path=not args.no_host_path,
        host_workers=args.host_workers,
        model_version=model_version,
        replica_id=replica_id,
        admin_endpoint=args.admin_endpoint,
        history_interval_s=args.history_interval,
        alert_rules=(
            _load_alert_rules(args.alert_rules) if args.alert_rules else None
        ),
        alerts_enabled=not args.no_alerts,
        incident_dir=args.incident_dir,
        incident_min_interval_s=args.incident_min_interval,
        incident_retention=args.incident_retention,
        aot_bundle=aot_bundle,
        use_aot=not args.no_aot,
        device=dev,
    )
    # The warm startup heap (torch, the parameters, the captured graphs)
    # is permanent: freeze it out of the collector once, after warmup.
    gc.collect()
    gc.freeze()
    host, port = handle.address
    if replica_id is None and (args.register or args.advertise):
        # Default id from the BOUND address, not args.port: with --port 0
        # every replica would otherwise register as HOST:0 — same id,
        # different urls — and each one's heartbeat would replace the
        # other in the registry forever.
        replica_id = f"{host}:{port}"
        handle.replica_id = replica_id
    print(
        f"serving {type(params).__name__} on http://{host}:{port} "
        f"(device {dev}, buckets {buckets}, max_wait {args.max_wait_ms}ms, "
        f"queue bound {args.max_queue}"
        + (f", worker {worker_id}/{args.workers}" if worker_id is not None else "")
        + ")",
        file=sys.stderr, flush=True,
    )
    # Fleet registration: announce this replica to the front-door router
    # (POST /fleet/replicas) on a background thread that retries until the
    # router answers — replicas and router may start in any order. A
    # multi-worker replica registers once (worker 0): the SO_REUSEPORT
    # workers share one port and are one logical replica.
    advertise = args.advertise or f"http://{host}:{port}"
    registers = bool(args.register) and worker_id in (None, 0)
    if registers:
        threading.Thread(
            target=_register_loop, args=(handle, args.register, replica_id, advertise),
            name="serve-register", daemon=True,
        ).start()

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
        if registers:
            # Best-effort deregistration: a drained replica should leave
            # the rotation table instead of waiting out probe failures.
            try:
                _post_json(args.register.rstrip("/") + "/fleet/replicas",
                           {"deregister": replica_id})
            except Exception:
                pass
    return 0


def _post_json(url: str, body: dict, timeout: float = 5.0) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _register_loop(handle, router: str, replica_id: str, advertise: str) -> None:
    """The registration heartbeat, not a one-shot: registration is
    idempotent (same id + url keeps the router's rotation state), so
    re-posting every beat means a RESTARTED router — whose in-memory
    registry came up empty — repopulates within one interval. Journals
    ``replica_registered`` each time registration (re)succeeds."""
    import time

    from machine_learning_replications_tpu_torch.obs import journal

    url = router.rstrip("/") + "/fleet/replicas"
    registered = False
    while not handle.draining:
        try:
            _post_json(url, {"id": replica_id, "url": advertise})
        except Exception:
            registered = False
            time.sleep(1.0)
            continue
        if not registered:
            registered = True
            journal.event("replica_registered", router=router, replica=replica_id,
                          url=advertise)
            print(f"registered with router {router} as {replica_id!r} ({advertise})",
                  file=sys.stderr, flush=True)
        time.sleep(10.0)


def cmd_sweep(args) -> int:
    brought_up = _bring_up(args)
    try:
        dev = _device(args, "sweep")
        return _run_sweep(args, dev, _build_mesh(args, dev))
    finally:
        if brought_up:
            from machine_learning_replications_tpu_torch.parallel import distributed

            distributed.shutdown()


def _run_sweep(args, dev: torch.device, mesh) -> int:
    from machine_learning_replications_tpu_torch.config import SweepConfig
    from machine_learning_replications_tpu_torch.data import selected_indices
    from machine_learning_replications_tpu_torch.device import to_host
    from machine_learning_replications_tpu_torch.models import knn_impute, sweep

    X64, y = _load_cohort(args, "develop")
    if np.isnan(X64).any():
        _, X64 = knn_impute.fit_transform(X64, mesh=mesh, device=dev)
        X64 = to_host(X64)
    X = X64[:, selected_indices()]
    cfg = SweepConfig(
        n_estimators_grid=tuple(args.n_estimators),
        max_depth_grid=tuple(args.max_depth),
        cv_folds=args.folds,
    )
    res = sweep.cv_sweep(X, y, cfg, mesh=mesh, device=dev)
    print(f"{'depth':>6} " + " ".join(f"m={m:>5d}" for m in res.n_estimators_grid))
    for di, d in enumerate(res.max_depth_grid):
        print(f"{d:>6} " + " ".join(f"{a:7.4f}" for a in res.mean_auc[di]))
    print(f"best: n_estimators={res.best_n_estimators} "
          f"max_depth={res.best_max_depth} mean AUC={res.best_mean_auc:.4f}")
    if args.save:
        from machine_learning_replications_tpu_torch.persist import checkpoint

        params, _ = sweep.refit_best(X, y, res, mesh=mesh, device=dev)
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
    checkpoint.save_model(args.out, params, aot=args.aot)
    print(f"imported {args.pkl} -> {args.out}"
          + (" (with AOT executable bundle)" if args.aot else ""))
    return 0


def cmd_score(args) -> int:
    """Population-scale bulk scoring: stream a cohort file through the
    overlapped ingest → device pipeline into sharded, resumable output.
    Under ``--mesh`` every rank reads and parses the cohort and scores each
    chunk's rows sharded over the ranks; rank 0 alone writes ``--out``."""
    brought_up = _bring_up(args)
    try:
        dev = _device(args, "score")
        return _score(args, dev, _build_mesh(args, dev))
    finally:
        if brought_up:
            from machine_learning_replications_tpu_torch.parallel import distributed

            distributed.shutdown()


def _score(args, dev: torch.device, mesh) -> int:
    if args.xla_intra_op_threads is not None and args.xla_intra_op_threads < 0:
        raise SystemExit("--xla-intra-op-threads must be >= 0")
    if args.xla_intra_op_threads:
        # The JAX CLI bounds XLA's CPU pool; the port's host-side math
        # (parse, impute prep, the CPU engine) runs on torch's intra-op pool.
        import torch

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
    with _observed(args, "score", config_json=score_cfg, manifest_extra=_mesh_manifest(mesh)):
        return _run_score(args, dev, mesh)


def _run_score(args, dev: torch.device, mesh=None) -> int:
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
        mesh=mesh,
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
    if mesh is not None and mesh.rank != 0:
        print(f"output: written by rank 0 (sha256 {summary['output_sha256'][:16]}…)",
              file=sys.stderr)
    else:
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


def cmd_fleet(args) -> int:
    """Fleet tier: front-door router, rolling deploys, the autoscaler
    daemon, and fleet status — the `cli fleet ROLE` entry points, as the
    JAX CLI's. None imports torch or touches the card: a router or
    autoscaler process needs no accelerator stack (the replicas it spawns
    pay that cost in their own processes), and the router's ``--workers``
    may fork freely."""
    if args.role == "router":
        return _run_fleet_router(args)
    if args.role == "deploy":
        return _run_fleet_deploy(args)
    if args.role == "autoscale":
        return _run_fleet_autoscale(args)
    return _run_fleet_status(args)


def _run_fleet_router(args) -> int:
    import signal
    import threading

    from machine_learning_replications_tpu_torch.fleet import make_router
    from machine_learning_replications_tpu_torch.obs import journal

    replicas = []
    for spec in args.replica or []:
        rid, sep, url = spec.partition("=")
        if not sep or not rid or not url:
            raise SystemExit(
                f"--replica expects ID=URL, got {spec!r}"
            )
        replicas.append((rid, url))
    worker_id = getattr(args, "_worker_id", None)
    if args.workers > 1 and worker_id is None:
        return _run_router_multiworker(args)
    jrn = None
    if args.journal:
        # Deliberately not _observed: that path installs the torch
        # accounting, and the router must stay torch-free.
        jrn = journal.RunJournal(args.journal, command="fleet router")
        journal.set_journal(jrn)
    handle = make_router(
        host=args.host,
        port=args.port,
        replicas=replicas,
        request_timeout_s=args.request_timeout,
        hedge_ms=args.hedge_ms,
        max_attempts=args.max_attempts,
        probe_interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        fail_threshold=args.fail_threshold,
        recover_probes=args.recover_probes,
        breaker_failures=args.breaker_failures,
        reuse_port=args.workers > 1,
        quiet=not args.verbose,
        capture_dir=args.capture,
        capture_rows_per_shard=args.capture_rows_per_shard,
        capture_max_shards=args.capture_max_shards,
        history_interval_s=args.history_interval,
        alert_rules=(
            _load_alert_rules(args.alert_rules) if args.alert_rules
            else None
        ),
        alerts_enabled=not args.no_alerts,
        incident_dir=args.incident_dir,
        incident_min_interval_s=args.incident_min_interval,
        incident_retention=args.incident_retention,
    )
    host, port = handle.address
    who = f" (worker {worker_id})" if worker_id is not None else ""
    print(
        f"fleet router on http://{host}:{port}{who} "
        f"({len(replicas)} static replicas; POST /fleet/replicas to "
        "register more)",
        file=sys.stderr,
    )

    def _graceful(signum, frame):
        print("router shutting down ...", file=sys.stderr)
        threading.Thread(target=handle.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        handle.serve_forever()
    finally:
        handle.shutdown()
        if jrn is not None:
            journal.set_journal(None)
            jrn.close()
            print(f"journal written to {jrn.path}", file=sys.stderr)
    return 0


def _run_router_multiworker(args) -> int:
    """Pre-fork ``SO_REUSEPORT`` multi-worker routing for many-core
    hosts: N router processes each run their own loop (listener AND
    upstream pool) on one shared port; the kernel spreads inbound
    connections across them. Each worker keeps its own registry — the
    replicas' periodic registration heartbeats (fresh connection per
    beat, so the kernel rotates them across workers) converge every
    worker's membership within a few beats, and static ``--replica``
    seeds apply to all workers at fork. The parent only supervises,
    exactly like ``cli serve --workers``."""
    import signal

    if args.port == 0:
        raise SystemExit("--workers requires a fixed --port (not 0): "
                         "all workers bind the same SO_REUSEPORT port")
    if args.capture:
        # N workers appending to one rotating shard window would
        # interleave rotations and tear the capture contract; the tap
        # stays a single-worker feature.
        raise SystemExit("--capture is not supported with --workers > 1 "
                         "(run a single-worker capture router)")
    if args.incident_dir:
        # Same single-writer contract as --capture: timestamped bundle
        # dirs and retention pruning from N processes would race.
        raise SystemExit("--incident-dir is not supported with "
                         "--workers > 1 (run a single-worker alerting "
                         "router)")
    children: list[int] = []
    for k in range(args.workers):
        pid = os.fork()
        if pid == 0:
            rc = 1
            try:
                args._worker_id = k
                if args.journal:
                    args.journal = f"{args.journal}.w{k}"
                rc = _run_fleet_router(args)
            except SystemExit as exc:
                rc = exc.code if isinstance(exc.code, int) else 1
            except BaseException:
                import traceback

                traceback.print_exc()
                rc = 1
            finally:
                os._exit(rc or 0)
        children.append(pid)
    print(
        f"fleet router with {args.workers} SO_REUSEPORT workers on port "
        f"{args.port} (pids {children})",
        file=sys.stderr,
    )
    shutting_down = False

    def _forward(signum, frame):
        nonlocal shutting_down
        shutting_down = True
        for pid in children:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)
    rc = 0
    alive = set(children)
    while alive:
        try:
            pid, status = os.waitpid(-1, 0)
        except InterruptedError:
            continue
        except ChildProcessError:
            break
        if pid not in alive:
            continue
        alive.discard(pid)
        code = (
            os.WEXITSTATUS(status) if os.WIFEXITED(status)
            else 128 + os.WTERMSIG(status)
        )
        rc = max(rc, code)
        if code != 0 and not shutting_down and alive:
            print(
                f"router worker pid {pid} exited {code}; stopping the "
                "rest", file=sys.stderr,
            )
            _forward(None, None)
    return rc


def _run_fleet_autoscale(args) -> int:
    """The elastic-fleet daemon: watch the router's load signals,
    spawn/retire local replica processes (``cli serve`` of this package)
    through the drain-first lifecycle manager, replace crashed ones.
    torch-free — the spawned replicas bring their own accelerator stack."""
    import signal
    import threading
    import time

    from machine_learning_replications_tpu_torch.fleet.autoscale import (
        AutoscaleDaemon,
        AutoscalePolicy,
        AutoscaleThresholds,
    )
    from machine_learning_replications_tpu_torch.fleet.lifecycle import (
        LifecycleManager,
        ReplicaSpec,
        RouterClient,
    )
    from machine_learning_replications_tpu_torch.obs import journal
    from machine_learning_replications_tpu_torch.resilience import faults

    for spec_text in args.inject or []:
        try:
            armed = faults.arm(spec_text)
        except ValueError as exc:
            raise SystemExit(f"--inject: {exc}")
        print(f"fault armed: {armed.describe()}", file=sys.stderr)
    jrn = None
    if args.journal:
        # Not _observed: the autoscaler must stay torch-free (the
        # router's reasoning — no torch accounting in this process).
        jrn = journal.RunJournal(args.journal, command="fleet autoscale")
        journal.set_journal(jrn)
    say = lambda m: print(f"autoscale: {m}", file=sys.stderr)  # noqa: E731
    spec = ReplicaSpec(
        model=args.model,
        register_url=args.router,
        host=args.replica_host,
        serve_args=tuple(args.serve_arg or []),
        journal_dir=args.replica_journal_dir,
        no_aot=args.no_aot,
    )
    try:
        manager = LifecycleManager(
            spec,
            RouterClient(args.router),
            min_replicas=args.min,
            max_replicas=args.max,
            ready_deadline_s=args.ready_deadline,
            drain_settle_s=args.drain_settle,
            term_deadline_s=args.term_deadline,
            respawn_backoff_s=args.respawn_backoff,
            respawn_backoff_max_s=args.respawn_backoff_max,
            say=say,
        )
        policy = AutoscalePolicy(
            thresholds=AutoscaleThresholds(
                out_queue_depth=args.out_queue_depth,
                out_latency_ms=args.out_latency_ms,
                out_shed_rate=args.out_shed_rate,
                out_burn_rate=args.out_burn_rate,
                in_queue_depth=args.in_queue_depth,
                in_latency_ms=args.in_latency_ms,
                in_shed_rate=args.in_shed_rate,
                in_burn_rate=args.in_burn_rate,
                out_alerts_active=args.out_alerts_active,
                in_alerts_active=args.in_alerts_active,
            ),
            min_replicas=args.min,
            max_replicas=args.max,
            breach_polls=args.breach_polls,
            idle_polls=args.idle_polls,
            cooldown_s=args.cooldown,
            step=args.step,
        )
    except ValueError as exc:
        # Bad bounds/thresholds are operator input, not a crash.
        raise SystemExit(f"fleet autoscale: {exc}")
    daemon = AutoscaleDaemon(
        args.router, manager, policy,
        poll_interval_s=args.poll_interval, say=say,
    )
    manager.scale_to(args.min)
    print(
        f"autoscaling {args.min}..{args.max} replicas of {args.model} "
        f"behind {args.router} (poll every {args.poll_interval:g}s)",
        file=sys.stderr,
    )
    stop = {"now": False}

    def _stop(signum, frame):
        stop["now"] = True
        print("autoscale: stopping after the current tick ...",
              file=sys.stderr)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        daemon.run(stop_check=lambda: stop["now"],
                   max_ticks=args.max_ticks)
    finally:
        if args.leave_running:
            print(
                "autoscale: leaving managed replicas running "
                "(--leave-running)", file=sys.stderr,
            )
        else:
            # Default teardown takes the managed fleet down with the
            # daemon: orphaned children would keep serving unmanaged —
            # alive but outside every control loop this command exists
            # to provide.
            closer = threading.Thread(target=manager.close, daemon=True)
            closer.start()
            closer.join(timeout=args.term_deadline + args.drain_settle + 5)
        if args.metrics_out:
            from machine_learning_replications_tpu_torch.obs.registry import (
                REGISTRY,
            )

            with open(args.metrics_out, "w") as f:
                f.write(REGISTRY.render_prometheus())
            print(f"metrics written to {args.metrics_out}",
                  file=sys.stderr)
        if jrn is not None:
            journal.set_journal(None)
            jrn.close()
            print(f"journal written to {jrn.path}", file=sys.stderr)
    return 0


def _run_fleet_deploy(args) -> int:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        args.router.rstrip("/") + "/fleet/deploy",
        data=json.dumps({"model": args.model}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            report = json.loads(resp.read())["deploy"]
    except urllib.error.HTTPError as exc:
        body = exc.read()
        try:
            payload = json.loads(body)
        except ValueError:
            payload = None
        if not isinstance(payload, dict):
            raise SystemExit(
                f"deploy request failed (http {exc.code}): "
                f"{body[:200]!r}"
            )
        if exc.code == 409:
            # Single-flight refusal: the "deploy" in this body is the
            # OTHER rollout's live status (result "ok" from the moment
            # it starts) — treating it as ours would print success for
            # a deploy that never began.
            raise SystemExit(
                "deploy refused: a rolling deploy is already in "
                "progress — watch it with `fleet status`:\n"
                + json.dumps(payload.get("deploy"), indent=1)
            )
        report = payload.get("deploy")
        if not isinstance(report, dict):
            raise SystemExit(
                f"deploy request failed (http {exc.code}): "
                f"{body[:200]!r}"
            )
    except (urllib.error.URLError, OSError) as exc:
        # Unreachable router / reset / client-side timeout: a clean exit
        # beats a traceback. NOTE a timed-out POST does not stop the
        # rollout server-side — `fleet status` shows where it got to.
        raise SystemExit(
            f"deploy request to {args.router} failed: {exc} "
            "(the rollout may still be running; check `fleet status`)"
        )
    print(json.dumps(report, indent=1))
    if report.get("result") != "ok":
        print(
            f"rollout {report.get('result')}: "
            f"{report.get('error', 'no detail')}",
            file=sys.stderr,
        )
        return 1
    print(
        f"rollout ok: version {report.get('target_version')} on "
        f"{len(report.get('replicas', []))} replicas",
        file=sys.stderr,
    )
    return 0


def _run_fleet_status(args) -> int:
    import urllib.error
    import urllib.request

    base = args.router.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(
            base + "/fleet/replicas", timeout=10
        ) as resp:
            replicas = json.loads(resp.read())["replicas"]
    except (urllib.error.URLError, OSError) as exc:
        raise SystemExit(f"fleet status request to {args.router} failed: {exc}")
    print(json.dumps({"router": health, "replicas": replicas}, indent=1))
    return 0


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
    """Continual learning: drift-triggered retraining, shadow evaluation
    and guarded promotion — the `cli learn ROLE` entry points, as the JAX
    CLI's. ``status`` imports no torch (it only asks the router and its
    replicas); ``promote`` republishes a checkpoint (with its AOT bundle,
    compiled on ``--device``, unless ``--no-aot``) and drives the router;
    ``run``, ``retrain`` and ``shadow`` fit and replay on ``--device``."""
    if args.role == "status":
        return _run_learn_status(args)
    dev = None if args.role == "promote" else _device(args, f"learn {args.role}")
    cfg = _config(args) if getattr(args, "config", None) else None
    learn_cfg = json.dumps({
        "role": args.role,
        "model": args.model,
        "capture": getattr(args, "capture", None),
        "candidate": args.candidate,
        "router": getattr(args, "router", None),
        "device": None if dev is None else str(dev),
    }, sort_keys=True)
    with _observed(args, f"learn {args.role}", config_json=learn_cfg):
        if args.role == "run":
            return _run_learn_loop(args, cfg, dev)
        if args.role == "retrain":
            return _run_learn_retrain(args, cfg, dev)
        if args.role == "shadow":
            return _run_learn_shadow(args, dev)
        return _run_learn_promote(args)


def _run_learn_loop(args, cfg, dev: torch.device) -> int:
    import signal

    from machine_learning_replications_tpu_torch.learn.loop import LearnLoop
    from machine_learning_replications_tpu_torch.learn.trigger import TriggerPolicy

    loop = LearnLoop(
        model_path=args.model,
        capture_dir=args.capture,
        candidate_dir=args.candidate or _candidate_default(args.model),
        router_url=args.router,
        policy=TriggerPolicy(
            alert_streak=args.alert_streak,
            cooldown_s=args.cooldown,
            schedule_s=args.schedule,
        ),
        cfg=cfg,
        thresholds=_learn_thresholds(args),
        poll_interval_s=args.poll_interval,
        max_rows=args.rows,
        min_rows=args.min_rows,
        recovery_timeout_s=args.recovery_timeout,
        settle_timeout_s=args.settle_timeout,
        say=lambda m: print(f"learn: {m}", file=sys.stderr, flush=True),
        device=dev,
    )
    stop = {"now": False}

    def _stop(signum, frame):
        stop["now"] = True
        print("learn: stopping after the current poll ...", file=sys.stderr)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    cycles = loop.run(max_cycles=args.max_cycles, stop_check=lambda: stop["now"])
    print(json.dumps({"cycles": cycles}, indent=1, default=str))
    if args.max_cycles and len(cycles) < args.max_cycles:
        return 1  # interrupted before the demanded cycles completed
    bad = [c for c in cycles if c["outcome"] in ("failed",)]
    return 1 if bad else 0


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


def _run_learn_promote(args) -> int:
    from machine_learning_replications_tpu_torch.learn import promote as promod

    candidate_dir = args.candidate or _candidate_default(args.model)
    if not args.verdict:
        raise SystemExit(
            "learn promote: pass --verdict VERDICT.json (from `learn "
            "shadow --out`) — promotion without a shadow verdict is "
            "exactly the unguarded swap this gate exists to prevent"
        )
    with open(args.verdict) as f:
        verdict = json.load(f)
    # The bundle is compiled where the replicas serve; a plain republish
    # needs no card.
    dev = None if args.no_aot else _device(args, "learn promote")
    result = promod.promote(
        candidate_dir, args.model, args.router, verdict,
        deploy_timeout_s=args.timeout, aot=not args.no_aot, device=dev,
    )
    print(json.dumps(result, indent=1))
    return 0 if result["result"] == "promoted" else 1


def _run_learn_status(args) -> int:
    import urllib.error
    import urllib.request

    from machine_learning_replications_tpu_torch.learn.trigger import (
        poll_quality,
        replica_urls,
    )

    base = args.router.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        urls = replica_urls(args.router)
    except (urllib.error.URLError, OSError) as exc:
        raise SystemExit(f"learn status request to {args.router} failed: {exc}")
    status = {
        "router": health,
        "capture": health.get("capture"),
        "replicas": {url: poll_quality(url) for url in urls},
    }
    if args.candidate:
        from machine_learning_replications_tpu_torch.fleet.deploy import manifest_version
        from machine_learning_replications_tpu_torch.learn.promote import (
            REFUSED_FILE,
            is_parked,
        )

        cand = os.path.abspath(args.candidate)
        status["candidate"] = {
            "path": cand,
            "exists": os.path.isdir(cand),
            "version": manifest_version(cand),
            "parked": is_parked(cand),
            "refused_file": os.path.join(cand, REFUSED_FILE) if is_parked(cand) else None,
        }
    print(json.dumps(status, indent=1))
    return 0


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

    def add_mesh_flags(p, what: str):
        p.add_argument(
            "--mesh", default=None,
            help="device-mesh shape DATA[,MODEL] (e.g. 8 or 4,2) or 'auto' "
            f"(all ranks on the data axis); {what}")
        p.add_argument(
            "--distributed", action="store_true",
            help="join the torch.distributed process group (torch's launcher "
            "variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) "
            "before building the mesh: NCCL when each rank has a card of its own, "
            "gloo on the CPU or when ranks share a card")

    def add_device_flag(p):
        p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                       help="where to run (default: the card; without CUDA this is an error)")

    t = sub.add_parser("train", help="fit the full pipeline and evaluate it")
    add_cohort_flags(t)
    t.add_argument("--save", help="port checkpoint directory to write")
    t.add_argument("--aot", action="store_true",
                   help="export the AOT executable bundle into --save (persist/aot.py): "
                   "pays the serving ladder's compile bill once at publish so every "
                   "replica restores executables instead of tracing at warmup")
    t.add_argument("--plots", help="directory for roc.png / pr.png")
    t.add_argument("--resume-dir", default=None,
                   help="stage-checkpoint directory: each pipeline stage is published on "
                   "completion, so a re-run with the same data and config resumes (the "
                   "directory is fingerprinted against its inputs)")
    add_mesh_flags(t, "routes the GBDT member through the row-sharded trainers")
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
    add_mesh_flags(s, "each (depth, fold) fit and the best-cell refit run row-sharded "
                   "(fold masks ride the trainers' weight path)")
    add_device_flag(s)
    s.set_defaults(fn=cmd_sweep)

    i = sub.add_parser("import-sklearn", help="legacy sklearn pickle → port checkpoint")
    i.add_argument("--pkl", help="pickle path (no default; the reference's "
                   "hf_predict_model.pkl lies outside the checkout)")
    i.add_argument("--out", required=True, help="port checkpoint directory")
    i.add_argument("--aot", action="store_true",
                   help="also export the AOT executable bundle into the checkpoint "
                   "(persist/aot.py): replicas serving it restore per-bucket "
                   "executables instead of compiling at warmup")
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

    add_fleet_parser(sub, add_alerting_flags)
    add_learn_parser(sub, add_obs_flags, add_device_flag)
    add_score_parser(sub, add_obs_flags, add_device_flag, add_mesh_flags)
    return ap


def add_fleet_parser(sub, add_alerting_flags) -> None:
    """The JAX CLI's whole ``fleet`` parser (no ``--device``: no fleet role
    touches the card)."""
    f = sub.add_parser(
        "fleet",
        help="fleet tier: front-door router, rolling deploys, the autoscaler, "
        "status (none of them touches the card)",
    )
    fsub = f.add_subparsers(dest="role", required=True)
    fr = fsub.add_parser(
        "router",
        help="run the front-door router: replica registry, /readyz-driven "
        "rotation, retry/hedging, /fleet control plane",
    )
    fr.add_argument("--host", default="127.0.0.1")
    fr.add_argument("--port", type=int, default=8080)
    fr.add_argument(
        "--replica", action="append", metavar="ID=URL", default=None,
        help="seed the registry with a static replica (repeatable); "
        "replicas may also self-register via `cli serve --register`",
    )
    fr.add_argument(
        "--request-timeout", type=float, default=30.0,
        help="router-side reply deadline per request (seconds); an "
        "inbound X-Request-Deadline-Ms tightens it, never loosens",
    )
    fr.add_argument(
        "--hedge-ms", type=float, default=250.0,
        help="fire a duplicate attempt against a second replica when the "
        "first has not answered within this delay (0 disables hedging)",
    )
    fr.add_argument(
        "--max-attempts", type=int, default=3,
        help="upstream attempts per request (first + retries/hedges)",
    )
    fr.add_argument(
        "--probe-interval", type=float, default=0.5,
        help="seconds between /readyz probe passes",
    )
    fr.add_argument(
        "--probe-timeout", type=float, default=2.0,
        help="per-probe HTTP timeout",
    )
    fr.add_argument(
        "--fail-threshold", type=int, default=2,
        help="consecutive failed probes before rotation out (an explicit "
        "not-ready rotates out on the first probe)",
    )
    fr.add_argument(
        "--recover-probes", type=int, default=2,
        help="consecutive ready probes before an out replica re-enters "
        "rotation",
    )
    fr.add_argument(
        "--breaker-failures", type=int, default=3,
        help="consecutive request failures that open a replica's breaker "
        "(immediate rotation out; probes close it)",
    )
    fr.add_argument(
        "--workers", type=int, default=1,
        help="pre-fork N SO_REUSEPORT router processes on the shared "
        "--port for many-core hosts; each worker owns its own event "
        "loop (listener + upstream pool) and registry, converging "
        "membership through the replicas' registration heartbeats",
    )
    fr.add_argument(
        "--journal", default=None,
        help="JSONL journal path (registration, rotation, deploy arc)",
    )
    fr.add_argument(
        "--capture", default=None, metavar="DIR",
        help="continual-learning cohort tap: append "
        "every served /predict body to a bounded rotating JSONL window "
        "in DIR — the `cli learn` retrain's data source",
    )
    fr.add_argument(
        "--capture-rows-per-shard", type=int, default=4096,
        help="capture shard rotation size (rows)",
    )
    fr.add_argument(
        "--capture-max-shards", type=int, default=8,
        help="capture shards retained (older ones are unlinked; the "
        "window is ~rows-per-shard x max-shards recent rows)",
    )
    add_alerting_flags(fr, "router")
    fr.add_argument("--verbose", action="store_true")
    fr.set_defaults(fn=cmd_fleet)
    fd = fsub.add_parser(
        "deploy",
        help="rolling deploy: drive a new checkpoint version across the "
        "fleet through the router, one replica at a time",
    )
    fd.add_argument("--router", required=True, help="router base URL")
    fd.add_argument(
        "--model", required=True,
        help="checkpoint directory (every replica must be able to read "
        "this path)",
    )
    fd.add_argument(
        "--timeout", type=float, default=1800.0,
        help="end-to-end rollout timeout (seconds)",
    )
    fd.set_defaults(fn=cmd_fleet)
    fa = fsub.add_parser(
        "autoscale",
        help="elastic-fleet daemon: watch the router's load signals and "
        "grow/shrink local replica processes with drain-first "
        "retirement and crash replacement",
    )
    fa.add_argument("--router", required=True, help="router base URL")
    fa.add_argument(
        "--model", required=True,
        help="checkpoint directory every spawned replica serves",
    )
    fa.add_argument(
        "--min", type=int, default=1,
        help="minimum replica count (the daemon spawns up to this at "
        "start and never retires below it)",
    )
    fa.add_argument(
        "--max", type=int, default=4,
        help="maximum replica count (scale-out stops here no matter the "
        "load)",
    )
    fa.add_argument(
        "--step", type=int, default=1,
        help="replicas added/removed per scale decision",
    )
    fa.add_argument(
        "--poll-interval", type=float, default=1.0,
        help="seconds between signal polls",
    )
    fa.add_argument(
        "--breach-polls", type=int, default=3,
        help="consecutive breaching polls before a scale-out fires "
        "(debounce)",
    )
    fa.add_argument(
        "--idle-polls", type=int, default=10,
        help="consecutive all-quiet polls before a scale-in fires",
    )
    fa.add_argument(
        "--cooldown", type=float, default=30.0,
        help="seconds after any scale action before the next may fire "
        "(both directions — flapping load cannot thrash the fleet)",
    )
    fa.add_argument(
        "--out-queue-depth", type=float, default=8.0,
        help="scale-out when any replica's /healthz queue depth reaches "
        "this (sustained --breach-polls)",
    )
    fa.add_argument(
        "--out-latency-ms", type=float, default=250.0,
        help="scale-out when the router's recent mean /predict latency "
        "reaches this",
    )
    fa.add_argument(
        "--out-shed-rate", type=float, default=0.02,
        help="scale-out when the router's recent shed fraction reaches "
        "this",
    )
    fa.add_argument(
        "--out-burn-rate", type=float, default=4.0,
        help="scale-out when any replica's worst SLO burn rate reaches "
        "this",
    )
    fa.add_argument(
        "--in-queue-depth", type=float, default=1.0,
        help="scale-in requires every replica queue depth at or under "
        "this (and every other signal under its twin) for --idle-polls",
    )
    fa.add_argument("--in-latency-ms", type=float, default=50.0)
    fa.add_argument("--in-shed-rate", type=float, default=0.0)
    fa.add_argument("--in-burn-rate", type=float, default=1.0)
    fa.add_argument(
        "--out-alerts-active", type=float, default=None,
        help="scale-out when this many router alert rules are firing "
        "(/fleet/alerts; default None keeps the alert plane out of the "
        "control loop — the reading is journaled either way)",
    )
    fa.add_argument(
        "--in-alerts-active", type=float, default=None,
        help="scale-in twin of --out-alerts-active (None: firing "
        "alerts never block a scale-in)",
    )
    fa.add_argument(
        "--ready-deadline", type=float, default=300.0,
        help="seconds a spawned replica may take to answer /readyz "
        "before the spawn fails closed (killed, journaled, retried "
        "under backoff)",
    )
    fa.add_argument(
        "--drain-settle", type=float, default=10.0,
        help="retirement drain bound: seconds to wait (after leaving "
        "rotation) for the replica's queue to empty before SIGTERM",
    )
    fa.add_argument(
        "--term-deadline", type=float, default=30.0,
        help="seconds after SIGTERM before a replica that refuses to "
        "drain is SIGKILLed",
    )
    fa.add_argument(
        "--respawn-backoff", type=float, default=1.0,
        help="initial crash-respawn backoff (doubles per consecutive "
        "failure)",
    )
    fa.add_argument("--respawn-backoff-max", type=float, default=30.0)
    fa.add_argument(
        "--replica-host", default="127.0.0.1",
        help="host spawned replicas bind (ports are allocated fresh)",
    )
    fa.add_argument(
        "--serve-arg", action="append", metavar="ARG", default=None,
        help="extra `serve` flag for every spawned replica (repeatable, "
        "one token per use; use the = form for tokens that start with a "
        "dash: --serve-arg=--buckets --serve-arg=1,8). Replicas run on the "
        "card unless --serve-arg=--device --serve-arg=cpu",
    )
    fa.add_argument(
        "--no-aot", action="store_true",
        help="spawn every replica with `serve --no-aot`: ignore published AOT "
        "bundles and capture every bucket at warmup",
    )
    fa.add_argument(
        "--replica-journal-dir", default=None,
        help="directory for per-replica journals "
        "(replica_<id>.jsonl each)",
    )
    fa.add_argument(
        "--max-ticks", type=int, default=None,
        help="exit after N polls (drills/CI; default: run until "
        "signalled)",
    )
    fa.add_argument(
        "--leave-running", action="store_true",
        help="on shutdown, leave managed replicas serving (default: "
        "drain and stop them with the daemon)",
    )
    fa.add_argument(
        "--inject", action="append", metavar="SPEC", default=None,
        help="arm a lifecycle faultpoint in this process (repeatable): "
        "lifecycle.spawn:corrupt@once, lifecycle.drain:corrupt@once, … "
        "(the resilience.faults catalog)",
    )
    fa.add_argument(
        "--metrics-out", default=None,
        help="write the daemon's final Prometheus exposition "
        "(autoscale_*, lifecycle_* families) to this path on exit",
    )
    fa.add_argument(
        "--journal", default=None,
        help="JSONL journal path (autoscale decisions + lifecycle arcs)",
    )
    fa.set_defaults(fn=cmd_fleet)
    fs = fsub.add_parser(
        "status", help="print the router's registry and health snapshot"
    )
    fs.add_argument("--router", required=True, help="router base URL")
    fs.set_defaults(fn=cmd_fleet)



def add_learn_parser(sub, add_obs_flags, add_device_flag) -> None:
    """The JAX CLI's whole ``learn`` parser, ``--device`` added to the roles
    that fit or replay a model."""
    ln = sub.add_parser(
        "learn",
        help="continual learning: drift-triggered retraining on captured traffic, "
        "shadow evaluation and guarded promotion through the fleet router",
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
        help="publish the candidate without an AOT executable bundle (the "
        "rolling deploy's replicas then capture every bucket at warmup)",
    )
    lp.add_argument(
        "--timeout", type=float, default=1800.0,
        help="end-to-end rollout timeout (seconds)",
    )
    add_obs_flags(lp)
    add_device_flag(lp)  # where the AOT bundle is compiled
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


def add_score_parser(sub, add_obs_flags, add_device_flag, add_mesh_flags) -> None:
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
    add_mesh_flags(c, "scores each chunk's rows sharded over the ranks; every rank reads "
                   "the cohort, rank 0 alone writes --out")
    add_obs_flags(c)
    add_device_flag(c)
    c.set_defaults(fn=cmd_score)


def add_alerting_flags(p, role: str = "replica") -> None:
    """The JAX CLI's alerting flags (history sampler, alert rules, incident
    bundles), for ``serve`` and ``fleet router``."""
    p.add_argument("--history-interval", type=float, default=10.0, metavar="SECONDS",
                   help="in-process metrics history sampling interval for /debug/history "
                   "and alert evaluation (0 disables the whole history/alerting plane)")
    p.add_argument("--alert-rules", default=None, metavar="FILE",
                   help="JSON alert-rule file (list of rule specs) replacing the built-in "
                   f"{role} defaults")
    p.add_argument("--no-alerts", action="store_true",
                   help="sample history but evaluate no alert rules")
    p.add_argument("--incident-dir", default=None, metavar="DIR",
                   help="capture an incident bundle into DIR when a rule fires")
    p.add_argument("--incident-min-interval", type=float, default=60.0, metavar="SECONDS",
                   help="minimum seconds between incident captures")
    p.add_argument("--incident-retention", type=int, default=8,
                   help="complete incident bundles retained in --incident-dir")


def add_serve_flags(v) -> None:
    """The JAX CLI's ``serve`` flags, plus the private ``--worker-id`` a
    multi-worker parent hands each worker it starts."""
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
                   help="SO_REUSEPORT worker processes on one fixed --port, each a fresh "
                   "interpreter with its own CUDA context and graphs; the parent only "
                   "supervises (forwards SIGTERM/SIGINT, stops the rest if one dies)")
    v.add_argument("--worker-id", type=int, default=None, help=argparse.SUPPRESS)
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
    v.add_argument("--no-aot", action="store_true",
                   help="ignore the checkpoint's AOT executable bundle (persist/aot.py) "
                   "and capture every bucket at warmup, here and on every later "
                   "/admin/deploy")
    v.add_argument("--xla-intra-op-threads", type=int, default=None,
                   help="torch host intra-op thread-pool size (torch.set_num_threads; the "
                   "host path and the CPU engine run there; default: min(4, cores/2) with "
                   "a floor of 1; 0 leaves torch alone); journaled in the serve manifest")
    v.add_argument("--replica-id", default=None,
                   help="fleet identity echoed on every reply as X-Replica and on the "
                   "health probes (default when registering: HOST:PORT)")
    v.add_argument("--register", default=None, metavar="ROUTER_URL",
                   help="self-register with a fleet router (POST /fleet/replicas), "
                   "retrying until it answers; deregisters on graceful shutdown. With "
                   "--workers N only worker 0 registers (one shared port = one logical "
                   "replica)")
    v.add_argument("--advertise", default=None, metavar="URL",
                   help="the URL the router should reach this replica at (default "
                   "http://HOST:PORT)")
    v.add_argument("--admin-endpoint", action="store_true",
                   help="enable the guarded /admin/deploy warm-swap endpoint")
    v.add_argument("--verbose", action="store_true", help="log each request")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv  # what a multi-worker serve parent re-runs in each worker
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

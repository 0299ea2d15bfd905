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

``--trace-dir`` and ``--journal`` (``train``, ``predict``) write the run's
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
    stacked ensemble take the 17 contract columns as they are."""
    from machine_learning_replications_tpu_torch.models import pipeline, stacking, tree

    if isinstance(params, pipeline.PipelineParams):
        return float(pipeline.pipeline_predict_proba1_contract(params, x, device=dev)[0])
    if isinstance(params, tree.TreeEnsembleParams):
        xt = torch.as_tensor(x, device=dev).to(params.threshold.dtype)
        return float(tree.predict_proba1(params, xt)[0])
    xt = torch.as_tensor(x, device=dev).to(params.meta.coef.dtype)
    return float(stacking.predict_proba1(params, xt, device=dev)[0])


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
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

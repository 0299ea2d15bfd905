"""Command line of the PyTorch port.

    python -m machine_learning_replications_tpu_torch train \\
        [--develop MAT --select MAT | --synthetic N] [--missing-rate R] \\
        [--seed S] [--config JSON] [--save DIR] [--resume-dir DIR] \\
        [--device cpu|cuda]
    python -m machine_learning_replications_tpu_torch predict --model DIR \\
        [--patient JSON] [--device cpu|cuda]

``train`` is ``train_ensemble_public.py``: it fits the full pipeline
(impute → LassoCV top-17 → stacking ensemble → quality profile) on the
development cohort, scores the model-select cohort, prints the
classification report at threshold 0.5 and the ``AUC-ROC … average
precision …`` line, and with ``--save`` writes a port checkpoint. Without
``.mat`` paths the two cohorts are the disjoint halves of
``make_cohort(2 · --synthetic)``. ``--resume-dir`` checkpoints every stage
so a re-run with the same inputs resumes.

``predict`` loads a port checkpoint (``persist/checkpoint.py``), scores one
patient — the reference's example patient (``predict_hf.py:5-27``) unless
``--patient`` names a JSON object of the 17 contract variables — and prints
``Probability of progressive HF is: XX.XX %`` (``predict_hf.py:38-40``). Both
run on the card unless ``--device cpu`` is given; without CUDA they exit
with an error instead of moving to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device


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


def cmd_train(args) -> int:
    from machine_learning_replications_tpu_torch.device import to_host
    from machine_learning_replications_tpu_torch.models import pipeline
    from machine_learning_replications_tpu_torch.utils import metrics

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"train: {exc}")
    cfg = _config(args)
    X_dev, y_dev = _load_cohort(args, "develop")
    X_sel, y_sel = _load_cohort(args, "select")
    params, info = pipeline.fit_pipeline(X_dev, y_dev, cfg, checkpoint_dir=args.resume_dir,
                                         device=dev)
    print(f"selected {info['n_selected']} features", file=sys.stderr)
    p1 = to_host(pipeline.pipeline_predict_proba1(params, X_sel, device=dev))
    yy = (p1 > 0.5).astype(np.float64)  # train_ensemble_public.py:63
    print(metrics.report_text(metrics.classification_report(y_sel, yy)))
    auc = float(metrics.roc_auc(y_sel, p1))
    ap = float(metrics.average_precision(y_sel, p1))
    print(f"AUC-ROC {auc:.4f}   average precision {ap:.4f}")
    if args.save:
        from machine_learning_replications_tpu_torch.persist import checkpoint

        checkpoint.save_model(args.save, params)
        print(f"model checkpointed to {args.save}", file=sys.stderr)
    return 0


def cmd_predict(args) -> int:
    from machine_learning_replications_tpu_torch.persist import load_inference_params

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"predict: {exc}")
    x = _load_patient(args.patient)
    params = load_inference_params(model=args.model, device=dev)
    prob = predict_proba1(params, x, dev)
    print(f"Probability of progressive HF is: {100.0 * prob:.2f} %")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m machine_learning_replications_tpu_torch",
                                 description="PyTorch port of the heart-failure ensemble")
    sub = ap.add_subparsers(dest="command", required=True)
    t = sub.add_parser("train", help="fit the full pipeline and evaluate it")
    t.add_argument("--develop", help=".mat path of the development cohort")
    t.add_argument("--select", help=".mat path of the model-select cohort")
    t.add_argument("--synthetic", type=int, default=713,
                   help="rows per cohort when no .mat is given: two disjoint halves of "
                   "this size (default 713, the reference's fit-split size)")
    t.add_argument("--missing-rate", type=float, default=0.03)
    t.add_argument("--seed", type=int, default=2020)
    t.add_argument("--config", help="ExperimentConfig JSON path")
    t.add_argument("--save", help="port checkpoint directory to write")
    t.add_argument("--resume-dir", default=None,
                   help="stage-checkpoint directory: each pipeline stage is published on "
                   "completion, so a re-run with the same data and config resumes (the "
                   "directory is fingerprinted against its inputs)")
    t.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="where to run (default: the card; without CUDA this is an error)")
    t.set_defaults(fn=cmd_train)
    p = sub.add_parser("predict", help="single-patient inference from a port checkpoint")
    p.add_argument("--model", required=True, help="checkpoint directory (persist/checkpoint.py)")
    p.add_argument("--patient", help="patient JSON file (default: the predict_hf.py example)")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="where to run (default: the card; without CUDA this is an error)")
    p.set_defaults(fn=cmd_predict)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

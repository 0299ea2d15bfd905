"""Command line of the PyTorch port.

    python -m machine_learning_replications_tpu_torch predict --model DIR \\
        [--patient JSON] [--device cpu|cuda]

``predict`` loads a port checkpoint (``persist/checkpoint.py``), scores one
patient — the reference's example patient (``predict_hf.py:5-27``) unless
``--patient`` names a JSON object of the 17 contract variables — and prints
``Probability of progressive HF is: XX.XX %`` (``predict_hf.py:38-40``). It
runs on the card unless ``--device cpu`` is given; without CUDA it exits
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

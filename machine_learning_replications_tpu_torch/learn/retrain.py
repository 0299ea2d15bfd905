"""Warm-start refit on the captured recent cohort — the loop's "act" half.

Port of the JAX package's ``learn/retrain.py`` over the port's
``fit_pipeline`` / ``fit_stacking`` (on ``device``, default the card: the
GBDT member's fit and the stacking CV's fold fits run the hand-written
stump and node histogram kernels there) and its checkpoints
(``persist.checkpoint.save_model`` / ``checkpoint_version`` in place of
``orbax_io``).

The trigger (``learn.trigger``) says the served population no longer
matches the model's training reference; this module produces the model
that DOES match it. The refit rides entirely on machinery that already
exists:

  * **Data** — the router's bounded capture buffer (``learn.capture``),
    loaded as contract-order rows through the same quarantine-tolerant
    parse bulk scoring uses.
  * **Labels** — serving is label-free, so by default the refit
    *distills*: the live model's own probabilities over the captured
    rows, thresholded at the published 0.5 operating point, become
    pseudo-labels. That adapts every distribution-facing stage (imputer
    donors, scaler moments, lasso selection, member fits, the reference
    profile) to the shifted cohort while anchoring the decision function
    to the model clinicians validated — the honest scope of an
    *unsupervised* continual loop. When adjudicated outcomes exist,
    ``labels`` overrides the distillation (journaled either way:
    ``labels_source``).
  * **Fit** — ``fit_pipeline`` / ``fit_stacking`` with their existing
    ``StageCheckpointer``: every stage durably checkpointed and
    stage-timed (the ``stage_start``/``stage_done`` journal arc), so a
    preempted refit re-entered with the same cohort resumes instead of
    restarting.
  * **Publish** — ``persist.checkpoint.save_model`` → the atomic
    publish path: the candidate gets a monotonic version id, an integrity
    manifest, and last-known-good rotation for free.

Family dispatch mirrors serving: a ``PipelineParams`` live model refits
the full impute → select → stack program over the captured rows embedded
at their schema positions (the candidate's reference profile comes out
of ``fit_pipeline`` itself); a bare ``StackingParams`` refits the
ensemble on the contract rows and attaches a fresh reference profile
(``StackingParams.quality``) so the candidate ships its own drift
baseline — the property the shadow evaluator and the post-promotion
monitor rebase both key on.

**Where the port departs from the JAX module.** The captured rows carry
only the 17 contract variables, so embedded at their schema positions the
other 47 columns are NaN in every row. JAX refits its pipeline on those
rows as they are: the candidate's imputer then has no donor and a NaN mean
for each of the 47 columns, the imputed cohort keeps them NaN, and the fit
stops at the GBDT member's binning ("feature 0 contains NaN") once LassoCV
has selected such a column. The port first fills the 47 columns with the
LIVE model's imputer (its 1-NN donors, the model clinicians validated) and
refits on the completed rows, so the candidate's imputer, selection and
members see finite values. The bare-ensemble refit is JAX's as it is.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

RETRAINS = REGISTRY.counter(
    "learn_retrain_total",
    "Continual-learning refits by result.",
    labels=("result",),
)
for _r in ("ok", "failed"):
    RETRAINS.labels(result=_r)
RETRAIN_SECONDS = REGISTRY.gauge(
    "learn_retrain_seconds",
    "Wall seconds of the most recent refit (NaN until one ran).",
)
RETRAIN_SECONDS.get().set(float("nan"))

#: Refuse to refit on fewer rows: a model fit on a few dozen rows would
#: pass its own reference profile trivially while being statistical noise.
DEFAULT_MIN_ROWS = 200


def pseudo_labels(live_params: Any, X17: np.ndarray, *, device=None) -> np.ndarray:
    """Distillation labels: the live model's decisions over the captured
    rows at the published 0.5 operating point (``predict_hf.py``'s
    threshold; ``train_ensemble_public.py:63`` rounds the same way)."""
    from machine_learning_replications_tpu_torch.learn.shadow import replay_scores

    p1, _members, _rows = replay_scores(live_params, X17, device=device)
    return (p1 >= 0.5).astype(np.float64)


def complete_with_live_imputer(live_params: Any, X17: np.ndarray) -> np.ndarray:
    """Captured contract rows as full-width float64 rows: embedded at their
    schema positions, every other column imputed by the live pipeline's
    1-NN imputer (on the device its donors lie on)."""
    from machine_learning_replications_tpu_torch.device import to_host
    from machine_learning_replications_tpu_torch.models import knn_impute
    from machine_learning_replications_tpu_torch.models import pipeline as pipelinemod

    x64 = pipelinemod.contract_rows_to_x64(live_params, X17)
    return to_host(knn_impute.transform(live_params.imputer, x64)).astype(np.float64)


def warm_refit(
    live_params: Any,
    X17: np.ndarray,
    out_dir: str | os.PathLike,
    cfg=None,
    labels: np.ndarray | None = None,
    resume_dir: str | os.PathLike | None = None,
    min_rows: int = DEFAULT_MIN_ROWS,
    mesh=None,
    *,
    device=None,
) -> tuple[Any, dict]:
    """Refit the live model's family on contract-order rows ``X17`` and
    publish the candidate checkpoint at ``out_dir`` (atomic, versioned,
    integrity-manifested). Returns ``(candidate_params, info)`` where
    ``info`` carries the published version, row counts, label source,
    and wall seconds — the same dict the ``learn_retrain_done`` journal
    event records — plus, in the port, each fit stage's seconds
    (``stage_seconds``). ``resume_dir`` makes the fit stage-resumable
    (``StageCheckpointer``; it is fingerprinted against the cohort, so a
    DIFFERENT captured window refuses a stale dir loudly). The fit runs on
    ``device`` (default: the card), where ``live_params`` must lie. With
    ``mesh`` (a ``parallel.make_mesh`` on ``device``) the refit runs its
    row-parallel stages sharded, every rank of the mesh calls this on the
    same rows and the same ``out_dir`` and ``resume_dir``, rank 0 alone
    writes them, and every rank returns once the candidate is published (or
    raises where rank 0's publish failed)."""
    import dataclasses

    import torch

    from machine_learning_replications_tpu_torch.config import ExperimentConfig
    from machine_learning_replications_tpu_torch.device import resolve_device
    from machine_learning_replications_tpu_torch.models import (
        pipeline as pipelinemod,
    )
    from machine_learning_replications_tpu_torch.models import stacking
    from machine_learning_replications_tpu_torch.obs import quality as qualitymod
    from machine_learning_replications_tpu_torch.parallel.mesh import agree
    from machine_learning_replications_tpu_torch.persist import checkpoint

    dev = resolve_device(device)
    X17 = np.asarray(X17, np.float64)
    if X17.ndim != 2 or X17.shape[1] != 17:
        raise ValueError(f"refit rows must be [n, 17], got {X17.shape}")
    n = int(X17.shape[0])
    if n < min_rows:
        raise ValueError(
            f"refit cohort has {n} rows, below min_rows={min_rows}; "
            "capture more traffic before retraining"
        )
    if not np.isfinite(X17).all():
        raise ValueError("refit rows must be finite (contract-validated)")
    cfg = cfg or ExperimentConfig()
    # Family dispatch is validated BEFORE the (expensive) distillation
    # pass: an unsupported params object must refuse up front, not fail
    # obscurely inside the live model's replay.
    if not isinstance(
        live_params, (pipelinemod.PipelineParams, stacking.StackingParams)
    ):
        raise TypeError(
            f"cannot warm-refit a {type(live_params).__name__}: the "
            "continual loop supports PipelineParams and StackingParams"
        )
    if labels is None:
        y = pseudo_labels(live_params, X17, device=dev)
        labels_source = "distilled"
    else:
        y = np.asarray(labels, np.float64).ravel()
        if y.shape[0] != n:
            raise ValueError(
                f"{y.shape[0]} labels for {n} rows"
            )
        labels_source = "provided"
    if len(np.unique(y)) < 2:
        raise ValueError(
            "refit labels are single-class (the live model decides every "
            "captured row the same way); a one-class refit cannot fit "
            "the members — provide labels or widen the capture window"
        )

    t0 = time.perf_counter()
    timings: dict[str, float] = {}
    journal.event(
        "learn_retrain_start", rows=n, labels_source=labels_source,
        family=type(live_params).__name__, out=os.fspath(out_dir),
    )
    try:
        if isinstance(live_params, pipelinemod.PipelineParams):
            # Full pipeline: captured contract rows embedded at their
            # schema positions, the unobserved columns filled by the live
            # model's imputer (see the module docstring: JAX leaves them
            # NaN and its refit fails), then the whole impute → select →
            # stack program, stage-resumable.
            x64 = complete_with_live_imputer(live_params, X17)
            candidate, info = pipelinemod.fit_pipeline(
                x64, y, cfg,
                checkpoint_dir=(
                    os.fspath(resume_dir) if resume_dir else None
                ),
                mesh=mesh, device=dev,
            )
            timings = info["stage_seconds"]
        else:  # StackingParams — the only other family past the gate
            stages = pipelinemod._make_stages(
                dev,
                os.fspath(resume_dir) if resume_dir else None,
                None,
                fingerprint=(
                    pipelinemod._fit_fingerprint(X17, y, cfg)
                    if resume_dir else None
                ),
                timings=timings,
                mesh=mesh,
            )
            ens = pipelinemod.fit_stacking(
                X17, y, cfg, stages=stages, mesh=mesh, device=dev
            )
            scores = pipelinemod._ensemble_scores(
                ens, torch.as_tensor(X17, device=dev),
                chunk_rows=cfg.svc.predict_chunk_rows, mesh=mesh,
            )
            prof = qualitymod.build_reference_profile(X17, scores, y=y)
            candidate = dataclasses.replace(
                ens,
                quality={k: torch.as_tensor(v, device=dev) for k, v in prof.items()},
            )
        # Rank 0 publishes; every rank returns (or raises) with its outcome.
        agree(mesh, lambda: checkpoint.save_model(out_dir, candidate)
              if mesh is None or mesh.rank == 0 else None)
    except BaseException as exc:
        RETRAINS.inc(result="failed")
        journal.event(
            "learn_retrain_failed", rows=n,
            error=f"{type(exc).__name__}: {exc}",
            seconds=round(time.perf_counter() - t0, 3),
        )
        raise
    seconds = round(time.perf_counter() - t0, 3)
    version = checkpoint.checkpoint_version(out_dir)
    RETRAINS.inc(result="ok")
    RETRAIN_SECONDS.get().set(seconds)
    info = {
        "rows": n,
        "labels_source": labels_source,
        "family": type(candidate).__name__,
        "candidate": os.path.abspath(os.fspath(out_dir)),
        "version": version,
        "seconds": seconds,
        "stage_seconds": {k: round(v, 3) for k, v in timings.items()},
    }
    journal.event("learn_retrain_done", **info)
    return candidate, info

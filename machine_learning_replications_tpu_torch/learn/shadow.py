"""Shadow evaluation — the candidate model judged on live traffic before
it may serve a single client.

Port of the JAX package's ``learn/shadow.py``: the comparator math, the
thresholds, the gauges and the journal event as in JAX; ``replay_scores``
runs the port's eager ``cli predict`` route on ``device`` (default: the
card).

A retrained candidate (``learn.retrain``) is a hypothesis, not a deploy:
it was fit on pseudo-labeled recent rows and could be anything from "the
same model, recalibrated to the shifted cohort" to "a confidently wrong
model fit on garbage". This module replays captured live traffic
(``learn.capture``) through BOTH models' eager oracle composition — the
exact route ``cli predict`` takes, the same oracle the deploy parity
probe trusts — and reduces the two score streams to a machine-readable
verdict:

  * **Blended-probability divergence** — mean/p95/max ``|p_cand −
    p_live|`` and the decision flip rate (rows crossing the 0.5
    operating point; ``predict_hf.py``'s published threshold). A
    continual refit should *recalibrate*, not reinvent: large divergence
    means the candidate is a different model, and a human belongs in the
    loop.
  * **Score-distribution PSI** — candidate vs live score histograms over
    the replay, the population-level restatement of the same question.
  * **Candidate self-quality** — the replayed rows binned against the
    candidate's OWN training reference profile (``obs.quality`` math,
    same PSI thresholds): the candidate was refit precisely so that
    current traffic matches its training distribution, so a candidate
    that already reads ``alert`` against its own profile failed at the
    one job the retrain existed to do.
  * **Ensemble-disagreement delta** — mean pairwise member disagreement,
    candidate minus live: a spike means the members stopped agreeing on
    the new cohort (the classic symptom of a member overfit to
    pseudo-labels), which the blended probability alone can hide.

Everything is exported three ways, consistently: the verdict dict
(strict JSON — not-computable statistics are ``None``, never NaN), the
``learn_shadow_*`` gauge families on the process registry (NaN marks "no
data", the idiomatic gauge convention, validator-clean), and one
journaled ``learn_shadow_verdict`` event.

The replay is the *offline* mirror mode: deterministic, free of serving
jitter, and runs anywhere the checkpoint does. A router-level live
mirror tap (duplicate requests to a shadow replica, replies discarded)
would exercise the serving stack too — docs/CONTINUAL.md discusses the
trade; the comparator below is shared by both designs.

The comparator math is numpy-only and import-light; torch is imported
lazily inside ``replay_scores``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs import quality as qualitymod
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

#: Decision threshold for the flip rate — the published operating point
#: (``predict_hf.py``'s 0.5; ``train_ensemble_public.py:63``).
DECISION_THRESHOLD = 0.5

#: Fewer replay rows than this and the divergence statistics are noise —
#: the verdict refuses to pass (mirrors ``QualityMonitor.min_rows``).
DEFAULT_MIN_ROWS = 64

# One explicit, literal registration per family: a name assembled in a
# comprehension can't be cataloged, grepped, or held to ``obs/catalog.py``
# (``tests/test_torch_obs.py::test_code_and_catalog_agree`` reads these).
_G = {
    "divergence_mean": REGISTRY.gauge(
        "learn_shadow_divergence_mean",
        "Mean |p_candidate - p_live| over the shadow replay (NaN until "
        "a replay ran).",
    ),
    "divergence_p95": REGISTRY.gauge(
        "learn_shadow_divergence_p95",
        "95th-percentile |p_candidate - p_live| over the shadow replay "
        "(NaN until a replay ran).",
    ),
    "divergence_max": REGISTRY.gauge(
        "learn_shadow_divergence_max",
        "Max |p_candidate - p_live| over the shadow replay (NaN until a "
        "replay ran).",
    ),
    "flip_rate": REGISTRY.gauge(
        "learn_shadow_flip_rate",
        "Fraction of replay rows whose 0.5-threshold decision flips "
        "between live and candidate (NaN until a replay ran).",
    ),
    "score_psi": REGISTRY.gauge(
        "learn_shadow_score_psi",
        "PSI between the candidate and live score distributions over "
        "the shadow replay (NaN until a replay ran).",
    ),
    "candidate_worst_psi": REGISTRY.gauge(
        "learn_shadow_candidate_worst_psi",
        "Worst per-feature PSI of the replay rows vs the CANDIDATE's "
        "own training reference profile (NaN when the candidate carries "
        "no profile).",
    ),
    "candidate_status": REGISTRY.gauge(
        "learn_shadow_candidate_status",
        "Candidate self-quality status over the replay: 0 ok, 1 warn, "
        "2 alert (NaN when no profile).",
    ),
    "disagreement_delta": REGISTRY.gauge(
        "learn_shadow_disagreement_delta",
        "Mean pairwise ensemble-member disagreement, candidate minus "
        "live (NaN when the family has no members).",
    ),
    "rows": REGISTRY.gauge(
        "learn_shadow_rows", "Rows in the most recent shadow replay.",
    ),
}
EVALUATIONS = REGISTRY.counter(
    "learn_shadow_evaluations_total",
    "Shadow evaluations by verdict.",
    labels=("verdict",),
)
for _v in ("pass", "fail"):
    EVALUATIONS.labels(verdict=_v)
for _g in _G.values():
    _g.get().set(float("nan"))
_G["rows"].get().set(0.0)


class ShadowThresholds:
    """The promotion gate's contract (docs/CONTINUAL.md "Shadow
    contract"). Defaults are deliberately conservative for a clinical
    score: a refit that moves the mean probability by more than 0.15, or
    flips more than 10% of decisions, is no longer a recalibration."""

    def __init__(
        self,
        max_divergence_mean: float = 0.15,
        max_divergence_p95: float = 0.35,
        max_flip_rate: float = 0.10,
        max_score_psi: float = 2.0,
        max_candidate_psi: float = qualitymod.DEFAULT_ALERT_PSI,
        max_disagreement_delta: float = 0.15,
        min_rows: int = DEFAULT_MIN_ROWS,
        require_candidate_profile: bool = True,
    ) -> None:
        self.max_divergence_mean = float(max_divergence_mean)
        self.max_divergence_p95 = float(max_divergence_p95)
        self.max_flip_rate = float(max_flip_rate)
        self.max_score_psi = float(max_score_psi)
        self.max_candidate_psi = float(max_candidate_psi)
        self.max_disagreement_delta = float(max_disagreement_delta)
        self.min_rows = int(min_rows)
        self.require_candidate_profile = bool(require_candidate_profile)

    def as_dict(self) -> dict:
        return {
            "max_divergence_mean": self.max_divergence_mean,
            "max_divergence_p95": self.max_divergence_p95,
            "max_flip_rate": self.max_flip_rate,
            "max_score_psi": self.max_score_psi,
            "max_candidate_psi": self.max_candidate_psi,
            "max_disagreement_delta": self.max_disagreement_delta,
            "min_rows": self.min_rows,
            "require_candidate_profile": self.require_candidate_profile,
        }


# ---------------------------------------------------------------------------
# Comparator math (numpy-only — the unit-tested spec)
# ---------------------------------------------------------------------------


def score_divergence(
    p_live: np.ndarray,
    p_candidate: np.ndarray,
    score_bins: int = qualitymod.DEFAULT_SCORE_BINS,
) -> dict:
    """Reduce two aligned score streams to the divergence block of the
    verdict. Pure and deterministic: the golden-value tests pin this
    function, and everything downstream (gauges, verdict, journal) is
    formatting."""
    p_live = np.asarray(p_live, np.float64).ravel()
    p_cand = np.asarray(p_candidate, np.float64).ravel()
    if p_live.shape != p_cand.shape:
        raise ValueError(
            f"score streams differ in length: {p_live.shape} vs "
            f"{p_cand.shape}"
        )
    n = int(p_live.shape[0])
    if n == 0:
        return {
            "rows": 0, "divergence_mean": None, "divergence_p95": None,
            "divergence_max": None, "flip_rate": None, "score_psi": None,
        }
    if not (np.isfinite(p_live).all() and np.isfinite(p_cand).all()):
        raise ValueError("score streams must be finite probabilities")
    d = np.abs(p_cand - p_live)
    flips = (p_cand >= DECISION_THRESHOLD) != (p_live >= DECISION_THRESHOLD)
    live_counts = np.bincount(
        qualitymod._score_bin_indices(p_live, score_bins),
        minlength=score_bins,
    )
    cand_counts = np.bincount(
        qualitymod._score_bin_indices(p_cand, score_bins),
        minlength=score_bins,
    )
    return {
        "rows": n,
        "divergence_mean": float(d.mean()),
        "divergence_p95": float(np.quantile(d, 0.95)),
        "divergence_max": float(d.max()),
        "flip_rate": float(flips.mean()),
        # expected = live (the serving status quo), actual = candidate.
        "score_psi": qualitymod.psi(live_counts, cand_counts),
    }


def cohort_quality(profile: Any, X: np.ndarray) -> dict:
    """One-shot ``obs.quality`` judgment of a row matrix against a
    reference profile (the windowed monitor's math without the rings):
    per-feature PSI/KS, worst offender, and the standard thresholded
    status. ``X`` must live in the profile's own feature space."""
    prof = qualitymod._as_host_profile(profile)
    X = np.asarray(X, np.float64)
    F, B = prof["bin_counts"].shape
    if X.ndim != 2 or X.shape[1] != F:
        raise ValueError(
            f"rows are {X.shape} but the profile describes {F} features"
        )
    if not np.isfinite(X).all():
        raise ValueError("cohort_quality rows must be finite")
    mins, widths = qualitymod.profile_bin_geometry(prof)
    fidx = qualitymod._feature_bin_indices(X, mins, widths, B)
    flat = (np.arange(F, dtype=np.int64) * B)[None, :] + fidx
    counts = np.bincount(flat.ravel(), minlength=F * B).reshape(
        F, B
    ).astype(np.float64)
    f_psi = qualitymod._psi_rows(prof["bin_counts"], counts)
    f_ks = qualitymod._ks_rows(prof["bin_counts"], counts)
    worst = int(np.argmax(f_psi))
    worst_psi = float(f_psi[worst])
    status = (
        "alert" if worst_psi >= qualitymod.DEFAULT_ALERT_PSI
        else "warn" if worst_psi >= qualitymod.DEFAULT_WARN_PSI
        else "ok"
    )
    return {
        "rows": int(X.shape[0]),
        "status": status,
        "worst_feature_index": worst,
        "worst_psi": worst_psi,
        "feature_psi": [float(v) for v in f_psi],
        "feature_ks": [float(v) for v in f_ks],
    }


def mean_disagreement(members: np.ndarray | None) -> float | None:
    """Mean pairwise |p_i − p_j| across members — ``None`` (not NaN) for
    a memberless family, the strict-JSON convention."""
    if members is None:
        return None
    members = np.asarray(members, np.float64)
    n, m = members.shape
    if n == 0 or m < 2:
        return None
    return float(qualitymod.pairwise_disagreement(members).mean())


# ---------------------------------------------------------------------------
# Replay (lazy torch — the eager oracle composition)
# ---------------------------------------------------------------------------


def replay_scores(
    params: Any, X17: np.ndarray, chunk_rows: int = 512, *, device=None
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """Score contract-order rows through the eager oracle composition —
    the exact ``cli predict`` route the deploy parity probe pins — on
    ``device`` (default: the card; the parameters must lie there), and
    return ``(p1[n], members[n, M] | None, monitored_rows[n, F])`` as
    float64 host arrays. ``monitored_rows`` is the matrix in the family's
    quality-profile space: the contract rows themselves for a bare
    ensemble, the post-impute post-select matrix for a full pipeline (the
    space its reference profile was built over). Rows go in the
    parameters' dtype, as ``serve.engine.oracle_proba1`` casts them."""
    import torch

    from machine_learning_replications_tpu_torch.device import resolve_device, to_host
    from machine_learning_replications_tpu_torch.models import (
        pipeline, stacking, tree,
    )

    dev = resolve_device(device)
    X17 = np.asarray(X17, np.float64)
    if X17.ndim != 2 or X17.shape[1] != 17:
        raise ValueError(f"replay rows must be [n, 17], got {X17.shape}")
    is_pipeline = isinstance(params, pipeline.PipelineParams)
    cols = pipeline.support_columns(params) if is_pipeline else None
    p1_parts, member_parts, row_parts = [], [], []
    for s in range(0, X17.shape[0], max(1, int(chunk_rows))):
        chunk = X17[s:s + chunk_rows]
        if is_pipeline:
            x64 = pipeline.contract_rows_to_x64(params, chunk)
            X17sel = pipeline.impute_select(params, x64, cols=cols)
            p1, members = stacking.predict_proba1_with_members(
                params.ensemble, X17sel.to(params.ensemble.meta.coef.dtype), device=dev
            )
            qrows = to_host(X17sel)
        elif isinstance(params, tree.TreeEnsembleParams):
            xt = torch.as_tensor(chunk, device=dev).to(params.threshold.dtype)
            p1, members, qrows = tree.predict_proba1(params, xt), None, chunk
        else:
            xt = torch.as_tensor(chunk, device=dev).to(params.meta.coef.dtype)
            p1, members = stacking.predict_proba1_with_members(params, xt, device=dev)
            qrows = chunk
        p1_parts.append(to_host(p1).astype(np.float64))
        row_parts.append(np.asarray(qrows, np.float64))
        if members is not None:
            member_parts.append(to_host(members).astype(np.float64))
    p1 = np.concatenate(p1_parts) if p1_parts else np.zeros(0)
    rows = (
        np.concatenate(row_parts) if row_parts
        else np.zeros((0, X17.shape[1]))
    )
    members = np.concatenate(member_parts) if member_parts else None
    return p1, members, rows


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------


def evaluate(
    live_params: Any,
    candidate_params: Any,
    X17: np.ndarray,
    thresholds: ShadowThresholds | None = None,
    candidate_version: int | None = None,
    *,
    device=None,
) -> dict:
    """Run the full shadow comparison on ``device`` (default: the card)
    and return the verdict dict (strict-JSON; ``verdict["pass"]`` is the
    promotion gate's input). Gauges and the ``learn_shadow_verdict``
    journal event are updated as a side effect — the evaluation IS the
    observable."""
    thresholds = thresholds or ShadowThresholds()
    p_live, m_live, _ = replay_scores(live_params, X17, device=device)
    p_cand, m_cand, cand_rows = replay_scores(candidate_params, X17, device=device)
    stats = score_divergence(p_live, p_cand)

    dis_live = mean_disagreement(m_live)
    dis_cand = mean_disagreement(m_cand)
    stats["disagreement_live"] = dis_live
    stats["disagreement_candidate"] = dis_cand
    stats["disagreement_delta"] = (
        None if dis_live is None or dis_cand is None
        else dis_cand - dis_live
    )

    cand_profile = getattr(candidate_params, "quality", None)
    if cand_profile is not None:
        cq = cohort_quality(cand_profile, cand_rows)
        stats["candidate_quality"] = {
            "status": cq["status"], "worst_psi": cq["worst_psi"],
            "rows": cq["rows"],
        }
    else:
        stats["candidate_quality"] = None

    verdict = judge(stats, thresholds)
    verdict["candidate_version"] = candidate_version
    _export(stats)
    EVALUATIONS.inc(verdict="pass" if verdict["pass"] else "fail")
    journal.event(
        "learn_shadow_verdict",
        passed=verdict["pass"],
        reasons=verdict["reasons"],
        candidate_version=candidate_version,
        **{k: stats[k] for k in (
            "rows", "divergence_mean", "divergence_p95", "divergence_max",
            "flip_rate", "score_psi", "disagreement_delta",
        )},
        candidate_quality=stats["candidate_quality"],
    )
    return verdict


def judge(stats: dict, thresholds: ShadowThresholds) -> dict:
    """Apply the thresholds to a stats block: ``{"pass", "reasons",
    "stats", "thresholds"}``. Pure — the both-sides threshold tests pin
    this. A not-computable statistic (``None``) fails closed where the
    thresholds demand it: a gate that cannot measure must refuse, not
    wave through."""
    reasons: list[str] = []
    rows = stats.get("rows") or 0
    if rows < thresholds.min_rows:
        reasons.append(
            f"replay has {rows} rows, below min_rows={thresholds.min_rows}"
        )
    for key, bound in (
        ("divergence_mean", thresholds.max_divergence_mean),
        ("divergence_p95", thresholds.max_divergence_p95),
        ("flip_rate", thresholds.max_flip_rate),
        ("score_psi", thresholds.max_score_psi),
    ):
        v = stats.get(key)
        if v is not None and v > bound:
            reasons.append(f"{key} {v:.6g} exceeds {bound:g}")
    dd = stats.get("disagreement_delta")
    if dd is not None and dd > thresholds.max_disagreement_delta:
        reasons.append(
            f"disagreement_delta {dd:.6g} exceeds "
            f"{thresholds.max_disagreement_delta:g}"
        )
    cq = stats.get("candidate_quality")
    if cq is None:
        if thresholds.require_candidate_profile:
            reasons.append(
                "candidate carries no quality reference profile"
            )
    elif cq["worst_psi"] > thresholds.max_candidate_psi:
        reasons.append(
            f"candidate self-quality {cq['status']} (worst PSI "
            f"{cq['worst_psi']:.6g} exceeds "
            f"{thresholds.max_candidate_psi:g}): the replayed cohort "
            "does not match the candidate's own training reference"
        )
    return {
        "pass": not reasons,
        "reasons": reasons,
        "stats": _jsonsafe(stats),
        "thresholds": thresholds.as_dict(),
    }


def _jsonsafe(stats: dict) -> dict:
    """Strict-JSON copy: every float rounded, NaN coerced to None (the
    strict-JSON convention — a bare NaN token breaks strict parsers)."""
    def fix(v):
        if isinstance(v, dict):
            return {k: fix(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [fix(x) for x in v]
        if isinstance(v, float):
            return None if v != v else round(v, 6)
        return v

    return {k: fix(v) for k, v in stats.items()}


def _export(stats: dict) -> None:
    """Gauge-side rendering of the stats block: ``None`` (JSON's "no
    data") becomes NaN (the gauge convention, legal under the strict
    validator) — the two surfaces stay consistent by construction."""
    def val(v):
        return float("nan") if v is None else float(v)

    _G["divergence_mean"].get().set(val(stats.get("divergence_mean")))
    _G["divergence_p95"].get().set(val(stats.get("divergence_p95")))
    _G["divergence_max"].get().set(val(stats.get("divergence_max")))
    _G["flip_rate"].get().set(val(stats.get("flip_rate")))
    _G["score_psi"].get().set(val(stats.get("score_psi")))
    _G["disagreement_delta"].get().set(val(stats.get("disagreement_delta")))
    cq = stats.get("candidate_quality")
    if cq is None:
        _G["candidate_worst_psi"].get().set(float("nan"))
        _G["candidate_status"].get().set(float("nan"))
    else:
        _G["candidate_worst_psi"].get().set(val(cq.get("worst_psi")))
        _G["candidate_status"].get().set(
            float(qualitymod._STATUS_LEVEL[cq["status"]])
        )
    _G["rows"].get().set(float(stats.get("rows") or 0))

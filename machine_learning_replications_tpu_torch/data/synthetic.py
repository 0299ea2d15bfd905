"""Synthetic cohort generator matched to Table S1 marginals.

The reference's training data (``develop_data.mat`` / ``model_select_data.mat``,
loaded at ``train_ensemble_public.py:36,39``) is not shipped; only the fitted
pickle is. Parity and benchmarking therefore run on synthetic cohorts whose
marginals match Supplementary Table S1 (see ``schema.py``) and whose outcome is
generated from a logistic model over the 17 contractual features with
coefficient signs matching the decoded L1-LR member of the shipped model
(SURVEY.md §2.3), calibrated to the fit-split class prior 19.776 % positive
(pickle: ``DummyClassifier.class_prior_ = [0.80224, 0.19776]``).

Host-side numpy by design. This is a bit-identical copy of the JAX
package's ``data/synthetic.py``: both sides of every parity test draw their
inputs from it, so the two generators must never drift.
"""

from __future__ import annotations

import numpy as np

from machine_learning_replications_tpu_torch.data import schema

# Logistic outcome coefficients over SELECTED_17, sign-matched to the decoded
# L1-LR base member (SURVEY.md §2.3: coef_ = [1.1247, -0.2490, ...]).
_OUTCOME_COEF = np.array(
    [
        1.12, -0.25, 0.39, 1.20, 0.56, 1.42, 0.42, 0.20, -0.22,
        0.59, 0.36, -0.42, 1.23, 0.042, 0.77, 0.20, -0.065,
    ]
)

TARGET_POSITIVE_RATE = 0.19776  # pickle class prior


def _sample_column(rng: np.random.Generator, spec: schema.VariableSpec, n: int) -> np.ndarray:
    if spec.kind == "binary":
        return (rng.random(n) < spec.p).astype(np.float64)
    if spec.kind == "continuous":
        if spec.median == 0.0:
            # Heavily right-skewed (LVOT / mid-cavity gradients: median 0,
            # mean ≪ sd). Zero-inflated exponential matches the published
            # mean and the zero median.
            q = 0.5
            x = rng.exponential(spec.mean / (1 - q), size=n)
            x[rng.random(n) < q] = 0.0
            return x
        x = rng.normal(spec.mean, spec.sd, size=n)
        # Clinical measurements are non-negative.
        return np.maximum(x, 0.0)
    if spec.kind == "ordinal":
        levels = np.arange(spec.lo, spec.hi + 1)
        # Geometric-ish mass decaying away from the median level.
        w = 0.5 ** np.abs(levels - spec.median)
        return rng.choice(levels, size=n, p=w / w.sum()).astype(np.float64)
    raise ValueError(spec.kind)


def make_cohort(
    n: int = schema.N_COHORT,
    seed: int = 2020,
    missing_rate: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate ``(X[n,64] float64, y[n] float64, var_names[1,64] object)``.

    Return types mirror ``load_data_public.py:4-14``'s contract exactly
    (float64 X/y; names as a (1, 64) object row so ``names[0, mask]`` works as
    at ``train_ensemble_public.py:55``).

    ``missing_rate`` > 0 masks that fraction of entries to NaN (MCAR) in the
    continuous/ordinal columns, exercising the KNN imputation path
    (``train_ensemble_public.py:37-40``).
    """
    rng = np.random.default_rng(seed)
    # Fill a preallocated matrix column-by-column: np.stack's 64×n temporary
    # copy was the single largest cost of a 10M-row cohort build (bench
    # config 5 spent ~3.5 min of its budget generating data, r3 profile).
    X = np.empty((n, len(schema.COHORT_SCHEMA)), dtype=np.float64)
    for j, spec in enumerate(schema.COHORT_SCHEMA):
        X[:, j] = _sample_column(rng, spec, n)

    sel = schema.selected_indices()
    Xs = X[:, sel]
    # Standardize continuous scales so one unit of each feature contributes
    # comparably, then calibrate the intercept to the target prior by
    # bisection. Calibration only needs the MEAN sigmoid, so it runs on a
    # leading subsample — a 262k-row estimate of a 0.198 rate is exact to
    # ~1e-3, far tighter than the class-prior variation between seeds —
    # instead of 60 full-cohort exp() passes.
    mu, sd = Xs.mean(0), Xs.std(0) + 1e-12
    logits = ((Xs - mu) / sd) @ _OUTCOME_COEF
    cal = logits[: min(n, 262_144)]
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if (1 / (1 + np.exp(-(cal + mid)))).mean() > TARGET_POSITIVE_RATE:
            hi = mid
        else:
            lo = mid
    p = 1 / (1 + np.exp(-(logits + 0.5 * (lo + hi))))
    y = (rng.random(n) < p).astype(np.float64)

    if missing_rate > 0.0:
        mask = rng.random(X.shape) < missing_rate
        # Only non-binary columns go missing (binary indicators are charted).
        nonbin = np.array([s.kind != "binary" for s in schema.COHORT_SCHEMA])
        X[mask & nonbin[None, :]] = np.nan

    names = np.array([schema.variable_names()], dtype=object)
    return X, y, names


def dev_select_split(
    X: np.ndarray, y: np.ndarray, seed: int = 2020
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic 713/714 development / model-selection split.

    The shipped model was fitted on 713 of 1427 rows (pickle:
    ``SVC.shape_fit_ = (713, 17)``); the split itself is not in the public
    code, so we define a seeded permutation split with the same sizes.
    """
    n = X.shape[0]
    n_dev = round(n * 713 / 1427)
    perm = np.random.default_rng(seed).permutation(n)
    dev, sel = perm[:n_dev], perm[n_dev:]
    return X[dev], y[dev], X[sel], y[sel]

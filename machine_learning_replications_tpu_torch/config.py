"""Configuration layer.

The reference hard-codes every knob in source (``train_ensemble_public.py:29-30``
sets ``num_xrsval=10`` / ``init_rs=2020``; hyperparameters inline at ``:43-52``;
paths relative to ``__file__`` at ``:34-39``; the inference input is edited
in-source, ``predict_hf.py:5-27``). SURVEY.md §5 calls for a real config layer
over seed, split, imputer-k, max_features, ensemble hparams, mesh shape, and
the sweep grid — this module is it.

All configs are frozen dataclasses so they are hashable. This is a copy of
``machine_learning_replications_tpu/config.py`` (the port imports nothing of
the JAX package): the field names and defaults are identical, so an
``ExperimentConfig`` JSON round-trips between the two packages unchanged.
``GBDTConfig.histogram_backend`` keeps its four values for that round trip;
the port has two behaviours for them (``models.gbdt.histogram_kernels``):
'auto'/'pallas' take the hand-written CUDA histogram kernels, 'xla'/'matmul'
their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """Gradient-boosted trees member (reference: ``train_ensemble_public.py:45``).

    The reference uses 100 depth-1 stumps, lr 0.1, binomial deviance,
    friedman_mse split scoring, no subsampling.
    """

    n_estimators: int = 100
    max_depth: int = 1
    learning_rate: float = 0.1
    # 'exact' enumerates sorted thresholds (parity with sklearn's BestSplitter);
    # 'hist' uses quantile-binned histograms (the scalable TPU path).
    splitter: str = "exact"
    n_bins: int = 256
    min_samples_split: int = 2
    min_samples_leaf: int = 1
    # CV-fold candidate protocol (gbdt.fit_folds / the pipeline's mesh fold
    # loop): False (default) derives split candidates once from the full
    # matrix — cheaper, with a documented <6e-3 meta-feature deviation from
    # sklearn's per-refit enumeration; True re-derives candidates from each
    # fold's own rows (reference-exact, costs a [k, n, F] binned tensor).
    per_fold_binning: bool = False
    # Which histogram entries the fits call (models.gbdt.histogram_kernels).
    # The port has two behaviours: 'auto' and 'pallas' = the hand-written
    # CUDA kernels (their plain versions on a CPU tensor), 'xla' and
    # 'matmul' = the plain PyTorch versions on any device. The four values
    # are the JAX package's, kept so an ExperimentConfig JSON round-trips.
    histogram_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class SVCConfig:
    """RBF support-vector member (reference: ``train_ensemble_public.py:44``).

    Scaled-regime policy (SURVEY.md §7 "SVC on TPU"): the kernel matrix is
    O(n²), so above ``max_rows`` fit rows the member either trains on a
    deterministic stratified subsample of ``max_rows`` rows
    (``scale_policy='subsample'`` — the default; the GBDT/LR members still
    see every row, and they dominate the meta weights anyway, SURVEY.md
    §2.3) or refuses with a clear error (``scale_policy='error'``).
    """

    C: float = 1.0
    gamma: str | float = "scale"  # 'scale' → 1 / (n_features * X.var())
    class_weight: str | None = "balanced"
    probability: bool = True
    platt_cv: int = 5
    tol: float = 1e-3
    max_iter: int = 20_000
    # 8192² kernel + dual matrices ≈ 0.5 GB f32 — the 20k default measured
    # as a worker-killing ~3.2 GB+ on the single v5e; the SVC member also
    # carries the smallest meta weight (SURVEY §2.3: 0.41 of 5.13), so the
    # subsample cap costs the least of the three members.
    max_rows: int = 8_192
    scale_policy: str = "subsample"  # 'subsample' | 'error'
    predict_chunk_rows: int = 65_536  # bound the [chunk, n_sv] kernel at predict


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    """Logistic-regression members (reference: ``train_ensemble_public.py:46,48``)."""

    penalty: str = "l1"  # base member is l1/liblinear; meta learner is l2/lbfgs
    C: float = 1.0
    class_weight: str | None = "balanced"
    tol: float = 1e-5
    max_iter: int = 2_000


@dataclasses.dataclass(frozen=True)
class LassoSelectConfig:
    """LassoCV + SelectFromModel (reference: ``train_ensemble_public.py:51-52``).

    Scaled-regime policy (VERDICT r3 missing #2): the covariance-form CV
    solve is row-free, so the only O(n) footprint is the cohort itself plus
    the per-fold Gram passes. On a single device, above ``max_rows`` the
    stage either fits on a deterministic stratified subsample of
    ``max_rows`` rows (``scale_policy='subsample'``, the default) or
    refuses with a clear error (``'error'``). With a mesh, the Gram passes
    shard over 'data' (``parallel.select_trainer``) and the cap applies to
    the per-device row count instead.
    """

    cv_folds: int = 10  # num_xrsval, train_ensemble_public.py:29
    n_alphas: int = 100
    eps: float = 1e-3
    max_features: int = 17
    max_iter: int = 1_000
    tol: float = 1e-6
    # 20M rows × 64 f32 features ≈ 5.1 GB device-resident — comfortably
    # inside a 16 GB v5e with the [K, F, F] stats and FISTA state on top.
    max_rows: int = 20_000_000
    scale_policy: str = "subsample"  # 'subsample' | 'error'


@dataclasses.dataclass(frozen=True)
class ImputerConfig:
    """KNN imputation (reference: ``train_ensemble_public.py:37``).

    Scaled-regime policy: the donor distance matrix is O(n_query · n_fit),
    so the fit cohort is capped at ``max_donors`` rows (deterministic
    uniform subsample — 1-NN imputation quality saturates long before 10⁵
    donors) and ``transform`` processes queries in ``chunk_rows`` blocks.
    """

    n_neighbors: int = 1
    max_donors: int = 100_000
    chunk_rows: int = 8_192


@dataclasses.dataclass(frozen=True)
class StackingConfig:
    """Stacking orchestration (reference: ``train_ensemble_public.py:48``).

    cv=None in sklearn resolves to 5-fold stratified CV for classifiers; the
    meta learner sees one predict_proba column per binary base member.
    """

    cv_folds: int = 5
    passthrough: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the TPU build (no reference analogue — SURVEY §2.5).

    Axes:
      data  — cohort rows (data parallelism; histogram partials psum over it)
      model — feature/bin tiles inside split search, and fold/member fan-out
    """

    data: int = 1
    model: int = 1
    axis_names: tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment: seed/split policy + every member's hparams."""

    seed: int = 2020  # init_rs, train_ensemble_public.py:30
    n_features_raw: int = 64
    imputer: ImputerConfig = ImputerConfig()
    select: LassoSelectConfig = LassoSelectConfig()
    gbdt: GBDTConfig = GBDTConfig()
    svc: SVCConfig = SVCConfig()
    logreg: LogRegConfig = LogRegConfig()
    meta: LogRegConfig = LogRegConfig(penalty="l2")
    stacking: StackingConfig = StackingConfig()
    mesh: MeshConfig = MeshConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, Mapping):
                hints = typing.get_type_hints(tp)
                names = {f.name for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in names:
                        raise KeyError(f"unknown config key {k!r} for {tp.__name__}")
                    ftype = hints[k]
                    if dataclasses.is_dataclass(ftype):
                        v = build(ftype, v)
                    elif isinstance(v, list):
                        v = tuple(v)  # JSON has no tuples; all sequence fields are tuples
                    kwargs[k] = v
                return tp(**kwargs)
            return val

        return build(cls, dict(d))

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """5-fold CV hyperparameter sweep grid (BASELINE.json config 4)."""

    n_estimators_grid: Sequence[int] = (25, 50, 100, 200)
    max_depth_grid: Sequence[int] = (1, 2, 3)
    cv_folds: int = 5

"""The port's depth-1 GBDT fits off the fused path vs the JAX package's.

``GBDTConfig()`` is the reference member as the repo defaults it: the
'exact' splitter (every unique-value midpoint a candidate), depth 1, 100
stumps. The JAX package fits it on a replicated sorted layout
(``_fit_stumps``); the port runs the fused fit's stage loop over host bins,
so each stage's boundary sums come from a per-bin histogram and a cumulative
sum over bins — the same sums, added in another order. On the reference
cohort no split is tied in exact arithmetic, so the forests must be equal,
values and deviance paths at rtol 1e-10. (Where two candidates tied, the
summation order could pick either; ROADMAP's rule then holds deviance and
predictions instead of split indices. No case here needs it.)

Inputs come from ``make_cohort`` with a seed; the JAX side runs on the CPU
under x64 (``conftest.py``), its Pallas histogram kernel in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import GBDTConfig as JGBDTConfig
from machine_learning_replications_tpu.config import SweepConfig as JSweepConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import gbdt as jgbdt
from machine_learning_replications_tpu.models import sweep as jsweep
from machine_learning_replications_tpu.models import tree as jtree
from machine_learning_replications_tpu.ops import binning as jbinning
from machine_learning_replications_tpu.ops import histogram as jhist
from machine_learning_replications_tpu.ops.pallas_histogram import stump_histograms_pallas
from machine_learning_replications_tpu_torch.config import GBDTConfig, SweepConfig
from machine_learning_replications_tpu_torch.models import gbdt, sweep, tree
from machine_learning_replications_tpu_torch.ops import cuda_histogram, histogram

FOREST = ("feature", "threshold", "left", "right")


def _x17(n, seed):
    X, y, _ = make_cohort(n=n, seed=seed)
    return X[:, selected_indices()], y


@pytest.fixture(scope="module")
def cohort():
    return _x17(1427, 2020)


@pytest.fixture(scope="module")
def jax_exact(cohort):
    X, y = cohort
    return jgbdt.fit(X, y, JGBDTConfig())


def _assert_same_fit(got, aux, want, want_aux, X, rtol=1e-10):
    for name in FOREST:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=rtol, atol=1e-14)
    np.testing.assert_allclose(float(got.init_raw), float(want.init_raw), rtol=1e-14)
    assert got.max_depth == want.max_depth == 1
    assert isinstance(aux["train_deviance"], np.ndarray)
    np.testing.assert_allclose(aux["train_deviance"], want_aux["train_deviance"], rtol=rtol)
    np.testing.assert_allclose(tree.predict_proba1(got, torch.as_tensor(X)).numpy(),
                               np.asarray(jtree.predict_proba1(want, X)), rtol=rtol, atol=1e-14)


def test_exact_fit_matches_jax(cohort, jax_exact):
    """The reference member on the reference cohort: 1427 rows, so up to
    1427 bins per continuous column (int32 bins), 100 stages."""
    X, y = cohort
    got, aux = gbdt.fit(X, y, GBDTConfig(), device="cpu")
    _assert_same_fit(got, aux, *jax_exact, X)
    assert jbinning.bin_features(X, None).max_bins > 256


def test_exact_fit_backends_use_the_plain_version_on_cpu(cohort, jax_exact):
    """Every backend value is the plain histogram on a CPU tensor (the
    kernel's launch count does not move) and gives the same forest."""
    X, y = cohort
    before = dict(cuda_histogram.LAUNCHES)
    for backend in ("auto", "pallas", "matmul"):
        got, aux = gbdt.fit(X, y, GBDTConfig(histogram_backend=backend), device="cpu")
        _assert_same_fit(got, aux, *jax_exact, X)
    assert cuda_histogram.LAUNCHES == before


def test_exact_fit_float32_inputs(cohort):
    """The card's working type: float32 X and y keep the fit in float32 and
    choose the float64 fit's splits."""
    X, y = cohort
    cfg = GBDTConfig(n_estimators=30)
    p64, a64 = gbdt.fit(X, y, cfg, device="cpu")
    p32, a32 = gbdt.fit(X.astype(np.float32), y.astype(np.float32), cfg, device="cpu")
    assert p32.value.dtype == torch.float32 and a32["train_deviance"].dtype == np.float32
    np.testing.assert_array_equal(p32.feature.numpy(), p64.feature.numpy())
    np.testing.assert_allclose(a32["train_deviance"], a64["train_deviance"], rtol=1e-5)


def test_small_hist_depth1_fit_matches_jax():
    """'hist' at depth 1 below ``DEVICE_BINNING_MIN_ROWS``: host quantile
    midpoints (256 bins, u8), the same stage loop."""
    X, y = _x17(5000, 7)
    cfg = dict(splitter="hist", n_estimators=40)
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**cfg))
    got, aux = gbdt.fit(X, y, GBDTConfig(**cfg), device="cpu")
    _assert_same_fit(got, aux, want, want_aux, X)


@pytest.mark.parametrize("labels", ["binary", "soft"])
def test_fit_stump_host_matches_jax(labels):
    """``n_estimators == 1`` at device-binning scale with host inputs: the
    host single-stump engine (candidates from a systematic subsample above
    131,072 rows are not reached at 120,000; the label-histogram shortcut
    for binary labels, weighted bincounts for soft ones)."""
    X, y = _x17(120_000, 3)
    if labels == "soft":
        y = np.clip(y * 0.8 + 0.1 * np.random.default_rng(0).random(y.shape[0]), 0.0, 1.0)
    cfg = dict(splitter="hist", n_estimators=1)
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**cfg))
    got, aux = gbdt.fit(X, y, GBDTConfig(**cfg), device="cpu")
    for name in FOREST + ("value", "init_raw", "learning_rate"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    np.testing.assert_allclose(aux["train_deviance"], want_aux["train_deviance"], rtol=1e-12)
    assert bool(got.left[0, 0] == 1)  # the stump split


def test_fit_stump_host_subsamples_candidates():
    """Above 131,072 rows the candidates come from every second row (the
    JAX engine's systematic subsample): the same stump."""
    X, y = _x17(200_000, 4)
    cfg = dict(splitter="hist", n_estimators=1, n_bins=64)
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**cfg))
    got, aux = gbdt.fit(X, y, GBDTConfig(**cfg), device="cpu")
    for name in FOREST + ("value",):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    np.testing.assert_allclose(aux["train_deviance"], want_aux["train_deviance"], rtol=1e-12)


def test_fit_stump_host_rejects_nan():
    X, y = _x17(100_000, 5)
    X[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        gbdt.fit(X, y, GBDTConfig(splitter="hist", n_estimators=1), device="cpu")


def test_refit_best_depth1_winner_matches_jax():
    """A sweep whose winner is a depth-1 cell refits through the exact path."""
    X, y = _x17(600, 11)
    grid = dict(n_estimators_grid=(3, 6), max_depth_grid=(1,), cv_folds=3)
    want = jsweep.cv_sweep(X, y, JSweepConfig(**grid))
    got = sweep.cv_sweep(X, y, SweepConfig(**grid), device="cpu")
    assert got.best_max_depth == want.best_max_depth == 1
    assert got.best_n_estimators == want.best_n_estimators
    p_want, c_want = jsweep.refit_best(X, y, want)
    p_got, c_got = sweep.refit_best(X, y, got, device="cpu")
    assert dataclasses.asdict(c_got) == dataclasses.asdict(c_want)
    for name in FOREST:
        np.testing.assert_array_equal(getattr(p_got, name).numpy(), np.asarray(getattr(p_want, name)))
    np.testing.assert_allclose(p_got.value.numpy(), np.asarray(p_want.value), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("n,seed,cfg", [
    (300, 21, {}),
    (300, 22, {"learning_rate": 0.5}),
    (300, 23, {"min_samples_leaf": 7}),
    (300, 24, {"min_samples_leaf": 60}),
    (300, 25, {"min_samples_split": 120}),
    (300, 26, {"n_estimators": 1}),
    (80, 27, {}),
    (257, 28, {"learning_rate": 0.05}),
    (1000, 29, {"min_samples_leaf": 3, "learning_rate": 0.2}),
])
def test_exact_fit_options_match_jax(n, seed, cfg):
    """The exact stage loop under the leaf and split minimums, other
    learning rates, a single stage and cohorts of other sizes (B from below
    to above 256): the same forest as JAX."""
    X, y = _x17(n, seed)
    cfg = dict(n_estimators=25) | cfg
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**cfg))
    got, aux = gbdt.fit(X, y, GBDTConfig(**cfg), device="cpu")
    _assert_same_fit(got, aux, want, want_aux, X)


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
def test_stump_histograms_at_exact_bins_match_jax(cohort, val_dtype):
    """The stump histogram at the exact splitter's shape (int32 bins, B of
    the cohort's unique-value midpoints) vs JAX's Pallas kernel in interpret
    mode and its segment_sum branch."""
    X, y = cohort
    bins = jbinning.bin_features(X, None)
    B = bins.max_bins
    rng = np.random.default_rng(1)
    p = rng.uniform(0.05, 0.95, size=y.shape[0])
    g, h = (y - p).astype(val_dtype), (p * (1 - p)).astype(val_dtype)
    got = histogram.stump_histograms(torch.as_tensor(bins.binned), torch.as_tensor(g),
                                     torch.as_tensor(h), B)
    assert got.shape == (2, 17, B) and bins.binned.dtype == np.int32
    tol = 1e-9 if val_dtype == np.float64 else 1e-5
    for want in (stump_histograms_pallas(jnp.asarray(bins.binned), jnp.asarray(g),
                                         jnp.asarray(h), B),
                 jhist.stump_histograms(jnp.asarray(bins.binned), jnp.asarray(g),
                                        jnp.asarray(h), B, backend="xla")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)

"""The port's 1-NN imputer vs the JAX package's ``knn_impute``.

Donors and queries are made with numpy from a seed and handed to both
sides; the JAX side runs on the CPU under x64 (``conftest.py``). An imputed
value is a copied donor value, so equal outputs at 1e-12 mean the port chose
the JAX package's donor (the first nearest eligible one): the port takes the
argmin form for every pattern, the JAX package its top-K scan above 16
masked donor columns, and the tie-heavy trials hold the two together.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import ImputerConfig as JImputerConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import knn_impute as jknn
from machine_learning_replications_tpu.ops import linalg as jlinalg
from machine_learning_replications_tpu.utils.cv import (
    stratified_subsample_indices as jstratified_subsample_indices,
)
from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.config import ImputerConfig
from machine_learning_replications_tpu_torch.models import knn_impute
from machine_learning_replications_tpu_torch.ops import linalg
from machine_learning_replications_tpu_torch.utils.cv import stratified_subsample_indices

TOL = dict(rtol=1e-12, atol=1e-12)


def _both(donors, col_means=None):
    """The same imputer on both sides (fitted by JAX, bridged to the port)."""
    jp = jknn.KNNImputerParams(
        donors=jnp.asarray(donors),
        col_means=jnp.asarray(np.nanmean(donors, axis=0) if col_means is None else col_means))
    return jp, convert.knn_imputer_params_from_arrays(jp, device="cpu")


def _check(jp, p, Xq, **kw):
    want = np.asarray(jknn.transform(jp, jnp.asarray(Xq), **kw))
    got = knn_impute.transform(p, Xq, **kw)
    assert got.shape == Xq.shape and not np.isnan(got.numpy()).any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    return got


@pytest.fixture(scope="module")
def cohort():
    X, y, _ = make_cohort(n=1427, seed=2020, missing_rate=0.03)
    return X, y


def test_fit_matches_jax(cohort):
    X, y = cohort
    want = jknn.fit(jnp.asarray(X))
    got = knn_impute.fit(X, device="cpu")
    np.testing.assert_array_equal(got.donors.numpy(), np.asarray(want.donors))
    np.testing.assert_array_equal(got.col_means.numpy(), np.asarray(want.col_means))


@pytest.mark.parametrize("stratified", [False, True])
def test_fit_caps_donors_as_jax_does(cohort, stratified):
    X, y = cohort
    y = y if stratified else None
    want = jknn.fit(jnp.asarray(X), JImputerConfig(max_donors=300), seed=5, y=y)
    got = knn_impute.fit(X, ImputerConfig(max_donors=300), seed=5, y=y, device="cpu")
    assert got.donors.shape == (300, 64)
    np.testing.assert_array_equal(got.donors.numpy(), np.asarray(want.donors))
    np.testing.assert_array_equal(got.col_means.numpy(), np.asarray(want.col_means))


def test_stratified_subsample_indices_matches_jax():
    y = (np.random.default_rng(3).random(997) < 0.2).astype(float)
    for m, rows in ((100, None), (50, np.arange(0, 997, 3)), (2000, None)):
        np.testing.assert_array_equal(stratified_subsample_indices(y, m, rows, seed=9),
                                      jstratified_subsample_indices(y, m, rows, seed=9))


def test_mixed_missing_cohort_matches_jax(cohort):
    """The fit cohort imputed by itself: the NaN columns' donors hold NaN
    too, so every NaN column gets its own masked pass."""
    X, _ = cohort
    jp, p = _both(X)
    block = knn_impute.resolve_block_fn(p, X[np.isnan(X).any(axis=1)])
    assert block.dist_cols is None and len(block.masked_donor_cols) > 0
    _check(jp, p, X)


def test_contract_shaped_queries_use_dense_query_distances(cohort):
    """Contract rows: the 17 selected variables present, the other 47 fully
    missing — the ``dist_cols`` restriction through the dense-query
    distances."""
    X, _ = cohort
    jp, p = _both(X)
    rows = make_cohort(n=500, seed=8)[0]
    Xq = np.full_like(rows, np.nan)
    Xq[:, selected_indices()] = rows[:, selected_indices()]
    block = knn_impute.resolve_block_fn(p, Xq)
    assert block.dist_cols == tuple(sorted(selected_indices())) and len(block.nan_cols) == 47
    _check(jp, p, Xq)


def test_more_than_16_masked_donor_columns(cohort):
    """A pattern with more masked donor columns than the JAX package's
    argmin threshold (16): JAX takes its top-K scan, the port its argmin
    passes; the donors must agree."""
    rng = np.random.default_rng(21)
    donors = rng.normal(size=(300, 30))
    donors[rng.random(donors.shape) < 0.2] = np.nan
    donors[0] = 0.0
    Xq = rng.normal(size=(120, 30))
    Xq[rng.random(Xq.shape) < 0.5] = np.nan
    jp, p = _both(donors)
    assert len(knn_impute.resolve_block_fn(p, Xq).masked_donor_cols) > 16
    _check(jp, p, Xq)


def test_tie_heavy_integer_trials():
    """12 random trials with integer-valued features (exact distance ties
    everywhere), donor pools smaller than 8 and high missingness, mirroring
    ``tests/test_impute_svc.py``'s oracle trials: the first minimal donor
    index wins on both sides."""
    rng = np.random.default_rng(404)
    for trial in range(12):
        nd = int(rng.integers(3, 40))
        nq = int(rng.integers(2, 25))
        F = int(rng.integers(2, 9))
        donors = rng.integers(0, 3, size=(nd, F)).astype(float)
        Xq = rng.integers(0, 3, size=(nq, F)).astype(float)
        donors[rng.random(size=donors.shape) < rng.uniform(0.05, 0.5)] = np.nan
        Xq[rng.random(size=Xq.shape) < rng.uniform(0.1, 0.6)] = np.nan
        donors[0, :] = 0.0  # at least one complete donor row
        jp, p = _both(donors)
        want = np.asarray(jknn.transform(jp, jnp.asarray(Xq)))
        got = knn_impute.transform(p, Xq).numpy()
        np.testing.assert_allclose(got, want, err_msg=f"trial {trial}", **TOL)


def test_no_eligible_donor_falls_back_to_column_mean():
    donors = np.array([[1.0, np.nan], [2.0, np.nan], [np.nan, 5.0]])
    Xq = np.array([[1.1, np.nan], [np.nan, np.nan]])
    jp, p = _both(donors, col_means=np.array([1.5, 5.0]))
    got = _check(jp, p, Xq)
    # row 0 shares no coordinate with the one donor that has column 1
    assert got[0, 1] == 5.0


def test_complete_rows_pass_through_untouched(cohort):
    X, _ = cohort
    jp, p = _both(X)
    complete = X[~np.isnan(X).any(axis=1)][:50]
    Xq = np.concatenate([complete, X[np.isnan(X).any(axis=1)][:30]])
    before = Xq.copy()
    got = _check(jp, p, Xq)
    np.testing.assert_array_equal(Xq, before)  # the caller's array is not written
    np.testing.assert_array_equal(got[:50].numpy(), complete)
    np.testing.assert_array_equal(knn_impute.transform(p, complete).numpy(), complete)


def test_chunking_matches_one_block(cohort):
    X, _ = cohort
    jp, p = _both(X)
    got = _check(jp, p, X[:200], chunk_rows=7)
    np.testing.assert_array_equal(got.numpy(), knn_impute.transform(p, X[:200]).numpy())


def test_resolved_block_fn_and_donors(cohort):
    """A block resolved once serves later queries of its pattern; its
    ``donors`` are the indices whose values were copied."""
    X, _ = cohort
    jp, p = _both(X)
    Xq = X[np.isnan(X).any(axis=1)][:40]
    block = knn_impute.resolve_block_fn(p, Xq)
    got = knn_impute.transform(p, Xq, block_fn=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(jknn.transform(
        jp, jnp.asarray(Xq), block_fn=jknn.resolve_block_fn(jp, Xq))), **TOL)
    idx, ok = block.donors(p, torch.as_tensor(Xq))
    assert idx.shape == (40, len(block.nan_cols)) and bool(ok.all())
    for k, f in enumerate(block.nan_cols):
        miss = np.isnan(Xq[:, f])
        np.testing.assert_array_equal(got.numpy()[miss, f], X[idx[:, k].numpy(), f][miss])


def test_fit_transform(cohort):
    X, y = cohort
    jp, jout = jknn.fit_transform(jnp.asarray(X), JImputerConfig(chunk_rows=500))
    p, out = knn_impute.fit_transform(X, ImputerConfig(chunk_rows=500), device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("dense_query", [False, True])
def test_masked_distances_match_jax(dense_query):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, 9))
    y = rng.normal(size=(70, 9))
    y[rng.random(y.shape) < 0.3] = np.nan
    y[5] = np.nan                      # a donor that shares no coordinate
    if dense_query:
        x[3] = np.nan                  # an all-NaN (padding) query
        got = linalg.masked_pairwise_sq_dists_dense_query(torch.as_tensor(x), torch.as_tensor(y))
        want = jlinalg.masked_pairwise_sq_dists_dense_query(jnp.asarray(x), jnp.asarray(y))
    else:
        x[rng.random(x.shape) < 0.3] = np.nan
        got = linalg.masked_pairwise_sq_dists(torch.as_tensor(x), torch.as_tensor(y))
        want = jlinalg.masked_pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert np.isnan(got.numpy()[:, 5]).all()

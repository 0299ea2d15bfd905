"""The port's training solvers and their small companions vs the JAX package.

Covered: ``models/solvers`` (soft threshold, balanced weights, power
iteration, the FISTA driver, the raw and covariance-form lasso, LassoCV,
the L1 and L2 logistic regressions), ``models/feature_selection``,
``models/scaler.fit``, the CV-mask copies of ``utils/cv``, the tensor
metrics of ``utils/metrics``, ``obs/quality.build_reference_profile`` and
``data/matloader``. Inputs come from ``make_cohort`` or a seeded numpy
generator; the JAX side runs on the CPU under x64 (``conftest.py``), the
port with ``device="cpu"``. Tolerances: LassoCV's alpha grid at rtol 1e-12
and the same chosen alpha, its coefficients, intercept and MSE path at
1e-8; the L1-LR at 1e-8 (batched fold lanes against one-at-a-time lanes
too), the L2-LR at 1e-10; the rest at 1e-12 or exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import LassoSelectConfig as JLassoSelectConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data import matloader as jmatloader
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import feature_selection as jfs
from machine_learning_replications_tpu.models import scaler as jscaler
from machine_learning_replications_tpu.models import solvers as js
from machine_learning_replications_tpu.obs import quality as jquality
from machine_learning_replications_tpu.utils import cv as jcv
from machine_learning_replications_tpu.utils import metrics as jmetrics
from machine_learning_replications_tpu_torch.config import LassoSelectConfig
from machine_learning_replications_tpu_torch.data import matloader
from machine_learning_replications_tpu_torch.models import feature_selection, scaler, solvers
from machine_learning_replications_tpu_torch.obs import quality
from machine_learning_replications_tpu_torch.utils import cv, metrics


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The solvers step small tensors many times. Under the suite's xdist
    workers, which share the cores, one intra-op thread per worker keeps
    OpenMP and MKL threads from spinning against each other's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def cohort64():
    X, y, _ = make_cohort(n=300, seed=5)
    return X, y


def test_small_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=40)
    _close(solvers.soft_threshold(_t(x), 0.3), js.soft_threshold(jnp.asarray(x), 0.3), 0)
    y = (rng.random(40) < 0.3).astype(float)
    _close(solvers.balanced_class_weights(_t(y)), js.balanced_class_weights(jnp.asarray(y)), 1e-15)
    mask = (rng.random(40) < 0.7).astype(float)
    _close(solvers.balanced_class_weights_masked(_t(y), _t(mask)),
           js.balanced_class_weights_masked(jnp.asarray(y), jnp.asarray(mask)), 1e-15)
    A = rng.normal(size=(9, 9))
    G = A @ A.T
    _close(solvers._power_lmax(_t(G)), js._power_lmax(jnp.asarray(G)), 1e-12)
    # batched power iteration: each lane is its own matrix's
    Gs = np.stack([G, 2 * G + np.eye(9)])
    got = solvers._power_lmax(_t(Gs))
    for i in range(2):
        _close(got[i], js._power_lmax(jnp.asarray(Gs[i])), 1e-12)


@pytest.mark.parametrize("n_alphas,eps", [(100, 1e-3), (7, 1e-2)])
def test_alpha_grid_matches_jax(cohort64, n_alphas, eps):
    X, y = cohort64
    got = solvers.alpha_grid(_t(X), _t(y), n_alphas, eps)
    want = js.alpha_grid(jnp.asarray(X), jnp.asarray(y), n_alphas, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)


def test_raw_lasso_path_and_intercept_match_jax(cohort64):
    X, y = cohort64
    X, y = X[:120, :12], y[:120]
    mask = (np.random.default_rng(1).random(120) < 0.8).astype(float)
    alphas = np.asarray(js.alpha_grid(jnp.asarray(X), jnp.asarray(y), 8, 1e-2))
    want = js.lasso_path(jnp.asarray(X), jnp.asarray(y), jnp.asarray(alphas), jnp.asarray(mask))
    got = solvers.lasso_path(_t(X), _t(y), _t(alphas), _t(mask))
    _close(got, want, 1e-8)
    _close(solvers.lasso_intercept(_t(X), _t(y), got[-1], _t(mask)),
           js.lasso_intercept(jnp.asarray(X), jnp.asarray(y), want[-1], jnp.asarray(mask)), 1e-8)


def test_lasso_fold_stats_match_jax(cohort64):
    X, y = cohort64
    got = solvers.lasso_fold_stats(_t(X), _t(y), 7)
    want = js.lasso_fold_stats(jnp.asarray(X), jnp.asarray(y), 7)
    assert set(got) == set(want)
    for k in want:  # sums of products over ~43 rows, added in another order
        _close(got[k], want[k], 1e-10)
    assert solvers.fold_bounds(23, 5) == js.fold_bounds(23, 5)


@pytest.mark.parametrize("n,seed,cv_folds,n_alphas,eps",
                         [(713, 2020, 10, 100, 1e-3), (160, 5, 4, 25, 1e-2)])
def test_lasso_cv_matches_jax(n, seed, cv_folds, n_alphas, eps):
    """The first case is the reference's selection (713 development rows, 10
    folds, 100 alphas). FISTA stops a lane at ``delta < tol``; the port adds
    in another order than XLA, so where a lane's ``delta`` lands within
    rounding of ``tol`` it can stop one step apart (a ~tol-sized difference);
    on these inputs none does."""
    X, y, _ = make_cohort(n=n, seed=seed)
    kw = dict(cv_folds=cv_folds, n_alphas=n_alphas, eps=eps)
    coef, b, alpha_, alphas, mse = solvers.lasso_cv(_t(X), _t(y), **kw)
    jcoef, jb, jalpha_, jalphas, jmse = js.lasso_cv(jnp.asarray(X), jnp.asarray(y), **kw)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(jalphas), rtol=1e-12, atol=0)
    assert int(np.argmin(mse.numpy().mean(axis=1))) == int(np.argmin(np.asarray(jmse).mean(axis=1)))
    np.testing.assert_allclose(float(alpha_), float(jalpha_), rtol=1e-12)
    _close(coef, jcoef, 1e-8)
    _close(b, jb, 1e-8)
    _close(mse, jmse, 1e-8)
    assert mse.shape == (n_alphas, cv_folds)


def test_lasso_cv_float32_mean_shift():
    """Columns whose means dominate their spread (mean/std = 100): without
    the global mean shift the covariance-form centering cancels in float32
    (the JAX suite's ``test_lasso_cv_float32_with_large_feature_means``).
    The port's float32 fit holds to its float64 fit as the JAX one does."""
    rng = np.random.default_rng(3)
    n, f = 50_000, 20
    X = 100.0 + rng.normal(size=(n, f))
    w = np.zeros(f)
    w[:5] = [2.0, -1.5, 1.0, 0.6, -0.4]
    y = X @ w + 0.5 * rng.normal(size=n)
    ref = solvers.lasso_cv(_t(X), _t(y), cv_folds=10)
    got = solvers.lasso_cv(_t(X.astype(np.float32)), _t(y.astype(np.float32)), cv_folds=10)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-2)
    np.testing.assert_array_equal(feature_selection.select_top_k(got[0].numpy(), 5),
                                  feature_selection.select_top_k(ref[0].numpy(), 5))


@pytest.fixture(scope="module")
def lr_data():
    X, y, _ = make_cohort(n=400, seed=11)
    masks = (np.random.default_rng(2).random((4, 400)) < 0.75).astype(float)
    return X[:, selected_indices()], y, masks


@pytest.mark.parametrize("balanced,masked", [(True, False), (True, True), (False, True)])
def test_logreg_l1_matches_jax(lr_data, balanced, masked):
    X, y, masks = lr_data
    m = masks[0] if masked else None
    got = solvers.logreg_l1_fit(_t(X), _t(y), C=0.7, sample_mask=None if m is None else _t(m),
                                balanced=balanced)
    want = js.logreg_l1_fit(jnp.asarray(X), jnp.asarray(y), C=0.7,
                            sample_mask=None if m is None else jnp.asarray(m), balanced=balanced)
    _close(got.coef, want.coef, 1e-8)
    _close(got.intercept, want.intercept, 1e-8)


def test_logreg_l1_batched_lanes_equal_single_lanes(lr_data):
    """The stacking CV runs its L1-LR folds as lanes of one FISTA: each lane
    stops on its own and is frozen, so it equals its one-lane run."""
    X, y, masks = lr_data
    batched = solvers.logreg_l1_fit(_t(X), _t(y), sample_mask=_t(masks))
    assert batched.coef.shape == (4, 17) and batched.intercept.shape == (4,)
    for j in range(4):
        one = solvers.logreg_l1_fit(_t(X), _t(y), sample_mask=_t(masks[j]))
        _close(batched.coef[j], one.coef, 1e-8)
        _close(batched.intercept[j], one.intercept, 1e-8)


def test_fista_lanes_stop_on_their_own():
    """Lanes converge after different step counts; ``n_done`` counts each
    lane's own steps, and a frozen lane holds its value while others run."""
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5], [0.0, 0.0]], dtype=torch.float64)
    rate = torch.tensor([[0.9], [0.3], [0.5]], dtype=torch.float64)

    def prox_step(z):  # contracts each lane towards its target at its own rate
        return target + (1.0 - rate) * (z - target)

    w, n_done = solvers._fista_while(prox_step, torch.zeros(3, 2, dtype=torch.float64),
                                     1e-10, 500)
    assert len(set(n_done.tolist())) == 3
    for j in range(3):
        def one_lane(z, j=j):
            return target[j] + (1.0 - rate[j]) * (z - target[j])

        wj, nj = solvers._fista_while(one_lane, torch.zeros(2, dtype=torch.float64), 1e-10, 500)
        assert int(nj) == int(n_done[j])
        torch.testing.assert_close(w[j], wj, rtol=0, atol=0)


@pytest.mark.parametrize("balanced", [True, False])
def test_logreg_l2_matches_jax(balanced):
    X, y, _ = make_cohort(n=300, seed=13)
    X3 = 1.0 / (1.0 + np.exp(-(X[:, :3] - X[:, :3].mean(0)) / X[:, :3].std(0)))
    got = solvers.logreg_l2_fit(_t(X3), _t(y), C=1.3, balanced=balanced)
    want = js.logreg_l2_fit(jnp.asarray(X3), jnp.asarray(y), C=1.3, balanced=balanced)
    _close(got.coef, want.coef, 1e-10)
    _close(got.intercept, want.intercept, 1e-10)


def test_fit_select_matches_jax():
    X, y, _ = make_cohort(n=260, seed=7)
    kw = dict(cv_folds=5, n_alphas=30)
    mask, info = feature_selection.fit_select(X, y, LassoSelectConfig(**kw), device="cpu")
    jmask, jinfo = jfs.fit_select(X, y, JLassoSelectConfig(**kw))
    np.testing.assert_array_equal(mask, jmask)
    assert mask.sum() == 17 and "subsampled_from_rows" not in info
    np.testing.assert_allclose(info["alpha_"], jinfo["alpha_"], rtol=1e-12)
    _close(info["coef"], jinfo["coef"], 1e-8)
    # the row guard: a seeded stratified subsample, or a refusal
    sub = dict(kw, max_rows=150)
    mask, info = feature_selection.fit_select(X, y, LassoSelectConfig(**sub), device="cpu")
    jmask, jinfo = jfs.fit_select(X, y, JLassoSelectConfig(**sub))
    np.testing.assert_array_equal(mask, jmask)
    assert info["subsampled_from_rows"] == jinfo["subsampled_from_rows"] == 260
    with pytest.raises(ValueError, match="max_rows"):
        feature_selection.fit_select(X, y, LassoSelectConfig(max_rows=150, scale_policy="error"),
                                     device="cpu")


def test_select_top_k_ties_match_jax():
    coef = np.array([0.5, -0.5, 0.1, 0.5, 0.0, -0.1])
    for k in (1, 2, 3, 5):
        np.testing.assert_array_equal(feature_selection.select_top_k(coef, k),
                                      jfs.select_top_k(coef, k))


def test_scaler_fit_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(50, 6)) * [1, 2, 3, 4, 5, 0]      # a constant column → scale 1
    w = (rng.random((3, 50)) < 0.6).astype(float)
    for got, want in ((scaler.fit(_t(X)), jscaler.fit(jnp.asarray(X))),
                      (scaler.fit(_t(X), _t(w[0])), jscaler.fit(jnp.asarray(X), jnp.asarray(w[0])))):
        _close(got.mean, want.mean, 1e-14)
        _close(got.scale, want.scale, 1e-14)
    assert float(scaler.fit(_t(X)).scale[-1]) == 1.0
    # batched fold scalers: one call, each fold's own moments
    batched = scaler.fit(_t(X), _t(w))
    Xt = scaler.transform(batched, _t(X))
    assert Xt.shape == (3, 50, 6)
    for j in range(3):
        want = jscaler.fit(jnp.asarray(X), jnp.asarray(w[j]))
        _close(batched.mean[j], want.mean, 1e-14)
        _close(Xt[j], jscaler.transform(want, jnp.asarray(X)), 1e-13)


def test_cv_mask_copies_match_jax():
    y = (np.random.default_rng(6).random(57) < 0.3).astype(float)
    np.testing.assert_array_equal(cv.kfold_test_masks(57, 10), jcv.kfold_test_masks(57, 10))
    rows = (np.random.default_rng(7).random(57) < 0.7).astype(float)
    np.testing.assert_array_equal(cv.stratified_kfold_test_masks_within(y, 4, rows),
                                  jcv.stratified_kfold_test_masks_within(y, 4, rows))


@pytest.fixture(scope="module")
def scored():
    rng = np.random.default_rng(8)
    y = (rng.random(500) < 0.25).astype(float)
    s = np.clip(0.3 * y + rng.normal(0.35, 0.2, 500), 0, 1).round(2)   # rounded: ties
    return y, s


def test_metrics_match_jax(scored):
    y, s = scored
    jy, js_ = jnp.asarray(y), jnp.asarray(s)
    _close(metrics.roc_auc(y, s), jmetrics.roc_auc(jy, js_), 1e-14)
    _close(metrics.roc_auc(_t(y), _t(s)), jmetrics.roc_auc(jy, js_), 1e-14)
    for got, want in ((metrics.roc_curve(y, s), jmetrics.roc_curve(jy, js_)),
                      (metrics.precision_recall_curve(y, s),
                       jmetrics.precision_recall_curve(jy, js_))):
        for g, w in zip(got, want):
            _close(g, w, 1e-14)
    _close(metrics.average_precision(y, s), jmetrics.average_precision(jy, js_), 1e-14)
    yp = (s > 0.5).astype(float)
    rep, jrep = metrics.classification_report(y, yp), jmetrics.classification_report(jy, jnp.asarray(yp))
    for g, w in zip(rep, jrep):
        _close(g, w, 1e-6)
    assert metrics.report_text(rep) == jmetrics.report_text(jrep)
    _close(metrics.wald_ci_halfwidth(_t(0.8), 500), jmetrics.wald_ci_halfwidth(0.8, 500), 1e-15)
    np.testing.assert_allclose(metrics.roc_auc_batch_host(y, np.stack([s, 1 - s])),
                               jmetrics.roc_auc_batch_host(y, np.stack([s, 1 - s])), rtol=1e-14)


def test_reference_profile_matches_jax():
    X, y, _ = make_cohort(n=400, seed=9)
    X = X[:, :17]
    scores = np.random.default_rng(9).random(400)
    for labels in (y, None):
        got = quality.build_reference_profile(X, scores, y=labels)
        want = jquality.build_reference_profile(X, scores, y=labels)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="finite"):
        quality.build_reference_profile(np.full((3, 2), np.nan), np.zeros(3))


def test_matloader_round_trip_matches_jax(tmp_path):
    X, y, names = make_cohort(n=40, seed=10, missing_rate=0.1)
    path = str(tmp_path / "cohort.mat")
    matloader.save_data(path, X, y, names)
    got = matloader.load_data(path)
    want = jmatloader.load_data(path, backend="scipy")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], X)
    assert got[2].shape == want[2].shape

"""The port's SVC training and the stacking CV's meta-features vs the JAX package.

Covered: ``models/svm``'s training half (the box ∩ hyperplane projection,
the dual solver with its KKT check every ``_KKT_CHECK_EVERY`` steps, the
intercept, Platt's sigmoid fit, ``svc_fit``, ``svc_fit_masked``,
``scale_gamma``, ``trim_support``, ``predict_proba1_chunked``) and
``models/pipeline.cross_val_member_probas`` (its masked fold fits, the
scaled regime's subsampled folds, the batched and one-fold-at-a-time SVC
branches, and the per-fold-subset oracle ``cross_val_member_probas_loop``).

Inputs come from ``make_cohort`` or a seeded numpy generator, scaled by the
JAX scaler where an SVC takes them. The JAX side runs on the CPU under x64
(``conftest.py``), the port with ``device="cpu"``. Tolerances: dual
coefficients, intercepts, Platt's A and B and probabilities at 1e-6; the
meta-features at 1e-6; lanes of one batched solve against their one-lane
solves at 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import ExperimentConfig as JExperimentConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.models import scaler as jscaler
from machine_learning_replications_tpu.models import svm as jsvm
from machine_learning_replications_tpu.ops.linalg import rbf_kernel
from machine_learning_replications_tpu.utils.cv import stratified_kfold_test_masks
from machine_learning_replications_tpu_torch.config import ExperimentConfig
from machine_learning_replications_tpu_torch.models import pipeline, svm

TOL = 1e-6
SVC_FIELDS = ("dual_coef", "intercept", "prob_a", "prob_b", "gamma")


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
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _scaled(n, seed):
    X, y, _ = make_cohort(n=n, seed=seed)
    X = X[:, selected_indices()]
    sp = jscaler.fit(jnp.asarray(X))
    return np.array(jscaler.transform(sp, jnp.asarray(X))), y


@pytest.fixture(scope="module")
def data():
    return _scaled(200, 21)


@pytest.fixture(scope="module")
def dual(data):
    """K, s and per-sample C (balanced) of the scaled cohort."""
    Xt, y = data
    gamma = float(jsvm.scale_gamma(jnp.asarray(Xt)))
    K = np.asarray(rbf_kernel(jnp.asarray(Xt), jnp.asarray(Xt), gamma))
    s = 2.0 * y - 1.0
    C = np.where(y > 0.5, len(y) / (2.0 * y.sum()), len(y) / (2.0 * (len(y) - y.sum())))
    return K, s, C


def test_projection_matches_jax(dual):
    _, s, C = dual
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, s.shape[0])) * 2.0
    Cl = np.stack([C, 0.5 * C, C * (rng.random(C.shape) < 0.7)])
    got = svm._project_box_hyperplane(_t(v), _t(s)[None], _t(Cl))
    for j in range(3):
        want = jsvm._project_box_hyperplane(jnp.asarray(v[j]), jnp.asarray(s), jnp.asarray(Cl[j]))
        _close(got[j], want, 1e-12)
    assert float(torch.max(torch.abs(got @ _t(s)))) < 1e-9          # on the hyperplane
    assert bool(((got >= 0) & (got <= _t(Cl))).all())                # in the box


@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_solve_dual_matches_jax(dual, tol):
    K, s, C = dual
    want = jsvm.solve_dual(jnp.asarray(K), jnp.asarray(s), jnp.asarray(C), tol, 3000)
    iters = []
    got = svm.solve_dual(_t(K), _t(s), _t(C), tol, 3000, iterations=iters)
    _close(got, want)
    assert len(iters) == 1 and iters[0][0] % svm._KKT_CHECK_EVERY == 0
    _close(svm._intercept_from_alpha(_t(K), _t(s), _t(C), got),
           jsvm._intercept_from_alpha(jnp.asarray(K), jnp.asarray(s), jnp.asarray(C), want))


def test_dual_lanes_equal_single_solves(dual):
    """One batched solve over lanes that share K (the Platt folds): each lane
    stops on its own KKT check and is frozen, so it equals its one-lane
    solve; the lanes stop after different step counts here."""
    K, s, C = dual
    masks = 1.0 - stratified_kfold_test_masks((s > 0).astype(float), 4)
    Cl = np.concatenate([C[None], C[None] * masks])                 # [5, n]
    iters = []
    got = svm.solve_dual(_t(K), _t(s), _t(Cl), 1e-4, 3000, iterations=iters)
    assert len(set(iters[0])) > 1
    for j in range(Cl.shape[0]):
        one = svm.solve_dual(_t(K), _t(s), _t(Cl[j]), 1e-4, 3000)
        _close(got[j], one, 1e-10)
    _close(got[1], jsvm.solve_dual(jnp.asarray(K), jnp.asarray(s), jnp.asarray(Cl[1]), 1e-4, 3000))


def test_intercept_fallback_without_free_vectors(dual):
    """Every α at a bound: the midpoint of the KKT-feasible interval."""
    K, s, C = dual
    alpha = np.where(np.arange(s.shape[0]) % 3 == 0, C, 0.0)
    _close(svm._intercept_from_alpha(_t(K), _t(s), _t(C), _t(alpha)),
           jsvm._intercept_from_alpha(jnp.asarray(K), jnp.asarray(s), jnp.asarray(C),
                                      jnp.asarray(alpha)), 1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_platt_sigmoid_matches_jax(masked):
    rng = np.random.default_rng(5)
    y = (rng.random(300) < 0.3).astype(float)
    dec = np.where(y > 0.5, 1.0, -1.0) * 0.8 + rng.normal(size=300)
    mask = (rng.random(300) < 0.7).astype(float) if masked else None
    A, B = svm.platt_sigmoid_train(_t(dec), _t(y), None if mask is None else _t(mask))
    jA, jB = jsvm.platt_sigmoid_train(jnp.asarray(dec), jnp.asarray(y),
                                      None if mask is None else jnp.asarray(mask))
    _close(A, jA, 1e-10)
    _close(B, jB, 1e-10)
    # lanes: each its own fit, the line searches halving independently
    decs = np.stack([dec, 3.0 * dec, -0.5 * dec])
    Al, Bl = svm.platt_sigmoid_train(_t(decs), _t(y), None if mask is None else _t(mask))
    for j in range(3):
        a1, b1 = svm.platt_sigmoid_train(_t(decs[j]), _t(y), None if mask is None else _t(mask))
        _close(Al[j], a1, 1e-12)
        _close(Bl[j], b1, 1e-12)


@pytest.mark.parametrize("probability,gamma", [(True, None), (True, 0.05), (False, None)])
def test_svc_fit_matches_jax(data, probability, gamma):
    Xt, y = data
    kw = dict(C=1.0, gamma=gamma, probability=probability, platt_cv=5, tol=1e-3)
    got = svm.svc_fit(_t(Xt), _t(y), **kw)
    want = jsvm.svc_fit(jnp.asarray(Xt), jnp.asarray(y), **kw)
    for f in SVC_FIELDS:
        if probability or f not in ("prob_a", "prob_b"):
            _close(getattr(got, f), getattr(want, f))
    if probability:
        Xq = _scaled(300, 22)[0]
        _close(svm.predict_proba1(got, _t(Xq)), jsvm.predict_proba1(want, jnp.asarray(Xq)))
    else:
        assert bool(torch.isnan(got.prob_a)) and bool(torch.isnan(got.prob_b))


def test_svc_fit_masked_matches_jax_and_batches(data):
    """A fold fit: scaler-free masked rows, the masked 'scale' gamma and the
    nested Platt folds within the train rows. Three folds batched on a
    leading axis equal their one-fold fits."""
    from machine_learning_replications_tpu.utils.cv import stratified_kfold_test_masks_within

    Xt, y = data
    test = stratified_kfold_test_masks(y, 3)
    train = 1.0 - test
    platt = np.stack([stratified_kfold_test_masks_within(y, 3, tm) for tm in train])
    Xb = np.stack([Xt * (1.0 + 0.1 * j) for j in range(3)])        # per-fold inputs
    batched = svm.svc_fit_masked(_t(Xb), _t(y), _t(train), _t(platt), tol=1e-3)
    assert batched.dual_coef.shape == (3, Xt.shape[0]) and batched.prob_a.shape == (3,)
    for j in range(3):
        want = jsvm.svc_fit_masked(jnp.asarray(Xb[j]), jnp.asarray(y), jnp.asarray(train[j]),
                                   jnp.asarray(platt[j]), tol=1e-3)
        one = svm.svc_fit_masked(_t(Xb[j]), _t(y), _t(train[j]), _t(platt[j]), tol=1e-3)
        for f in SVC_FIELDS:
            _close(getattr(one, f), getattr(want, f))
            _close(getattr(batched, f)[j], getattr(one, f), 1e-10)
        excluded = test[j] > 0.5
        assert float(torch.abs(one.dual_coef[torch.as_tensor(excluded)]).max()) == 0.0


def test_scale_gamma_trim_and_chunked_predict(data):
    Xt, y = data
    _close(svm.scale_gamma(_t(Xt)), jsvm.scale_gamma(jnp.asarray(Xt)), 1e-14)
    fit = svm.svc_fit(_t(Xt), _t(y), tol=1e-3)
    trimmed = svm.trim_support(fit)
    jtrim = jsvm.trim_support(jsvm.svc_fit(jnp.asarray(Xt), jnp.asarray(y), tol=1e-3))
    assert trimmed.dual_coef.shape == jtrim.dual_coef.shape
    assert 0 < trimmed.dual_coef.shape[0] < Xt.shape[0]
    Xq = _scaled(300, 23)[0]
    full = svm.predict_proba1(fit, _t(Xq))
    _close(svm.predict_proba1(trimmed, _t(Xq)), full, 1e-12)
    chunked = svm.predict_proba1_chunked(fit, Xq, chunk_rows=64)
    assert isinstance(chunked, np.ndarray) and chunked.shape == (300,)
    _close(chunked, full.numpy(), 1e-12)


def _fast(svc=None, **kw):
    d = {"gbdt": {"n_estimators": 5}, "svc": {"platt_cv": 2, "max_iter": 400, **(svc or {})}}
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def cv_data():
    X, y, _ = make_cohort(n=1427, seed=2020)
    return np.asarray(X[:200, selected_indices()]), np.asarray(y[:200])


@pytest.mark.parametrize("svc", [{}, {"max_rows": 150}], ids=["masked", "subsampled"])
def test_cross_val_member_probas_matches_jax(cv_data, svc):
    Xs, ys = cv_data
    want = jpipeline.cross_val_member_probas(Xs, ys, JExperimentConfig.from_dict(_fast(svc)))
    got = pipeline.cross_val_member_probas(Xs, ys, ExperimentConfig.from_dict(_fast(svc)),
                                           device="cpu")
    assert got.shape == (200, 3)
    _close(got, want)


@pytest.mark.parametrize("svc", [{}, {"max_rows": 150}], ids=["masked", "subsampled"])
def test_svc_fold_branches_agree(cv_data, svc, monkeypatch):
    """Above the memory budget the SVC fold fits run one after another; the
    batched and the sequential branch give the same meta-features (the JAX
    suite's ``test_svc_fold_map_sequential_branch_matches_vmap`` bounds)."""
    Xs, ys = cv_data
    cfg = ExperimentConfig.from_dict(_fast(svc))
    batched = pipeline.cross_val_member_probas(Xs, ys, cfg, device="cpu").numpy()
    monkeypatch.setattr(pipeline, "_SVC_VMAP_BYTES_BUDGET", 1)
    sequential = pipeline.cross_val_member_probas(Xs, ys, cfg, device="cpu").numpy()
    np.testing.assert_allclose(sequential, batched, rtol=1e-6, atol=1e-9)


def test_masked_meta_features_match_the_loop_oracle():
    """The masked fold fan-out against the per-fold-subset construction, at
    the JAX suite's bounds (``test_vmapped_meta_features_match_loop``): the
    masked dual takes another step size than the subset's, and the fold
    GBDT bins on the full matrix's candidates."""
    X, y, _ = make_cohort(n=1427, seed=2020)
    Xs, ys = np.asarray(X[:200, selected_indices()]), np.asarray(y[:200])
    cfg = ExperimentConfig.from_dict({"gbdt": {"n_estimators": 10},
                                      "svc": {"platt_cv": 2, "tol": 1e-4}})
    meta_v = pipeline.cross_val_member_probas(Xs, ys, cfg, device="cpu").numpy()
    meta_l = pipeline.cross_val_member_probas_loop(Xs, ys, cfg, device="cpu")
    d = np.abs(meta_v - meta_l)
    assert d[:, 0].max() < 6e-3, f"svc meta diff {d[:, 0].max()}"
    assert d[:, 1].max() < 6e-3, f"gbdt meta diff {d[:, 1].max()}"
    assert d[:, 2].max() < 1e-7, f"logreg meta diff {d[:, 2].max()}"
    assert ((meta_v > 0) & (meta_v < 1)).all()

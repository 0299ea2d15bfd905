"""The port's stacked forward step vs the JAX package's.

Parameters come from ``pipeline.fit_stacking`` on ``make_cohort(n=160,
seed=0)`` with 5 stumps and 2-fold Platt CV (the flagship-parameter
fallback of ``__graft_entry__``), bridged through ``convert.py``. Outputs
are held at ``serve.engine.parity_tolerance()`` (1e-12 relative under the
suite's x64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import ExperimentConfig
from machine_learning_replications_tpu.config import GBDTConfig as JGBDTConfig
from machine_learning_replications_tpu.config import SVCConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import gbdt as jgbdt
from machine_learning_replications_tpu.models import linear as jlinear
from machine_learning_replications_tpu.models import pipeline
from machine_learning_replications_tpu.models import scaler as jscaler
from machine_learning_replications_tpu.models import stacking as jstacking
from machine_learning_replications_tpu.models import svm as jsvm
from machine_learning_replications_tpu.models import tree as jtree
from machine_learning_replications_tpu.serve.engine import parity_tolerance
from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.models import linear, scaler, stacking, svm, tree


@pytest.fixture(scope="module")
def jax_params():
    X, y, _ = make_cohort(n=160, seed=0)
    cfg = ExperimentConfig(gbdt=JGBDTConfig(n_estimators=5), svc=SVCConfig(platt_cv=2))
    return pipeline.fit_stacking(X[:, selected_indices()], y, cfg)


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.stacking_params_from_arrays(jax_params, device="cpu")


def _entry_batch():
    """The ``__graft_entry__.entry()`` example batch: [64, 17] float32."""
    X = np.asarray(np.random.default_rng(0).normal(size=(64, 17)), dtype=np.float32)
    X[:, :13] = (X[:, :13] > 0.5).astype(np.float32)
    return X


def _cohort_batch():
    return make_cohort(n=500, seed=3)[0][:, selected_indices()]


BATCHES = {"entry": _entry_batch, "cohort": _cohort_batch}


def _close(got, want):
    rtol, atol = parity_tolerance()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_predict_proba1_with_members_matches_jax(jax_params, params, batch):
    X = BATCHES[batch]()
    p1, members = stacking.predict_proba1_with_members(params, X, device="cpu")
    want_p1, want_m = jstacking.predict_proba1_with_members(jax_params, X)
    assert p1.shape == (X.shape[0],) and members.shape == (X.shape[0], 3)
    _close(p1, want_p1)
    _close(members, want_m)


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_predict_proba_matches_jax(jax_params, params, batch):
    X = BATCHES[batch]()
    got = stacking.predict_proba(params, X, device="cpu")
    _close(got, jstacking.predict_proba(jax_params, X))
    _close(stacking.predict_proba1(params, torch.as_tensor(X), device="cpu"),
           jstacking.predict_proba1(jax_params, X))


def test_members_match_jax(jax_params, params):
    X = _cohort_batch()
    Xt = torch.as_tensor(X)
    _close(scaler.transform(params.scaler, Xt), jscaler.transform(jax_params.scaler, X))
    _close(linear.predict_proba1(params.logreg, Xt),
           jlinear.predict_proba1(jax_params.logreg, X))
    _close(tree.apply(params.gbdt, Xt), jtree.apply(jax_params.gbdt, X))
    Xs = scaler.transform(params.scaler, Xt)
    _close(svm.decision_function(params.svc, Xs),
           jsvm.decision_function(jax_params.svc, jscaler.transform(jax_params.scaler, X)))


def test_binary_coupling_matches_jax():
    """All 100 iterations with the per-lane done mask, over the whole
    clipped range (lanes converge at different iterations)."""
    r0 = np.concatenate([np.linspace(1e-7, 1 - 1e-7, 997), [0.5, 0.3, 0.9999]])
    got = svm._binary_coupling(torch.as_tensor(r0))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsvm._binary_coupling(jnp.asarray(r0))),
                               rtol=1e-12, atol=1e-15)
    # the coupling is not the closed form: it stops early, off 1 - r0
    assert np.abs(got.numpy() - (1 - r0)).max() > 1e-4


def test_depth2_forest_matches_jax():
    """The generic descent branch of ``tree.apply`` on a depth-2 forest."""
    X, y, _ = make_cohort(n=1427, seed=2020)
    X = X[:, selected_indices()]
    jp, _ = jgbdt.fit(X, y, JGBDTConfig(n_estimators=5, max_depth=2))
    tp = convert.tree_params_from_arrays(jp, device="cpu")
    assert tp.max_depth == 2 and tp.feature.shape == (5, 7)
    _close(tree.predict_proba1(tp, torch.as_tensor(X)), jtree.predict_proba1(jp, X))
    _close(tree.apply_one_tree(tp.feature[1], tp.threshold[1], tp.left[1], tp.right[1],
                               tp.value[1], torch.as_tensor(X), 2),
           jtree.apply_one_tree(jp.feature[1], jp.threshold[1], jp.left[1], jp.right[1],
                                jp.value[1], jnp.asarray(X), 2))


def test_convert_accepts_dicts_and_keeps_dtypes(jax_params, params):
    as_dict = {
        f.name: (dataclasses.asdict(getattr(jax_params, f.name))
                 if f.name != "quality" else None)
        for f in dataclasses.fields(jax_params)
    }
    from_dict = convert.stacking_params_from_arrays(as_dict, device="cpu")
    for a, b in ((from_dict.gbdt.value, params.gbdt.value),
                 (from_dict.svc.support_vectors, params.svc.support_vectors)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert params.gbdt.feature.dtype == torch.int32
    assert params.svc.gamma.dtype == torch.float64
    f32 = convert.stacking_params_from_arrays(jax_params, device="cpu", dtype=torch.float32)
    assert f32.meta.coef.dtype == torch.float32 and f32.gbdt.left.dtype == torch.int32


def test_params_must_lie_on_the_requested_device(params):
    moved = convert.params_to(params, "cpu")
    assert moved.svc.support_vectors.device.type == "cpu"
    assert moved.gbdt.max_depth == params.gbdt.max_depth
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params_to"):
            stacking.predict_proba(params, _entry_batch(), device="cuda")

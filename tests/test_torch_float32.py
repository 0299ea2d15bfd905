"""Float32 fits of the port against JAX on the CPU: the card's working type.

The port's other fit tests run float64 against the x64 oracle; on the card
the fits run float32, held there only to the port's own plain versions.
Here the same float32 cohort goes through JAX's ``gbdt.fit`` / ``cv_sweep``
and the port's. Under x64 JAX keeps float32 inputs float32 where its fit
is float32 (the fused depth-1 path); its exact and small-'hist' stage loops
promote to float64, while the port stays float32. So the two are held at
model level, not split by split (ROADMAP: float32 regrouping may flip a
near tie): the deviance path, the probabilities and the AUC, each at a
stated tolerance; the sweep's mean-AUC grid and chosen cell at the
bench's AUC gate.
"""

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
from machine_learning_replications_tpu_torch.config import GBDTConfig, SweepConfig
from machine_learning_replications_tpu_torch.models import gbdt, sweep, tree
from machine_learning_replications_tpu_torch.utils import metrics

#: (deviance rtol, probability atol, AUC tolerance) per route. The exact and
#: small-'hist' loops (port float32, JAX float64) differ by float32 rounding
#: alone; the fused loop runs float32 on both sides with sums in other
#: orders: the bench's own deviance gate, rtol 1e-4.
TOL = {"exact": (1e-5, 1e-5, 1e-4), "hist": (1e-5, 1e-5, 1e-4), "fused": (1e-4, 1e-4, 1e-3)}
#: The sweep's mean-AUC grid and best cell: the bench's AUC gate.
AUC_GATE = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def x17_f32():
    X, y, _ = make_cohort(n=5000, seed=7)
    return (np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32),
            y.astype(np.float32))


@pytest.mark.parametrize("route,rows,cfg", [
    ("exact", 1427, dict(n_estimators=30)),
    ("hist", 5000, dict(splitter="hist", n_estimators=30)),
    ("fused", 5000, dict(splitter="hist", n_estimators=30, histogram_backend="xla")),
])
def test_depth1_fit_float32_matches_jax(x17_f32, monkeypatch, route, rows, cfg):
    X, y = x17_f32[0][:rows], x17_f32[1][:rows]
    if route == "fused":     # the fused path at test size, as tests/test_gbdt_train.py runs it
        monkeypatch.setattr(jgbdt, "DEVICE_BINNING_MIN_ROWS", 1)
        monkeypatch.setattr(gbdt, "DEVICE_BINNING_MIN_ROWS", 1)
    assert gbdt.uses_fused_hist1(GBDTConfig(**cfg), rows) == (route == "fused")
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**cfg))
    got, aux = gbdt.fit(X, y, GBDTConfig(**cfg), device="cpu")
    assert got.value.dtype == torch.float32 and got.max_depth == 1
    dev_rtol, p_atol, auc_tol = TOL[route]
    dk = np.asarray(aux["train_deviance"], np.float64)
    np.testing.assert_allclose(dk, np.asarray(want_aux["train_deviance"], np.float64),
                               rtol=dev_rtol)
    assert dk.shape == (cfg["n_estimators"],) and dk[-1] < dk[0]
    p1 = tree.predict_proba1(got, torch.as_tensor(X)).numpy().astype(np.float64)
    jp1 = np.array(jtree.predict_proba1(want, X), np.float64)
    np.testing.assert_allclose(p1, jp1, rtol=0, atol=p_atol)
    assert abs(float(metrics.roc_auc(y, p1)) - float(metrics.roc_auc(y, jp1))) <= auc_tol


def test_cv_sweep_float32_matches_jax(x17_f32):
    X, y = x17_f32[0][:2000], x17_f32[1][:2000]
    grid = dict(n_estimators_grid=(5, 10), max_depth_grid=(1, 2), cv_folds=3)
    want = jsweep.cv_sweep(X, y, JSweepConfig(**grid))
    got = sweep.cv_sweep(X, y, SweepConfig(**grid), device="cpu")
    assert np.asarray(got.mean_auc).shape == np.asarray(want.mean_auc).shape == (2, 2)
    np.testing.assert_allclose(got.mean_auc, want.mean_auc, rtol=0, atol=AUC_GATE)
    np.testing.assert_allclose(got.fold_auc, want.fold_auc, rtol=0, atol=AUC_GATE)
    assert abs(got.best_mean_auc - want.best_mean_auc) <= AUC_GATE
    assert 0.5 < got.best_mean_auc <= 1.0

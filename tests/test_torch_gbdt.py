"""The port's fused depth-1 GBDT fit vs the JAX package's ``gbdt.fit``.

Both sides fit the same ``make_cohort`` X17 with the fused-path row gate
dropped to 1 (as ``tests/test_gbdt_train.py`` does), so the fused route
runs at test size. On the CPU the port's histogram pass is the kernel's
plain version, which sums in the same order as JAX's segment_sum: the
forest structure must be identical, leaf values agree to 1e-9.

The fit through the kernel itself needs the card: it is in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import GBDTConfig as JGBDTConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import gbdt as jgbdt
from machine_learning_replications_tpu.models import tree as jtree
from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.models import gbdt, tree


@pytest.fixture(scope="module")
def x17():
    X, y, _ = make_cohort(n=1427, seed=2020)
    return X[:, selected_indices()], y


@pytest.fixture
def fused_gate(monkeypatch):
    monkeypatch.setattr(jgbdt, "DEVICE_BINNING_MIN_ROWS", 1)
    monkeypatch.setattr(gbdt, "DEVICE_BINNING_MIN_ROWS", 1)


@pytest.fixture(scope="module")
def jax_fit(x17):
    X, y = x17
    mp = pytest.MonkeyPatch()
    mp.setattr(jgbdt, "DEVICE_BINNING_MIN_ROWS", 1)
    try:
        return jgbdt.fit(X, y, JGBDTConfig(n_estimators=8, splitter="hist", n_bins=32,
                                           histogram_backend="xla"))
    finally:
        mp.undo()


@pytest.mark.parametrize("backend", ["xla", "auto", "pallas", "matmul"])
def test_fused_fit_matches_jax(x17, jax_fit, fused_gate, backend):
    X, y = x17
    want, want_aux = jax_fit
    got, aux = gbdt.fit(
        X, y, GBDTConfig(n_estimators=8, splitter="hist", n_bins=32,
                         histogram_backend=backend),
        device="cpu",
    )
    for name in ("feature", "threshold", "left", "right"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(aux["train_deviance"].numpy(),
                               np.asarray(want_aux["train_deviance"]), rtol=1e-6)
    np.testing.assert_allclose(float(got.init_raw), float(want.init_raw), rtol=1e-12)
    assert got.max_depth == 1
    np.testing.assert_allclose(
        tree.predict_proba1(got, torch.as_tensor(X)).numpy(),
        np.asarray(jtree.predict_proba1(want, X)), rtol=1e-9, atol=1e-12,
    )


def test_fused_fit_float32_inputs(x17, fused_gate):
    """The card's working type: float32 X/y keep the whole fit in float32
    (u8 bins, float32 statistics) and land close to the float64 fit."""
    X, y = x17
    cfg = GBDTConfig(n_estimators=8, splitter="hist", n_bins=32)
    p32, a32 = gbdt.fit(X.astype(np.float32), y.astype(np.float32), cfg, device="cpu")
    p64, a64 = gbdt.fit(X, y, cfg, device="cpu")
    assert p32.value.dtype == torch.float32 and p32.feature.dtype == torch.int32
    np.testing.assert_array_equal(p32.feature.numpy(), p64.feature.numpy())
    np.testing.assert_allclose(a32["train_deviance"].numpy(), a64["train_deviance"].numpy(),
                               rtol=1e-5)


def test_fused_fit_rejects_nan(x17, fused_gate):
    X, y = x17
    Xn = X.copy()
    Xn[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        gbdt.fit(Xn, y, GBDTConfig(n_estimators=2, splitter="hist", n_bins=32), device="cpu")


@pytest.mark.parametrize("cfg,match", [
    # every depth-1 regime is ported since: each fit matches JAX
    (GBDTConfig(splitter="exact", n_estimators=8), "_fit_stumps"),
    (GBDTConfig(splitter="hist", max_depth=2, n_estimators=8, n_bins=32), None),  # _fit_binned
    (GBDTConfig(splitter="hist", n_estimators=1), "_fit_stump_host"),
])
def test_unported_regimes_raise(x17, fused_gate, cfg, match):
    """Each regime that once raised now fits (``match`` names its engine, the
    grower's case kept as None, its id since slice 2) and matches the JAX fit:
    forest equal, values and deviance at 1e-9."""
    X, y = x17
    got, aux = gbdt.fit(X, y, cfg, device="cpu")
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**dataclasses.asdict(cfg)))
    for name in ("feature", "threshold", "left", "right"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=f"{match} {name}")
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-9, atol=1e-12)
    assert isinstance(aux["train_deviance"], np.ndarray)
    np.testing.assert_allclose(aux["train_deviance"], want_aux["train_deviance"], rtol=1e-9)


def test_small_hist_fit_names_unported_path(x17):
    """'hist' at depth 1 below ``DEVICE_BINNING_MIN_ROWS`` takes the
    host-binned stump path (it raised before that path was ported) and
    matches the JAX fit."""
    X, y = x17
    cfg = GBDTConfig(splitter="hist", n_estimators=20)
    got, aux = gbdt.fit(X, y, cfg, device="cpu")
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(**dataclasses.asdict(cfg)))
    for name in ("feature", "threshold"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(aux["train_deviance"], want_aux["train_deviance"], rtol=1e-9)


def test_resolve_backend():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert gbdt.resolve_backend(GBDTConfig(histogram_backend="auto"), cpu) == "xla"
    assert gbdt.resolve_backend(GBDTConfig(histogram_backend="auto"), cuda) == "pallas"
    for b in ("pallas", "xla", "matmul"):
        assert gbdt.resolve_backend(GBDTConfig(histogram_backend=b), cuda) == b
    with pytest.raises(ValueError, match="histogram_backend"):
        gbdt.resolve_backend(GBDTConfig(histogram_backend="cuda"), cpu)


def test_uses_fused_hist1_matches_jax():
    for cfg_kw in ({}, {"splitter": "hist"}, {"splitter": "hist", "max_depth": 2}):
        for n in (99_999, 100_000):
            assert gbdt.uses_fused_hist1(GBDTConfig(**cfg_kw), n) == jgbdt.uses_fused_hist1(
                JGBDTConfig(**cfg_kw), n)


def test_forest_to_params_matches_jax():
    rng = np.random.default_rng(4)
    feature = rng.integers(0, 17, size=(6, 7)).astype(np.int32)
    threshold = rng.normal(size=(6, 7))
    value = rng.normal(size=(6, 7))
    is_split = rng.random((6, 7)) < 0.5
    want = jgbdt.forest_to_params(feature, threshold, value, is_split,
                                  init_raw=np.asarray(-1.3), learning_rate=0.1, max_depth=2)
    got = gbdt.forest_to_params(*(torch.as_tensor(a) for a in (feature, threshold, value,
                                                              is_split)),
                                init_raw=torch.tensor(-1.3, dtype=torch.float64),
                                learning_rate=0.1, max_depth=2)
    for name in ("feature", "threshold", "left", "right", "value", "init_raw",
                 "learning_rate"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.max_depth == want.max_depth

"""The port's level-wise GBDT grower and its paths vs the JAX package.

Node histograms, split search, host binning, ``gbdt.fit`` at depth 2 and
3, ``gbdt.fit_folds``, ``sweep.cv_sweep`` and ``sweep.refit_best``. Inputs
come from ``np.random.default_rng`` or ``make_cohort`` and go to both sides;
JAX runs on the CPU under x64 (``conftest.py``), its Pallas node kernel in
interpret mode. On the CPU every histogram backend of the port is the
kernel's plain float64 version and the split search adds in XLA's order, so
forests must be equal exactly, values and deviance to 1e-9, fold AUCs to
1e-12. The node kernel itself needs the card: ``tests/test_torch_cuda.py``.
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
from machine_learning_replications_tpu.ops.pallas_histogram import node_histograms_pallas
from machine_learning_replications_tpu.utils.cv import stratified_kfold_test_masks as jmasks
from machine_learning_replications_tpu_torch.config import GBDTConfig, SweepConfig
from machine_learning_replications_tpu_torch.models import gbdt, sweep, tree
from machine_learning_replications_tpu_torch.ops import binning, cuda_histogram, histogram
from machine_learning_replications_tpu_torch.utils.cv import stratified_kfold_test_masks

FOREST = ("feature", "threshold", "left", "right")
STATS = ("grad", "hess", "grad2", "count")
CFG = dict(splitter="hist", n_bins=32, n_estimators=8, histogram_backend="xla")


@pytest.fixture(scope="module")
def x17():
    X, y, _ = make_cohort(n=1427, seed=2020)
    return X[:, selected_indices()], y


def _assert_forest_equal(got, want):
    for name in FOREST:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.init_raw.numpy(), np.asarray(want.init_raw), rtol=1e-12)
    assert got.max_depth == want.max_depth


def _node_inputs(seed, n, F, K, B):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(n, F)).astype(np.int32)
    node = rng.integers(-1, K, size=n).astype(np.int32)
    return binned, node, rng.normal(size=n), rng.uniform(0.01, 0.25, size=n)


@pytest.mark.parametrize("n,F,K,B", [(500, 17, 1, 4), (1000, 17, 4, 16), (257, 3, 8, 33),
                                     (64, 1, 2, 256)])
def test_node_histograms_match_jax(n, F, K, B):
    args = _node_inputs(n + K, n, F, K, B)
    got = histogram.node_histograms(*(torch.as_tensor(a) for a in args), K, B)
    jargs = [jnp.asarray(a) for a in args]
    for name, want in (("pallas", node_histograms_pallas(*jargs, K, B)),
                       ("xla", jhist.node_histograms(*jargs, K, B))):
        for stat in STATS:
            assert getattr(got, stat).shape == (K, F, B)
            np.testing.assert_allclose(getattr(got, stat).numpy(), np.asarray(getattr(want, stat)),
                                       rtol=1e-9, atol=1e-9, err_msg=f"{name} {stat}")
    before = dict(cuda_histogram.LAUNCHES)
    via_wrapper = cuda_histogram.node_histograms_cuda(*(torch.as_tensor(a) for a in args), K, B)
    assert cuda_histogram.LAUNCHES == before  # a CPU tensor takes the plain version
    for stat in STATS:
        torch.testing.assert_close(getattr(via_wrapper, stat), getattr(got, stat), rtol=0, atol=0)


def test_node_histograms_all_rows_inactive():
    binned, _, g, h = _node_inputs(1, 100, 5, 2, 8)
    node = np.full(100, -1, np.int32)
    got = histogram.node_histograms(*(torch.as_tensor(a) for a in (binned, node, g, h)), 2, 8)
    for stat in STATS:
        assert not getattr(got, stat).any(), stat


@pytest.mark.parametrize("per_fold_bins", [False, True])
def test_node_histograms_fold_axis_equals_each_fold(per_fold_bins):
    """k fits in one call (the grower's fold axis) equal k single calls."""
    k, n, F, K, B = 3, 300, 4, 4, 16
    rng = np.random.default_rng(9)
    binned = rng.integers(0, B, size=(k, n, F) if per_fold_bins else (n, F)).astype(np.int32)
    node = rng.integers(-1, K, size=(k, n)).astype(np.int32)
    g, h = rng.normal(size=(k, n)), rng.uniform(0.01, 0.25, size=(k, n))
    t = [torch.as_tensor(a) for a in (binned, node, g, h)]
    got = histogram.node_histograms(*t, K, B)
    for i in range(k):
        one = histogram.node_histograms(t[0][i] if per_fold_bins else t[0], t[1][i], t[2][i],
                                        t[3][i], K, B)
        for stat in STATS:
            torch.testing.assert_close(getattr(got, stat)[i], getattr(one, stat), rtol=0, atol=0)


@pytest.mark.parametrize("B", [2, 16, 33, 256])
def test_best_splits_match_jax(B):
    """Split search over real node histograms; duplicated features with
    other bin layouts make gains that tie in exact arithmetic, which both
    sides must break alike."""
    rng = np.random.default_rng(B)
    n, K = 800, 4
    base = rng.integers(0, B, size=(n, 3))
    binned = np.concatenate([base, base // 2, np.minimum(base, B // 2)], axis=1).astype(np.int32)
    node = rng.integers(-1, K, size=n).astype(np.int32)
    g, h = rng.normal(size=n), rng.uniform(0.01, 0.25, size=n)
    thr = np.sort(rng.normal(size=(9, B - 1)), axis=1)
    thr[4, B // 2:] = np.inf
    want_h = jhist.node_histograms(*(jnp.asarray(a) for a in (binned, node, g, h)), K, B)
    hists = histogram.NodeHistograms(*(torch.as_tensor(np.array(a)) for a in want_h))
    want = jhist.best_splits(want_h, jnp.asarray(thr), 2, 3)
    got = histogram.best_splits(hists, torch.as_tensor(thr), 2, 3)
    for name in ("do_split", "feature", "boundary", "threshold", "gain"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # With a fit axis and one threshold table per fit: each fit alone.
    stacked = histogram.NodeHistograms(*(torch.stack([a, a.flip(0)]) for a in hists))
    thr2 = torch.as_tensor(np.stack([thr, thr[:, ::-1].copy()]))
    both = histogram.best_splits(stacked, thr2, 2, 3)
    for i in range(2):
        one = histogram.best_splits(histogram.NodeHistograms(*(a[i] for a in stacked)),
                                    thr2[i], 2, 3)
        for name in ("do_split", "feature", "boundary", "threshold", "gain"):
            torch.testing.assert_close(getattr(both, name)[i], getattr(one, name), rtol=0, atol=0)


@pytest.mark.parametrize("n", [3, 16, 17, 33, 100, 256, 257, 600])
def test_xla_order_sums_match_jax_bit_for_bit(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(3, 5, n)) * np.exp(3 * rng.normal(size=(3, 5, n)))
    np.testing.assert_array_equal(histogram.xla_cumsum(torch.as_tensor(a)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(a), axis=-1)))
    np.testing.assert_array_equal(histogram.xla_sum(torch.as_tensor(a)).numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(a), axis=-1)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_bins", [None, 2, 32, 256])
def test_host_binning_matches_jax_bit_for_bit(x17, dtype, n_bins):
    X = x17[0].astype(dtype)
    X[:, -1] += np.random.default_rng(3).normal(size=X.shape[0]).astype(dtype)  # continuous
    got, want = binning.bin_features(X, n_bins), jbinning.bin_features(X, n_bins)
    for name in ("binned", "thresholds", "n_bins"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert binning.feature_bin_counts(got) == jbinning.feature_bin_counts(want)
    X2 = X[::-1] * 1.5
    for nb in (None, got.n_bins):
        np.testing.assert_array_equal(binning.rebin_with_thresholds(X2, got.thresholds, nb),
                                      jbinning.rebin_with_thresholds(X2, want.thresholds, nb))
    Xn = X.copy()
    Xn[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        binning.bin_features(Xn, n_bins)


def test_device_binning_matches_jax(x17):
    X = x17[0]
    got = binning.bin_features_device(torch.as_tensor(X), 32)
    want = jbinning.bin_features_device(X, 32)
    np.testing.assert_array_equal(got.binned.numpy(), np.asarray(want.binned))
    np.testing.assert_array_equal(got.thresholds.numpy(), np.asarray(want.thresholds))
    np.testing.assert_array_equal(got.n_bins, want.n_bins)
    assert got.max_bins == want.max_bins
    Xn = X.copy()
    Xn[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        binning.bin_features_device(torch.as_tensor(Xn), 32)


@pytest.mark.parametrize("F,S,kb,itemsize,row_bytes,want", [
    # Without a staging ring: the tiles alone.
    (17, 2, 256, 4, (), (17, 256, 1024)),          # the fused fit's stump pass: one tile
    (17, 4, 4 * 256, 4, (), (9, 1024, 1024)),      # depth 3's last level: 2 feature tiles
    (17, 4, 4 * 256, 8, (), (6, 1024, 1024)),      # the same in float64: 3 feature tiles
    (17, 4, 64 * 256, 4, (), (1, 8192, 1024)),     # one feature alone is over: cell ranges
    (3, 2, 1 << 16, 8, (), (1, 13108, 1024)),      # a 65536-bin float64 stump: 5 cell ranges
    # With the ring of the main path's launches reserved (bins, node ids, g, h).
    (17, 2, 256, 4, (17, 4, 4), (17, 256, 1024)),           # stump, u8 bins
    (17, 4, 4 * 256, 4, (17, 4, 4, 4), (9, 1024, 1024)),    # depth 3, int32 nodes: 2 tiles
    (17, 4, 4 * 256, 8, (17, 4, 8, 8), (6, 1024, 256)),     # float64: fewer rows keep 3 tiles
    (17, 4, 4 * 256, 4, (68, 4, 4, 4), (9, 1024, 512)),     # int32 bins: 2 tiles at 512 rows
    (17, 4, 64 * 256, 4, (17, 4, 4, 4), (1, 8192, 1024)),   # K = 64: cell ranges
    (3, 2, 1 << 16, 8, (12, 8, 8), (1, 13108, 256)),        # 65536 bins: 5 ranges at 256 rows
])
def test_tile_plan_fits_the_budget(F, S, kb, itemsize, row_bytes, want):
    budget = 232_448  # H100's opt-in shared memory per CTA
    tf, tc, rows = cuda_histogram.tile_plan(F, S, kb, itemsize, budget, row_bytes)
    assert (tf, tc, rows) == want
    ring = cuda_histogram.BARRIER_BYTES + cuda_histogram.STAGES * cuda_histogram.stage_bytes(
        rows, row_bytes)
    assert S * tf * tc * itemsize + ring <= budget
    assert rows in cuda_histogram.BLOCK_ROWS and rows % 32 == 0
    with pytest.raises(ValueError, match="do not fit"):
        cuda_histogram.tile_plan(F, 64, kb, 8, 256, ())
    with pytest.raises(ValueError, match="do not fit"):
        cuda_histogram.tile_plan(F, 2, kb, 4, 2_000, (4_000,))   # the ring alone is over


def test_stage_bytes_round_each_input_to_16():
    """Each staged input starts on a 16-byte boundary (the bulk copy's unit),
    as the kernel lays its stage out."""
    assert cuda_histogram.stage_bytes(1024, (17, 4, 4)) == 17 * 1024 + 2 * 4096
    assert cuda_histogram.stage_bytes(32, (17,)) == 544
    assert cuda_histogram.stage_bytes(33, (17, 1)) == 576 + 48
    assert cuda_histogram.stage_bytes(1024, ()) == 0


def test_fold_stride_of_kernel_inputs():
    """The fold stride the wrapper hands the kernel: 0 without a fold axis
    or for an ``expand``ed one, ``stride(0)`` otherwise; the inner
    dimensions must be contiguous."""
    fs = cuda_histogram._fold_stride
    g = torch.arange(12.0)
    assert fs(g, "grad", 1, None) == 0
    assert fs(g.reshape(3, 4), "grad", 1, 3) == 4
    assert fs(g[:4].expand(5, -1), "grad", 1, 5) == 0
    bins = torch.zeros((2, 7, 3), dtype=torch.uint8)
    assert fs(bins, "bins", 2, 2) == 21
    assert fs(bins[0], "bins", 2, 2) == 0          # one bin matrix shared by the folds
    with pytest.raises(ValueError, match="contiguous"):
        fs(g.reshape(3, 4)[:, ::2], "grad", 1, 3)
    with pytest.raises(ValueError, match="leading fold axis of 4"):
        fs(g.reshape(3, 4), "grad", 1, 4)
    with pytest.raises(ValueError, match="expected 1 dimensions"):
        fs(bins, "grad", 1, None)


@pytest.fixture
def both_gates(monkeypatch):
    monkeypatch.setattr(jgbdt, "DEVICE_BINNING_MIN_ROWS", 1)
    monkeypatch.setattr(gbdt, "DEVICE_BINNING_MIN_ROWS", 1)


@pytest.mark.parametrize("route", ["host_bins", "device_bins"])
@pytest.mark.parametrize("depth", [2, 3])
def test_fit_depth_matches_jax(x17, request, depth, route):
    if route == "device_bins":
        request.getfixturevalue("both_gates")
    X, y = x17
    want, want_aux = jgbdt.fit(X, y, JGBDTConfig(max_depth=depth, **CFG))
    got, aux = gbdt.fit(X, y, GBDTConfig(max_depth=depth, **CFG), device="cpu")
    _assert_forest_equal(got, want)
    assert isinstance(aux["train_deviance"], np.ndarray)
    np.testing.assert_allclose(aux["train_deviance"], want_aux["train_deviance"], rtol=1e-9)
    np.testing.assert_allclose(tree.predict_proba1(got, torch.as_tensor(X)).numpy(),
                               np.asarray(jtree.predict_proba1(want, X)), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k,depth", [(1, 3), (5, 2)])
def test_leaf_sums_on_cpu_equal_the_index_add_pair(k, depth, val_dtype):
    """On a CPU tensor the leaf-sum entry and every backend's leaf sums are
    the plain version (``histogram.leaf_sums``, the float64 ``index_add_``
    pair) bit for bit, parked rows included, and no launch count moves."""
    rng = np.random.default_rng(10 * k + depth)
    n, NN = 3001, 2 ** (depth + 1) - 1
    node = torch.as_tensor(np.where(rng.random((k, n)) < 0.3, -1,
                                    rng.integers(0, NN, size=(k, n))).astype(np.int32))
    g = torch.as_tensor(rng.normal(size=(k, n)).astype(val_dtype))
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=(k, n)).astype(val_dtype))
    before = dict(cuda_histogram.LAUNCHES)
    got = cuda_histogram.leaf_sums_cuda(node, g, h, k, NN)
    assert cuda_histogram.LAUNCHES == before
    assert got.shape == (2, k, NN + 1) and got.dtype == torch.float64
    assert torch.equal(got, histogram.leaf_sums(node, g, h, k, NN))
    for backend in ("auto", "matmul", "pallas", "xla"):
        leaf = gbdt.histogram_kernels(GBDTConfig(histogram_backend=backend)).leaf
        assert torch.equal(leaf(node, g, h, k, NN), got)
    assert cuda_histogram.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown histogram_backend"):
        gbdt.histogram_kernels(GBDTConfig(histogram_backend="cuda"))


def test_fit_depth_float32_and_backends(x17):
    """The card's working type: float32 X keeps the fit in float32 (u8
    bins) close to the float64 fit; every backend value is the plain
    version on a CPU tensor."""
    X, y = x17
    cfg = GBDTConfig(max_depth=3, **CFG)
    p64, a64 = gbdt.fit(X, y, cfg, device="cpu")
    p32, a32 = gbdt.fit(X.astype(np.float32), y, cfg, device="cpu")
    assert p32.value.dtype == torch.float32 and p32.threshold.dtype == torch.float32
    np.testing.assert_allclose(a32["train_deviance"], a64["train_deviance"], rtol=1e-5)
    before = dict(cuda_histogram.LAUNCHES)
    for backend in ("auto", "pallas", "matmul"):
        pb, _ = gbdt.fit(X, y, dataclasses.replace(cfg, histogram_backend=backend), device="cpu")
        for name in FOREST + ("value",):
            torch.testing.assert_close(getattr(pb, name), getattr(p64, name), rtol=0, atol=0)
    assert cuda_histogram.LAUNCHES == before


@pytest.mark.parametrize("per_fold_binning", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_fit_folds_match_jax(x17, depth, per_fold_binning):
    X, y = x17
    masks = 1.0 - stratified_kfold_test_masks(y, 5)
    np.testing.assert_array_equal(masks, 1.0 - jmasks(y, 5))
    kw = dict(CFG, max_depth=depth, per_fold_binning=per_fold_binning)
    want = jgbdt.fit_folds(X, y, masks, JGBDTConfig(**kw))
    got = gbdt.fit_folds(X, y, masks, GBDTConfig(**kw), device="cpu")
    assert got.feature.shape == (5, 8, 2 ** (depth + 1) - 1)
    _assert_forest_equal(got, want)
    np.testing.assert_allclose(got.learning_rate.numpy(), np.asarray(want.learning_rate))


def test_fit_folds_float32_match_float64(x17):
    """The card's working type: float32 fold fits choose the float64 fits'
    splits. Held-out rows gather the root's value, so an empty node's
    guarded 0/0 must stay 0 in float32 too."""
    X, y = x17
    masks = 1.0 - stratified_kfold_test_masks(y, 5)
    cfg = GBDTConfig(max_depth=2, **dict(CFG, histogram_backend="auto"))
    p64 = gbdt.fit_folds(X, y, masks, cfg, device="cpu")
    p32 = gbdt.fit_folds(X.astype(np.float32), y.astype(np.float32), masks, cfg, device="cpu")
    assert p32.value.dtype == torch.float32 and bool(torch.isfinite(p32.value).all())
    np.testing.assert_array_equal(p32.feature.numpy(), p64.feature.numpy())
    np.testing.assert_allclose(p32.value.numpy(), p64.value.numpy(), rtol=1e-4, atol=1e-5)


def test_cv_sweep_and_refit_match_jax():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(128, 6))
    y = (X @ rng.normal(size=6) + 0.5 * rng.normal(size=128) > 0).astype(float)
    grid = dict(n_estimators_grid=(2, 4), max_depth_grid=(1, 2), cv_folds=2)
    want = jsweep.cv_sweep(X, y, JSweepConfig(**grid))
    got = sweep.cv_sweep(X, y, SweepConfig(**grid), device="cpu")
    np.testing.assert_allclose(got.fold_auc, want.fold_auc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.mean_auc, want.mean_auc, rtol=0, atol=1e-12)
    assert (got.best_n_estimators, got.best_max_depth) == (want.best_n_estimators,
                                                           want.best_max_depth)
    # refit at depth 2
    at2 = dataclasses.replace(want, best_max_depth=2)
    p_want, c_want = jsweep.refit_best(X, y, at2)
    p_got, c_got = sweep.refit_best(X, y, dataclasses.replace(got, best_max_depth=2),
                                    device="cpu")
    assert dataclasses.asdict(c_got) == dataclasses.asdict(c_want)
    _assert_forest_equal(p_got, p_want)
    staged = sweep.staged_proba1(p_got, torch.as_tensor(X), (1, 2, 4))
    np.testing.assert_allclose(staged.numpy(),
                               np.asarray(jsweep.staged_proba1(p_want, jnp.asarray(X), (1, 2, 4))),
                               rtol=1e-12, atol=1e-14)
    # a depth-1 winner refits through the exact stump path
    at1 = dataclasses.replace(want, best_max_depth=1)
    p_want, _ = jsweep.refit_best(X, y, at1)
    p_got, c_got = sweep.refit_best(X, y, dataclasses.replace(got, best_max_depth=1),
                                    device="cpu")
    assert c_got.max_depth == 1 and c_got.splitter == "exact"
    _assert_forest_equal(p_got, p_want)
    # the sharded sweep on a one-rank mesh is the same sweep; it refuses
    # per-fold binning, as JAX's does
    from machine_learning_replications_tpu_torch.parallel import single_device_mesh

    mesh = single_device_mesh(device="cpu")
    on_mesh = sweep.cv_sweep(X, y, SweepConfig(**grid), mesh=mesh, device="cpu")
    np.testing.assert_allclose(on_mesh.fold_auc, got.fold_auc, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="shared-bins"):
        sweep.cv_sweep(X, y, SweepConfig(**grid), GBDTConfig(per_fold_binning=True), mesh=mesh,
                       device="cpu")

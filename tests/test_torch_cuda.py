"""The hand-written histogram kernel on the card, against its plain version,
and the port's paths that run on the card (serving, scoring, the fleet).

Every test here needs an NVIDIA GPU and ``nvcc``; without them each skips.
The file imports neither JAX nor the JAX package, so on a machine that has
only PyTorch it runs alone, without the suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The plain versions accumulate in float64, so a difference is the kernel's
own float32 rounding; tolerances are the JAX suite's histogram bounds (1e-5
at float32, 1e-9 at float64). The fit through the kernel is held at model
level (deviance, predictions), never split by split: float atomics regroup
sums, which may flip a near-tied split.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.data import make_cohort, selected_indices
from machine_learning_replications_tpu_torch.models import gbdt, sweep, tree
from machine_learning_replications_tpu_torch.ops import cuda_histogram, histogram

pytestmark = pytest.mark.cuda

TOL = {np.float32: 1e-5, np.float64: 1e-9}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda", 0)


def _stump_inputs(seed, n, F, B, bin_dtype, val_dtype, dev):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(n, F)).astype(bin_dtype)
    g = rng.normal(size=n).astype(val_dtype)
    h = rng.uniform(0.01, 0.25, size=n).astype(val_dtype)
    return [torch.as_tensor(a, device=dev) for a in (binned, g, h)]


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,F,B", [(5000, 5, 32), (257, 3, 33), (64, 1, 256), (4096, 17, 2)])
def test_stump_histograms_kernel_matches_plain(cuda_device, n, F, B, bin_dtype, val_dtype):
    args = _stump_inputs(n * F + B, n, F, B, bin_dtype, val_dtype, cuda_device)
    before = cuda_histogram.LAUNCHES["stump_histograms"]
    got = cuda_histogram.stump_histograms_cuda(*args, B)
    torch.cuda.synchronize()
    assert cuda_histogram.LAUNCHES["stump_histograms"] == before + 1
    assert got.shape == (2, F, B) and got.dtype == args[1].dtype
    want = histogram.stump_histograms_reference(*args, B)
    tol = TOL[val_dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    zero = cuda_histogram.stump_histograms_cuda(args[0], args[1] * 0, args[2] * 0, B)
    assert not zero.any()


def test_stats_histograms_kernel_matches_plain(cuda_device):
    """The general contract: node segments, four statistics, a cell past
    ``kb`` dropped."""
    rng = np.random.default_rng(8)
    n, F, K, B = 3001, 6, 8, 33
    bins = torch.as_tensor(rng.integers(0, B + 1, size=(n, F)).astype(np.int32), device=cuda_device)
    seg = torch.as_tensor((rng.integers(0, K, size=n) * B).astype(np.int32), device=cuda_device)
    vals = torch.as_tensor(rng.normal(size=(n, 4)), device=cuda_device)
    before = cuda_histogram.LAUNCHES["stats_histograms"]
    got = cuda_histogram.stats_histograms_cuda(bins, seg, vals, K * B)
    assert cuda_histogram.LAUNCHES["stats_histograms"] == before + 1
    want = histogram.stats_histograms_reference(bins, seg, vals, K * B)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    binned, g, h = _stump_inputs(1, 100, 4, 16, np.uint8, np.float32, cuda_device)
    with pytest.raises(TypeError, match="uint8 or int32"):
        cuda_histogram.stump_histograms_cuda(binned.long(), g, h, 16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_histogram.stump_histograms_cuda(binned.t().contiguous().t(), g, h, 16)
    with pytest.raises(ValueError, match="expected binned"):
        cuda_histogram.stump_histograms_cuda(binned, g[:50], h, 16)
    node = torch.zeros(100, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="node ids must be int32"):
        cuda_histogram.node_histograms_cuda(binned, node, g, h, 2, 16)



def test_histogram_past_shared_memory_is_tiled(cuda_device):
    """A 65536-bin float64 stump histogram (1 MB per feature, over one CTA's
    shared memory) is cut into cell-range tiles and matches the plain
    version."""
    binned, g, h = _stump_inputs(1, 3000, 4, 1 << 16, np.int32, np.float64, cuda_device)
    got = cuda_histogram.stump_histograms_cuda(binned, g, h, 1 << 16)
    want = histogram.stump_histograms_reference(binned, g, h, 1 << 16)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def _node_inputs(seed, n, F, K, B, bin_dtype, val_dtype, dev, folds=None, fold_bins=False):
    rng = np.random.default_rng(seed)
    lead = () if folds is None else (folds,)
    binned = rng.integers(0, B, size=lead * fold_bins + (n, F)).astype(bin_dtype)
    node = rng.integers(-1, K, size=lead + (n,)).astype(np.int32)
    g = rng.normal(size=lead + (n,)).astype(val_dtype)
    h = rng.uniform(0.01, 0.25, size=lead + (n,)).astype(val_dtype)
    return [torch.as_tensor(a, device=dev) for a in (binned, node, g, h)]


def _assert_node_close(got, want, tol):
    torch.testing.assert_close(got.count, want.count, rtol=0, atol=0)  # counts exact
    for stat in ("grad", "hess", "grad2"):
        torch.testing.assert_close(getattr(got, stat), getattr(want, stat), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,F,K,B,bin_dtype,val_dtype", [
    (20_000, 17, 1, 256, np.uint8, np.float32),   # one tile
    (20_000, 17, 4, 256, np.uint8, np.float32),   # 2 feature tiles
    (20_000, 17, 4, 256, np.uint8, np.float64),   # 3 feature tiles
    (5_000, 17, 64, 256, np.uint8, np.float32),   # cell-range tiles
    (257, 3, 8, 33, np.int32, np.float64),
])
def test_node_histograms_kernel_matches_plain(cuda_device, n, F, K, B, bin_dtype, val_dtype):
    args = _node_inputs(n + K, n, F, K, B, bin_dtype, val_dtype, cuda_device)
    before = cuda_histogram.LAUNCHES["node_histograms"]
    got = cuda_histogram.node_histograms_cuda(*args, K, B)
    torch.cuda.synchronize()
    assert cuda_histogram.LAUNCHES["node_histograms"] == before + 1
    assert got.grad.shape == (K, F, B) and got.grad.dtype == args[2].dtype
    _assert_node_close(got, histogram.node_histograms(*args, K, B), TOL[val_dtype])
    args[1].fill_(-1)  # every row inactive: exactly zero
    zero = cuda_histogram.node_histograms_cuda(*args, K, B)
    assert not any(bool(a.any()) for a in zero)


@pytest.mark.parametrize("fold_bins", [False, True])
def test_node_histograms_kernel_fold_axis(cuda_device, fold_bins):
    """k fits in one launch (a fold grid dimension), shared or per-fold bins."""
    args = _node_inputs(3, 4000, 17, 4, 256, np.uint8, np.float32, cuda_device, folds=5,
                        fold_bins=fold_bins)
    before = cuda_histogram.LAUNCHES["node_histograms"]
    got = cuda_histogram.node_histograms_cuda(*args, 4, 256)
    assert cuda_histogram.LAUNCHES["node_histograms"] == before + 1
    assert got.grad.shape == (5, 4, 17, 256)
    _assert_node_close(got, histogram.node_histograms(*args, 4, 256), 1e-5)


MASS_TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-9, 1e-9)}  # (rtol, atol)


def _assert_close_to_mass(got, want, mass):
    """Cell by cell within ``atol + rtol·Σ|terms|`` (``chip_smoke.compare``):
    a float sum taken in another order errs in proportion to its terms'
    absolute mass, not to its possibly cancelled result."""
    rtol, atol = MASS_TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.double() - want.double()).abs()
    bad = diff > atol + rtol * mass.double()
    assert bool(torch.isfinite(got).all()) and not bool(bad.any()), (
        f"{int(bad.sum())} cells off; worst {diff.max().item()}")


def _pattern_bins(kind, rng, n, F, B, dtype):
    """Bin matrices that stress the warp aggregation: ``dominant`` puts 95%
    of rows in one bin (the cohort's two-valued columns), ``one_cell`` every
    row in one bin (one peer group per warp step), ``distinct`` 32
    consecutive rows in 32 different bins (no peers at all)."""
    if kind == "uniform":
        b = rng.integers(0, B, size=(n, F))
    elif kind == "dominant":
        b = np.where(rng.random((n, F)) < 0.95, 7 % B, rng.integers(0, B, size=(n, F)))
    elif kind == "one_cell":
        b = np.full((n, F), 3 % B)
    else:
        b = (np.arange(n)[:, None] + 5 * np.arange(F)[None, :]) % B
    return b.astype(dtype)


def _check_stump(dev, binned, g, h, B):
    got = cuda_histogram.stump_histograms_cuda(binned, g, h, B)
    torch.cuda.synchronize()
    want = histogram.stump_histograms_reference(binned, g, h, B)
    _assert_close_to_mass(got, want, histogram.stump_histograms_reference(binned, g.abs(),
                                                                          h.abs(), B))


def _check_node(dev, binned, node, g, h, K, B):
    got = cuda_histogram.node_histograms_cuda(binned, node, g, h, K, B)
    torch.cuda.synchronize()
    want = histogram.node_histograms(binned, node, g, h, K, B)
    mass = histogram.node_histograms(binned, node, g.abs(), h.abs(), K, B)
    torch.testing.assert_close(got.count, want.count, rtol=0, atol=0)  # counts exact
    for stat in ("grad", "hess", "grad2", "count"):
        _assert_close_to_mass(getattr(got, stat), getattr(want, stat), getattr(mass, stat))


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("kind", ["dominant", "one_cell", "distinct"])
def test_stump_kernel_bin_patterns(cuda_device, kind, bin_dtype, val_dtype):
    """The aggregation's best and worst cases, float64 shuffles included, at
    a row count that is no multiple of 16 (a ragged last block)."""
    rng = np.random.default_rng(11)
    n, F, B = 4099, 17, 256
    binned = torch.as_tensor(_pattern_bins(kind, rng, n, F, B, bin_dtype), device=cuda_device)
    g = torch.as_tensor(rng.normal(size=n).astype(val_dtype), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(val_dtype), device=cuda_device)
    _check_stump(cuda_device, binned, g, h, B)


@pytest.mark.parametrize("inactive", [0.2, 0.95])
@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["dominant", "one_cell", "distinct"])
def test_node_kernel_bin_patterns(cuda_device, kind, val_dtype, inactive):
    """Node mode with 20% or 95% inactive rows (at 95% about one warp in
    five has no active row and skips its chunk), K = 1 for ``one_cell``
    (every active row of a warp in one cell) and K = 4 (two shared-memory
    tiles in float32) otherwise."""
    rng = np.random.default_rng(12)
    n, F, B = 4099, 17, 256
    K = 1 if kind == "one_cell" else 4
    binned = torch.as_tensor(_pattern_bins(kind, rng, n, F, B, np.uint8), device=cuda_device)
    node = np.where(rng.random(n) < inactive, -1, rng.integers(0, K, size=n)).astype(np.int32)
    g = rng.normal(size=n).astype(val_dtype)
    h = rng.uniform(0.01, 0.25, size=n).astype(val_dtype)
    _check_node(cuda_device, binned, *(torch.as_tensor(a, device=cuda_device)
                                       for a in (node, g, h)), K, B)


@pytest.mark.parametrize("n", [1, 20, 31, 33, 1037, 2063])
def test_kernels_at_ragged_row_counts(cuda_device, n):
    """n < 32, and n no multiple of 16 or of a staged block's rows: the last
    block loads by ordinary loads."""
    rng = np.random.default_rng(n)
    F, B, K = 17, 64, 2
    binned = torch.as_tensor(rng.integers(0, B, size=(n, F)).astype(np.uint8), device=cuda_device)
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(np.float32), device=cuda_device)
    node = torch.as_tensor(rng.integers(-1, K, size=n).astype(np.int32), device=cuda_device)
    _check_stump(cuda_device, binned, g, h, B)
    _check_node(cuda_device, binned, node, g, h, K, B)


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
def test_node_kernel_unaligned_fold_strides(cuda_device, val_dtype):
    """Per-fold bins ``[3, 1001, 17]`` (a fold stride of 17017 bytes), and
    statistics and node ids whose fold strides are no multiple of 16 bytes:
    every fold but the first loads by ordinary loads."""
    rng = np.random.default_rng(5)
    k, n, F, K, B = 3, 1001, 17, 4, 256
    binned = rng.integers(0, B, size=(k, n, F)).astype(np.uint8)
    node = rng.integers(-1, K, size=(k, n)).astype(np.int32)
    g = rng.normal(size=(k, n)).astype(val_dtype)
    h = rng.uniform(0.01, 0.25, size=(k, n)).astype(val_dtype)
    args = [torch.as_tensor(a, device=cuda_device) for a in (binned, node, g, h)]
    got = cuda_histogram.node_histograms_cuda(*args, K, B)
    assert got.grad.shape == (k, K, F, B)
    _check_node(cuda_device, *args, K, B)


def test_node_kernel_broadcast_fold_statistics(cuda_device):
    """Fold statistics given as an ``expand`` of one row vector (fold
    stride 0) read the same rows in every fold, with no copy."""
    rng = np.random.default_rng(6)
    n, F, K, B = 3000, 17, 4, 256
    binned = torch.as_tensor(rng.integers(0, B, size=(n, F)).astype(np.uint8), device=cuda_device)
    node = torch.as_tensor(rng.integers(-1, K, size=(5, n)).astype(np.int32), device=cuda_device)
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(np.float32), device=cuda_device)
    _check_node(cuda_device, binned, node, g.expand(5, -1), h.expand(5, -1), K, B)


@pytest.mark.parametrize("S", [1, 4, 6])
def test_stats_kernel_general_entry(cuda_device, S):
    """The general entry at S not 2 or 4 (S = 6 takes two passes of four),
    with a fold axis over shared bins and without one."""
    rng = np.random.default_rng(S)
    k, n, F, kb = 3, 2500, 5, 40
    bins = torch.as_tensor(rng.integers(0, 36, size=(n, F)).astype(np.int32), device=cuda_device)
    seg = torch.as_tensor(rng.integers(0, 5, size=(k, n)).astype(np.int32), device=cuda_device)
    vals = torch.as_tensor(rng.normal(size=(k, n, S)), device=cuda_device)
    got = cuda_histogram.stats_histograms_cuda(bins, seg, vals, kb)
    assert got.shape == (k, S, F, kb)
    for i in range(k):
        want = histogram.stats_histograms_reference(bins, seg[i], vals[i], kb)
        mass = histogram.stats_histograms_reference(bins, seg[i], vals[i].abs(), kb)
        _assert_close_to_mass(got[i], want, mass)
        one = cuda_histogram.stats_histograms_cuda(bins, seg[i], vals[i], kb)
        _assert_close_to_mass(one, want, mass)


def test_depth3_fit_kernel_matches_plain(cuda_device):
    """The level-wise fit through the node kernel against the same fit
    through the plain version, at model level; one launch per tree level."""
    X, y, _ = make_cohort(n=1427, seed=2020)
    Xc = torch.as_tensor(X[:, selected_indices()], dtype=torch.float32, device=cuda_device)
    yc = torch.as_tensor(y, dtype=torch.float32, device=cuda_device)
    cfg = GBDTConfig(n_estimators=8, max_depth=3, splitter="hist", n_bins=32)
    cuda_histogram.reset_launch_counts()
    pk, ak = gbdt.fit(Xc, yc, cfg, device=cuda_device)
    assert cuda_histogram.LAUNCHES["node_histograms"] == 8 * 3
    pp, ap = gbdt.fit(Xc, yc, dataclasses.replace(cfg, histogram_backend="xla"), device=cuda_device)
    assert cuda_histogram.LAUNCHES["node_histograms"] == 8 * 3
    np.testing.assert_allclose(ak["train_deviance"], ap["train_deviance"], rtol=1e-4, atol=0)
    torch.testing.assert_close(tree.predict_proba1(pk, Xc), tree.predict_proba1(pp, Xc),
                               rtol=1e-4, atol=1e-5)
    masks = (np.arange(X.shape[0])[None, :] % 3 != np.arange(3)[:, None]).astype(np.float64)
    cuda_histogram.reset_launch_counts()
    fk = gbdt.fit_folds(Xc, yc, masks, dataclasses.replace(cfg, max_depth=2), device=cuda_device)
    assert cuda_histogram.LAUNCHES["node_histograms"] == 8 * 2
    fp = gbdt.fit_folds(Xc, yc, masks, dataclasses.replace(cfg, max_depth=2,
                                                          histogram_backend="xla"),
                        device=cuda_device)
    for i in range(3):
        torch.testing.assert_close(tree.predict_proba1(sweep.one_fold(fk, i), Xc),
                                   tree.predict_proba1(sweep.one_fold(fp, i), Xc),
                                   rtol=1e-4, atol=1e-5)


def test_fused_fit_kernel_matches_plain(cuda_device, monkeypatch):
    """The fit through the kernel against the fit through the plain version
    on the same card, at model level."""
    monkeypatch.setattr(gbdt, "DEVICE_BINNING_MIN_ROWS", 1)
    X, y, _ = make_cohort(n=1427, seed=2020)
    Xc = torch.as_tensor(X[:, selected_indices()], dtype=torch.float32, device=cuda_device)
    yc = torch.as_tensor(y, dtype=torch.float32, device=cuda_device)
    cfg = GBDTConfig(n_estimators=8, splitter="hist", n_bins=32)
    cuda_histogram.reset_launch_counts()
    pk, ak = gbdt.fit(Xc, yc, cfg, device=cuda_device)
    assert cuda_histogram.LAUNCHES["stump_histograms"] == 8
    pp, ap = gbdt.fit(Xc, yc, dataclasses.replace(cfg, histogram_backend="xla"), device=cuda_device)
    assert cuda_histogram.LAUNCHES["stump_histograms"] == 8
    torch.testing.assert_close(ak["train_deviance"], ap["train_deviance"], rtol=1e-4, atol=0)
    torch.testing.assert_close(tree.predict_proba1(pk, Xc), tree.predict_proba1(pp, Xc),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,B,one_tile", [(1427, 1428, True), (50_000, 50_001, False)])
def test_stump_kernel_at_exact_bins(cuda_device, n, B, one_tile, val_dtype):
    """The exact splitter's shapes: int32 bins with B = n + 1 (every
    unique-value midpoint of a continuous column), in one shared-memory tile
    at the reference cohort's 1427 rows, and with each feature's cells cut
    into ranges at 50,000 rows."""
    rng = np.random.default_rng(n)
    F = 17
    cols = [rng.permutation(n) + rng.integers(0, 2) for _ in range(F)]  # distinct ids, some at B-1
    binned = torch.as_tensor(np.stack(cols, 1).astype(np.int32), device=cuda_device)
    binned[:, 3] = torch.as_tensor(rng.integers(0, 2, size=n).astype(np.int32))  # a binary column
    g = torch.as_tensor(rng.normal(size=n).astype(val_dtype), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(val_dtype), device=cuda_device)
    itemsize = np.dtype(val_dtype).itemsize
    tf, tc, _ = cuda_histogram.tile_plan(F, 2, B, itemsize, cuda_histogram.smem_budget(cuda_device),
                                         (F * 4, itemsize, itemsize))
    assert (-(-F // tf) * -(-B // tc) == 1) is one_tile or val_dtype == np.float64
    assert (tc < B) is not one_tile
    before = cuda_histogram.LAUNCHES["stump_histograms"]
    _check_stump(cuda_device, binned, g, h, B)
    assert cuda_histogram.LAUNCHES["stump_histograms"] == before + 1


def test_exact_fit_kernel_matches_plain(cuda_device):
    """``GBDTConfig()`` ('exact', depth 1) through the stump kernel at int32
    bins against the same fit through the plain version, at model level;
    one launch per stage."""
    X, y, _ = make_cohort(n=1427, seed=2020)
    X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
    yf = y.astype(np.float32)
    cfg = GBDTConfig(n_estimators=20)
    cuda_histogram.reset_launch_counts()
    pk, ak = gbdt.fit(X17, yf, cfg, device=cuda_device)
    assert cuda_histogram.LAUNCHES["stump_histograms"] == 20
    pp, ap = gbdt.fit(X17, yf, dataclasses.replace(cfg, histogram_backend="xla"),
                      device=cuda_device)
    assert cuda_histogram.LAUNCHES["stump_histograms"] == 20
    assert isinstance(ak["train_deviance"], np.ndarray)
    np.testing.assert_allclose(ak["train_deviance"], ap["train_deviance"], rtol=1e-4, atol=0)
    Xc = torch.as_tensor(X17, device=cuda_device)
    torch.testing.assert_close(tree.predict_proba1(pk, Xc), tree.predict_proba1(pp, Xc),
                               rtol=1e-4, atol=1e-6)


def test_imputer_card_matches_cpu(cuda_device):
    """The imputer on the card against its CPU path on one batch of contract
    rows (47 of 64 columns missing): the same donors, and so the same
    imputed values."""
    from machine_learning_replications_tpu_torch import convert
    from machine_learning_replications_tpu_torch.models import knn_impute

    X64, _, _ = make_cohort(n=1427, seed=2020, missing_rate=0.03)
    cpu = knn_impute.fit(X64, device="cpu")
    card = convert.params_to(cpu, cuda_device)
    rows = make_cohort(n=4000, seed=7)[0]
    Xq = np.full_like(rows, np.nan)
    Xq[:, selected_indices()] = rows[:, selected_indices()]
    block = knn_impute.resolve_block_fn(cpu, Xq)
    assert block.dist_cols is not None and len(block.nan_cols) == 47
    xq = torch.as_tensor(Xq)
    idx, ok = block.donors(card, xq.to(cuda_device))
    idx_c, ok_c = block.donors(cpu, xq)
    assert torch.equal(ok.cpu(), ok_c)
    assert torch.equal(idx.cpu()[ok_c], idx_c[ok_c])
    got = knn_impute.transform(card, Xq, chunk_rows=1500)
    want = knn_impute.transform(cpu, Xq, chunk_rows=1500)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=0)


def _member_and_fold_inputs(rows, seed, dev):
    """The ``train`` route's histogram inputs at ``rows`` develop rows: the
    exact member's int32 bins of every unique-value midpoint, and the fold
    fits' u8 bins (256-bin budget) with the 5 folds' root node ids."""
    from machine_learning_replications_tpu_torch.ops import binning
    from machine_learning_replications_tpu_torch.utils.cv import stratified_kfold_test_masks

    X, y, _ = make_cohort(n=rows, seed=seed)
    X17 = np.ascontiguousarray(X[:, selected_indices()])
    exact = binning.bin_features(X17, None)
    capped = binning.bin_features(X17, 256)
    train = 1.0 - stratified_kfold_test_masks(y, 5)
    node = torch.as_tensor(np.where(train > 0, 0, -1).astype(np.int32), device=dev)
    return (torch.as_tensor(exact.binned, device=dev), exact.max_bins,
            torch.as_tensor(capped.binned.astype(np.uint8), device=dev), capped.max_bins, node,
            torch.as_tensor(train, device=dev))


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
def test_kernels_at_the_train_route_shapes(cuda_device, val_dtype):
    """The stump kernel at the reference member's shape (713 rows, int32
    bins, B = unique midpoints + 1) and the node kernel at the stacking CV's
    fold fits (5 folds in one launch, K = 1, u8 bins, B <= 256)."""
    ebins, eB, fbins, fB, node, train = _member_and_fold_inputs(713, 2020, cuda_device)
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.normal(size=713).astype(val_dtype), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=713).astype(val_dtype), device=cuda_device)
    assert ebins.dtype == torch.int32 and 256 < eB <= 714
    _check_stump(cuda_device, ebins, g, h, eB)
    w = train.to(g.dtype)
    _check_node(cuda_device, fbins, node, g[None] * w, h[None] * w, 1, fB)


def test_train_solvers_card_match_cpu(cuda_device):
    """The solver loops replayed as CUDA graphs on the card against the same
    loops run eagerly on the CPU: the batched dual solve (Platt lanes
    sharing K), the L1-LR fold lanes and LassoCV, at 1e-7: products on the
    card add in another order than on the CPU."""
    from machine_learning_replications_tpu_torch.models import scaler, solvers, svm

    X, y, _ = make_cohort(n=300, seed=11)
    X17 = torch.as_tensor(np.ascontiguousarray(X[:, selected_indices()]))
    yt = torch.as_tensor(y)
    Xt = scaler.transform(scaler.fit(X17), X17)
    cpu = svm.svc_fit(Xt, yt, tol=1e-3)
    its = []
    card = svm.svc_fit(Xt.to(cuda_device), yt.to(cuda_device), tol=1e-3, iterations=its)
    assert its and max(its[0]) > svm._KKT_CHECK_EVERY
    for f in ("dual_coef", "intercept", "prob_a", "prob_b"):
        torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f), rtol=1e-7, atol=1e-7)
    masks = torch.as_tensor((np.random.default_rng(4).random((5, 300)) < 0.8).astype(float))
    lc = solvers.logreg_l1_fit(X17, yt, sample_mask=masks)
    lg = solvers.logreg_l1_fit(X17.to(cuda_device), yt.to(cuda_device),
                               sample_mask=masks.to(cuda_device))
    torch.testing.assert_close(lg.coef.cpu(), lc.coef, rtol=1e-7, atol=1e-7)
    X64 = torch.as_tensor(X)
    kc = solvers.lasso_cv(X64, yt, cv_folds=5, n_alphas=20)
    kg = solvers.lasso_cv(X64.to(cuda_device), yt.to(cuda_device), cv_folds=5, n_alphas=20)
    for a, b in zip(kg, kc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-7, atol=1e-7)


def test_fit_pipeline_card_matches_cpu(cuda_device):
    """``fit_pipeline`` on the card against the CPU port at a small size:
    the same selection, donors and forest (one stump launch per stage, one
    node launch per level of the 5 fold fits), the same predictions."""
    from machine_learning_replications_tpu_torch.config import ExperimentConfig
    from machine_learning_replications_tpu_torch.models import pipeline

    X, y, _ = make_cohort(n=400, seed=2020, missing_rate=0.03)
    cfg = ExperimentConfig.from_dict({"gbdt": {"n_estimators": 10}, "svc": {"platt_cv": 2},
                                      "select": {"cv_folds": 3, "n_alphas": 20}})
    cuda_histogram.reset_launch_counts()
    card, _ = pipeline.fit_pipeline(X[:200], y[:200], cfg, device=cuda_device)
    assert cuda_histogram.LAUNCHES["stump_histograms"] == 10
    assert cuda_histogram.LAUNCHES["node_histograms"] == 10
    cpu, _ = pipeline.fit_pipeline(X[:200], y[:200], cfg, device="cpu")
    assert torch.equal(card.support_mask.cpu(), cpu.support_mask)
    torch.testing.assert_close(card.imputer.donors.cpu(), cpu.imputer.donors, equal_nan=True,
                               rtol=0, atol=0)
    assert torch.equal(card.ensemble.gbdt.feature.cpu(), cpu.ensemble.gbdt.feature)
    p_card = pipeline.pipeline_predict_proba1(card, X[200:], device=cuda_device).cpu()
    p_cpu = pipeline.pipeline_predict_proba1(cpu, X[200:], device="cpu")
    torch.testing.assert_close(p_card, p_cpu, rtol=0, atol=1e-6)


def test_span_waits_for_a_graph_replayed_solver_block(cuda_device):
    """A span around solver blocks replayed as a CUDA graph
    (``ops.steps.run_blocks``, captured on a side stream) lasts at least as
    long as the blocks' CUDA-event time: span exit synchronizes the device,
    not one stream. The host check here never syncs, so without that wait
    the span would close while the card still works."""
    from machine_learning_replications_tpu_torch.obs import spans
    from machine_learning_replications_tpu_torch.ops.steps import run_blocks

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    A = torch.randn(2048, 2048, device=cuda_device, generator=gen) / 64
    x = torch.randn(2048, 512, device=cuda_device, generator=gen)

    def block():
        for _ in range(8):
            x.copy_(torch.tanh(A @ x))

    torch.cuda.synchronize()
    tr = spans.Tracer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with tr.span("solve") as sp:
        start.record()
        run_blocks(block, 40, lambda: True, cuda_device)
        end.record()
        sp.block(x)
    end.synchronize()
    event_ms = start.elapsed_time(end)
    span_ms = next(e for e in tr.export()["traceEvents"] if e.get("name") == "solve")["dur"] / 1e3
    assert event_ms > 1.0 and span_ms >= event_ms, (span_ms, event_ms)


def test_torchmon_counts_captures_and_launches_on_the_card(cuda_device):
    from machine_learning_replications_tpu_torch.obs import torchmon
    from machine_learning_replications_tpu_torch.ops.steps import run_blocks

    torchmon.install()
    before = torchmon.totals()
    x = torch.ones(64, device=cuda_device)

    def block():
        x.mul_(1.0001)

    run_blocks(block, 3, lambda: True, cuda_device)
    args = _stump_inputs(7, 4096, 17, 256, np.uint8, np.float32, cuda_device)
    cuda_histogram.stump_histograms_cuda(*args, 256)
    node = torch.zeros(4096, dtype=torch.int32, device=cuda_device)
    cuda_histogram.node_histograms_cuda(args[0], node, args[1], args[2], 1, 256)
    torchmon.device_get(x)
    torch.cuda.synchronize()
    after = torchmon.totals()
    assert after["torch_graph_captures_total"] == before["torch_graph_captures_total"] + 1
    for k in ("stump_histograms", "node_histograms"):
        assert after["torch_kernel_launches_total"][k] == \
            before["torch_kernel_launches_total"].get(k, 0) + 1
    assert after["torch_transfer_bytes_total"]["d2h"] >= \
        before["torch_transfer_bytes_total"].get("d2h", 0) + 256


def test_committed_sklearn_fixture_imports_on_the_card(cuda_device):
    """The committed sklearn-layout pickle decodes without sklearn and
    imports onto the card; its stacked probabilities equal the CPU import's
    at (1e-5, 1e-8)."""
    import sys

    from machine_learning_replications_tpu_torch.models import stacking
    from machine_learning_replications_tpu_torch.persist import sklearn_import

    path = sklearn_import.__file__.replace("sklearn_import.py", "testdata/stacking_small.pkl")
    had_sklearn = "sklearn" in sys.modules
    obj = sklearn_import.decode_pickle(path)
    assert ("sklearn" in sys.modules) == had_sklearn         # the decoder never imports it
    card = sklearn_import.import_stacking(obj, device=cuda_device)
    cpu = sklearn_import.import_stacking(obj, device="cpu")
    assert card.gbdt.threshold.dtype == torch.float64 and card.meta.coef.is_cuda
    rng = np.random.default_rng(29)
    X = rng.normal(size=(64, 17))
    X[:, :10] = (X[:, :10] > 0.3).astype(float)
    p = stacking.predict_proba(card, X, device=cuda_device).cpu()
    torch.testing.assert_close(p, stacking.predict_proba(cpu, X, device="cpu"), rtol=1e-5,
                               atol=1e-8)


# ---------------------------------------------------------------------------
# the serving engine: one CUDA graph per bucket
# ---------------------------------------------------------------------------


def _serve_families(dev, ens_dtype=torch.float64):
    """The committed sklearn-layout fixture as the stacking family, its
    forest as the tree family, and a pipeline with a float64 1-NN imputer
    over ``make_cohort(1427, missing_rate=0.05)`` in front of it (the
    ensemble in ``ens_dtype``), all on ``dev``."""
    from machine_learning_replications_tpu_torch import convert
    from machine_learning_replications_tpu_torch.models import knn_impute, pipeline
    from machine_learning_replications_tpu_torch.persist import sklearn_import

    path = sklearn_import.__file__.replace("sklearn_import.py", "testdata/stacking_small.pkl")
    ens = sklearn_import.import_stacking(sklearn_import.decode_pickle(path), device=dev)
    if ens_dtype != torch.float64:
        ens = convert.stacking_params_from_arrays(convert.params_to(ens, "cpu"), device=dev,
                                                  dtype=ens_dtype)
    X64, _, _ = make_cohort(n=1427, seed=2020, missing_rate=0.05)
    mask = torch.zeros(64, dtype=torch.bool, device=dev)
    mask[selected_indices()] = True
    pipe = pipeline.PipelineParams(imputer=knn_impute.fit(X64, device=dev), support_mask=mask,
                                   ensemble=ens)
    return {"stacking": ens, "tree": ens.gbdt, "pipeline": pipe}


def _serve_rows(n, seed=13):
    from machine_learning_replications_tpu_torch.data.examples import patient_row

    rng = np.random.default_rng(seed)
    return patient_row() * (1.0 + 0.1 * rng.standard_normal((n, 17)))


@pytest.mark.parametrize("family", ["stacking", "tree", "pipeline"])
def test_serve_engine_captures_one_graph_per_bucket(cuda_device, family):
    from machine_learning_replications_tpu_torch.obs import torchmon
    from machine_learning_replications_tpu_torch.serve import engine

    torchmon.install()
    eng = engine.BucketedPredictEngine(_serve_families(cuda_device)[family], device=cuda_device)
    before = torchmon.totals()["torch_graph_captures_total"]
    eng.warmup()
    assert eng.trace_counts == {b: 1 for b in engine.DEFAULT_BUCKETS}
    assert torchmon.totals()["torch_graph_captures_total"] == before + len(engine.DEFAULT_BUCKETS)
    X = _serve_rows(1100)
    for n in (1, 2, 9, 65, 200, 700, 1100):
        assert eng.predict(X[:n]).shape == (n,)
    assert eng.trace_counts == {b: 1 for b in engine.DEFAULT_BUCKETS}


@pytest.mark.parametrize("ens_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", ["stacking", "tree", "pipeline"])
def test_serve_graph_replay_equals_eager_route(cuda_device, family, ens_dtype):
    from machine_learning_replications_tpu_torch.serve import engine

    params = _serve_families(cuda_device, ens_dtype)[family]
    eng = engine.BucketedPredictEngine(params, buckets=(1, 8, 64), device=cuda_device)
    eng.warmup()
    X = _serve_rows(150)
    rtol, atol = engine.parity_tolerance(params)
    for n in (1, 7, 9, 64, 150):
        np.testing.assert_allclose(eng.predict(X[:n]), engine.oracle_proba1(params, X[:n]),
                                   rtol=rtol, atol=atol)
    if family == "pipeline":                 # a NaN contract value: the eager route, on the card
        Xn = X[:5].copy()
        Xn[2, 4] = np.nan
        np.testing.assert_allclose(eng.predict(Xn), engine.oracle_proba1(params, Xn),
                                   rtol=rtol, atol=atol)
    assert eng.trace_counts == {1: 1, 8: 1, 64: 1}


def test_serve_capture_while_another_engine_replays(cuda_device):
    """A deploy warms (captures) a new engine while the old one serves from
    another thread: both stay equal to the eager route."""
    import threading

    from machine_learning_replications_tpu_torch.serve import engine

    params = _serve_families(cuda_device)["pipeline"]
    old = engine.BucketedPredictEngine(params, buckets=(1, 8, 64), device=cuda_device)
    old.warmup()
    X = _serve_rows(64)
    want = engine.oracle_proba1(params, X)
    rtol, atol = engine.parity_tolerance(params)
    stop, errors, replays = threading.Event(), [], [0]

    def serve():
        try:
            while not stop.is_set():
                np.testing.assert_allclose(old.predict(X), want, rtol=rtol, atol=atol)
                replays[0] += 1
        except BaseException as exc:  # pragma: no cover - reported below
            errors.append(exc)

    t = threading.Thread(target=serve)
    t.start()
    try:
        new = engine.BucketedPredictEngine(params, device=cuda_device)
        new.warmup()
    finally:
        stop.set()
        t.join()
    assert not errors and replays[0] > 0
    np.testing.assert_allclose(new.predict(X), want, rtol=rtol, atol=atol)


def test_serve_supervisor_restart_recaptures(cuda_device):
    import time

    from machine_learning_replications_tpu_torch.resilience import faults
    from machine_learning_replications_tpu_torch.resilience.supervisor import (
        BreakerOpen,
        SupervisedEngine,
    )
    from machine_learning_replications_tpu_torch.serve import engine

    params = _serve_families(cuda_device)["stacking"]

    def factory():
        eng = engine.BucketedPredictEngine(params, buckets=(1, 8), device=cuda_device)
        eng.warmup()
        return eng

    first = factory()
    sup = SupervisedEngine(first, factory, flush_deadline_s=10.0, breaker_failures=2,
                           restart_backoff_s=0.05, restart_backoff_max_s=0.2)
    X = _serve_rows(5)
    want = sup.predict(X)
    faults.arm("engine.compute:raise@count=2")
    try:
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                sup.predict(X)
    finally:
        faults.reset()
    deadline = time.monotonic() + 60
    while True:
        try:
            got = sup.predict(X)
            break
        except BreakerOpen:
            assert time.monotonic() < deadline, "the supervisor never restarted the engine"
            time.sleep(0.05)
    try:
        assert sup._engine is not first and sup._engine.trace_counts == {1: 1, 8: 1}
        np.testing.assert_array_equal(got, want)
    finally:
        sup.close()


def test_serve_host_path_agrees_with_the_card(cuda_device):
    from machine_learning_replications_tpu_torch.serve import engine
    from machine_learning_replications_tpu_torch.serve.hostpath import HostScorer

    params = _serve_families(cuda_device)["pipeline"]
    eng = engine.BucketedPredictEngine(params, buckets=(1, 8), device=cuda_device)
    host = HostScorer(params)
    eng.warmup()
    host.warmup()
    assert host.device.type == "cpu" and not host.trace_counts.keys() - {1, 8}
    rtol, atol = engine.parity_tolerance(params)
    for r in _serve_rows(6):
        np.testing.assert_allclose(host.predict(r[None, :]), eng.predict(r[None, :]),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# bulk scoring: pinned double-buffered copies on a copy stream
# ---------------------------------------------------------------------------


def _score_cohort(path, n, bad_every=97, seed=21):
    """A JSONL contract cohort of ``n`` rows with a malformed line before
    every ``bad_every``-th row; returns the valid rows."""
    import json

    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17

    rows = _serve_rows(n, seed=seed)
    with open(path, "w") as f:
        for i, row in enumerate(rows):
            if i and i % bad_every == 0:
                f.write("{not json\n")
            f.write(json.dumps({k: float(v) for k, v in zip(SELECTED_17, row)}) + "\n")
    return rows


def _score_run(params, path, out, dev, **kw):
    from machine_learning_replications_tpu_torch.score import ScorePipeline, open_cohort

    kw.setdefault("rows_per_shard", 250)
    return ScorePipeline(params, open_cohort(str(path), kw.pop("chunk_rows", 64)), str(out),
                         model_digest="card-test", device=dev, **kw).run()


def _score_bytes(out):
    return b"".join(name.encode() + open(os.path.join(out, name), "rb").read()
                    for name in sorted(os.listdir(out))
                    if name.startswith("scores-") or name == "quarantine.jsonl")


@pytest.mark.parametrize("family", ["stacking", "pipeline"])
def test_score_overlapped_equals_sequential_on_the_card(cuda_device, tmp_path, family):
    import json

    from machine_learning_replications_tpu_torch import convert
    from machine_learning_replications_tpu_torch.obs import torchmon
    from machine_learning_replications_tpu_torch.serve import engine

    torchmon.install()
    params = _serve_families(cuda_device, torch.float32)[family]
    rows = _score_cohort(tmp_path / "c.jsonl", 600)
    seq = _score_run(params, tmp_path / "c.jsonl", tmp_path / "seq", cuda_device, overlap=False)
    before = torchmon.totals()
    ovl = _score_run(params, tmp_path / "c.jsonl", tmp_path / "ovl", cuda_device)
    after = torchmon.totals()
    assert seq["rows"] == ovl["rows"] == 600 and ovl["bad_rows"] == 6
    assert seq["output_sha256"] == ovl["output_sha256"]
    assert _score_bytes(tmp_path / "seq") == _score_bytes(tmp_path / "ovl")
    for key in ("torch_graph_captures_total", "torch_kernel_builds_total"):
        assert after[key] == before[key]
    p1 = np.asarray([json.loads(line)["p1"] for name in sorted(os.listdir(tmp_path / "ovl"))
                     if name.startswith("scores-")
                     for line in open(tmp_path / "ovl" / name)])
    cpu = engine.oracle_proba1(convert.params_to(params, "cpu"), rows)
    np.testing.assert_allclose(p1, cpu, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("family", ["stacking", "tree", "pipeline"])
def test_score_three_chunks_in_flight_equal_the_eager_route(cuda_device, family):
    """Three chunks submitted before the first is finished hold three
    pinned slots; each chunk's ``p1`` equals the eager route on its own
    padded chunk on the card, bit for bit."""
    from machine_learning_replications_tpu_torch.data.sharding import pad_rows_to
    from machine_learning_replications_tpu_torch.score.pipeline import ChunkScorer
    from machine_learning_replications_tpu_torch.serve import engine

    params = _serve_families(cuda_device, torch.float32)[family]
    scorer = ChunkScorer(params, 256, "contract", device=cuda_device)
    X = _serve_rows(700, seed=5)
    chunks = [X[:256], X[256:512], X[512:]]
    pending = [scorer.submit(scorer.prep(c)) for c in chunks]
    assert not scorer._free                       # three slots in flight
    for c, handle in zip(chunks, pending):
        p1, members, qrows = scorer.finish(handle)
        padded, n = pad_rows_to(c, 256, mode="edge")
        want = engine.oracle_proba1(params, padded, device=cuda_device)[:n]
        np.testing.assert_array_equal(p1, want)
        assert qrows.shape == (n, 17) and (members is None) == (family == "tree")
    assert len(scorer._free) == 3
    again = scorer.submit(scorer.prep(chunks[0]))
    assert len(scorer._free) == 2                 # a finished slot is reused
    np.testing.assert_array_equal(scorer.finish(again)[0], scorer.finish(pending[0])[0])


def test_score_parse_worker_race(cuda_device, tmp_path):
    """Four parse threads against the device thread (a small prefetch
    budget, short chunks): the output bytes equal the sequential run's."""
    params = _serve_families(cuda_device, torch.float32)["pipeline"]
    _score_cohort(tmp_path / "c.jsonl", 1500, bad_every=211)
    seq = _score_run(params, tmp_path / "c.jsonl", tmp_path / "seq", cuda_device, overlap=False,
                     chunk_rows=32)
    for k in range(2):
        out = tmp_path / f"race{k}"
        ovl = _score_run(params, tmp_path / "c.jsonl", out, cuda_device, chunk_rows=32,
                         parse_workers=4, prefetch=2)
        assert ovl["output_sha256"] == seq["output_sha256"]
        assert _score_bytes(out) == _score_bytes(tmp_path / "seq")


# ---------------------------------------------------------------------------
# the fleet: workers with their own contexts, registered replicas, the loop
# ---------------------------------------------------------------------------


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "machine_learning_replications_tpu_torch", "persist", "testdata",
                       "stacking_small.pkl")


def _holds_card(pid):
    """Whether process ``pid`` has a CUDA device node (``/dev/nvidiaN``) open."""
    import re

    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            if re.fullmatch(r"/dev/nvidia\d+", os.readlink(f"/proc/{pid}/fd/{fd}")):
                return True
        except OSError:
            pass
    return False


def _smi_pids():
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return {int(line) for line in out.split() if line.strip()}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url, body=None, timeout=5.0):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def _serve(log, *argv):
    import subprocess
    import sys

    return subprocess.Popen([sys.executable, "-m", "machine_learning_replications_tpu_torch",
                             "serve", "--pkl", FIXTURE, *argv],
                            stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                            env={**os.environ, "MLR_TPU_PROGRESS": "0"})


def _stop(proc):
    import signal

    proc.send_signal(signal.SIGTERM)
    return proc.wait(timeout=120)


def test_cli_serve_workers_each_own_a_context_the_parent_none(cuda_device, tmp_path):
    import json
    import time

    port = _free_port()
    with open(tmp_path / "serve.log", "w") as log:
        proc = _serve(log, "--port", str(port), "--workers", "2", "--buckets", "1,8")
        try:
            seen, deadline = set(), time.monotonic() + 240
            while seen != {0, 1}:
                assert proc.poll() is None, (tmp_path / "serve.log").read_text()[-3000:]
                assert time.monotonic() < deadline, seen
                try:
                    health, _ = _get_json(f"http://127.0.0.1:{port}/healthz")
                    if health["ready"]:
                        seen.add(health["worker"])
                except OSError:
                    time.sleep(0.2)
            line = next(ln for ln in (tmp_path / "serve.log").read_text().splitlines()
                        if "(pids " in ln)
            pids = json.loads(line.split("(pids ")[1].rstrip(")"))
            smi = _smi_pids()
            assert len(set(pids)) == 2 and all(_holds_card(p) for p in pids)
            assert not _holds_card(proc.pid) and proc.pid not in smi
        finally:
            assert _stop(proc) == 0, (tmp_path / "serve.log").read_text()[-3000:]


def test_registered_replicas_behind_a_router_answer_the_oracle(cuda_device, tmp_path):
    import time

    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17
    from machine_learning_replications_tpu_torch.fleet import make_router
    from machine_learning_replications_tpu_torch.persist import load_inference_params
    from machine_learning_replications_tpu_torch.serve import engine

    router = make_router(port=0, probe_interval_s=0.2).start_background()
    rurl = f"http://127.0.0.1:{router.address[1]}"
    procs, logs = [], []
    try:
        for k in range(2):
            logs.append(open(tmp_path / f"r{k}.log", "w"))
            procs.append(_serve(logs[-1], "--port", "0", "--buckets", "1,8", "--register", rurl,
                                "--replica-id", f"r{k}"))
        deadline = time.monotonic() + 240
        while router.registry.ready_count() < 2:
            assert all(p.poll() is None for p in procs)
            assert time.monotonic() < deadline, router.registry.snapshot()
            time.sleep(0.2)
        params = load_inference_params(pkl=FIXTURE, device=cuda_device)
        rows = _serve_rows(40)
        want = engine.oracle_proba1(params, rows)
        rtol, atol = engine.parity_tolerance(params)
        served = set()
        for i, row in enumerate(rows):
            body, headers = _get_json(rurl + "/predict", dict(zip(SELECTED_17, map(float, row))),
                                      timeout=30)
            served.add(headers["X-Replica"])
            assert abs(body["probability"] - want[i]) <= atol + rtol * abs(want[i])
        assert served == {"r0", "r1"}
    finally:
        codes = [_stop(p) for p in procs]
        for log in logs:
            log.close()
        router.shutdown()
    assert codes == [0, 0]


def test_learn_run_cycle_on_the_card_equals_the_cpu_port(cuda_device, tmp_path):
    from machine_learning_replications_tpu_torch import convert
    from machine_learning_replications_tpu_torch.config import ExperimentConfig
    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17
    from machine_learning_replications_tpu_torch.learn import capture, loop, shadow
    from machine_learning_replications_tpu_torch.models import pipeline
    from machine_learning_replications_tpu_torch.persist import checkpoint

    cfg = ExperimentConfig.from_dict({"gbdt": {"n_estimators": 5},
                                      "svc": {"platt_cv": 2, "max_iter": 2000},
                                      "stacking": {"cv_folds": 2},
                                      "select": {"cv_folds": 3, "n_alphas": 20}})
    X64, y, _ = make_cohort(n=300, seed=7, missing_rate=0.03)
    live, _ = pipeline.fit_pipeline(X64, y, cfg, device="cpu")
    checkpoint.save_model(str(tmp_path / "live"), live)
    Xc, _, _ = make_cohort(n=300, seed=8, missing_rate=0.0)
    X17 = np.ascontiguousarray(Xc[:, selected_indices()], np.float64)
    X17[:, 0] += 1.0
    cap = capture.CohortCapture(tmp_path / "cap", rows_per_shard=128)
    for row in X17:
        cap.append_line({k: float(v) for k, v in zip(SELECTED_17, row)})
    cap.close()
    runs = {}
    for name, dev in (("card", cuda_device), ("cpu", "cpu")):
        runs[name] = loop.run_cycle(str(tmp_path / "live"), str(tmp_path / "cap"),
                                    str(tmp_path / f"cand_{name}"), None, cfg=cfg, min_rows=200,
                                    device=dev)
    assert runs["card"]["outcome"] == runs["cpu"]["outcome"]
    assert runs["card"]["verdict"]["pass"] == runs["cpu"]["verdict"]["pass"]
    cand = checkpoint.load_model(str(tmp_path / "cand_card"), device=cuda_device)
    cand_cpu = checkpoint.load_model(str(tmp_path / "cand_cpu"), device="cpu")
    got = shadow.replay_scores(cand, X17, device=cuda_device)
    want = shadow.replay_scores(cand_cpu, X17, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8)
    # and the card's candidate replayed on the CPU equals it too
    again = shadow.replay_scores(convert.params_to(cand, "cpu"), X17, device="cpu")
    np.testing.assert_allclose(again[0], got[0], rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# data-parallel training (parallel/): a one-rank NCCL world, two gloo ranks
# sharing the card
# ---------------------------------------------------------------------------

_PARALLEL_ROWS = 200_000
_PARALLEL_RANK = """
import sys
import numpy as np, torch
from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.data import make_cohort, selected_indices
from machine_learning_replications_tpu_torch.parallel import distributed, fit_gbdt_sharded, make_mesh
out, rows, depth = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert distributed.initialize_distributed()
mesh = make_mesh(2, 1)
X, y, _ = make_cohort(n=rows, seed=2020)
X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
cfg = GBDTConfig(splitter="hist", n_estimators=30, max_depth=depth)
params, aux = fit_gbdt_sharded(mesh, X17, y.astype(np.float32), cfg)
assert params.value.device.type == "cuda"
np.savez(f"{out}.rank{mesh.rank}.npz", feature=params.feature.cpu().numpy(),
         value=params.value.cpu().numpy(), deviance=aux["train_deviance"],
         backend=distributed.BRINGUP["backend"], reason=distributed.BRINGUP["reason"])
distributed.shutdown()
"""


def _parallel_cohort(rows):
    X, y, _ = make_cohort(n=rows, seed=2020)
    return np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32), y.astype(np.float32)


@pytest.mark.parametrize("depth", [1, 3])
def test_parallel_one_rank_nccl_fit_equals_the_single_device_fit(cuda_device, depth):
    """A one-rank NCCL world through ``fit_gbdt_sharded`` launches the same
    kernel entry once per tree level and fits the single-device forest
    within the float32 gates (deviance rtol 1e-4, predictions 1e-4)."""
    from machine_learning_replications_tpu_torch.parallel import (
        distributed, fit_gbdt_sharded, make_mesh,
    )

    X17, y = _parallel_cohort(_PARALLEL_ROWS)
    cfg = GBDTConfig(splitter="hist", n_estimators=30, max_depth=depth)
    assert distributed.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert distributed.BRINGUP["backend"] == "nccl"
        mesh = make_mesh(1, 1)
        assert mesh.device == cuda_device
        counter = "stump_histograms" if depth == 1 else "node_histograms"
        before = cuda_histogram.LAUNCHES[counter]
        sharded, aux = fit_gbdt_sharded(mesh, X17, y, cfg)
        assert cuda_histogram.LAUNCHES[counter] - before == cfg.n_estimators * depth
    finally:
        distributed.shutdown()
    single, single_aux = gbdt.fit(X17, y, cfg, device=cuda_device)
    np.testing.assert_allclose(aux["train_deviance"],
                               torch.as_tensor(single_aux["train_deviance"]).cpu().numpy(),
                               rtol=1e-4)
    Xd = torch.as_tensor(X17, device=cuda_device)
    torch.testing.assert_close(tree.predict_proba1(sharded, Xd), tree.predict_proba1(single, Xd),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("depth", [1, 3])
def test_parallel_two_gloo_ranks_share_the_card(cuda_device, tmp_path, depth):
    """Two ranks on one card declare gloo, compute on the card, hold one
    replicated forest, and fit the one-rank forest within the float32
    gates."""
    import subprocess
    import sys

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PARALLEL_RANK, str(tmp_path / "fit"), str(_PARALLEL_ROWS),
         str(depth)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r)}) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [np.load(tmp_path / f"fit.rank{r}.npz") for r in range(2)]
    assert str(ranks[0]["backend"]) == "gloo" and "share 1 card" in str(ranks[0]["reason"])
    for k in ("feature", "value", "deviance"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    X17, y = _parallel_cohort(_PARALLEL_ROWS)
    single, single_aux = gbdt.fit(X17, y, GBDTConfig(splitter="hist", n_estimators=30,
                                                     max_depth=depth), device=cuda_device)
    np.testing.assert_allclose(ranks[0]["deviance"],
                               torch.as_tensor(single_aux["train_deviance"]).cpu().numpy(),
                               rtol=1e-4)

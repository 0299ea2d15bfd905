"""The hand-written histogram kernel on the card, against its plain version.

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

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

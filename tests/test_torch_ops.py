"""PyTorch port ops vs the JAX package: histograms, binning, split search,
linear algebra.

Inputs are made with numpy from a seed and handed to both sides; the JAX
side runs on the CPU under x64 (``conftest.py``), its Pallas histogram
kernel in interpret mode. The port runs on the CPU, where every histogram
backend is the kernel's plain PyTorch version. Tolerances are the JAX
suite's own (``tests/test_pallas_histogram.py``): 1e-9 at float64, 1e-5 at
float32, the latter for summation regrouping in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.ops import binning as jbinning
from machine_learning_replications_tpu.ops import histogram as jhist
from machine_learning_replications_tpu.ops import linalg as jlinalg
from machine_learning_replications_tpu.ops.pallas_histogram import (
    node_histograms_pallas,
    stump_histograms_pallas,
)
from machine_learning_replications_tpu_torch.ops import binning, cuda_histogram, histogram, linalg

TOL = {np.float32: 1e-5, np.float64: 1e-9}


def _stump_inputs(seed, n, F, B, bin_dtype, val_dtype):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(n, F)).astype(bin_dtype)
    g = rng.normal(size=n).astype(val_dtype)
    h = rng.uniform(0.01, 0.25, size=n).astype(val_dtype)
    return binned, g, h


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,F,B", [(5000, 5, 32), (257, 3, 33), (64, 1, 256)])
def test_stump_histograms_reference_matches_jax(n, F, B, bin_dtype, val_dtype):
    binned, g, h = _stump_inputs(n + F + B, n, F, B, bin_dtype, val_dtype)
    got = histogram.stump_histograms_reference(
        torch.as_tensor(binned), torch.as_tensor(g), torch.as_tensor(h), B
    )
    assert got.shape == (2, F, B)
    assert got.dtype == torch.as_tensor(g).dtype
    pallas = stump_histograms_pallas(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h), B)
    xla = jhist.stump_histograms(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h), B, backend="xla"
    )
    tol = TOL[val_dtype]
    for name, want in (("pallas", pallas), ("xla", xla)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla", "matmul"])
def test_stump_histograms_backends_on_cpu_use_plain_version(backend):
    """On a CPU tensor every backend value is the plain version, and the
    kernel's launch count does not move."""
    binned, g, h = _stump_inputs(3, 500, 4, 16, np.uint8, np.float64)
    args = (torch.as_tensor(binned), torch.as_tensor(g), torch.as_tensor(h), 16)
    before = dict(cuda_histogram.LAUNCHES)
    got = histogram.stump_histograms(*args, backend=backend)
    assert cuda_histogram.LAUNCHES == before
    torch.testing.assert_close(got, histogram.stump_histograms_reference(*args),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown stump histogram backend"):
        histogram.stump_histograms(*args, backend="cuda")


@pytest.mark.parametrize("n,F,K,B", [(1000, 17, 4, 16), (257, 3, 8, 33), (64, 1, 2, 256)])
def test_stats_histograms_general_contract_matches_node_kernel(n, F, K, B):
    """The general ``[S, F, K·B]`` contract (segment offsets = node·B, four
    statistics) against JAX's node-histogram Pallas kernel."""
    rng = np.random.default_rng(n)
    binned = rng.integers(0, B, size=(n, F)).astype(np.int32)
    node = rng.integers(-1, K, size=n).astype(np.int32)
    g = rng.normal(size=n)
    h = rng.uniform(0.01, 0.25, size=n)
    want = node_histograms_pallas(jnp.asarray(binned), jnp.asarray(node), jnp.asarray(g),
                                  jnp.asarray(h), K, B)
    active = (node >= 0).astype(np.float64)
    vals = np.stack([g * active, h * active, g * g * active, active], axis=1)
    seg = (np.maximum(node, 0) * B).astype(np.int32)
    out = cuda_histogram.stats_histograms_cuda(
        torch.as_tensor(binned), torch.as_tensor(seg), torch.as_tensor(vals), K * B
    )
    stats = out.reshape(4, F, K, B).permute(0, 2, 1, 3).numpy()
    for i, name in enumerate(("grad", "hess", "grad2", "count")):
        np.testing.assert_allclose(stats[i], np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_stats_histograms_drop_out_of_range_cells():
    """A cell outside ``[0, kb)`` adds nothing (the one-hot contract)."""
    bins = torch.tensor([[0], [3], [5]], dtype=torch.int32)
    seg = torch.tensor([0, 0, 0], dtype=torch.int32)
    vals = torch.tensor([[1.0], [2.0], [4.0]], dtype=torch.float64)
    out = histogram.stats_histograms_reference(bins, seg, vals, 4)
    assert out.tolist() == [[[1.0, 0.0, 0.0, 2.0]]]


@pytest.mark.parametrize("n_bins", [2, 32, 256])
@pytest.mark.parametrize("n,seed", [(1427, 2020), (3001, 7)])
def test_device_binning_core_matches_jax(n, seed, n_bins):
    """Binned ids and midpoints equal to the bit, NaN flag equal."""
    from machine_learning_replications_tpu.data import make_cohort
    from machine_learning_replications_tpu.data.schema import selected_indices

    X = make_cohort(n=n, seed=seed)[0][:, selected_indices()]
    X[:, -1] += np.random.default_rng(seed).normal(size=n)  # a continuous column
    jb, jm, jf = jbinning.device_binning_core(jnp.asarray(X), n_bins)
    tb, tm, tf = binning.device_binning_core(torch.as_tensor(X), n_bins)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tb.dtype == torch.int32
    assert bool(tf) == bool(jf) is False
    Xn = X.copy()
    Xn[5, 3] = np.nan
    assert bool(binning.device_binning_core(torch.as_tensor(Xn), n_bins)[2]) == bool(
        jbinning.device_binning_core(jnp.asarray(Xn), n_bins)[2]
    ) is True


def test_device_binning_core_matches_jax_past_one_chunk():
    """Past one row chunk and at a size where the quantile ranks
    ``round(linspace(0, 1, B) * (n - 1))`` must be taken in float64 to land
    on the same rows as JAX's."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(65_547, 3))  # float32 ranks would move one pick here
    X[:, 0] = np.round(X[:, 0], 2)
    jb, jm, _ = jbinning.device_binning_core(jnp.asarray(X), 256)
    tb, tm, _ = binning.device_binning_core(torch.as_tensor(X), 256)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_chunked_row_reduce_ragged_chunks():
    X = torch.arange(10.0).reshape(10, 1)
    out = binning.chunked_row_reduce(X, lambda c: c * 2, chunk=4)
    torch.testing.assert_close(out, X * 2)
    with pytest.raises(ValueError, match="zero-row"):
        binning.chunked_row_reduce(X[:0], lambda c: c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_splits_matches_jax(seed):
    """Friedman split selection, including ties (integer-valued sums make
    many gains equal: both sides must pick the first in flat order), +inf
    thresholds and the leaf tests."""
    rng = np.random.default_rng(seed)
    K, F, Bm1 = 2, 4, 7
    GL = rng.integers(-3, 4, size=(K, F, Bm1)).astype(np.float64)
    CL = np.sort(rng.integers(0, 20, size=(K, F, Bm1)), axis=-1).astype(np.float64)
    GT = rng.normal(size=K)
    CT = np.array([20.0, 1.0 + seed])
    g2 = np.abs(rng.normal(size=K)) * 30
    thr = rng.normal(size=(F, Bm1))
    thr[1, 4:] = np.inf
    want = jhist.select_splits(*(jnp.asarray(a) for a in (GL, CL, GT, CT, g2, thr)),
                               min_samples_split=2, min_samples_leaf=2)
    got = histogram.select_splits(*(torch.as_tensor(a) for a in (GL, CL, GT, CT, g2, thr)),
                                  min_samples_split=2, min_samples_leaf=2)
    for name in ("do_split", "feature", "boundary", "threshold", "gain"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_newton_leaf_value_matches_jax():
    num = np.array([1.0, -2.0, 3.0, 0.5])
    den = np.array([2.0, 1e-200, -4.0, 0.0])
    np.testing.assert_array_equal(
        histogram.newton_leaf_value(torch.as_tensor(num), torch.as_tensor(den)).numpy(),
        np.asarray(jhist.newton_leaf_value(jnp.asarray(num), jnp.asarray(den))),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_newton_leaf_value_guard_below_float64(dtype):
    """The 1e-150 guard lies below every nonzero float32, so there it must
    read as den == 0: an empty node's 0/0 gives 0, as in float64, not NaN."""
    num = torch.tensor([0.0, 1.0, -2.0, 3.0])
    den = torch.tensor([0.0, 0.0, 4.0, 1e-30])
    want = histogram.newton_leaf_value(num.double(), den.double())
    got = histogram.newton_leaf_value(num.to(dtype), den.to(dtype))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:3].double(), want[:3], rtol=0, atol=0)


def test_rbf_kernel_matches_jax():
    rng = np.random.default_rng(11)
    x, y = rng.normal(size=(40, 17)), rng.normal(size=(25, 17))
    for got, want in (
        (linalg.pairwise_sq_dists(torch.as_tensor(x), torch.as_tensor(y)),
         jlinalg.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y))),
        (linalg.rbf_kernel(torch.as_tensor(x), torch.as_tensor(y), 1 / 17),
         jlinalg.rbf_kernel(jnp.asarray(x), jnp.asarray(y), 1 / 17)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)

"""Histogram statistics and split search for GBDT training.

Port of the parts of the JAX package's ``ops/histogram.py`` that the fused
depth-1 fit runs: the guarded Newton leaf value, friedman-MSE split
selection, and the per-stage ``[2, F, B]`` gradient/hessian histogram with
its ``backend`` switch.

The plain PyTorch versions of the histogram kernel live here too:

  * ``stats_histograms_reference`` — the general contract of the JAX
    package's ``_stats_histograms`` (``out[s, f, seg[r] + bin[r, f]] +=
    vals[r, s]`` → ``[S, F, K·B]``);
  * ``stump_histograms_reference`` — its K=1, S=2 case as ``index_add_``
    over flat ``f·B + bin`` ids, the counterpart of the JAX ``'xla'``
    (segment_sum) branch.

The CPU tests hold these against JAX; on the card ``chip_smoke.py`` holds
the CUDA kernel (``ops/cuda_histogram.py``) against them. Both accumulate
in float64 and return the working dtype: a float32 scatter-add adds a
million rows into one bin one after another, which loses ~1e-4 relative
(measured 8e-5 at 100k rows on the CPU) and is enough to move a fit's
split choices, so a float32 accumulator would make a poor yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# sklearn's impurity-is-zero leaf test: impurity <= EPSILON (np.finfo(double).eps)
IMPURITY_EPS = 2.220446049250313e-16

# sklearn _update_terminal_region zero guard on the Newton denominator
NEWTON_DEN_GUARD = 1e-150

BACKENDS = ("auto", "matmul", "pallas", "xla")


def newton_leaf_value(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Guarded Newton leaf value ``num/den`` (0 when |den| underflows)."""
    tiny = torch.abs(den) < NEWTON_DEN_GUARD
    return torch.where(tiny, torch.zeros_like(num), num / torch.where(tiny, torch.ones_like(den), den))


class NodeHistograms(NamedTuple):
    grad: torch.Tensor   # [K, F, B] Σ residual
    hess: torch.Tensor   # [K, F, B] Σ p(1−p)
    grad2: torch.Tensor  # [K, F, B] Σ residual²
    count: torch.Tensor  # [K, F, B] sample counts


class Splits(NamedTuple):
    do_split: torch.Tensor   # [K] bool — node splits (vs becomes/stays a leaf)
    feature: torch.Tensor    # [K] int64
    boundary: torch.Tensor   # [K] int64 — bin boundary b (left ⇔ bin ≤ b)
    threshold: torch.Tensor  # [K] float — real-valued split threshold
    gain: torch.Tensor       # [K] float — friedman proxy of the chosen split


def _acc_dtype(vals_dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(vals_dtype, torch.float32)


def stats_histograms_reference(
    bins: torch.Tensor,  # [n, F] integer bin ids
    seg: torch.Tensor,   # [n] int — per-row offset into the K·B axis (node·B)
    vals: torch.Tensor,  # [n, S] per-row statistics
    kb: int,
) -> torch.Tensor:
    """``out[s, f, seg[r] + bins[r, f]] += vals[r, s]`` → ``[S, F, kb]``.

    A cell outside ``[0, kb)`` contributes nothing, as in the one-hot
    contraction of the TPU kernel (and the CUDA kernel's guard)."""
    n, F = bins.shape
    S = vals.shape[1]
    dtype = _acc_dtype(vals.dtype)
    cell = seg.long()[:, None] + bins.long()                 # [n, F]
    ok = (cell >= 0) & (cell < kb)
    flat = (torch.arange(F, device=bins.device)[None, :] * kb
            + torch.where(ok, cell, torch.zeros_like(cell))).reshape(-1)
    out = torch.zeros((S, F * kb), dtype=torch.float64, device=bins.device)
    zero = torch.zeros((), dtype=torch.float64, device=bins.device)
    for s in range(S):
        v = torch.where(ok, vals[:, s].double()[:, None], zero)
        out[s].index_add_(0, flat, v.reshape(-1))
    return out.reshape(S, F, kb).to(dtype)


def stump_histograms_reference(
    binned: torch.Tensor,  # [n, F] integer bin ids
    grad: torch.Tensor,    # [n]
    hess: torch.Tensor,    # [n]
    max_bins: int,
) -> torch.Tensor:
    """Root-node (K=1) gradient/hessian histograms → ``[2, F, B]`` via
    ``index_add_`` over flat ``f·B + bin`` ids."""
    n, F = binned.shape
    B = max_bins
    dtype = _acc_dtype(grad.dtype)
    seg = (torch.arange(F, device=binned.device)[None, :] * B + binned.long()).reshape(-1)

    def acc(v: torch.Tensor) -> torch.Tensor:
        flat = v.double()[:, None].expand(n, F).reshape(-1)
        out = torch.zeros(F * B, dtype=torch.float64, device=binned.device)
        return out.index_add_(0, seg, flat)

    return torch.stack([acc(grad), acc(hess)]).reshape(2, F, B).to(dtype)


def stump_histograms(
    binned: torch.Tensor,  # [n, F] integer bin ids (narrow dtype preserved)
    grad: torch.Tensor,    # [n]
    hess: torch.Tensor,    # [n]
    max_bins: int,
    backend: str = "auto",
) -> torch.Tensor:
    """The per-stage statistics pass of the fused depth-1 fit → ``[2, F, B]``:
    ``out[0, f, b] = Σ_i grad[i]·[binned[i, f] == b]`` and likewise for hess.

    ``backend`` keeps ``GBDTConfig.histogram_backend``'s values. 'auto' and
    'pallas' go to ``cuda_histogram.stump_histograms_cuda``: the hand
    kernel on a CUDA tensor, its plain version on a CPU tensor (as the JAX
    package runs its Pallas kernel in interpret mode off the TPU). 'xla' and
    'matmul' ask for the plain version explicitly, on any device.
    """
    if backend in ("auto", "pallas"):
        from machine_learning_replications_tpu_torch.ops.cuda_histogram import (
            stump_histograms_cuda,
        )

        return stump_histograms_cuda(binned, grad, hess, max_bins)
    if backend in ("xla", "matmul"):
        return stump_histograms_reference(binned, grad, hess, max_bins)
    raise ValueError(
        f"unknown stump histogram backend {backend!r}; expected one of {BACKENDS}"
    )


def select_splits(
    GL: torch.Tensor,          # [K, F, B-1] left-of-boundary residual sums
    CL: torch.Tensor,          # [K, F, B-1] left-of-boundary counts
    GT: torch.Tensor,          # [K] node residual sums
    CT: torch.Tensor,          # [K] node counts
    sum_g2: torch.Tensor,      # [K] node Σ residual² (impurity leaf test)
    thresholds: torch.Tensor,  # [F, B-1] — +inf past a feature's last boundary
    min_samples_split: int = 2,
    min_samples_leaf: int = 1,
) -> Splits:
    """sklearn-equivalent friedman_mse split selection from cumulative sums.

    A node becomes a leaf when its residual variance is ≤ machine eps, it
    has fewer than ``min_samples_split`` samples, or no boundary leaves
    ≥ ``min_samples_leaf`` on both sides. Ties in gain resolve to the first
    (feature, boundary) in flat order (``torch.argmax`` returns the first
    maximum, as ``jnp.argmax`` does). Everything stays on the device: the
    chosen feature, boundary and threshold are ``[K]`` tensors.
    """
    GR = GT[:, None, None] - GL
    CR = CT[:, None, None] - CL

    valid = (
        (CL >= min_samples_leaf)
        & (CR >= min_samples_leaf)
        & torch.isfinite(thresholds)[None, :, :]
    )
    diff = GL / torch.clamp_min(CL, 1) - GR / torch.clamp_min(CR, 1)
    proxy = diff * diff * CL * CR  # friedman proxy; CT constant per node
    proxy = torch.where(valid, proxy, torch.full_like(proxy, -torch.inf))

    K, F, Bm1 = proxy.shape
    flat = proxy.reshape(K, F * Bm1)
    best = torch.argmax(flat, dim=-1)                        # [K] int64
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    f = torch.div(best, Bm1, rounding_mode="floor")
    b = best - f * Bm1
    thr = thresholds.reshape(-1).index_select(0, best)       # thresholds[f, b]

    # Node-level leaf tests (sklearn DepthFirstTreeBuilder)
    mean = GT / torch.clamp_min(CT, 1)
    impurity = torch.clamp_min(sum_g2 / torch.clamp_min(CT, 1) - mean * mean, 0.0)
    do_split = (
        (CT >= min_samples_split)
        & (impurity > IMPURITY_EPS)
        & torch.isfinite(best_gain)
    )
    return Splits(do_split=do_split, feature=f, boundary=b, threshold=thr, gain=best_gain)

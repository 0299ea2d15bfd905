"""Histogram statistics and split search for GBDT training.

Port of the parts of the JAX package's ``ops/histogram.py`` that the
GBDT fits run: the guarded Newton leaf value, friedman-MSE split selection
(``select_splits``, and ``best_splits`` over per-node histograms), and the
per-stage ``[2, F, B]`` gradient/hessian histogram of the fused depth-1 fit
with its ``backend`` switch.

The plain PyTorch versions of the histogram kernel live here too:

  * ``stats_histograms_reference`` — the general contract of the JAX
    package's ``_stats_histograms`` (``out[s, f, seg[r] + bin[r, f]] +=
    vals[r, s]`` → ``[S, F, K·B]``);
  * ``stump_histograms_reference`` — its K=1, S=2 case as ``index_add_``
    over flat ``f·B + bin`` ids, the counterpart of the JAX ``'xla'``
    (segment_sum) branch;
  * ``node_histograms`` — its S=4, seg = node·B case for the level-wise
    grower, the counterpart of the JAX ``node_histograms`` segment_sum.

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
    """Guarded Newton leaf value ``num/den`` (0 when |den| < 1e-150).

    No nonzero float32 lies below the guard, so below float64 the test is
    ``den == 0``. (Compared as written, 1e-150 would be cast to float32 0.0
    and let an empty node's 0/0 through as NaN.)"""
    if den.dtype == torch.float64:
        tiny = torch.abs(den) < NEWTON_DEN_GUARD
    else:
        tiny = den == 0
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


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis, added in XLA:CPU's order (the
    JAX package's ``jnp.cumsum`` there): sequential within blocks of 16,
    each block offset by the same scan over the block totals.

    Split search picks the first of equal gains; two candidates that cut
    the rows identically tie in exact arithmetic and differ only by the
    order their bins were added in. Summing in the oracle's order keeps the
    port's forests equal to the JAX package's on the CPU."""
    n = x.shape[-1]
    if n <= 16:
        return torch.cumsum(x, dim=-1)
    nb = -(-n // 16)
    blocks = torch.nn.functional.pad(x, (0, nb * 16 - n)).reshape(*x.shape[:-1], nb, 16)
    within = torch.cumsum(blocks, dim=-1)
    offset = xla_cumsum(within[..., -1])[..., :-1, None]     # blocks before each
    out = torch.cat([within[..., :1, :], within[..., 1:, :] + offset], dim=-2)
    return out.reshape(*x.shape[:-1], nb * 16)[..., :n]


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order: sequential within blocks
    of 32 (the zero padding split evenly before and after), then the same
    sum over the block totals (see ``xla_cumsum``)."""
    n = x.shape[-1]
    if n > 32:
        nb = -(-n // 32)
        pad = nb * 32 - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(*x.shape[:-1], nb, 32)
        return xla_sum(torch.cumsum(x, dim=-1)[..., -1])
    return torch.cumsum(x, dim=-1)[..., -1]


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


def node_histograms(
    binned: torch.Tensor,      # [n, F] or [k, n, F] integer bin ids
    node_local: torch.Tensor,  # [n] or [k, n] int — local node index, −1 ⇒ inactive row
    grad: torch.Tensor,        # [n] or [k, n]
    hess: torch.Tensor,        # [n] or [k, n]
    n_nodes: int,
    max_bins: int,
) -> NodeHistograms:
    """Per-(node, feature, bin) sums of grad, hess, grad² and counts →
    ``[K, F, B]`` each, over active rows only.

    Built on ``stats_histograms_reference`` with S=4 statistics (g·a, h·a,
    g²·a, a), a = [node_local ≥ 0], at seg = max(node_local, 0)·B, as the
    JAX package's Pallas kernel stacks them. With a leading fold axis (k
    fits at once; ``binned`` shared as ``[n, F]`` or one per fit) the folds
    become k·K segments of one call → ``[k, K, F, B]`` each."""
    if node_local.dim() == 1:
        hl = node_histograms(binned, node_local[None], grad[None], hess[None], n_nodes, max_bins)
        return NodeHistograms(*(a[0] for a in hl))
    k, n = node_local.shape
    F = binned.shape[-1]
    K, B = n_nodes, max_bins
    dtype = _acc_dtype(grad.dtype)
    active = (node_local >= 0).to(dtype)
    g = grad.to(dtype) * active
    h = hess.to(dtype) * active
    vals = torch.stack([g, h, g * g, active], dim=-1).reshape(k * n, 4)
    fold = torch.arange(k, device=node_local.device)[:, None]
    seg = ((fold * K + torch.clamp_min(node_local, 0)) * B).reshape(-1)
    bins = binned.expand(k, n, F).reshape(k * n, F)
    out = stats_histograms_reference(bins, seg, vals, k * K * B)   # [4, F, k·K·B]
    stats = out.reshape(4, F, k, K, B).permute(0, 2, 3, 1, 4)      # [4, k, K, F, B]
    return NodeHistograms(*stats.unbind(0))


def select_splits(
    GL: torch.Tensor,          # [K, F, B-1] left-of-boundary residual sums
    CL: torch.Tensor,          # [K, F, B-1] left-of-boundary counts
    GT: torch.Tensor,          # [K] node residual sums
    CT: torch.Tensor,          # [K] node counts
    sum_g2: torch.Tensor,      # [K] node Σ residual² (impurity leaf test)
    thresholds: torch.Tensor,  # [F, B-1] or per node [K, F, B-1] — +inf past a feature's last boundary
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
        & torch.isfinite(thresholds)
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
    thr = torch.gather(torch.broadcast_to(thresholds, proxy.shape).reshape(K, F * Bm1),
                       1, best[:, None])[:, 0]               # thresholds[(k,) f, b]

    # Node-level leaf tests (sklearn DepthFirstTreeBuilder)
    mean = GT / torch.clamp_min(CT, 1)
    impurity = torch.clamp_min(sum_g2 / torch.clamp_min(CT, 1) - mean * mean, 0.0)
    do_split = (
        (CT >= min_samples_split)
        & (impurity > IMPURITY_EPS)
        & torch.isfinite(best_gain)
    )
    return Splits(do_split=do_split, feature=f, boundary=b, threshold=thr, gain=best_gain)


def best_splits(
    hists: NodeHistograms,     # [K, F, B] each, or [k, K, F, B] for k fits
    thresholds: torch.Tensor,  # [F, B-1], or [k, F, B-1] (one table per fit)
    min_samples_split: int = 2,
    min_samples_leaf: int = 1,
) -> Splits:
    """Split selection from per-node histograms (the generic depth ≥ 2
    path); every node of every fit is one row of ``select_splits``, and the
    result keeps the histograms' leading ``[K]`` or ``[k, K]`` shape."""
    lead = hists.grad.shape[:-2]
    F, B = hists.grad.shape[-2:]
    grad = hists.grad.reshape(-1, F, B)
    count = hists.count.reshape(-1, F, B)
    GL = xla_cumsum(grad)[..., :-1]
    CL = xla_cumsum(count)[..., :-1]
    GT = xla_sum(grad[:, 0])
    CT = xla_sum(count[:, 0])
    sum_g2 = xla_sum(hists.grad2.reshape(-1, F, B)[:, 0])
    if thresholds.dim() == 3:  # one table per fit → one per (fit, node)
        thresholds = thresholds[:, None].expand(*lead, F, B - 1).reshape(-1, F, B - 1)
    sp = select_splits(GL, CL, GT, CT, sum_g2, thresholds, min_samples_split, min_samples_leaf)
    return Splits(*(a.reshape(lead) for a in sp))

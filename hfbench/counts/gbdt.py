"""Bytes and operations of the GBDT 'hist' fit, from its shapes.

Each input byte is counted once where it must be read and each output byte
once where it must be written, whatever a kernel reads again.

The hand histogram kernel, one launch:
  * stump entry: the ``[n, F]`` bins, ``grad`` and ``hess`` read, the
    ``[2, F, B]`` sums written;
  * node entry (``K`` nodes): the bins, the int32 node ids, ``grad`` and
    ``hess`` read, the ``[4, K, F, B]`` sums written.

One whole fit, the least a fit must do:
  * binning: ``X`` read once, the bins written once;
  * per stage: the labels and the scores read, the scores written;
  * per tree level: the bins read once; from depth 2, the node ids read
    and written once;
  * operations: per level, one add per (row, feature) for each of the two
    sums the split search needs (residual and hessian at depth 1, residual
    and count deeper), and about ten per row and stage for the residual,
    hessian, update and deviance. Bytes bind by two orders.
"""

from __future__ import annotations

from hfbench.counts.peaks import least_seconds

STAGE_OPS_PER_ROW = 10


def stump_launch_bytes(n: int, F: int, B: int, bin_bytes: int = 1, val_bytes: int = 4) -> int:
    return n * F * bin_bytes + 2 * n * val_bytes + 2 * F * B * val_bytes


def node_launch_bytes(n: int, F: int, B: int, K: int, bin_bytes: int = 1,
                      val_bytes: int = 4, id_bytes: int = 4) -> int:
    return n * F * bin_bytes + n * id_bytes + 2 * n * val_bytes + 4 * K * F * B * val_bytes


def launches_per_fit(stages: int, depth: int) -> dict:
    """Hand-kernel launches of one fit, by entry."""
    if depth == 1:
        return {"stump_histograms": stages, "node_histograms": 0}
    return {"stump_histograms": 0, "node_histograms": stages * depth}


def kernel_bytes_per_fit(n: int, F: int, B: int, stages: int, depth: int, **kw) -> int:
    """Bytes the hand kernel's launches of one fit must move."""
    if depth == 1:
        return stages * stump_launch_bytes(n, F, B, **kw)
    return stages * sum(node_launch_bytes(n, F, B, 2 ** level, **kw) for level in range(depth))


def fit_least(n: int, F: int, B: int, stages: int, depth: int, peaks: dict,
              x_bytes: int = 4, bin_bytes: int = 1, val_bytes: int = 4) -> dict:
    """The least time of one whole fit at the peaks ``peaks``."""
    nbytes = n * F * (x_bytes + bin_bytes)
    per_level = n * F * bin_bytes + (2 * n * 4 if depth > 1 else 0)
    nbytes += stages * (3 * n * val_bytes + depth * per_level)
    ops = stages * (depth * 2 * n * F + STAGE_OPS_PER_ROW * n)
    return least_seconds(nbytes, ops, peaks["bytes"], peaks["float32"])

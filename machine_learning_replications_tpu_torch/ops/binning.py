"""Feature quantisation for histogram-based tree growing (device side).

Port of ``device_binning_core`` and its row-chunk scaffolding from the JAX
package's ``ops/binning.py``: each column is sorted on the device and
``n_bins`` empirical quantile candidates are taken (duplicates weighted);
adjacent candidates give midpoint thresholds and a value's bin is the number
of thresholds strictly below it. The semantics are the JAX function's to the
bit, so a fit on the same matrix bins it identically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

ROW_CHUNK = 65_536


@dataclasses.dataclass(frozen=True)
class BinnedFeatures:
    """Quantised design matrix + the threshold table to decode splits."""

    binned: torch.Tensor      # [n, F] int — bin index per value
    thresholds: torch.Tensor  # [F, n_bins-1] float — candidate split values
    n_bins: torch.Tensor      # [F] int32 — bin count per feature

    @property
    def max_bins(self) -> int:
        return self.thresholds.shape[1] + 1


def chunked_row_reduce(
    X: torch.Tensor,
    per_chunk_fn: Callable[[torch.Tensor], torch.Tensor],
    chunk: int = ROW_CHUNK,
) -> torch.Tensor:
    """``per_chunk_fn`` over row chunks of ``X [n, ...]``, results
    concatenated along rows. For dense compare+reduce passes whose broadcast
    intermediate (``[chunk, B, F]``) must never exist at full n. The JAX
    version pads to equal chunks for ``lax.map``; eager PyTorch takes the
    ragged last chunk as it is."""
    n = X.shape[0]
    if n == 0:
        raise ValueError("chunked_row_reduce: zero-row input")
    return torch.cat(
        [per_chunk_fn(X[s:s + chunk]) for s in range(0, n, chunk)], dim=0
    )


def device_binning_core(X: torch.Tensor, n_bins: int):
    """Quantile binning on ``X``'s device.

    Returns ``(binned [n, F] int32, mids [n_bins-1, F], nan_flag)``, the
    last a 0-d bool tensor: the caller checks it once, after everything is
    queued, so binning costs no host sync of its own.
    """
    n, F = X.shape
    if n == 0:
        raise ValueError("device binning: zero-row input")
    nan_flag = torch.isnan(X).any()
    Xs = torch.sort(X, dim=0).values                       # [n, F]
    # jnp.linspace(0, 1, B) is exactly i / (B - 1) in float64 (the x64
    # oracle's default float); scaled by n − 1 and rounded half to even.
    # Computed in float64 whatever X's dtype: in float32 the products drift
    # and the picked ranks move by one at large n.
    q = torch.arange(n_bins, dtype=torch.float64, device=X.device) / (n_bins - 1)
    q_idx = torch.round(q * (n - 1)).long()
    u = Xs[q_idx, :]                                       # [B, F] candidates
    mids = (u[:-1] + u[1:]) / 2.0
    # sklearn BestSplitter guard: a midpoint that rounds up to the upper
    # value would mis-route the upper sample under "x <= t goes left".
    mids = torch.where(mids == u[1:], u[:-1], mids)        # [B-1, F]

    def _bin_chunk(xc: torch.Tensor) -> torch.Tensor:      # [chunk, F]
        return torch.sum(xc[:, None, :] > mids[None, :, :], dim=1, dtype=torch.int32)

    binned = chunked_row_reduce(X, _bin_chunk)             # [n, F] int32
    return binned, mids, nan_flag

"""Dense linear-algebra primitives (port of the JAX package's ``ops/linalg.py``).

Pairwise distances and kernel matrices are one matrix product plus rank-1
corrections (``‖x−y‖² = ‖x‖² + ‖y‖² − 2x·y``); the imputer's NaN-aware
distances are three masked products (one for a fully observed query). The
JAX package leaves these products to XLA outside any kernel, so here they go
to ``torch.matmul`` (cuBLAS on the card, with TF32 pinned off by
``device.resolve_device``).
"""

from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = ‖x_i − y_j‖²`` (leading dimensions batch), clamped
    at 0 against the small negative values the rank-1 form can produce."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    yy = torch.sum(y * y, dim=-1, keepdim=True)
    d2 = xx + yy.transpose(-1, -2) - 2.0 * (x @ y.transpose(-1, -2))
    return torch.clamp_min(d2, 0.0)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, gamma) -> torch.Tensor:
    """``exp(-γ‖x−y‖²)`` — the SVC kernel."""
    return torch.exp(-gamma * pairwise_sq_dists(x, y))


def masked_pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """NaN-aware squared distances, sklearn's ``nan_euclidean_distances``
    (squared) as ``KNNImputer`` uses them: coordinates missing in either row
    are dropped and the sum is rescaled by ``n_features / n_present``,
    clamped at 0; a pair with no shared coordinate comes out NaN. Three
    products over NaN-zeroed copies, as in the JAX package."""
    mx = ~torch.isnan(x)
    my = ~torch.isnan(y)
    x0 = torch.where(mx, x, 0.0)
    y0 = torch.where(my, y, 0.0)
    mxf, myf = mx.to(x0.dtype), my.to(x0.dtype)
    # Σ over present-in-both coordinates of (x² + y² − 2xy)
    d2 = (x0 * x0) @ myf.T + mxf @ (y0 * y0).T - 2.0 * (x0 @ y0.T)
    n_present = mxf @ myf.T
    scale = x.shape[-1] / torch.clamp_min(n_present, 1.0)
    d2 = torch.clamp_min(d2 * scale, 0.0)
    return torch.where(n_present > 0, d2, torch.nan)


def masked_pairwise_sq_dists_dense_query(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``masked_pairwise_sq_dists`` where every query row is fully observed
    (or entirely NaN, which propagates to NaN distances): mutual presence is
    the donor's presence, so the rescale depends on the donor only and the
    three masked products become one product plus rank-1 corrections. Same
    semantics: ``n_features / n_present`` rescale, 0-clamp, NaN where the
    pair shares no coordinate."""
    my = ~torch.isnan(y)
    y0 = torch.where(my, y, 0.0)
    sq = (x * x) @ my.T.to(x.dtype) - 2.0 * (x @ y0.T) + torch.sum(y0 * y0, dim=1)[None, :]
    n_present = torch.sum(my, dim=1).to(x.dtype)            # [m], donor only
    scale = x.shape[-1] / torch.clamp_min(n_present, 1.0)
    d2 = torch.clamp_min(sq * scale[None, :], 0.0)          # NaN queries propagate
    return torch.where(n_present[None, :] > 0, d2, torch.nan)

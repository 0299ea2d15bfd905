"""Dense linear-algebra primitives (port of the JAX package's ``ops/linalg.py``).

Pairwise distances and kernel matrices are one matrix product plus rank-1
corrections (``‖x−y‖² = ‖x‖² + ‖y‖² − 2x·y``). The JAX package leaves that
product to XLA outside any kernel, so here it goes to ``torch.matmul``
(cuBLAS on the card, with TF32 pinned off by ``device.resolve_device``).
"""

from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = ‖x_i − y_j‖²``, clamped at 0 against the small negative
    values the rank-1 form can produce."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    yy = torch.sum(y * y, dim=-1, keepdim=True)
    d2 = xx + yy.T - 2.0 * (x @ y.T)
    return torch.clamp_min(d2, 0.0)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, gamma) -> torch.Tensor:
    """``exp(-γ‖x−y‖²)`` — the SVC kernel."""
    return torch.exp(-gamma * pairwise_sq_dists(x, y))

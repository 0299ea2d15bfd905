"""Decision-tree ensembles as dense tensors (inference side).

A forest is five same-shaped ``[n_trees, n_nodes]`` tensors in heap layout
(root 0, children 2i+1 / 2i+2). Routing: go left iff ``x[feature] <=
threshold``. Leaves are self-loops (``left == right == self``), so
descending ``max_depth`` steps from the root lands on, and stays at, the
right leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from machine_learning_replications_tpu_torch.device import float_dtype


@dataclasses.dataclass(frozen=True)
class TreeEnsembleParams:
    feature: torch.Tensor        # [T, N] int — split feature (0 at leaves)
    threshold: torch.Tensor      # [T, N] float — split threshold (+inf at leaves)
    left: torch.Tensor           # [T, N] int — child if x[f] <= thr (self at leaves)
    right: torch.Tensor          # [T, N] int — child otherwise (self at leaves)
    value: torch.Tensor          # [T, N] float — leaf prediction (0 at internals)
    init_raw: torch.Tensor       # scalar — F₀ (prior log-odds)
    learning_rate: torch.Tensor  # scalar — stage shrinkage
    max_depth: int = 1


def apply_one_tree(
    feature: torch.Tensor,
    threshold: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    value: torch.Tensor,
    X: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Evaluate trees on ``X[n, F]`` by unrolled descent.

    The node tensors are ``[N]`` for one tree (→ ``[n]`` leaf values) or
    ``[T, N]`` for a whole forest (→ ``[T, n]``): the JAX package vmaps over
    trees, here the tree axis is a batch dimension written out.
    """
    single = feature.dim() == 1
    if single:
        feature, threshold, left, right, value = (
            t[None] for t in (feature, threshold, left, right, value)
        )
    n = X.shape[0]
    idx = torch.zeros((feature.shape[0], n), dtype=torch.long, device=X.device)
    rows = torch.arange(n, device=X.device)[None, :]
    for _ in range(max_depth):
        f = torch.gather(feature.long(), 1, idx)
        go_left = X[rows, f] <= torch.gather(threshold, 1, idx)
        idx = torch.where(
            go_left, torch.gather(left.long(), 1, idx),
            torch.gather(right.long(), 1, idx),
        )
    out = torch.gather(value, 1, idx)
    return out[0] if single else out


def apply(params: TreeEnsembleParams, X: torch.Tensor) -> torch.Tensor:
    """All trees on all rows → ``[T, n]`` leaf values.

    Depth 1 (the reference's shape) takes the gather-compare route: one
    ``[n, T]`` gather of each stump's root-split column, a broadcast compare
    and a two-way select, with no per-row node indices.
    """
    X = X.to(float_dtype(X, params.threshold))
    if params.max_depth == 1:
        f0 = params.feature[:, 0].long()           # [T] root split features
        thr0 = params.threshold[:, 0]              # [T]
        lchild = params.left[:, 0].long()          # [T] (self-loop 0 if no split)
        rchild = params.right[:, 0].long()
        t_idx = torch.arange(f0.shape[0], device=f0.device)
        lv = params.value[t_idx, lchild]           # [T] left-leaf values
        rv = params.value[t_idx, rchild]           # [T]
        Xg = X[:, f0]                              # [n, T] single gather
        return torch.where(Xg <= thr0[None, :], lv[None, :], rv[None, :]).T
    return apply_one_tree(
        params.feature, params.threshold, params.left, params.right,
        params.value, X, params.max_depth,
    )


def raw_score(params: TreeEnsembleParams, X: torch.Tensor) -> torch.Tensor:
    """Boosted raw score: ``F₀ + lr · Σ_t tree_t(X)``."""
    contrib = apply(params, X)  # [T, n]
    return params.init_raw + params.learning_rate * torch.sum(contrib, dim=0)


def predict_proba1(params: TreeEnsembleParams, X: torch.Tensor) -> torch.Tensor:
    """P(class 1) = σ(raw) — binomial-deviance link."""
    return torch.sigmoid(raw_score(params, X))

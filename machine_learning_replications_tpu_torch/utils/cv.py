"""Deterministic replication of sklearn's unshuffled CV fold assignment,
and the stratified subsample the scaled-regime guards draw.

Copies of ``kfold_test_masks``, ``stratified_kfold_test_masks{,_within}``
and ``stratified_subsample_indices`` from the JAX package's
``utils/cv.py`` (numpy only). ``StratifiedKFold(k, shuffle=False)`` is fully
deterministic, so the assignment is replicated exactly. Masks, not index
lists: every fold shares one shape, so fold fits batch over a fold axis.
"""

from __future__ import annotations

import numpy as np


def kfold_test_masks(n: int, k: int) -> np.ndarray:
    """``KFold(k, shuffle=False)``: contiguous blocks, first ``n % k`` folds
    one row larger. Returns ``[k, n]`` float 0/1 test masks."""
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    masks = np.zeros((k, n))
    start = 0
    for i, sz in enumerate(sizes):
        masks[i, start : start + sz] = 1.0
        start += sz
    return masks


def stratified_kfold_test_masks_within(
    y: np.ndarray, k: int, row_mask: np.ndarray
) -> np.ndarray:
    """Stratified k-fold test masks of the subset ``row_mask == 1``, expanded
    back to full-length ``[k, n]`` masks (rows outside the subset are 0 in
    every fold). Matches sklearn fitting ``StratifiedKFold(k)`` on the
    subset — the nested Platt CV inside each stacking fold fit."""
    y = np.asarray(y)
    rows = np.where(np.asarray(row_mask) > 0.5)[0]
    sub = stratified_kfold_test_masks(y[rows], k)  # [k, n_sub]
    masks = np.zeros((k, y.shape[0]))
    masks[:, rows] = sub
    return masks


def stratified_kfold_test_masks(y: np.ndarray, k: int) -> np.ndarray:
    """``StratifiedKFold(k, shuffle=False)`` exactly as sklearn assigns it:
    for each class, its occurrences (in row order) are dealt into folds in
    blocks sized by interleaving the sorted class sequence. Returns ``[k, n]``
    float 0/1 test masks."""
    y = np.asarray(y)
    classes, y_enc = np.unique(y, return_inverse=True)
    n_classes = classes.shape[0]
    y_order = np.sort(y_enc)
    allocation = np.asarray(
        [np.bincount(y_order[i::k], minlength=n_classes) for i in range(k)]
    )  # [k, n_classes]
    test_folds = np.empty(y.shape[0], dtype=int)
    for c in range(n_classes):
        folds_for_class = np.arange(k).repeat(allocation[:, c])
        test_folds[y_enc == c] = folds_for_class
    masks = np.zeros((k, y.shape[0]))
    for i in range(k):
        masks[i, test_folds == i] = 1.0
    return masks


def stratified_subsample_indices(
    y: np.ndarray,
    m: int,
    rows: np.ndarray | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Deterministic stratified subsample of ``m`` indices (from ``rows``,
    default all): per-class counts by largest-remainder apportionment of the
    class frequencies, rows drawn without replacement by a seeded
    ``numpy`` Generator. Returns sorted indices into the full array."""
    y = np.asarray(y)
    rows = np.arange(y.shape[0]) if rows is None else np.asarray(rows)
    if m >= rows.shape[0]:
        return np.sort(rows)
    rng = np.random.default_rng(seed)
    ysub = y[rows]
    classes, counts = np.unique(ysub, return_counts=True)
    quota = m * counts / counts.sum()
    take = np.floor(quota).astype(int)
    # largest remainders round up until the total hits m
    for c in np.argsort(-(quota - take))[: m - take.sum()]:
        take[c] += 1
    picked = []
    for c, t in zip(classes, take):
        members = rows[ysub == c]
        picked.append(rng.choice(members, size=t, replace=False))
    return np.sort(np.concatenate(picked))

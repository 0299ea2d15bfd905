"""Deterministic replication of sklearn's unshuffled stratified CV folds.

Copy of ``stratified_kfold_test_masks`` from the JAX package's
``utils/cv.py`` (numpy only). ``StratifiedKFold(k, shuffle=False)`` is fully
deterministic, so the assignment is replicated exactly. Masks, not index
lists: every fold shares one shape, so fold fits batch over a fold axis.
"""

from __future__ import annotations

import numpy as np


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

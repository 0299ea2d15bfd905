"""Host-side model-selection metrics.

Copy of the numpy/scipy part of the JAX package's ``utils/metrics.py``.
"""

from __future__ import annotations

import numpy as np


def roc_auc_batch_host(y_true, scores) -> np.ndarray:
    """Tie-averaged rank AUC over a batch of score rows ``[L, m]`` → ``[L]``,
    in host numpy (scipy ``rankdata`` along the row axis): the Mann-Whitney
    U statistic, equal to sklearn's trapezoidal ``roc_auc_score``. Returns
    NaN rows when a class is empty, rather than warning."""
    from scipy.stats import rankdata

    y = np.asarray(y_true, np.float64)
    n_pos = y.sum()
    n_neg = y.size - n_pos
    scores = np.atleast_2d(np.asarray(scores, np.float64))
    if n_pos == 0 or n_neg == 0:
        return np.full(scores.shape[0], np.nan)
    r = rankdata(scores, axis=-1, method="average")
    u = (r * y[None, :]).sum(axis=-1) - n_pos * (n_pos + 1.0) / 2.0
    return u / (n_pos * n_neg)

"""MAT-file ingestion (reference contract: ``HF/load_data_public.py:4-14``).

Copy of ``load_data`` and ``save_data`` from the JAX package's
``data/matloader.py``, on scipy's reader (the JAX package's native C++
reader is not ported). The ``.mat`` must contain ``data_tb`` (features +
outcome in the last column) and ``clin_var_names``.
"""

from __future__ import annotations

import numpy as np


def load_data(dataset_path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load ``(X, Y, var_names)`` from a MAT file, as
    ``load_data_public.load_data`` does: features are all columns but the
    last of ``data_tb``, the outcome is the last column; both float64."""
    import scipy.io as sio

    d = sio.loadmat(dataset_path)
    data, var_names = d["data_tb"], d["clin_var_names"]
    X = data[:, :-1].astype(np.float64)
    Y = data[:, -1].astype(np.float64)
    return X, Y, var_names


def save_data(dataset_path: str, X: np.ndarray, y: np.ndarray, var_names: np.ndarray) -> None:
    """Write a cohort in the reference's ``.mat`` layout."""
    import scipy.io as sio

    data_tb = np.concatenate([X, y.reshape(-1, 1)], axis=1)
    sio.savemat(dataset_path, {"data_tb": data_tb, "clin_var_names": var_names})

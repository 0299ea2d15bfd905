"""MAT-file ingestion (reference contract: ``HF/load_data_public.py:4-14``).

Copy of ``load_data``, ``load_feature_matrix`` and ``save_data`` from the
JAX package's ``data/matloader.py``, on scipy's reader: the JAX package's
native C++ MAT-v5 reader (``native/matio``) is not ported yet (ROADMAP,
"still to port"), so ``backend='native'`` raises. The ``.mat`` must contain
``data_tb`` (features + outcome in the last column) and ``clin_var_names``.
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


#: ``data_tb`` widths the bulk-scoring loader understands: the model's
#: feature spaces bare (64 raw schema columns / 17 contract columns) or in
#: the reference training layout with the outcome appended as the last
#: column (65 / 18 — ``load_data_public.py:9-10``).
_SCORE_WIDTHS = {64: 64, 65: 64, 17: 17, 18: 17}


def load_feature_matrix(dataset_path: str, backend: str = "auto") -> np.ndarray:
    """Feature matrix of a cohort ``.mat`` for label-free bulk scoring
    (``score/``): accepts both bare feature matrices and the reference
    training layout, stripping a trailing outcome column when one is
    present. Width is the route signal downstream — 64 raw schema columns
    run the full pipeline (impute → select → ensemble), 17 contract
    columns the contract route. ``backend`` is ``'auto'`` or ``'scipy'``
    (the same reader); ``'native'`` raises until ``native/matio`` is
    ported."""
    if backend not in ("auto", "native", "scipy"):
        raise ValueError(f"unknown backend {backend!r}; use auto | native | scipy")
    if backend == "native":
        raise NotImplementedError(
            "the native MAT-v5 reader (native/matio) is not ported yet "
            "(ROADMAP, still to port); use backend='scipy'"
        )
    import scipy.io as sio

    data = sio.loadmat(dataset_path)["data_tb"]
    width = data.shape[1]
    feat = _SCORE_WIDTHS.get(width)
    if feat is None:
        raise ValueError(
            f"{dataset_path!r}: data_tb is {width} columns wide; expected "
            "64 raw schema features or 17 contract features (with or "
            "without a trailing outcome column)"
        )
    return data[:, :feat].astype(np.float64)


def save_data(dataset_path: str, X: np.ndarray, y: np.ndarray, var_names: np.ndarray) -> None:
    """Write a cohort in the reference's ``.mat`` layout."""
    import scipy.io as sio

    data_tb = np.concatenate([X, y.reshape(-1, 1)], axis=1)
    sio.savemat(dataset_path, {"data_tb": data_tb, "clin_var_names": var_names})

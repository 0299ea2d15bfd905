"""Row padding to a fixed shape (numpy only).

Port of ``pad_rows_to`` from the JAX package's ``data/sharding.py``. Its
``pad_rows`` and ``shard_rows`` (rows placed across a device mesh) wait for
the data-parallel slice (ROADMAP item 7).
"""

from __future__ import annotations

import numpy as np


def pad_rows_to(
    x: np.ndarray, rows: int, mode: str = "zero"
) -> tuple[np.ndarray, int]:
    """Pad axis 0 up to an exact row count (the bulk-scoring device stage
    pads every streamed chunk, tail included, to one shape). ``mode='edge'``
    replicates the last real row (the serving engine's padding: every
    predict path is a pure per-row map, so replicated rows cannot perturb
    real ones and, unlike zeros, cannot manufacture NaN/denormal edge cases
    in imputed feature space); ``'zero'`` pads zero rows, which a consumer
    masks out of reductions by the returned count. Returns ``(padded,
    n_real)``."""
    n = x.shape[0]
    if n > rows:
        raise ValueError(f"cannot pad {n} rows down to {rows}")
    if n == rows:
        return x, n
    if mode not in ("zero", "edge"):
        raise ValueError(f"unknown pad mode {mode!r}; use 'zero' or 'edge'")
    pad_width = [(0, rows - n)] + [(0, 0)] * (x.ndim - 1)
    if mode == "edge" and n > 0:
        return np.pad(x, pad_width, mode="edge"), n
    return np.pad(x, pad_width), n

"""Row padding and row placement across a mesh.

Port of the JAX package's ``data/sharding.py``. ``pad_rows`` and
``pad_rows_to`` are numpy only. ``shard_rows`` is the one-process-per-rank
form of JAX's placement: where JAX puts every shard of a padded array on
the mesh's devices, each rank here keeps its own contiguous row block, on
its own device.
"""

from __future__ import annotations

import numpy as np


def pad_rows(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad axis 0 with zero rows up to a multiple of ``multiple``. Returns the
    padded array and the original row count; consumers mask reductions
    beyond it."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width), n


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


def row_block(n: int, n_shards: int, index: int) -> tuple[int, int, int]:
    """``(start, stop, n_local)`` of shard ``index``'s rows when ``n`` rows,
    padded to a multiple of ``n_shards``, are cut into equal contiguous
    blocks; ``stop`` is clipped to the real rows (the rest of the block is
    padding)."""
    n_local = -(-n // n_shards)
    start = min(index * n_local, n)
    return start, min(start + n_local, n), n_local


def shard_rows(mesh, *arrays, axis: str = "data", pad_value=0):
    """This rank's padded contiguous row block of each array, on the mesh's
    device: ``(block or blocks, n_rows)``.

    Rows are padded (with ``pad_value``) to a multiple of the axis size and
    cut into equal blocks; the rank takes the block of its coordinate on
    ``axis``. Padding rows are fabricated, so every consumer masks its
    reductions by the returned real row count, as in JAX. Arrays may be
    numpy arrays or tensors (sliced where they lie, then moved)."""
    import torch

    n_rows = None
    out = []
    for a in arrays:
        n = a.shape[0]
        if n_rows is None:
            n_rows = n
        elif n != n_rows:
            raise ValueError(f"row-count mismatch: {n} vs {n_rows}")
        start, stop, n_local = row_block(n, mesh.shape[axis], mesh.axis_index(axis))
        block = torch.as_tensor(a[start:stop]).to(mesh.device)
        if stop - start < n_local:
            pad = torch.full((n_local - (stop - start),) + tuple(block.shape[1:]), pad_value,
                             dtype=block.dtype, device=block.device)
            block = torch.cat([block, pad])
        out.append(block)
    return (out[0] if len(out) == 1 else tuple(out)), (n_rows or 0)

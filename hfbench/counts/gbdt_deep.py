"""Bytes of the grower's leaf-sum kernel, from its shapes.

Each input byte is counted once where it must be read and each output byte
once where it must be written, whatever the kernel reads again (it walks
its rows once per tile of 16 segments). One launch of ``k`` fits over
``n`` rows and ``segs`` segments: the int32 node ids, ``g`` and ``h`` read,
the ``[2, k, segs]`` float64 sums written. The grower sums ``2^(d+1)``
segments a tree at depth ``d`` (its ``2^(d+1) - 1`` heap nodes and the
segment of parked rows), one launch a stage.
"""

from __future__ import annotations


def leaf_launch_bytes(n: int, segs: int, k: int = 1, val_bytes: int = 4,
                      id_bytes: int = 4) -> int:
    return k * n * (id_bytes + 2 * val_bytes) + 2 * k * segs * 8


def leaf_bytes_per_fit(n: int, stages: int, depth: int, **kw) -> int:
    """Bytes the leaf-sum launches of one fit must move."""
    return stages * leaf_launch_bytes(n, 2 ** (depth + 1), **kw)

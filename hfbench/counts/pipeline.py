"""Operations and bytes of one served pipeline batch, from its shapes.

For ``n`` contract rows (``present`` variables of ``width`` schema columns),
``donors`` imputer donors of which ``masked`` missing columns have a NaN
among the donors, ``sv`` support vectors over ``F`` support columns,
``trees`` stumps and ``iters`` coupling steps; float64 throughout:

  * imputer: the squared distance over the present columns (a subtract, a
    multiply and an add per row, donor and column); one minimum over the
    donors for the donor-complete missing columns and one per masked
    column (a compare per row and donor);
  * SVC: the RBF block (three per row, vector and column, one exp per row
    and vector), the dual product (two per row and vector), Platt, and
    libsvm's coupling at ``COUPLING_OPS`` per row and step;
  * stumps (a compare and an add per row and tree), the L1-LR and the
    meta-LR (two per row and weight), the scaler (two per row and column);
  * bytes: the donors, the support vectors and the other weights read once,
    the ``[n, width]`` input read once, P(class 1) written once.
"""

from __future__ import annotations

from hfbench.counts.peaks import least_seconds

COUPLING_OPS = 24
VAL_BYTES = 8


def batch_ops(n: int, *, present: int, donors: int, masked: int, sv: int, F: int,
              trees: int, iters: int) -> int:
    impute = 3 * n * donors * present + (1 + masked) * n * donors
    svc = 3 * n * sv * F + n * sv + 2 * n * sv + 8 * n + COUPLING_OPS * n * iters
    rest = 2 * n * F + 2 * n * trees + 2 * n * F + 2 * n * 3 + 8 * n
    return impute + svc + rest


def batch_bytes(n: int, *, width: int, donors: int, sv: int, F: int, trees: int) -> int:
    weights = donors * width + width + sv * F + sv + 2 * F + 3 * trees + 2 * F + 3 + 8
    return VAL_BYTES * (weights + n * width + n)


def batch_least(n: int, peaks: dict, **shape) -> dict:
    """The least time of one batch at the float64 peak (the tensor cores',
    the highest the data sheet gives) and the memory rate."""
    ops = batch_ops(n, **{k: shape[k] for k in ("present", "donors", "masked", "sv", "F",
                                                "trees", "iters")})
    nbytes = batch_bytes(n, **{k: shape[k] for k in ("width", "donors", "sv", "F", "trees")})
    return least_seconds(nbytes, ops, peaks["bytes"], peaks["float64_tensor"])

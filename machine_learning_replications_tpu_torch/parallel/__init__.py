"""Data parallelism on ``torch.distributed``.

Port of the JAX package's ``parallel/``. The reference is one process; its
implicit parallel axes become the two axes of a mesh of ranks:

  data  — rows of the cohort: each rank histograms its own row block with
          the hand-written kernel, and the partials are all-reduced;
  model — feature tiles of the depth-1 split search.

Where JAX runs one program over a mesh of devices (``shard_map`` with
``psum``), here every rank is a process with one device running the same
loop, and the collectives are ``all_reduce`` calls on the mesh's process
groups (``mesh.py``). ``distributed.initialize_distributed`` brings the
process group up; a ``(1, 1)`` mesh without one runs in a single process.
"""

from machine_learning_replications_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    single_device_mesh,
)
from machine_learning_replications_tpu_torch.parallel import (
    distributed,
    hist_trainer,
    stump_trainer,
)


def fit_gbdt_sharded(mesh, X, y, cfg, sample_weight=None, bins=None):
    """Mesh-sharded GBDT fit, dispatching like ``models.gbdt.fit``: the stump
    trainer at depth 1 (rows over 'data', feature tiles over 'model') while
    its per-shard working set fits ``stump_trainer.MAX_LAYOUT_BYTES``, the
    level-wise trainer otherwise (depth ≥ 2, or the guard's fall-through).
    Without ``bins`` the binning policy is ``gbdt.default_bins`` on the
    mesh's device. Returns ``(params, aux)``."""
    from machine_learning_replications_tpu_torch.models import gbdt

    if bins is None:
        import torch

        bins = gbdt.default_bins(torch.as_tensor(X), cfg, mesh.device)
    if cfg.max_depth == 1:
        n, F = bins.binned.shape
        _, _, _, per_shard = stump_trainer._layout_plan(
            n, F, int(bins.max_bins), mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS])
        if per_shard <= stump_trainer.MAX_LAYOUT_BYTES:
            return stump_trainer.fit(mesh, X, y, cfg, bins=bins, sample_weight=sample_weight)
    return hist_trainer.fit(mesh, X, y, cfg, bins=bins, sample_weight=sample_weight)


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "single_device_mesh",
    "distributed",
    "fit_gbdt_sharded",
    "hist_trainer",
    "stump_trainer",
]

"""Persistence: the port's checkpoint format (``checkpoint``) and the legacy
sklearn pickle import (``sklearn_import``).

The JAX package checkpoints with Orbax; the port cannot read those (it
imports no JAX) and writes its own format with the same publish, integrity
and rollback semantics. JAX parameters cross over as numpy through
``convert.py``; a sklearn pickle (the
reference's shipped model included, given by path) is decoded without sklearn and without running pickled code.
"""

import os


def load_inference_params(model: "str | None" = None, pkl: "str | None" = None, *,
                          device=None):
    """The inference parameters a front end serves (``cli predict``), on
    ``device`` (default: the card): the port checkpoint at ``model`` when it
    is given — of whichever family its sidecar names (``PipelineParams``,
    ``StackingParams`` or ``TreeEnsembleParams``), falling back to its
    last-known-good slot (``checkpoint.load_model``) — else the sklearn
    pickle ``pkl``, as a ``StackingParams``. A pickle that is not there
    raises ``FileNotFoundError`` naming the path. With neither, ``ValueError``
    (``sklearn_import.NO_DEFAULT_PKL``): unlike the JAX package, the port
    has no default pickle, since the reference's shipped model lies outside
    its checkout."""
    if model:
        from machine_learning_replications_tpu_torch.persist import checkpoint

        return checkpoint.load_model(model, device=device)
    from machine_learning_replications_tpu_torch.persist.sklearn_import import (
        NO_DEFAULT_PKL,
        decode_pickle,
        import_stacking,
    )

    if not pkl:
        raise ValueError(NO_DEFAULT_PKL)
    if not os.path.isfile(pkl):
        raise FileNotFoundError(f"no sklearn pickle at {pkl!r}")
    return import_stacking(decode_pickle(pkl), device=device)

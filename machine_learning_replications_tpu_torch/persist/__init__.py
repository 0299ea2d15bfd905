"""Persistence: the port's checkpoint format (``checkpoint``).

The JAX package checkpoints with Orbax; the port cannot read those (it
imports no JAX) and writes its own format with the same publish, integrity
and rollback semantics. JAX parameters cross over as numpy through
``convert.py``.
"""


def load_inference_params(model: str, *, device=None):
    """The inference parameters a front end serves (``cli predict``): the
    checkpoint at ``model``, of whichever family its sidecar names
    (``PipelineParams``, ``StackingParams`` or ``TreeEnsembleParams``), on
    ``device`` (default: the card). A checkpoint that fails to load falls
    back to its last-known-good slot (``checkpoint.load_model``)."""
    from machine_learning_replications_tpu_torch.persist import checkpoint

    return checkpoint.load_model(model, device=device)

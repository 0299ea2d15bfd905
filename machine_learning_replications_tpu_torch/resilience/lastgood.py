"""Last-known-good rollback telemetry.

Port of the JAX package's ``resilience/lastgood.py``, thinned: the port's
checkpoint format already owns the rotation (``persist.checkpoint``'s
publish moves the previous checkpoint to ``<path>.lastgood``) and the
fallback (``load_model_versioned`` loads the last-known-good when the
primary fails). What this module owns is what makes a rollback LOUD, as in
JAX: the ``resilience_checkpoint_rollbacks_total`` counter, the journaled
``checkpoint_rollback`` event with the primary's error, and the stderr line.
Serving yesterday's model silently would be as dangerous as the corruption
itself; ``/metrics`` and ``/admin/deploy``'s ``rolled_back`` result expose it.
"""

from __future__ import annotations

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

CHECKPOINT_ROLLBACKS = REGISTRY.counter(
    "resilience_checkpoint_rollbacks_total",
    "Checkpoint loads that fell back to the retained last-known-good "
    "after the primary failed to restore.",
)


def record_rollback(path: str, lastgood: str, error: str) -> None:
    """Account one rollback of the checkpoint at ``path`` to ``lastgood``
    (both absolute), after the primary failed with ``error``: counted,
    journaled and said on stderr."""
    from machine_learning_replications_tpu_torch.utils.trace import stage_say

    CHECKPOINT_ROLLBACKS.inc()
    journal.event("checkpoint_rollback", path=path, lastgood=lastgood, error=error)
    stage_say(
        f"checkpoint {path!r} failed to restore ({error}) — rolled back "
        f"to last-known-good {lastgood!r}"
    )

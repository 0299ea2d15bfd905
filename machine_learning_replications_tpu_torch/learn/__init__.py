"""Continual learning, the offline half: the port of the JAX package's
``learn/`` as far as it runs without a fleet router.

  ``capture``   bounded rotating JSONL window of served rows (the
                ``score``/``loadgen`` patient format) — the refit's data;
                a verbatim copy of the JAX module
  ``retrain``   warm-start refit of the live family on the captured
                cohort (``fit_pipeline``/``fit_stacking`` stage
                checkpoints — resumable), published through the atomic
                versioned checkpoint path
  ``shadow``    the candidate replayed against captured traffic before it
                may serve: divergence, flip rate, candidate self-quality on
                its OWN reference profile, disagreement delta —
                ``learn_shadow_*`` metrics + a machine-readable verdict

The JAX package's ``trigger``, ``promote`` and ``loop`` talk to a fleet
router; they come with the fleet slice (ROADMAP item 8b).
"""

from machine_learning_replications_tpu_torch.learn.capture import (
    CohortCapture,
    load_recent,
)
from machine_learning_replications_tpu_torch.learn.shadow import (
    ShadowThresholds,
    cohort_quality,
    score_divergence,
)

__all__ = [
    "CohortCapture",
    "ShadowThresholds",
    "cohort_quality",
    "load_recent",
    "score_divergence",
]

"""Continual learning: the port of the JAX package's ``learn/``.

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
  ``trigger``   the debounced drift trigger over the fleet's replicas
                (a verbatim copy)
  ``promote``   the guarded promotion: publish + rolling deploy through
                the fleet router on a passing verdict, park on a failing one
  ``loop``      the closed loop (``cli learn run``): trigger → retrain →
                shadow → promote

``capture``, ``trigger`` and ``promote``'s router half import no torch;
the exports below resolve on first use, so importing one of them does not
pull in the refit's or the replay's stack.
"""

from machine_learning_replications_tpu_torch.lazyimport import lazy_exports

_EXPORTS = {
    "CohortCapture": "capture",
    "load_recent": "capture",
    "ShadowThresholds": "shadow",
    "cohort_quality": "shadow",
    "score_divergence": "shadow",
    "TriggerPolicy": "trigger",
    "poll_quality": "trigger",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)

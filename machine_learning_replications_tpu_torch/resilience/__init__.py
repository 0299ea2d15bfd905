"""Resilience layer — fault injection, supervised serving, checkpoint rollback.

The serving path (serve/) and the observability stack (obs/) can *see*
failures; this package makes the system *survive* them, and proves it the
only credible way: by injecting the faults deterministically and asserting
the degradation contract under test (``tests/test_resilience.py``,
``tools/chaos_drill.py``, the CI chaos job).

  * ``faults`` — a process-global, deterministic fault-injection registry.
    Named sites woven into serve/persist hot paths can be armed to raise,
    delay, or corrupt on a seeded schedule; every firing is journaled and
    counted (``fault_injected_total{site}``). Zero measurable cost while
    nothing is armed.
  * ``supervisor`` — ``SupervisedEngine`` wraps the bucketed predict
    engine with a per-flush watchdog deadline and a circuit breaker:
    a wedged or repeatedly-failing compute trips the breaker, ``/predict``
    sheds with an explicit 503 + ``Retry-After`` while a bounded
    exponential-backoff restart rebuilds and re-warms the engine off the
    request path, and every transition is journaled and exported
    (``resilience_*`` metric families).
  * ``lastgood`` — last-known-good checkpoint retention and rollback:
    ``persist.orbax_io`` publishes checkpoints atomically with a content
    checksum manifest and retains the previous checkpoint; a torn or
    corrupt restore falls back to it (journaled ``checkpoint_rollback``)
    so a bad deploy degrades to the previous model, not a dead server.

The degradation contract, chaos-verified end to end: under every injected
fault class a client gets either a correct answer or an explicit shed —
never a wrong answer, never a hang (docs/RESILIENCE.md).
"""

from machine_learning_replications_tpu_torch.resilience.faults import (  # noqa: F401
    InjectedFault,
    arm,
    disarm,
    fire,
    parse_spec,
    reset,
)
from machine_learning_replications_tpu_torch.resilience.supervisor import (  # noqa: F401
    BreakerOpen,
    ComputeDeadlineExceeded,
    SupervisedEngine,
)

"""L7 — the fleet tier: N replicas as one service (docs/FLEET.md).

Everything below this package is replica-side plumbing — the
liveness/readiness split, drain-first shutdown, breaker-aware
``/readyz``, last-known-good rollback, the event-loop transport. The
fleet tier is the layer that composes them into a *service*:

  * ``fleet.registry`` — the replica rotation table: probe-driven
    in/out, per-replica request breakers, admin holds, every transition
    journaled and on ``fleet_*`` metrics.
  * ``fleet.health`` — the ``/readyz`` prober feeding the registry.
  * ``fleet.router`` — the front-door HTTP router (``make_router``):
    the serve transport reused, with per-request retry/hedging, deadline
    propagation, and replica/version header passthrough.
  * ``fleet.deploy`` — rolling deploys of versioned checkpoints
    (``persist.checkpoint_version``), in capacity-gated waves through
    the replica-side ``/admin/deploy`` warm swap, with the
    last-known-good rollback as the safety net.
  * ``fleet.lifecycle`` — the replica lifecycle manager: spawn →
    ready → drain-first retire (hold → settle → SIGTERM → deadline
    SIGKILL) → crash replacement with backoff, every arc journaled.
  * ``fleet.autoscale`` — the load-driven control loop over it:
    router/replica load signals → debounced, cooled-down, bounded
    scale decisions (``cli fleet autoscale``).

Deliberately jax-free: a router process starts in milliseconds and
needs no accelerator stack. Enforced statically — the whole package is
in the import-purity manifest (``analysis/project.py``; graftcheck rule
``import-purity``, docs/ANALYSIS.md), so an import-time jax edge
anywhere in its transitive closure fails CI.
"""

from machine_learning_replications_tpu_torch.fleet.autoscale import (
    AutoscaleDaemon,
    AutoscalePolicy,
    AutoscaleThresholds,
)
from machine_learning_replications_tpu_torch.fleet.deploy import (
    manifest_version,
    rolling_deploy,
)
from machine_learning_replications_tpu_torch.fleet.lifecycle import (
    LifecycleManager,
    ReplicaSpec,
    RouterClient,
)
from machine_learning_replications_tpu_torch.fleet.health import (
    HealthProber,
    probe_replica,
)
from machine_learning_replications_tpu_torch.fleet.registry import (
    Replica,
    ReplicaRegistry,
)
from machine_learning_replications_tpu_torch.fleet.router import (
    RouterHandle,
    make_router,
)

__all__ = [
    "AutoscaleDaemon",
    "AutoscalePolicy",
    "AutoscaleThresholds",
    "HealthProber",
    "LifecycleManager",
    "Replica",
    "ReplicaRegistry",
    "ReplicaSpec",
    "RouterClient",
    "RouterHandle",
    "make_router",
    "manifest_version",
    "probe_replica",
    "rolling_deploy",
]

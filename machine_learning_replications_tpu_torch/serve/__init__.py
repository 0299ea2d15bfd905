"""Inference serving of the port (the JAX package's ``serve/``).

  ``engine``    batched predict over a fixed bucket ladder: one CUDA graph
                captured per bucket on the card, a bounded capture count,
                startup warmup held to the eager ``cli predict`` route
  ``hostpath``  the host fast path: the same engine over a CPU copy of the
                parameters, and its bounded worker pool
  ``batcher``   thread-safe micro-batching (max-batch / max-wait flush),
                bounded admission with explicit load shedding, graceful
                drain, and the dual-path router
  ``protocol``  pure HTTP/1.1 parse/respond rules (a copy of the JAX
                package's; no sockets)
  ``transport`` the non-blocking ``selectors`` event loop (a copy)
  ``metrics``   the ``serve_*`` instruments (a copy; the fleet merges them)
  ``server``    the application: ``/predict``, ``/healthz``, ``/readyz``,
                ``/metrics``, the guarded ``/debug/*`` surfaces and
                ``/admin/deploy``; ``make_server`` assembles the stack on
                ``device=`` (default: the card)

The engine runs supervised by default (``resilience.supervisor``):
watchdog deadline per flush, circuit breaker, degraded-mode 503 +
``Retry-After`` shedding, and bounded-backoff restart that re-captures.

Entry point: ``python -m machine_learning_replications_tpu_torch serve``.
"""

from machine_learning_replications_tpu_torch.lazyimport import lazy_exports

# Resolved on first use: the fleet's processes import ``serve.protocol``,
# ``serve.transport`` and ``serve.metrics`` without torch, which the engine,
# host path and server pull in.
_EXPORTS = {
    "BucketedPredictEngine": "engine",
    "DEFAULT_BUCKETS": "engine",
    "HostBusy": "hostpath",
    "HostPath": "hostpath",
    "HostScorer": "hostpath",
    "MicroBatcher": "batcher",
    "Overloaded": "batcher",
    "PathRouter": "batcher",
    "ServingMetrics": "metrics",
    "ServerHandle": "server",
    "make_server": "server",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)

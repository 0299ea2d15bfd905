"""Serving metrics — the observability half of the serving contract.

Copy of the JAX package's ``serve/metrics.py`` (stdlib + numpy); every
``serve_*`` family name and its exposition stay as they are, because the
fleet merges them.

A model server that sheds load needs numbers to prove the shedding was
correct: offered vs served throughput, latency quantiles, how deep the
admission queue ran, and how much device work the bucket ladder wasted on
padding. Everything here is one lock per instrument, rendered in
Prometheus text exposition format on ``/metrics`` (``serve.server``);
``snapshot()`` is the same data as a dict for JSON consumers and tests.

Quantiles come from a bounded ring of recent observations (default 8192)
rather than streaming sketches: a serving process answering p99 questions
about *recent* traffic wants a sliding window anyway, and the ring keeps
the memory bound explicit (one f64 per slot).

The primitive instruments (``Counter`` / ``Gauge`` / ``Histogram``) live in
``obs.registry`` and are re-exported here. The serving ``/metrics`` page
appends the global registry's exposition (the graph-capture, kernel and
transfer accounting of ``obs.torchmon``); see ``serve.server``.
"""

from __future__ import annotations

import time
from typing import Sequence

# Re-exported: the serving layer's instruments are the shared obs
# primitives (import sites and pickles of these classes keep working).
from machine_learning_replications_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
)


# Latency buckets in seconds: sub-ms through 10 s, roughly log-spaced — wide
# enough for a cold-compile outlier, fine enough to see micro-batch wait.
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Queue-wait buckets: tuned around the flush interval (--max-wait-ms,
# default 5 ms). A healthy server's waits cluster at or below that knob
# (sub-bucket resolution on both sides of it); the tail buckets exist to
# make queueing collapse visible — waits 10–1000× the flush interval are
# the overload signature tail sampling attributes per request, and this
# histogram shows in aggregate on every scrape.
QUEUE_WAIT_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.0075, 0.01, 0.025, 0.05,
    0.1, 0.25, 1.0, 5.0,
)


class ServingMetrics:
    """The fixed instrument set the serving layer exports.

    ``requests_total`` counts admitted requests; ``shed_total`` counts
    admission-queue rejections (the explicit "overloaded" replies);
    ``errors_total`` counts requests that failed inside the engine;
    ``timeouts_total`` counts admitted requests whose client deadline
    expired before the batcher reached them (replied 504 and cancelled, so
    the engine never computes them). Batch instruments are per flushed
    micro-batch: ``batch_size`` is real rows, ``padding_waste`` is
    ``bucket − real rows`` (device rows computed and thrown away — the
    cost of the bounded compile cache).
    """

    def __init__(
        self,
        batch_buckets: Sequence[float] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
    ) -> None:
        self.requests_total = Counter()
        self.shed_total = Counter()
        self.errors_total = Counter()
        self.timeouts_total = Counter()
        self.batches_total = Counter()
        self.queue_depth = Gauge()
        self.latency = Histogram(LATENCY_BUCKETS_S)
        self.queue_wait = Histogram(QUEUE_WAIT_BUCKETS_S)
        self.batch_size = Histogram(batch_buckets)
        self.padding_waste = Histogram(batch_buckets)
        # Monotonic: uptime is duration arithmetic, and the wall
        # clock jumps (NTP) — rule monotonic-clock.
        self.started_monotonic = time.monotonic()

    def uptime_seconds(self) -> float:
        return time.monotonic() - self.started_monotonic

    def snapshot(self) -> dict:
        # Empty-window quantiles become None (JSON null): a bare NaN token
        # is not strict JSON, and this dict feeds /metrics?format=json.
        p50, p95, p99 = (
            None if v != v else v
            for v in self.latency.quantile((0.5, 0.95, 0.99))
        )
        lat = self.latency.snapshot()
        return {
            "requests_total": self.requests_total.value,
            "shed_total": self.shed_total.value,
            "errors_total": self.errors_total.value,
            "timeouts_total": self.timeouts_total.value,
            "batches_total": self.batches_total.value,
            "queue_depth": self.queue_depth.value,
            "latency_seconds": {
                "p50": p50, "p95": p95, "p99": p99,
                "sum": lat["sum"], "count": lat["count"],
            },
            "queue_wait_seconds": self.queue_wait.snapshot(),
            "batch_size": self.batch_size.snapshot(),
            "padding_waste": self.padding_waste.snapshot(),
            "uptime_seconds": self.uptime_seconds(),
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every instrument."""
        lines: list[str] = []

        def counter(name: str, help_: str, v: float) -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {v}")

        def histogram(name: str, help_: str, h: Histogram) -> None:
            snap = h.snapshot()
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            for le, c in snap["buckets"].items():
                lines.append(f'{name}_bucket{{le="{le}"}} {c}')
            lines.append(f"{name}_sum {snap['sum']}")
            lines.append(f"{name}_count {snap['count']}")

        counter("serve_requests_total", "Admitted predict requests.",
                self.requests_total.value)
        counter("serve_shed_total",
                "Requests rejected by admission control (overloaded).",
                self.shed_total.value)
        counter("serve_errors_total", "Requests failed inside the engine.",
                self.errors_total.value)
        counter("serve_timeouts_total",
                "Admitted requests whose deadline expired before flush "
                "(504, cancelled unserved).",
                self.timeouts_total.value)
        counter("serve_batches_total", "Micro-batches flushed to the engine.",
                self.batches_total.value)
        lines.append("# HELP serve_queue_depth Admission queue depth after "
                     "the last flush.")
        lines.append("# TYPE serve_queue_depth gauge")
        lines.append(f"serve_queue_depth {self.queue_depth.value}")
        # Quantiles live under their OWN family name: summary-style samples
        # inside the histogram family (metadata after samples / duplicate
        # family) make the whole exposition unparseable to a strict
        # Prometheus scraper.
        lines.append("# HELP serve_request_latency_quantile_seconds "
                     "Recent-window latency quantiles (ring of last 8192).")
        lines.append("# TYPE serve_request_latency_quantile_seconds gauge")
        for q, v in zip((0.5, 0.95, 0.99),
                        self.latency.quantile((0.5, 0.95, 0.99))):
            val = "NaN" if v != v else repr(v)
            lines.append(
                f'serve_request_latency_quantile_seconds{{quantile="{q}"}} '
                f"{val}"
            )
        histogram("serve_request_latency_seconds",
                  "Request latency from enqueue to flush completion "
                  "(excludes HTTP reply serialization).",
                  self.latency)
        histogram("serve_queue_wait_seconds",
                  "Admission-queue wait per flushed request (enqueue to "
                  "flush claim) — tail queueing visible without a "
                  "sampled trace.",
                  self.queue_wait)
        histogram("serve_batch_size_rows", "Real rows per flushed micro-batch.",
                  self.batch_size)
        histogram("serve_padding_waste_rows",
                  "Pad rows per flushed micro-batch (bucket minus real rows).",
                  self.padding_waste)
        return "\n".join(lines) + "\n"

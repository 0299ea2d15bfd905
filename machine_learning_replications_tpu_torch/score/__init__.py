"""Population-scale bulk scoring — the "nightly rescore every patient"
workload, the port of the JAX package's ``score/``.

The serving layer (``serve/``) answers *requests*: single patients and
micro-batches under a latency SLO. This package answers *cohorts*: stream
a multi-million-row patient file (JSONL patient dicts or a reference-layout
``.mat``) through the same predict tail as ``cli predict``, with

  * a pipelined producer/consumer architecture — reader + parse workers
    doing host work (parse, validate, quarantine, the impute route's host
    half) feed a bounded prefetch queue; the device stage double-buffers
    pinned host buffers and non-blocking copies on a copy stream, so chunk
    N+1 transfers while chunk N computes, every chunk at one padded shape;
    an ordered writer drains results to sharded output files;
  * resumability — per-chunk journal events plus an atomic progress
    manifest (``score/progress.py``), so a killed run restarts at the last
    committed chunk with zero re-scored and zero skipped rows,
    byte-identical to an uninterrupted run;
  * observability — per-stage spans (``obs/spans.py``), ``score_*`` metric
    families (``obs/registry.py``), and the model-quality monitor
    (``obs/quality.py``) running over the full scored population instead
    of a serving window.

``progress``, ``writer`` and ``reader`` are verbatim copies of the JAX
package's modules (stdlib + numpy); ``pipeline`` is the port. Entry point:
``cli.py score``.
"""

# Re-exports resolve lazily (PEP 562), as in the JAX package: the spawned
# parse workers import ``score.reader`` only, and an eager ``pipeline``
# import here would pull torch into every one of them.
from machine_learning_replications_tpu_torch.lazyimport import lazy_exports

_EXPORTS = {
    "ScorePipeline": "pipeline",
    "ScoreBudgetExceeded": "pipeline",
    "ScoreInterrupted": "pipeline",
    "JsonlCohortSource": "reader",
    "MatCohortSource": "reader",
    "open_cohort": "reader",
    "ScoreProgress": "progress",
    "ScoreResumeError": "progress",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)

"""Observability of the port (the JAX package's ``obs/``, as far as ported):

  ``spans``     thread-aware spans whose exit synchronizes the card, with
                Chrome-trace export (``--trace-dir``);
  ``journal``   the JSONL run journal — a manifest first, then events
                (``--journal``) — and ``stage_scope``, the stage runner's
                telemetry;
  ``registry``  labeled counter / gauge / histogram families rendered as
                Prometheus text;
  ``torchmon``  graph-capture, kernel-build, kernel-launch and transfer
                accounting into the registry;
  ``catalog``   the closed lists of the port's families and journal events;
  ``quality``   the training reference profile a fitted model carries.
"""

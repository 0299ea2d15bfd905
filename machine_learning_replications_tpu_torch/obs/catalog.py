"""The closed catalogs of the port's metric families and journal events.

The port's own catalog, not the JAX package's ``obs/catalog.py``: every
family the port registers in its registry, and every journal event the port
emits, with the keys each emit site must carry. The runtime accounting of
``obs.torchmon`` is the port's own (``torch_*``); every other family — the
serving, resilience, quality, request-trace, SLO, alerting, bulk-scoring
and continual-learning ones — and
every event keep the JAX catalog's names, kinds, labels and required keys,
because the fleet merges them. The serving layer's fixed ``serve_*``
instruments (``serve/metrics.py``) render through their own exposition
path and are outside ``METRICS``, as in JAX. Both dicts stay
literal (no comprehensions, no calls) so a test can read this file with
``ast.literal_eval`` and hold the code to it in both directions: a family
registered or an event emitted outside the catalog fails, and so does a
catalog entry nothing registers or emits
(``tests/test_torch_obs.py::test_code_and_catalog_agree``).
"""

from __future__ import annotations

#: Every process-global metric family: name -> (kind, label names).
#: Kind is "counter" | "gauge" | "histogram".
METRICS: dict[str, tuple[str, tuple[str, ...]]] = {
    # -- obs/torchmon --------------------------------------------------------
    "torch_graph_captures_total": ("counter", ()),
    "torch_kernel_builds_total": ("counter", ()),
    "torch_kernel_build_seconds_total": ("counter", ()),
    "torch_kernel_launches_total": ("counter", ("kernel",)),
    "torch_kernel_row_passes_total": ("counter", ("kernel",)),
    "torch_transfer_bytes_total": ("counter", ("direction",)),
    # -- obs/quality ---------------------------------------------------------
    "quality_feature_ks": ("gauge", ("feature",)),
    "quality_feature_psi": ("gauge", ("feature",)),
    "quality_feed_depth": ("gauge", ()),
    "quality_feed_dropped_rows_total": ("counter", ("reason",)),
    "quality_member_disagreement": ("gauge", ()),
    "quality_rows_total": ("counter", ()),
    "quality_score_psi": ("gauge", ()),
    "quality_status": ("gauge", ()),
    "quality_status_transitions_total": ("counter", ("to",)),
    "quality_window_rows": ("gauge", ()),
    # -- obs/reqtrace --------------------------------------------------------
    "reqtrace_dropped_total": ("counter", ()),
    "reqtrace_sampled_total": ("counter", ("reason",)),
    # -- obs/slo -------------------------------------------------------------
    "slo_bad_total": ("counter", ("slo",)),
    "slo_burn_rate": ("gauge", ("slo",)),
    "slo_error_budget_remaining_ratio": ("gauge", ("slo",)),
    "slo_good_ratio": ("gauge", ("slo",)),
    "slo_requests_total": ("counter", ("slo",)),
    "slo_target_ratio": ("gauge", ("slo",)),
    # -- obs/timeseries ------------------------------------------------------
    "history_samples_total": ("counter", ()),
    "history_series": ("gauge", ()),
    # -- obs/alerts ----------------------------------------------------------
    "alerts_active": ("gauge", ("rule", "severity")),
    "alerts_transitions_total": ("counter", ("rule", "transition")),
    # -- obs/incident --------------------------------------------------------
    "incident_captures_total": ("counter", ("result",)),
    # -- obs/profiler --------------------------------------------------------
    "profile_captures_total": ("counter", ("outcome",)),
    # -- resilience/ ---------------------------------------------------------
    "fault_injected_total": ("counter", ("site",)),
    "resilience_breaker_state": ("gauge", ()),
    "resilience_breaker_transitions_total": ("counter", ("to",)),
    "resilience_checkpoint_rollbacks_total": ("counter", ()),
    "resilience_degraded_sheds_total": ("counter", ()),
    "resilience_engine_restarts_total": ("counter", ("result",)),
    "resilience_watchdog_trips_total": ("counter", ()),
    # -- serve/ --------------------------------------------------------------
    "serve_aot_fallback_total": ("counter", ("reason",)),
    "serve_aot_restore_seconds": ("gauge", ("path", "bucket")),
    "serve_deploys_total": ("counter", ("result",)),
    "serve_host_fallback_total": ("counter", ()),
    "serve_model_version": ("gauge", ()),
    "serve_path_total": ("counter", ("path",)),
    "serve_warmup_seconds": ("gauge", ("path", "bucket")),
    "serve_worker_info": ("gauge", ("worker",)),
    # -- learn/ --------------------------------------------------------------
    "learn_capture_rows_total": ("counter", ()),
    "learn_capture_retained_rows": ("gauge", ()),
    "learn_retrain_total": ("counter", ("result",)),
    "learn_retrain_seconds": ("gauge", ()),
    "learn_shadow_divergence_mean": ("gauge", ()),
    "learn_shadow_divergence_p95": ("gauge", ()),
    "learn_shadow_divergence_max": ("gauge", ()),
    "learn_shadow_flip_rate": ("gauge", ()),
    "learn_shadow_score_psi": ("gauge", ()),
    "learn_shadow_candidate_worst_psi": ("gauge", ()),
    "learn_shadow_candidate_status": ("gauge", ()),
    "learn_shadow_disagreement_delta": ("gauge", ()),
    "learn_shadow_rows": ("gauge", ()),
    "learn_shadow_evaluations_total": ("counter", ("verdict",)),
    # -- learn/{trigger,promote} ---------------------------------------------
    "learn_trigger_alert_streak": ("gauge", ()),
    "learn_trigger_total": ("counter", ("outcome",)),
    "learn_promotions_total": ("counter", ("result",)),
    # -- fleet/registry, fleet/router ----------------------------------------
    "fleet_probe_total": ("counter", ("result",)),
    "fleet_replicas": ("gauge", ("state",)),
    "fleet_rotations_total": ("counter", ("direction",)),
    "fleet_capture_dropped_total": ("counter", ()),
    "fleet_deploys_total": ("counter", ("result",)),
    "fleet_hedge_wins_total": ("counter", ()),
    "fleet_hedges_total": ("counter", ()),
    "fleet_replica_requests_total": ("counter", ("replica", "result")),
    "fleet_request_latency_seconds": ("histogram", ()),
    "fleet_requests_total": ("counter", ("outcome",)),
    "fleet_retries_total": ("counter", ("reason",)),
    "fleet_upstream_attempts_total": ("counter", ("result",)),
    "fleet_upstream_connections_total": ("counter", ("event",)),
    # -- obs/fleetmetrics, obs/fleettrace ------------------------------------
    "fleet_scrape_merge_rejected_total": ("counter", ("reason",)),
    "fleet_scrape_stale": ("gauge", ("replica",)),
    "fleet_scrape_total": ("counter", ("result",)),
    "fleet_slo_bad_total": ("counter", ("slo",)),
    "fleet_slo_burn_rate": ("gauge", ("slo",)),
    "fleet_slo_error_budget_remaining_ratio": ("gauge", ("slo",)),
    "fleet_slo_good_ratio": ("gauge", ("slo",)),
    "fleet_slo_requests_total": ("counter", ("slo",)),
    "fleet_slo_target_ratio": ("gauge", ("slo",)),
    "fleet_clock_offset_ms": ("gauge", ("replica",)),
    "fleet_trace_joins_total": ("counter", ("result",)),
    # -- fleet/lifecycle, fleet/autoscale ------------------------------------
    "lifecycle_replicas": ("gauge", ("state",)),
    "lifecycle_transitions_total": ("counter", ("event",)),
    "autoscale_decisions_total": ("counter", ("decision",)),
    "autoscale_desired_replicas": ("gauge", ()),
    "autoscale_signal": ("gauge", ("signal",)),
    "autoscale_streak": ("gauge", ("kind",)),
    # -- score/ --------------------------------------------------------------
    "score_rows_total": ("counter", ()),
    "score_quarantined_rows_total": ("counter", ()),
    "score_chunks_total": ("counter", ()),
    "score_chunk_seconds": ("histogram", ()),
    "score_queue_depth": ("gauge", ("stage",)),
    "score_stage_seconds_total": ("counter", ("stage",)),
}

#: Every journal event kind -> the keys EVERY emit site must carry.
#: The run manifest record (kind="manifest") is written directly by
#: ``RunJournal.__init__``, not through ``event``, and is not an entry.
EVENTS: dict[str, tuple[str, ...]] = {
    # -- run lifecycle (cli, journal) ---------------------------------------
    "run_done": (),
    "run_error": ("error",),
    "stage_start": ("stage",),
    "stage_done": ("stage", "seconds", "checkpointed"),
    "stage_error": ("stage", "seconds", "error"),
    # -- checkpoints (persist/) ---------------------------------------------
    "checkpoint_publish": ("path", "version"),
    "checkpoint_restore": ("stage",),
    "checkpoint_corrupt": ("stage", "error"),
    "checkpoint_rollback": ("path", "lastgood", "error"),
    "aot_export": ("path", "blobs", "seconds"),
    "aot_restore": ("role", "bucket", "seconds"),
    "aot_fallback": ("reason",),
    # -- serving (serve/) ----------------------------------------------------
    "flush": ("seq", "rows", "ok"),
    "deploy_start": ("path", "from_version", "replica"),
    "deploy_applied": ("path", "from_version", "to_version", "replica", "seconds"),
    "deploy_failed": ("path", "error", "replica", "seconds"),
    "deploy_quality_detached": ("path",),
    # -- resilience (resilience/) --------------------------------------------
    "breaker_open": ("reason", "wedged"),
    "breaker_close": ("attempts", "open_seconds"),
    "engine_restart": ("attempt", "ok", "seconds"),
    "engine_swap": ("warm",),
    "fault_armed": ("site", "spec"),
    "fault_disarmed": ("site",),
    "fault_injected": ("site", "mode", "fire", "spec"),
    "faults_reset": ("sites",),
    # -- model quality (obs/quality) -----------------------------------------
    "quality_status": ("from_status", "to_status", "window_rows", "worst_feature",
                       "worst_psi", "score_psi"),
    "quality_rebased": ("reference_rows", "feature_bins"),
    "quality_feed_disabled": ("error",),
    "quality_feed_reenabled": ("after",),
    # -- profiler, alerting (obs/) -------------------------------------------
    "profile_capture": ("ok", "seconds"),
    "alert_fired": ("rule", "severity", "value"),
    "alert_resolved": ("rule", "severity", "seconds"),
    "incident_captured": ("rule", "dir", "files"),
    # -- learn/ --------------------------------------------------------------
    "learn_retrain_start": ("family", "rows", "labels_source", "out"),
    "learn_retrain_done": (),
    "learn_retrain_failed": ("error", "rows", "seconds"),
    "learn_shadow_verdict": ("passed", "reasons"),
    "learn_trigger": ("fired", "reason"),
    "learn_candidate_published": ("candidate", "model", "version"),
    "learn_promotion": ("candidate", "result"),
    "learn_settle": ("skipped",),
    "learn_cycle_done": ("outcome",),
    "learn_recovery": ("recovered",),
    # -- the fleet (cli serve --register, fleet/, obs/fleet*) ----------------
    "replica_registered": ("replica", "router", "url"),
    "fleet_router_started": ("address", "replicas"),
    "fleet_replica_registered": ("replica", "url"),
    "fleet_replica_deregistered": ("replica", "url"),
    "fleet_rotation": ("replica", "direction", "reason"),
    "fleet_deploy_start": ("model", "target_version", "replicas", "concurrency"),
    "fleet_deploy_replica": ("model",),
    "fleet_deploy_done": ("model", "target_version", "result", "error", "seconds"),
    "fleet_scrape_transition": ("replica", "stale"),
    "fleet_trace_export": ("requests", "joined", "containment_ratio"),
    "lifecycle_spawn": ("replica", "pid", "port", "attempt", "respawn"),
    "lifecycle_spawn_failed": ("replica", "reason", "attempts", "retry_in_s"),
    "lifecycle_ready": ("replica", "url", "seconds", "respawn"),
    "lifecycle_drain": ("replica", "reason", "settle_deadline_s"),
    "lifecycle_drain_error": ("replica", "error"),
    "lifecycle_term": ("replica", "delivered", "drained", "kill_deadline_s"),
    "lifecycle_kill": ("replica", "reason"),
    "lifecycle_exit": ("replica", "code", "reason"),
    "lifecycle_crash": ("replica", "state", "detail"),
    "autoscale_decision": ("decision", "reason", "ready", "desired"),
    "autoscale_tick_error": ("error",),
    # -- score/ --------------------------------------------------------------
    "score_resume": ("chunks", "rows", "bad_rows", "lines"),
    "score_chunk": ("seq", "rows", "bad", "seconds"),
    "score_done": (
        "rows", "bad_rows", "chunks", "wall_seconds", "rows_per_second",
        "output_sha256",
    ),
}

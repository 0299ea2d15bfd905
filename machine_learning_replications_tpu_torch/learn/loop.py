"""The closed loop: alert → retrain → shadow → guarded promote → ok.

This module is pure composition — every step below is owned, tested, and
journaled by another module; the loop's job is ordering, bounded waits,
and making the whole arc one joined journal story:

    quality_status(ok→alert)        the replicas (obs.quality)
    learn_trigger(fired)            learn.trigger
    learn_retrain_start/stage_*/…   learn.retrain over fit_* stages
    learn_shadow_verdict            learn.shadow
    learn_promotion                 learn.promote
    fleet_deploy_start/…/done       the router (fleet.deploy)
    quality_status(alert→ok)        the replicas, on the REBASED profile

``run_cycle`` is one trigger-to-verdict pass (the unit ``cli learn run
--once`` and the CI continual job drive); ``LearnLoop.run`` wraps it in
the poll/debounce/cooldown daemon loop.

Port of the JAX package's ``learn/loop.py``: the live model loads through
the port's checkpoints (``persist.checkpoint``), and the refit (both hand
histogram kernels on the card) and the shadow replay run on ``device``
(default: the card). Everything else is the JAX loop.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

from machine_learning_replications_tpu_torch.learn import capture as capturemod
from machine_learning_replications_tpu_torch.learn import promote as promotemod
from machine_learning_replications_tpu_torch.learn import shadow as shadowmod
from machine_learning_replications_tpu_torch.learn import trigger as triggermod
from machine_learning_replications_tpu_torch.obs import journal


def run_cycle(
    model_path: str,
    capture_dir: str,
    candidate_dir: str,
    router_url: str | None,
    cfg=None,
    thresholds: shadowmod.ShadowThresholds | None = None,
    max_rows: int = 8192,
    min_rows: int = 200,
    resume_dir: str | None = None,
    deploy_timeout_s: float = 1800.0,
    say=None,
    *,
    device=None,
) -> dict:
    """One full retrain → shadow → promote cycle against the captured
    cohort. Returns a summary dict (``outcome`` ∈ promoted / refused /
    failed / skipped). ``router_url=None`` stops after the shadow
    verdict (retrain-and-judge mode — the candidate is published or
    parked but no rollout is driven). The refit and the replay run on
    ``device`` (default: the card)."""
    from machine_learning_replications_tpu_torch.device import resolve_device
    from machine_learning_replications_tpu_torch.learn import retrain as retrainmod
    from machine_learning_replications_tpu_torch.persist import checkpoint

    dev = resolve_device(device)

    def _say(msg: str) -> None:
        if say is not None:
            say(msg)

    t0 = time.perf_counter()
    X17, n_bad = capturemod.load_recent(capture_dir, max_rows=max_rows)
    _say(f"captured cohort: {X17.shape[0]} rows ({n_bad} malformed dropped)")
    if X17.shape[0] < min_rows:
        journal.event(
            "learn_cycle_done", outcome="skipped",
            reason=f"only {X17.shape[0]} captured rows (min {min_rows})",
            seconds=round(time.perf_counter() - t0, 3),
        )
        return {
            "outcome": "skipped",
            "reason": f"only {X17.shape[0]} captured rows "
                      f"(min_rows={min_rows})",
        }

    live_params = checkpoint.load_model(model_path, device=dev)
    live_version = checkpoint.checkpoint_version(model_path)
    candidate, retrain_info = retrainmod.warm_refit(
        live_params, X17, candidate_dir, cfg=cfg,
        resume_dir=resume_dir, min_rows=min_rows, device=dev,
    )
    _say(
        f"refit done: candidate v{retrain_info['version']} "
        f"({retrain_info['seconds']}s over {retrain_info['rows']} rows, "
        f"labels {retrain_info['labels_source']})"
    )
    verdict = shadowmod.evaluate(
        live_params, candidate, X17,
        thresholds=thresholds,
        candidate_version=retrain_info["version"],
        device=dev,
    )
    stats = verdict["stats"]
    _say(
        f"shadow verdict: {'pass' if verdict['pass'] else 'FAIL'} "
        f"(divergence mean {stats['divergence_mean']}, flip rate "
        f"{stats['flip_rate']}, candidate quality "
        f"{(stats['candidate_quality'] or {}).get('status')})"
        + (f" — {'; '.join(verdict['reasons'])}" if verdict["reasons"]
           else "")
    )
    if router_url is None:
        outcome = "shadow_pass" if verdict["pass"] else "refused"
        if not verdict["pass"]:
            promotemod.park(candidate_dir, verdict)
        summary = {
            "outcome": outcome,
            "from_version": live_version,
            "retrain": retrain_info,
            "verdict": verdict,
        }
    else:
        result = promotemod.promote(
            candidate_dir, model_path, router_url, verdict,
            deploy_timeout_s=deploy_timeout_s,
        )
        _say(f"promotion: {result['result']}")
        summary = {
            "outcome": result["result"],
            "from_version": live_version,
            "retrain": retrain_info,
            "verdict": verdict,
            "promotion": result,
        }
    summary["seconds"] = round(time.perf_counter() - t0, 3)
    # The arc's destination version: the LIVE path's id after a
    # promotion republishes the candidate (the candidate dir keeps its
    # own local counter — journaling that would tell a v1→v1 story).
    to_version = summary.get("promotion", {}).get("version")
    journal.event(
        "learn_cycle_done", outcome=summary["outcome"],
        from_version=live_version,
        to_version=(to_version if to_version is not None
                    else retrain_info["version"]),
        seconds=summary["seconds"],
    )
    return summary


def wait_for_quality_ok(
    replica_urls: list[str], timeout_s: float = 120.0,
    poll_s: float = 1.0,
) -> bool:
    """Post-promotion verification: block until every reachable replica's
    quality status reads ``ok`` (the rebased profile judging live
    traffic), or the timeout passes. The loop's closing assertion — a
    promotion whose quality never recovers is journaled as such
    (``learn_recovery``), not silently declared victorious."""
    deadline = time.monotonic() + timeout_s
    last: dict[str, str | None] = {}
    while time.monotonic() < deadline:
        last = {
            url: triggermod.poll_quality(url).get("status")
            for url in replica_urls
        }
        statuses = [s for s in last.values() if s is not None]
        if statuses and all(s == "ok" for s in statuses):
            journal.event(
                "learn_recovery", recovered=True, statuses=last,
            )
            return True
        time.sleep(poll_s)
    journal.event("learn_recovery", recovered=False, statuses=last)
    return False


class LearnLoop:
    """The daemon ``cli learn run`` drives: poll the fleet's quality,
    debounce through ``TriggerPolicy``, and run full cycles when it
    fires. ``max_cycles`` bounds the loop for drills and CI (None = run
    until interrupted)."""

    def __init__(
        self,
        model_path: str,
        capture_dir: str,
        candidate_dir: str,
        router_url: str,
        policy: triggermod.TriggerPolicy | None = None,
        cfg=None,
        thresholds: shadowmod.ShadowThresholds | None = None,
        poll_interval_s: float = 2.0,
        max_rows: int = 8192,
        min_rows: int = 200,
        recovery_timeout_s: float = 120.0,
        settle_timeout_s: float = 300.0,
        say=None,
        *,
        device=None,
    ) -> None:
        self.model_path = os.path.abspath(model_path)
        self.capture_dir = os.path.abspath(capture_dir)
        self.candidate_dir = os.path.abspath(candidate_dir)
        self.router_url = router_url
        self.policy = policy or triggermod.TriggerPolicy()
        self.cfg = cfg
        self.thresholds = thresholds
        self.poll_interval_s = float(poll_interval_s)
        self.max_rows = int(max_rows)
        self.min_rows = int(min_rows)
        self.recovery_timeout_s = float(recovery_timeout_s)
        self.settle_timeout_s = float(settle_timeout_s)
        self.say = say
        self.device = device
        self.cycles: list[dict] = []

    def _capture_rows_appended(self) -> int | None:
        """The router's lifetime capture-append counter (``/healthz``'s
        ``capture.rows_appended``), or ``None`` when the router is
        unreachable or runs without the tap."""
        try:
            with urllib.request.urlopen(
                self.router_url.rstrip("/") + "/healthz", timeout=5.0
            ) as resp:
                health = json.loads(resp.read())
        except Exception:
            return None
        cap = health.get("capture")
        if not isinstance(cap, dict):
            return None
        rows = cap.get("rows_appended")
        return int(rows) if isinstance(rows, (int, float)) else None

    def _await_fresh_capture(self) -> None:
        """Post-trigger capture turnover — the refit must not trust a
        window that still spans the pre-drift cohort. The quality monitor
        alerts within seconds of a drift's onset, while the bounded
        capture buffer turns over only as fast as traffic arrives; a
        refit on the mixed window learns a *blend* whose reference
        profile matches neither the old nor the new population — the
        post-promotion monitor then holds the fleet in alert on exactly
        the traffic the refit was promoted to match (measured: a 50/50
        blend profile reads PSI ~0.4 against pure post-drift traffic vs
        ~0.0004 for a clean post-drift profile). So: wait, bounded by
        ``settle_timeout_s``, until ``max_rows`` NEW rows have been
        captured since the trigger fired — ``load_recent``'s newest-first
        read then sees only post-decision traffic. Journaled
        ``learn_settle`` either way; skipped (journaled) when the router
        exposes no capture counter."""
        if self.settle_timeout_s <= 0:
            return
        t0 = time.monotonic()
        start = self._capture_rows_appended()
        if start is None:
            journal.event(
                "learn_settle", skipped=True,
                reason="router /healthz exposes no capture counter",
            )
            return
        target = start + self.max_rows
        while True:
            waited = time.monotonic() - t0
            rows = self._capture_rows_appended()
            if rows is not None and rows >= target:
                journal.event(
                    "learn_settle", skipped=False, timed_out=False,
                    fresh_rows=rows - start, seconds=round(waited, 3),
                )
                if self.say:
                    self.say(
                        f"capture settled: {rows - start} fresh rows in "
                        f"{waited:.1f}s"
                    )
                return
            if waited >= self.settle_timeout_s:
                journal.event(
                    "learn_settle", skipped=False, timed_out=True,
                    fresh_rows=(rows - start) if rows is not None else None,
                    seconds=round(waited, 3),
                )
                if self.say:
                    self.say(
                        "capture settle timed out after "
                        f"{waited:.1f}s — refitting on the window as-is"
                    )
                return
            time.sleep(min(1.0, self.poll_interval_s))

    def poll_once(self) -> dict | None:
        """One poll pass over the fleet → the policy's decision."""
        urls = triggermod.replica_urls(self.router_url)
        polls = []
        for url in urls:
            p = triggermod.poll_quality(url)
            p["url"] = url
            polls.append(p)
        return self.policy.observe(polls)

    def run(self, max_cycles: int | None = None,
            stop_check=None) -> list[dict]:
        """Poll until ``max_cycles`` cycles have run (or ``stop_check()``
        goes true). Each fire runs a full cycle; a promoted cycle then
        waits (bounded) for the fleet's quality to recover before the
        cooldown clock makes the next fire possible."""
        while max_cycles is None or len(self.cycles) < max_cycles:
            if stop_check is not None and stop_check():
                break
            try:
                decision = self.poll_once()
            except Exception as exc:
                if self.say:
                    self.say(f"poll failed: {exc}")
                decision = None
            if decision is not None:
                if self.say:
                    self.say(
                        f"trigger fired ({decision['reason']}; worst "
                        f"{decision['worst_feature']} PSI "
                        f"{decision['worst_psi']})"
                    )
                self._await_fresh_capture()
                try:
                    summary = run_cycle(
                        self.model_path, self.capture_dir,
                        self.candidate_dir, self.router_url, cfg=self.cfg,
                        thresholds=self.thresholds,
                        max_rows=self.max_rows, min_rows=self.min_rows,
                        say=self.say, device=self.device,
                    )
                    summary["trigger"] = decision
                    if summary["outcome"] == "promoted":
                        # A router blip HERE must not relabel a cycle the
                        # fleet already completed as failed — the rollout
                        # is done; only the recovery verdict is unknown.
                        try:
                            summary["recovered"] = wait_for_quality_ok(
                                triggermod.replica_urls(self.router_url),
                                timeout_s=self.recovery_timeout_s,
                            )
                        except Exception as exc:
                            journal.event(
                                "learn_recovery", recovered=False,
                                error=str(exc),
                            )
                            summary["recovered"] = False
                except Exception as exc:
                    # A daemon documented to run until signalled must not
                    # die on one bad cycle (single-class distilled labels
                    # under extreme drift, a router blip mid-promotion…).
                    # The failure becomes a journaled, counted cycle —
                    # the cooldown the policy started at fire time still
                    # spaces the next attempt.
                    journal.event(
                        "learn_cycle_done", outcome="failed",
                        error=str(exc),
                    )
                    if self.say:
                        self.say(f"cycle failed: {exc}")
                    summary = {
                        "outcome": "failed", "error": str(exc),
                        "trigger": decision,
                    }
                self.cycles.append(summary)
                continue
            time.sleep(self.poll_interval_s)
        return self.cycles

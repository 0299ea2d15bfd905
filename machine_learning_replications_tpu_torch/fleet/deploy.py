"""Rolling deploys: a new checkpoint version across the fleet, one
replica at a time, with zero client-visible downtime.

The lifecycle per replica (docs/FLEET.md "Deploy lifecycle"):

  1. **Capacity gate.** Refuse to touch a replica unless at least
     ``min_in_rotation`` (default 1) OTHER replicas stay in rotation
     (waiting up to ``capacity_timeout_s`` for capacity to appear) — a
     rollout must never take the last server out from under live
     traffic. Up to ``concurrency`` replicas are held and warmed **at
     once** inside that gate: a one-at-a-time rollout pays O(N) serial
     warmups on a large fleet, while the gate is about how much
     capacity may be *missing*, not about how many swaps are in flight
     — so waves of ``min(concurrency, in_rotation − min_in_rotation)``
     replicas swap together, and the rotation capacity observed by the
     router never drops below the gate.
  2. **Hold.** ``registry.hold`` removes the replica from routing while
     it keeps serving its in-flight work; new traffic flows to the rest
     of the fleet.
  3. **Warm swap.** One long ``POST /admin/deploy`` to the replica
     (``serve.server`` — load with integrity verification and the
     last-known-good rollback net, build + warm the new engine off the
     request path, parity-probe, atomic swap). The reply carries the
     achieved version and whether the restore rolled back. When the
     target checkpoint ships an AOT executable bundle (docs/AOT.md) the
     warm step restores serialized executables instead of compiling the
     ladder, so the per-replica hold window — what paces the whole
     rollout — is deserialize-scale, not compile-scale.
  4. **Verify + release.** Poll the replica's ``/readyz`` until it
     reports ready AT the achieved version, release the hold, and wait
     for the registry (probe-fed) to rotate it back in before moving on.

A replica that reports ``rolled_back`` (corrupt target checkpoint → it
restored the retained last-known-good) or a version other than the
rollout target **stops the rollout**: the remaining replicas keep the
old version, the report says ``rolled_back``, and the journal carries
the full arc (``fleet_deploy_start`` → per-replica
``fleet_deploy_replica`` → ``fleet_deploy_done``). A replica whose swap
fails outright keeps its previous engine (the replica-side contract)
and the rollout stops with ``result="failed"`` — in every case the
fleet is left serving *some* consistent, parity-verified version.

The rollout's target version is read from the checkpoint's
``integrity.json`` when the controller can see the path (a local JSON
read — deliberately NOT ``persist.orbax_io``, which imports jax and
orbax; the router process stays accelerator-free); on a router without
filesystem access to the checkpoint, the first replica's achieved
version becomes the target the rest must match.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

from machine_learning_replications_tpu_torch.obs import journal


def manifest_version(path: str | os.PathLike) -> int | None:
    """The monotonic version id in a checkpoint's ``integrity.json`` —
    the jax-free mirror of ``persist.checkpoint_version`` for the
    router process. None when unreadable or unversioned."""
    try:
        with open(os.path.join(os.fspath(path), "integrity.json")) as f:
            v = json.load(f).get("version")
        return int(v) if v is not None else None
    except (OSError, ValueError, json.JSONDecodeError, TypeError):
        return None


def _post_admin_deploy(url: str, model: str, timeout_s: float) -> dict:
    """The replica-side warm swap; returns its final deploy status dict.
    Raises ``RuntimeError`` with the replica's error on failure."""
    req = urllib.request.Request(
        url.rstrip("/") + "/admin/deploy",
        data=json.dumps({"model": model}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())["deploy"]
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read() or b"{}")
        except (ValueError, OSError):
            body = {}
        raise RuntimeError(
            f"replica deploy failed (http {exc.code}): "
            f"{body.get('error', 'no detail')}"
        ) from exc


def _wait(pred, timeout_s: float, what: str, poll_s: float = 0.1) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(poll_s)
    raise RuntimeError(f"timed out waiting for {what}")


def _deploy_one(
    registry, rid: str, url: str, model_path: str,
    admin_timeout_s: float, ready_timeout_s: float,
) -> dict:
    """One replica's hold → warm swap → verify → release arc (steps 2–4
    of the lifecycle). The capacity gate (step 1) is the caller's wave
    planner. Returns the step dict; never raises — the hold is released
    on every exit path so a failed swap cannot strand a healthy replica
    out of rotation."""
    from machine_learning_replications_tpu_torch.fleet.health import probe_replica

    step: dict = {"replica": rid, "result": "ok"}
    try:
        # 2. Hold: out of routing, still serving in-flight work.
        registry.hold(rid)
        # 3. The replica-side warm swap (load → warm → parity → swap).
        status = _post_admin_deploy(url, model_path, admin_timeout_s)
        achieved = status.get("version")
        step.update(
            achieved_version=achieved,
            rolled_back=bool(status.get("rolled_back")),
            seconds=status.get("seconds"),
        )
        # 4. Ready at the achieved version, then back into rotation.
        _wait(
            lambda: (
                lambda p: p["ok"] and p["ready"]
                and p["version"] == achieved
            )(probe_replica(url)),
            ready_timeout_s,
            f"{rid!r} ready at version {achieved}",
        )
        registry.release(rid)
        _wait(
            lambda: (registry.get(rid) or {}).get("in_rotation"),
            ready_timeout_s, f"{rid!r} back in rotation",
        )
    except Exception as exc:
        registry.release(rid)
        step.update(
            result="failed", error=f"{type(exc).__name__}: {exc}"
        )
    return step


def rolling_deploy(
    registry,
    model_path: str,
    admin_timeout_s: float = 600.0,
    ready_timeout_s: float = 60.0,
    capacity_timeout_s: float = 30.0,
    concurrency: int = 1,
    min_in_rotation: int = 1,
    status_cb=None,
) -> dict:
    """Drive the checkpoint at ``model_path`` across every registered
    replica (see module docstring). Up to ``concurrency`` replicas are
    warm-swapped per wave, never leaving fewer than ``min_in_rotation``
    replicas in rotation. Returns the rollout report; never raises for
    per-replica failures — the report's ``result`` is ``ok`` /
    ``rolled_back`` / ``failed``."""
    import threading

    if concurrency < 1 or min_in_rotation < 1:
        raise ValueError("concurrency and min_in_rotation must be >= 1")
    target = manifest_version(model_path)
    t0 = time.perf_counter()  # duration base; "started" is display-only
    report: dict = {
        "kind": "fleet_deploy",
        "model": model_path,
        "target_version": target,
        "concurrency": int(concurrency),
        "replicas": [],
        "result": "ok",
        "started": time.time(),  # graftcheck: disable=monotonic-clock
    }

    def publish(state: str) -> None:
        report["state"] = state
        if status_cb is not None:
            status_cb(dict(report))

    members = registry.snapshot()
    journal.event(
        "fleet_deploy_start", model=model_path, target_version=target,
        concurrency=int(concurrency),
        replicas=[r["id"] for r in members],
    )
    publish("running")
    pending = list(members)
    while pending and report["result"] == "ok":
        # 1. Capacity gate, per WAVE: holding a not-in-rotation replica
        # (probing, out) costs no capacity; each in-rotation member of
        # the wave spends one unit of the headroom above the floor.
        wave: list[dict] = []

        def plan_wave() -> bool:
            wave.clear()
            in_rotation = {
                r["id"] for r in registry.snapshot() if r["in_rotation"]
            }
            headroom = len(in_rotation) - min_in_rotation
            for member in pending:
                if len(wave) >= concurrency:
                    break
                if member["id"] in in_rotation:
                    if headroom <= 0:
                        continue
                    headroom -= 1
                wave.append(member)
            return bool(wave)

        try:
            _wait(
                plan_wave, capacity_timeout_s,
                f"{min_in_rotation} in-rotation replica(s) of spare "
                "capacity before the next deploy wave",
            )
        except RuntimeError as exc:
            report["result"] = "failed"
            report["error"] = str(exc)
            break
        publish(
            "deploying " + ",".join(m["id"] for m in wave)
        )
        steps: list[dict | None] = [None] * len(wave)
        threads = []
        for i, member in enumerate(wave):
            rid, url = member["id"], member["url"]
            if registry.get(rid) is None:
                steps[i] = {
                    "replica": rid, "result": "skipped",
                    "error": "deregistered mid-rollout",
                }
                continue

            def run(i=i, rid=rid, url=url):
                steps[i] = _deploy_one(
                    registry, rid, url, model_path,
                    admin_timeout_s, ready_timeout_s,
                )

            t = threading.Thread(
                target=run, name=f"fleet-deploy-{rid}", daemon=True,
            )
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        for member, step in zip(wave, steps):
            pending.remove(member)
            if step is None:  # a thread died before writing — treat failed
                step = {
                    "replica": member["id"], "result": "failed",
                    "error": "deploy worker died",
                }
            report["replicas"].append(step)
            achieved = step.get("achieved_version")
            if step["result"] == "ok" and target is None and \
                    achieved is not None:
                # No filesystem view of the checkpoint: the first
                # replica's achieved version defines the rollout target.
                target = report["target_version"] = achieved
            if step["result"] == "ok" and (
                step.get("rolled_back")
                or (target is not None and achieved != target)
            ):
                step["result"] = "rolled_back"
            # First bad outcome wins, as in the serial rollout: a later
            # wave member's rollback must not relabel an earlier hard
            # failure (callers branch on failed vs rolled_back).
            if step["result"] == "rolled_back" and report["result"] == "ok":
                report["result"] = "rolled_back"
                report["error"] = (
                    f"replica {step['replica']!r} restored version "
                    f"{achieved} instead of the target {target} "
                    "(corrupt checkpoint rolled back to last-known-good); "
                    "rollout stopped"
                )
            elif step["result"] == "failed" and report["result"] == "ok":
                report["result"] = "failed"
                report["error"] = step["error"]
            journal.event("fleet_deploy_replica", model=model_path, **step)
        # A failure/rollback anywhere in the wave leaves the REST of the
        # fleet on the known-good version (the wave that observed it has
        # already finished its swaps — those replicas stay where their
        # own arc left them, exactly like the serial rollout's).
    report["seconds"] = round(time.perf_counter() - t0, 3)
    journal.event(
        "fleet_deploy_done", model=model_path,
        target_version=report["target_version"],
        result=report["result"], error=report.get("error"),
        seconds=report["seconds"],
    )
    publish("done")
    return report

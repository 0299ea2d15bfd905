"""Guarded promotion — a passing candidate rides the fleet's deploy rail; a
failing one is parked, loudly.

The shadow verdict (``learn.shadow``) is the gate's only input: this
module deliberately adds no second opinion, because a gate that
re-litigates its evidence invites threshold drift between the two
judgments. What it adds is *consequence*:

  * **pass** → the candidate is republished into the LIVE checkpoint
    path (``persist.checkpoint.save_model`` — the atomic publish rotates
    the serving version into its last-known-good slot and stamps the
    next monotonic version id), then the fleet router's
    ``POST /fleet/deploy`` drives the zero-downtime rolling swap, replica
    by replica, with the replica-side parity probe and the lastgood
    rollback exactly as any operator-initiated deploy. The continual
    loop owns no deploy machinery of its own — that is the point.
  * **fail** → the candidate stays where the refit published it, with a
    ``REFUSED.json`` sidecar carrying the full verdict (a parked
    candidate must explain itself to the human who finds it), a
    journaled ``learn_promotion`` refusal, and the fleet untouched.

``promote_via_router`` is torch-free (one HTTP POST); ``publish_candidate``
restores + republishes a checkpoint and imports torch — the split keeps
the daemon's polling half accelerator-free.

Port of the JAX package's ``learn/promote.py``: the publish goes through
the port's own checkpoint format (``persist/checkpoint.py``, the same
atomic rotation into ``<path>.lastgood`` and monotonic version) and, by
default, exports the AOT executable bundle (``persist/aot.py``) into it:
promotion is publish time, so the rolling deploy's replicas restore the
compiled program instead of capturing every bucket. The bundle is compiled
for ``device``, where the replicas serve (default: the card).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

REFUSED_FILE = "REFUSED.json"

PROMOTIONS = REGISTRY.counter(
    "learn_promotions_total",
    "Continual-learning promotion outcomes (promoted: rolling deploy "
    "completed ok; refused: shadow verdict failed, candidate parked; "
    "failed: the deploy itself failed or rolled back).",
    labels=("result",),
)
for _r in ("promoted", "refused", "failed"):
    PROMOTIONS.labels(result=_r)


def park(candidate_dir: str | os.PathLike, verdict: dict) -> str:
    """Refuse a candidate: write the verdict as a ``REFUSED.json``
    sidecar inside the candidate checkpoint dir and journal the refusal.
    Returns the sidecar path. The candidate's payload is left intact —
    a parked model is evidence, not garbage."""
    candidate_dir = os.path.abspath(os.fspath(candidate_dir))
    path = os.path.join(candidate_dir, REFUSED_FILE)
    from machine_learning_replications_tpu_torch.persist.atomicio import (
        atomic_json_write,
    )

    atomic_json_write(path, {
        "kind": "learn_promotion_refused",
        "ts": journal.utc_now_iso(),
        "verdict": verdict,
    })
    PROMOTIONS.inc(result="refused")
    journal.event(
        "learn_promotion",
        result="refused",
        candidate=candidate_dir,
        reasons=verdict.get("reasons"),
    )
    return path


def is_parked(candidate_dir: str | os.PathLike) -> bool:
    return os.path.exists(
        os.path.join(os.path.abspath(os.fspath(candidate_dir)), REFUSED_FILE)
    )


def publish_candidate(
    candidate_dir: str | os.PathLike, model_path: str | os.PathLike,
    aot: bool = True,
    device=None,
) -> int | None:
    """Republish a shadow-approved candidate into the live checkpoint
    path: restore the candidate (integrity-verified) and ``save_model``
    it at ``model_path`` — one atomic publish that rotates the serving
    version into the last-known-good slot and stamps the next monotonic
    version id in the LIVE path's lineage. Returns the published
    version. The candidate dir itself is untouched (it remains the
    refit's resumable artifact).

    By default the publish also exports the AOT executable bundle
    (``persist.aot``), compiled for ``device`` (default: the card) and the
    CPU: the rolling deploy that follows restores it on every replica, so
    the compile is paid once, here. With ``aot=False`` the candidate is
    read onto the CPU: a plain republish copies arrays and needs no card."""
    from machine_learning_replications_tpu_torch.device import resolve_device
    from machine_learning_replications_tpu_torch.persist import checkpoint

    candidate_dir = os.path.abspath(os.fspath(candidate_dir))
    if is_parked(candidate_dir):
        raise RuntimeError(
            f"candidate {candidate_dir!r} was refused by a shadow "
            "verdict (REFUSED.json present); refusing to publish it"
        )
    params = checkpoint.load_model(
        candidate_dir, device=resolve_device(device) if aot else "cpu")
    checkpoint.save_model(model_path, params, aot=aot)
    version = checkpoint.checkpoint_version(model_path)
    journal.event(
        "learn_candidate_published",
        candidate=candidate_dir,
        model=os.path.abspath(os.fspath(model_path)),
        version=version,
    )
    return version


def promote_via_router(
    router_url: str, model_path: str | os.PathLike,
    timeout_s: float = 1800.0,
) -> dict:
    """Drive the fleet's rolling deploy of ``model_path`` through the
    router (``POST /fleet/deploy`` — single-flight, replica-side warm
    swap + parity probe + lastgood rollback). Returns the rollout
    report; raises ``RuntimeError`` on transport failure. The report's
    ``result`` (``ok`` / ``rolled_back`` / ``failed``) is the caller's
    verdict — a rolled-back rollout means the fleet PROTECTED itself
    and still serves the previous version."""
    req = urllib.request.Request(
        router_url.rstrip("/") + "/fleet/deploy",
        data=json.dumps({"model": os.fspath(model_path)}).encode(),
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
        if isinstance(body, dict) and isinstance(body.get("deploy"), dict):
            return body["deploy"]
        raise RuntimeError(
            f"fleet deploy request failed (http {exc.code}): "
            f"{body.get('error', 'no detail') if isinstance(body, dict) else body}"
        ) from exc
    except (urllib.error.URLError, OSError) as exc:
        raise RuntimeError(
            f"fleet deploy request to {router_url} failed: {exc}"
        ) from exc


def promote(
    candidate_dir: str | os.PathLike,
    model_path: str | os.PathLike,
    router_url: str,
    verdict: dict,
    deploy_timeout_s: float = 1800.0,
    aot: bool = True,
    device=None,
) -> dict:
    """The gate, end to end: apply the shadow verdict, then either park
    (fail) or publish + rolling-deploy (pass). Returns
    ``{"result": promoted|refused|failed, ...}`` and journals
    ``learn_promotion`` either way — the one event the obs-report's
    continual-learning section keys the arc on."""
    candidate_dir = os.path.abspath(os.fspath(candidate_dir))
    from machine_learning_replications_tpu_torch.fleet.deploy import (
        manifest_version,
    )

    judged = verdict.get("candidate_version")
    current = manifest_version(candidate_dir)
    if judged is not None and current is not None and judged != current:
        # A verdict is evidence about ONE candidate. If the dir was
        # retrained since the shadow ran, applying the old passing
        # verdict would roll out a model nobody evaluated — exactly the
        # unguarded swap the gate exists to prevent. Refuse loudly (not
        # park: the new candidate isn't judged bad, just unjudged).
        raise ValueError(
            f"verdict judged candidate v{judged} but {candidate_dir} now "
            f"holds v{current}: re-run `learn shadow` on the current "
            "candidate before promoting"
        )
    if not verdict.get("pass"):
        park(candidate_dir, verdict)
        return {
            "result": "refused",
            "candidate": candidate_dir,
            "reasons": verdict.get("reasons"),
        }
    version = publish_candidate(candidate_dir, model_path, aot=aot, device=device)
    try:
        report = promote_via_router(
            router_url, model_path, timeout_s=deploy_timeout_s
        )
    except Exception as exc:
        # The live path on disk already holds the candidate as its next
        # version, but the fleet never saw it (router unreachable,
        # transport drop mid-rollout). That half-state MUST reach the
        # journal — it is exactly what an operator needs to see before
        # the next replica restart silently serves an undeployed
        # version — and the caller gets a failed result, not an
        # exception that skips the arc's terminal event.
        PROMOTIONS.inc(result="failed")
        journal.event(
            "learn_promotion", result="failed",
            candidate=candidate_dir,
            model=os.path.abspath(os.fspath(model_path)),
            version=version,
            deploy_result=None,
            deploy_error=str(exc),
            replicas=[],
        )
        return {
            "result": "failed",
            "candidate": candidate_dir,
            "version": version,
            "error": str(exc),
        }
    ok = report.get("result") == "ok"
    PROMOTIONS.inc(result="promoted" if ok else "failed")
    journal.event(
        "learn_promotion",
        result="promoted" if ok else "failed",
        candidate=candidate_dir,
        model=os.path.abspath(os.fspath(model_path)),
        version=version,
        deploy_result=report.get("result"),
        deploy_error=report.get("error"),
        replicas=[r.get("replica") for r in report.get("replicas", [])],
    )
    return {
        "result": "promoted" if ok else "failed",
        "candidate": candidate_dir,
        "version": version,
        "deploy": report,
    }

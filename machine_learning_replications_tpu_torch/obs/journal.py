"""JSONL run journal: a manifest line, then structured events.

Port of the JAX package's ``obs/journal.py``. A journal answers "what
produced this artifact, and what did the run do?":

  * **Manifest first.** The journal's first record is a run manifest — run
    id, ISO-8601 UTC start time, command, git sha (+dirty flag) when the
    package runs from its own checkout, this package's, torch's and CUDA's
    versions, platform, the card's name when CUDA is up, and a sha256 hash
    of the ExperimentConfig JSON (the same hash the JAX package's manifest
    gives the same config, since both configs serialize to the same bytes).
  * **Structured events after.** One JSON object per line, ``ts`` in
    ISO-8601 UTC, ``kind`` plus event-specific fields. Event names and
    their required keys live in ``obs.catalog.EVENTS``: the stage runner
    emits ``stage_start`` / ``stage_done`` / ``stage_error`` /
    ``checkpoint_restore`` / ``checkpoint_corrupt``, a checkpoint publish
    ``checkpoint_publish``, the CLI ``run_done`` / ``run_error``.

``stage_scope`` is the one stage-timing code path
(``persist.checkpoint.StageCheckpointer.run``): the stderr lines the JAX
package's stage runners print, a span and journal events.

A process-global *active* journal (``set_journal`` / ``get_journal``)
mirrors the active tracer: call sites log unconditionally through the
module-level ``event``, which is a no-op until a journal is installed.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Iterator

from machine_learning_replications_tpu_torch.obs import spans


def utc_now_iso() -> str:
    """ISO-8601 UTC to millisecond precision, 'Z'-suffixed."""
    t = time.time()  # wall clock by intent: the human/manifest timestamp
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + (
        ".%03dZ" % (int(t * 1000) % 1000)
    )


def _git_sha(repo_dir: str | None = None) -> dict:
    """Best-effort git provenance (sha + dirty flag); {} outside a repo or
    without git. Never raises — a manifest must not be able to fail a run.

    The repo must BE the package's own checkout: ``git rev-parse`` walks
    upward, so a pip-installed copy whose site-packages happens to live
    inside some unrelated repository (venv-in-project layout) would
    otherwise stamp that project's HEAD into the manifest — silently wrong
    provenance is worse than none."""
    cwd = repo_dir or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"], cwd=cwd, timeout=10,
            capture_output=True, text=True,
        )
        if top.returncode != 0 or os.path.realpath(top.stdout.strip()) != \
                os.path.realpath(cwd):
            return {}
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, timeout=10,
            capture_output=True, text=True,
        )
        if sha.returncode != 0:
            return {}
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, timeout=10,
            capture_output=True, text=True,
        )
        return {
            "git_sha": sha.stdout.strip(),
            "git_dirty": bool(dirty.stdout.strip())
            if dirty.returncode == 0 else None,
        }
    except (OSError, subprocess.SubprocessError):
        return {}


def config_hash(config_json: str | bytes | None) -> str | None:
    """sha256 of the config JSON — the manifest's binding to hyperparameters
    (the stage-checkpoint fingerprint binds to data too; this one is cheap
    and comparable across cohorts)."""
    if config_json is None:
        return None
    if isinstance(config_json, str):
        config_json = config_json.encode()
    return hashlib.sha256(config_json).hexdigest()


def _dist_version(name: str) -> str | None:
    """An installed distribution's version without importing it."""
    try:
        from importlib.metadata import version

        return version(name)
    except Exception:
        return None


def run_manifest(command: str | None = None, config_json: str | None = None,
                 extra: dict | None = None) -> dict:
    """The run-provenance record every journal starts with. Versions come
    from the package and ``torch.version``; ``device`` is the card's
    name when CUDA is up (absent otherwise); ``git_sha``/``git_dirty`` only
    when the package runs from its own checkout. A process that never
    imported torch (the fleet's router and autoscaler) is left without it:
    torch's version then comes from its installed metadata, and no card is
    named, since such a process owns none."""
    import platform

    from machine_learning_replications_tpu_torch import __version__

    torch = sys.modules.get("torch")
    man = {
        "kind": "manifest",
        "run_id": uuid.uuid4().hex[:12],
        "ts": utc_now_iso(),
        "command": command,
        "argv": list(sys.argv),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "hostname": platform.node(),
        "pid": os.getpid(),
        "versions": {
            "machine_learning_replications_tpu_torch": __version__,
            "torch": (torch.version.__version__ if torch is not None
                      else _dist_version("torch")),
            "cuda": torch.version.cuda if torch is not None else None,
        },
        "config_hash": config_hash(config_json),
        **_git_sha(),
    }
    if torch is not None and torch.cuda.is_available():
        man["device"] = torch.cuda.get_device_name()
    if extra:
        man.update(extra)
    return man


class RunJournal:
    """Append-structured-events-to-one-file; first record is the manifest.

    Writes are line-buffered under a lock and flushed per event: a
    preempted run's journal is readable up to the last completed event
    (the same durability posture as ``stage_say``'s flush=True)."""

    def __init__(self, path: str | os.PathLike, command: str | None = None,
                 config_json: str | None = None, extra: dict | None = None) -> None:
        self.path = os.path.abspath(os.fspath(path))
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "w")
        self.manifest = run_manifest(command=command, config_json=config_json, extra=extra)
        self._write(self.manifest)

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def event(self, kind: str, **fields: Any) -> None:
        self._write({"ts": utc_now_iso(), "kind": kind, **fields})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- process-global active journal -----------------------------------------

_active: RunJournal | None = None
_active_lock = threading.Lock()


def set_journal(journal: RunJournal | None) -> None:
    """Install (or clear, with None) the process-global active journal."""
    global _active
    with _active_lock:
        _active = journal


def get_journal() -> RunJournal | None:
    return _active


def event(kind: str, **fields: Any) -> None:
    """Record an event on the active journal; no-op without one."""
    journal = _active
    if journal is not None:
        # Forwarder, not an emit site: kind is the caller's literal
        # (the catalog test checks the call sites).
        journal.event(kind, **fields)


# -- the shared stage runner scope ------------------------------------------


@contextlib.contextmanager
def stage_scope(name: str, done_suffix: str = "") -> Iterator[spans.SpanHandle]:
    """The one stage-timing code path (``persist.checkpoint.StageCheckpointer``,
    durable or straight through): the ``stage_say`` stderr lines of the JAX
    package's stage runners, the body in a span (``stage:<name>``), and
    ``stage_start`` / ``stage_done`` / ``stage_error`` journaled.
    ``done_suffix`` is the checkpointer's " (checkpointed)" tail; the
    yielded handle's ``block`` defers device completion to scope exit,
    inside the timing. One clock times the stage: the span's, so the trace
    event, the stderr line, the journaled seconds and the handle's
    ``seconds`` (read after the scope, as the checkpointer's ``timings``)
    are one interval.
    """
    from machine_learning_replications_tpu_torch.utils.trace import stage_say

    stage_say(f"stage {name!r} ...")
    event("stage_start", stage=name)
    handle = None
    try:
        with spans.span(f"stage:{name}") as handle:
            yield handle
    except BaseException as exc:
        event(
            "stage_error", stage=name,
            seconds=round(handle.seconds, 3) if handle is not None else 0.0,
            error=f"{type(exc).__name__}: {exc}",
        )
        raise
    dt = handle.seconds
    stage_say(f"stage {name!r} done in {dt:.1f}s{done_suffix}")
    event(
        "stage_done", stage=name, seconds=round(dt, 3),
        checkpointed=bool(done_suffix),
    )

"""On-demand ``torch.profiler`` capture with a single-flight guard.

Port of the JAX package's ``obs/profiler.py`` (``/debug/profile``'s
capture). The span timeline (``obs.spans``) is host-side orchestration;
when a tail investigation needs the *device* story — which kernels, what
overlap — the tool is the framework's profiler. Here that is
``torch.profiler`` with CPU activity and, when CUDA is up, CUDA activity,
written as a Chrome trace (``trace.json``, Perfetto-loadable) into a
timestamped directory under ``profile_dir``.

Profiling a live serving process must be **on demand and exclusive**: the
profiler is process-global state, and two operators hitting
``/debug/profile`` at once must not corrupt each other's capture.
``capture`` is therefore single-flight — concurrent callers get
``ProfilerBusy`` immediately (the HTTP layer maps it to 409). Captures are
counted (``profile_captures_total{outcome}``) and journaled
(``profile_capture``), as in JAX.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

#: Upper bound on one capture (seconds): /debug/profile is a blocking
#: endpoint, and an unbounded capture would pin the single-flight slot
#: (and grow the artifact) forever.
MAX_SECONDS = 60.0

_lock = threading.Lock()
_seq = 0  # capture ordinal; mutated only under _lock (single-flight)

# Declared at import, so the family is on /metrics from the first scrape.
_captures = REGISTRY.counter(
    "profile_captures_total",
    "On-demand torch.profiler captures served, by outcome.",
    labels=("outcome",),
)
_captures.labels(outcome="ok")
_captures.labels(outcome="error")


class ProfilerBusy(RuntimeError):
    """A capture is already in flight — the request was rejected, not
    queued (single-flight contract)."""


def is_busy() -> bool:
    """Whether a capture currently holds the single-flight slot (advisory
    — the authoritative answer is ``capture`` raising ``ProfilerBusy``)."""
    if _lock.acquire(blocking=False):
        _lock.release()
        return False
    return True


def _artifact_files(root: str) -> list[dict]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            path = os.path.join(dirpath, fn)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            out.append({"path": path, "bytes": size})
    out.sort(key=lambda f: f["path"])
    return out


def _record(seconds: float, target: str) -> None:
    """Profile the process for ``seconds`` of wall time and write the Chrome
    trace to ``<target>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(seconds)
    prof.export_chrome_trace(os.path.join(target, "trace.json"))


def capture(seconds: float, out_dir: str) -> dict[str, Any]:
    """Run one profiler capture of ``seconds`` wall time into ``out_dir``
    and return the artifact description (directory, files, total bytes).

    Raises ``ProfilerBusy`` when another capture is in flight and
    ``ValueError`` for an out-of-range duration. The capture directory is
    timestamped under ``out_dir`` so repeated captures never clobber each
    other."""
    seconds = float(seconds)
    if not 0.0 < seconds <= MAX_SECONDS:
        raise ValueError(
            f"capture seconds must be in (0, {MAX_SECONDS:g}], got {seconds:g}"
        )
    if not _lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already in flight")
    try:
        global _seq
        _seq += 1
        # Timestamp for the human, ordinal for uniqueness: two sub-second
        # captures land in the same wall-clock second.
        target = os.path.join(
            os.path.abspath(out_dir),
            time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) + f"-{_seq:04d}",
        )
        os.makedirs(target, exist_ok=True)
        t0 = time.perf_counter()
        try:
            _record(seconds, target)
        except Exception as exc:
            _captures.inc(outcome="error")
            journal.event(
                "profile_capture", ok=False, seconds=seconds,
                error=f"{type(exc).__name__}: {exc}",
            )
            raise
        wall = time.perf_counter() - t0
        files = _artifact_files(target)
        artifact = {
            "profile_dir": target,
            "requested_seconds": seconds,
            "wall_seconds": round(wall, 3),
            "files": files,
            "total_bytes": sum(f["bytes"] for f in files),
        }
        _captures.inc(outcome="ok")
        journal.event(
            "profile_capture", ok=True, seconds=seconds,
            profile_dir=target, total_bytes=artifact["total_bytes"],
        )
        return artifact
    finally:
        _lock.release()

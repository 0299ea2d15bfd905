"""Incident flight recorder: capture the evidence WHEN the rule fires.

An alert tells you *that* something broke; by the time a human reads
it, the evidence — tail samples in the flight recorder, the history
window around onset, per-replica load state, the journal context — has
aged out of the bounded rings. `IncidentCapturer` snapshots all of it
the moment a rule transitions to firing:

* rate-limited (`min_interval_s` between bundles) and single-flight
  (one capture thread at a time, later firings during a capture are
  dropped and counted) — an alert storm must not fork-bomb the host
  with capture threads or fill the disk;
* the bundle is a timestamped directory of JSON files written with
  ``persist.atomicio`` durability, and ``manifest.json`` is written
  LAST via the atomic path — **manifest presence is the completeness
  marker**. A crash mid-capture leaves a manifest-less directory that
  readers (and the next capture's retention sweep) treat as garbage;
* bounded retention: only the newest `retention` complete bundles are
  kept.

What lands in a bundle is supplied by the wiring as named zero-arg
`collectors` (router: `/debug/requests` tail, fleet trace join,
registry/load snapshot; replica: its own recorder tail + SLO state) —
this module stays generic, jax-free, and loop-free: captures run on a
short-lived daemon thread, never on an event loop.

`tools/incident_report.py` renders a bundle for humans.
"""

from __future__ import annotations

import os
import shutil
import threading
import time

from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.persist.atomicio import (
    atomic_json_write,
    fsync_json_dump,
)

INCIDENT_CAPTURES = REGISTRY.counter(
    "incident_captures_total",
    "Incident-bundle capture attempts by result (captured / "
    "rate_limited / in_flight / error).",
    labels=("result",),
)
for _result in ("captured", "rate_limited", "in_flight", "error"):
    INCIDENT_CAPTURES.labels(result=_result)

MANIFEST = "manifest.json"
SCHEMA_VERSION = 1


def _stamp(now: float) -> str:
    """Filesystem-safe UTC stamp (20260806T101530Z) of a wall time."""
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))


class IncidentCapturer:
    """One per process. `maybe_capture(transition)` is called by the
    sampler tick for every `fired` transition; the capture itself runs
    on its own daemon thread."""

    def __init__(
        self,
        out_dir: str | os.PathLike,
        store=None,
        collectors: dict | None = None,
        min_interval_s: float = 60.0,
        retention: int = 8,
        window_s: float = 900.0,
        say=None,
    ) -> None:
        self.out_dir = os.path.abspath(os.fspath(out_dir))
        os.makedirs(self.out_dir, exist_ok=True)
        self.store = store
        self.collectors = dict(collectors or {})
        self.min_interval_s = float(min_interval_s)
        self.retention = int(retention)
        self.window_s = float(window_s)
        self.say = say
        self.journal_tail_lines = 200
        self._lock = threading.Lock()
        self._in_flight = False
        self._last_capture_t: float | None = None  # monotonic
        self._threads: list[threading.Thread] = []

    # -- trigger side --------------------------------------------------------

    def maybe_capture(self, transition: dict) -> str | None:
        """Admission control + thread spawn. Returns the decision
        ("captured" meaning *started*; the bundle lands async)."""
        if transition.get("transition") != "fired":
            return None
        now_m = time.monotonic()
        with self._lock:
            if self._in_flight:
                INCIDENT_CAPTURES.inc(result="in_flight")
                return "in_flight"
            if (self._last_capture_t is not None
                    and now_m - self._last_capture_t
                    < self.min_interval_s):
                INCIDENT_CAPTURES.inc(result="rate_limited")
                return "rate_limited"
            self._in_flight = True
            self._last_capture_t = now_m
        t = threading.Thread(
            target=self._capture_and_release,
            args=(dict(transition),),
            name="incident-capture",
            daemon=True,
        )
        self._threads.append(t)
        t.start()
        return "captured"

    def _capture_and_release(self, transition: dict) -> None:
        try:
            self.capture(transition)
        finally:
            with self._lock:
                self._in_flight = False

    # -- capture side --------------------------------------------------------

    def capture(self, transition: dict) -> str | None:
        """Synchronous capture (the thread body; tests call it
        directly). Returns the bundle directory, or None on error."""
        at = transition.get("at")
        now = float(at) if isinstance(at, (int, float)) \
            else time.time()  # graftcheck: disable=monotonic-clock
        rule = str(transition.get("rule", "unknown"))
        name = f"incident_{_stamp(now)}_{rule}"
        bundle = os.path.join(self.out_dir, name)
        try:
            os.makedirs(bundle, exist_ok=True)
            files, errors = self._write_bundle(bundle, transition, now)
            atomic_json_write(os.path.join(bundle, MANIFEST), {
                "schema": SCHEMA_VERSION,
                "rule": rule,
                "severity": transition.get("severity"),
                "captured_at": journal.utc_now_iso(),
                "window_s": self.window_s,
                "files": sorted(files),
                "errors": errors,
            })
        except Exception:
            INCIDENT_CAPTURES.inc(result="error")
            return None
        INCIDENT_CAPTURES.inc(result="captured")
        journal.event(
            "incident_captured",
            rule=rule,
            dir=bundle,
            files=len(files),
        )
        if self.say:
            self.say(f"incident bundle captured: {bundle}")
        self._prune()
        return bundle

    def _write_bundle(self, bundle, transition, now):
        files, errors = [], {}

        def put(fname, obj):
            fsync_json_dump(os.path.join(bundle, fname), obj)
            files.append(fname)

        put("alert.json", transition)
        if self.store is not None:
            try:
                put("history.json", self.store.dump(self.window_s, now))
            except Exception as exc:
                errors["history.json"] = repr(exc)
        for cname, collect in sorted(self.collectors.items()):
            fname = f"{cname}.json"
            try:
                put(fname, collect())
            except Exception as exc:
                errors[fname] = repr(exc)
        tail = self._journal_tail()
        if tail is not None:
            path = os.path.join(bundle, "journal_tail.jsonl")
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(tail)
                fh.flush()
                os.fsync(fh.fileno())
            files.append("journal_tail.jsonl")
        return files, errors

    def _journal_tail(self) -> str | None:
        jr = journal.get_journal()
        if jr is None:
            return None
        try:
            with open(jr.path, encoding="utf-8", errors="replace") as fh:
                lines = fh.readlines()
        except OSError:
            return None
        return "".join(lines[-self.journal_tail_lines:])

    # -- retention -----------------------------------------------------------

    def bundles(self) -> list[str]:
        """Complete bundles (manifest present), oldest first — the
        directory-name stamp sorts chronologically."""
        out = []
        try:
            names = sorted(os.listdir(self.out_dir))
        except OSError:
            return []
        for n in names:
            d = os.path.join(self.out_dir, n)
            if n.startswith("incident_") and \
                    os.path.exists(os.path.join(d, MANIFEST)):
                out.append(d)
        return out

    def _prune(self) -> None:
        """Keep the newest `retention` complete bundles; incomplete
        (manifest-less) directories are crash leftovers — always
        swept."""
        try:
            names = sorted(os.listdir(self.out_dir))
        except OSError:
            return
        complete, partial = [], []
        for n in names:
            if not n.startswith("incident_"):
                continue
            d = os.path.join(self.out_dir, n)
            if os.path.exists(os.path.join(d, MANIFEST)):
                complete.append(d)
            else:
                partial.append(d)
        doomed = partial + (
            complete[:-self.retention] if self.retention > 0 else []
        )
        for d in doomed:
            shutil.rmtree(d, ignore_errors=True)

    def close(self, timeout_s: float = 5.0) -> None:
        """Wait for any in-flight capture — shutdown must not truncate
        the one bundle the process crashed hard enough to need."""
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads.clear()

"""Bounded recent-cohort capture — the continual-learning loop's data tap.

A drift-triggered refit needs the one thing training never had: the rows
the fleet is serving *right now*. This module captures them at the front
door: the router appends every served (HTTP 200) ``/predict`` body to a
rotating set of JSONL shards — ``cohort-00000.jsonl``, ... — in exactly
the 17-variable patient-dict format the rest of the stack already speaks
(``tools/loadgen.py --patients`` writes it, ``score.reader``'s
``JsonlCohortSource`` streams it, ``data.examples.validate_patient``
validates it). The shard discipline mirrors ``score.writer``: append-only
files, rotation every ``rows_per_shard`` rows — with one inversion: the
score writer keeps *everything* it commits, while the capture buffer
keeps only the newest ``max_shards`` shards and unlinks the oldest, so
the on-disk cohort is a bounded sliding window over recent traffic
(~``max_shards × rows_per_shard`` rows), never an unbounded log under a
serving process that runs for months.

Capture is deliberately *raw*: the router appends the admitted body
bytes without parsing them (a JSON parse per request on the proxy hot
path would be a measurable tax at four-digit qps). Validation happens
once, at refit time: ``load_recent`` routes the captured lines through
``score.reader.parse_patient_lines`` — the same quarantine-don't-die
contract bulk scoring uses — so a malformed line captured from a hostile
client costs the refit one dropped row, not a crash.

jax-free by construction (rule ``import-purity`` via the fleet
manifest): the router process imports this module.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading

import numpy as np

from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

SHARD_FMT = "cohort-{:05d}.jsonl"
_SHARD_RE = re.compile(r"^cohort-(\d{5})\.jsonl$")

CAPTURED_ROWS = REGISTRY.counter(
    "learn_capture_rows_total",
    "Served rows appended to the recent-cohort capture buffer.",
)
CAPTURE_RETAINED = REGISTRY.gauge(
    "learn_capture_retained_rows",
    "Rows currently retained in the bounded capture buffer (oldest "
    "shards beyond the bound are unlinked).",
)


class CohortCapture:
    """Rotating, bounded JSONL capture of served patient rows.

    ``append_line`` is the hot-path entry (router ``finish``, ok replies
    only): normalize the body to one line, append, flush (no fsync —
    the buffer is a best-effort recent window, not a ledger; a crash
    loses at most the page cache's tail and the window refills in
    seconds under live traffic). Thread-safe: the router's forwarder
    threads and loop timers all land here.
    """

    def __init__(
        self,
        out_dir: str | os.PathLike,
        rows_per_shard: int = 4096,
        max_shards: int = 8,
    ) -> None:
        if rows_per_shard < 1 or max_shards < 1:
            raise ValueError("rows_per_shard and max_shards must be >= 1")
        self.out_dir = os.path.abspath(os.fspath(out_dir))
        os.makedirs(self.out_dir, exist_ok=True)
        self.rows_per_shard = int(rows_per_shard)
        self.max_shards = int(max_shards)
        self._lock = threading.Lock()
        self._f = None
        self._closed = False
        self._rows_in_shard = 0
        self._rows_total = 0
        # Resume the shard sequence past anything already on disk: a
        # restarted router keeps appending instead of overwriting the
        # previous window's newest shard.
        existing = _shard_indices(self.out_dir)
        self._next_index = (existing[-1] + 1) if existing else 0
        self._retained = {
            i: _count_lines(self._shard_path(i)) for i in existing
        }
        CAPTURE_RETAINED.get().set(float(sum(self._retained.values())))

    def _shard_path(self, index: int) -> str:
        return os.path.join(self.out_dir, SHARD_FMT.format(index))

    def append_line(self, body: bytes | str | dict) -> None:
        """Append one served row. ``bytes``/``str`` bodies are appended
        raw (newlines normalized to spaces — legal JSON never carries a
        raw newline inside a token, so this cannot corrupt a valid row);
        dicts are serialized compactly."""
        if isinstance(body, dict):
            line = json.dumps(body, separators=(",", ":")).encode()
        else:
            raw = body.encode() if isinstance(body, str) else bytes(body)
            line = raw.replace(b"\r", b" ").replace(b"\n", b" ").strip()
        if not line:
            return
        with self._lock:
            if self._closed:
                # Router shutdown: a forwarder thread finishing its last
                # in-flight request may land here after close() — the
                # `_f is None` branch below would silently re-open a
                # fresh shard (leaked fd, stray post-shutdown rows).
                return
            if self._f is None or self._rows_in_shard >= self.rows_per_shard:
                self._rotate_locked()
            self._f.write(line + b"\n")
            self._f.flush()
            self._rows_in_shard += 1
            self._rows_total += 1
            self._retained[self._next_index - 1] = self._rows_in_shard
            retained = sum(self._retained.values())
        CAPTURED_ROWS.inc()
        CAPTURE_RETAINED.get().set(float(retained))

    def _rotate_locked(self) -> None:
        if self._f is not None:
            self._f.close()
        self._f = open(self._shard_path(self._next_index), "ab")
        self._rows_in_shard = 0
        self._retained[self._next_index] = 0
        self._next_index += 1
        # Enforce the bound: unlink oldest shards beyond max_shards.
        while len(self._retained) > self.max_shards:
            oldest = min(self._retained)
            self._retained.pop(oldest)
            try:
                os.unlink(self._shard_path(oldest))
            except OSError:
                pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.out_dir,
                "rows_appended": self._rows_total,
                "rows_retained": sum(self._retained.values()),
                "shards": len(self._retained),
                "rows_per_shard": self.rows_per_shard,
                "max_shards": self.max_shards,
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None


def _shard_indices(out_dir: str) -> list[int]:
    out = []
    for fp in glob.glob(os.path.join(out_dir, "cohort-*.jsonl")):
        m = _SHARD_RE.match(os.path.basename(fp))
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _count_lines(path: str) -> int:
    try:
        with open(path, "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def load_recent(
    capture_dir: str | os.PathLike, max_rows: int = 8192
) -> tuple[np.ndarray, int]:
    """The refit's read side: the newest ``max_rows`` captured rows as a
    contract-order ``(X[n, 17], n_bad)`` pair, oldest first. Lines that
    fail the 17-variable contract are dropped and counted (the
    ``score.reader`` quarantine policy, without the sidecar — the capture
    buffer is a window, not an audit trail)."""
    from machine_learning_replications_tpu_torch.score.reader import (
        parse_patient_lines,
    )

    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    capture_dir = os.path.abspath(os.fspath(capture_dir))
    lines: list[str] = []
    # Newest-first over shards, newest-first within each, until the row
    # budget is met — then restore oldest-first order for the refit.
    for idx in reversed(_shard_indices(capture_dir)):
        if len(lines) >= max_rows:
            break
        try:
            with open(
                os.path.join(capture_dir, SHARD_FMT.format(idx)),
                encoding="utf-8", errors="replace",
            ) as f:
                shard_lines = f.readlines()
        except OSError:
            continue
        take = max_rows - len(lines)
        lines.extend(reversed(shard_lines[-take:] if take < len(shard_lines)
                              else shard_lines))
    lines.reverse()
    X, _line_nos, bad = parse_patient_lines(lines, start_line=1)
    return X, len(bad)

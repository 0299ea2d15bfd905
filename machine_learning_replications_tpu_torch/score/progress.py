"""Resumable bulk-scoring progress: an atomic manifest + output truncation.

The training side solved preemption with stage checkpoints
(``persist.orbax_io.StageCheckpointer``); a cohort score is one long
"stage" whose output is a stream, so the durable unit here is the *chunk*:
after the writer has flushed a chunk's score lines (and its quarantine
entries), the progress manifest is atomically replaced
(``persist.atomicio.atomic_json_write`` — the integrity-publish style: a
crash leaves either the previous complete manifest or the new one) with
the new committed prefix: chunks, rows, input lines consumed, per-shard
row/byte counts, quarantine bytes, and a rolling sha256 over the emitted
score lines.

Resume re-enters through ``load()``:

  * the stored **fingerprint** (input path/size, route, params digest,
    chunk/shard geometry) must match this run's — a manifest written by a
    different cohort, model, or chunking must fail loudly
    (``ScoreResumeError``), never silently splice two runs' outputs (the
    ``StageCheckpointer`` fingerprint contract);
  * output files are **truncated back to the committed byte counts** —
    whatever a killed run wrote past its last commit is discarded, so the
    restarted run's appends continue byte-identically to an uninterrupted
    run (no duplicate rows, no missing rows);
  * the reader skips exactly ``lines`` committed input lines and the next
    chunk takes ``chunks`` as its sequence number.

The rolling digest makes "byte-identical" checkable without re-reading
shards: an uninterrupted run and a kill+resume run over the same input
must commit the same final ``output_sha256``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

from machine_learning_replications_tpu_torch.persist.atomicio import (
    atomic_json_write,
)

PROGRESS_FILE = "progress.json"
_FORMAT = 1


class ScoreResumeError(RuntimeError):
    """The output directory's progress manifest cannot serve this run."""


def params_digest(model: str | None = None, pkl: str | None = None) -> str:
    """Cheap identity of the scoring model for the resume fingerprint.
    Checkpoint dirs hash their integrity manifest (content-derived, the
    ``orbax_io`` publish wrote it over every payload file); pickles hash
    path + size + mtime. Same spirit as ``pipeline._fit_fingerprint``:
    catch accidental reuse, stay O(KB)."""
    h = hashlib.sha256()
    if model:
        path = os.path.abspath(model)
        h.update(b"model:" + path.encode())
        manifest = os.path.join(path, "integrity.json")
        try:
            with open(manifest, "rb") as f:
                h.update(f.read())
        except OSError:
            pass  # legacy checkpoint: path-only identity
    else:
        path = os.path.abspath(pkl) if pkl else "<reference-pkl>"
        h.update(b"pkl:" + str(path).encode())
        try:
            st = os.stat(path)
            h.update(f":{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            pass
    return h.hexdigest()


def make_fingerprint(
    input_path: str,
    route: str,
    params: str,
    chunk_rows: int,
    rows_per_shard: int,
    limit: int | None,
) -> dict:
    """The (input, model, geometry) identity a progress manifest binds to.
    Geometry is part of it on purpose: chunk boundaries define the commit
    points and shard boundaries define the output layout, so resuming with
    different values could not continue byte-identically."""
    input_path = os.path.abspath(input_path)
    try:
        input_bytes = os.path.getsize(input_path)
    except OSError:
        input_bytes = None
    return {
        "input": input_path,
        "input_bytes": input_bytes,
        "route": route,
        "params": params,
        "chunk_rows": int(chunk_rows),
        "rows_per_shard": int(rows_per_shard),
        "limit": limit,
    }


class ScoreProgress:
    """The committed-prefix ledger of one output directory."""

    def __init__(self, out_dir: str, fingerprint: dict) -> None:
        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(self.out_dir, PROGRESS_FILE)
        self.fingerprint = fingerprint
        self.chunks = 0
        self.rows = 0
        self.lines = 0
        self.bad_rows = 0
        self.quarantine_bytes = 0
        self.shards: list[dict] = []
        self.done = False
        self._hasher = hashlib.sha256()

    # -- load / init --------------------------------------------------------

    def load(self, fresh: bool = False) -> bool:
        """Adopt an existing manifest (returns True — a resume) or start
        clean (False). ``fresh`` discards any prior state instead of
        resuming it; a *finished* manifest also starts clean (re-scoring a
        cohort into the same directory is a new run, not a resume).
        Fingerprint mismatch raises ``ScoreResumeError``."""
        if fresh or not os.path.exists(self.path):
            self._reset_outputs()
            return False
        try:
            with open(self.path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            raise ScoreResumeError(
                f"unreadable progress manifest {self.path!r}: "
                f"{type(exc).__name__}: {exc}; pass --fresh to discard"
            ) from exc
        if rec.get("format") != _FORMAT:
            raise ScoreResumeError(
                f"progress manifest {self.path!r} has unknown format "
                f"{rec.get('format')!r}; pass --fresh to discard"
            )
        stored = rec.get("fingerprint") or {}
        if stored != self.fingerprint:
            diff = sorted(
                k for k in set(stored) | set(self.fingerprint)
                if stored.get(k) != self.fingerprint.get(k)
            )
            raise ScoreResumeError(
                f"output dir {self.out_dir!r} holds progress for a "
                f"different run (fields differing: {', '.join(diff)}); "
                "pass --fresh to discard it or use a new --out"
            )
        if rec.get("done"):
            self._reset_outputs()
            return False
        self.chunks = int(rec["chunks"])
        self.rows = int(rec["rows"])
        self.lines = int(rec["lines"])
        self.bad_rows = int(rec.get("bad_rows", 0))
        self.quarantine_bytes = int(rec.get("quarantine_bytes", 0))
        self.shards = list(rec.get("shards", []))
        # The rolling output digest cannot be resumed from a hash state —
        # rebuild it from the committed (truncated) shard bytes. Bounded
        # by the already-scored output, a read-only pass.
        self._hasher = hashlib.sha256()
        for shard in self.shards:
            fp = os.path.join(self.out_dir, shard["name"])
            with open(fp, "rb") as f:
                remaining = int(shard["bytes"])
                while remaining > 0:
                    buf = f.read(min(1 << 20, remaining))
                    if not buf:
                        raise ScoreResumeError(
                            f"shard {shard['name']!r} is shorter than its "
                            f"committed {shard['bytes']} bytes"
                        )
                    self._hasher.update(buf)
                    remaining -= len(buf)
        return True

    def _reset_outputs(self) -> None:
        """A clean start must not inherit stray outputs from an abandoned
        or finished run in the same directory — summary/quality included:
        a leftover ``summary.json`` from a prior completed run would
        attribute that run's rows, digest, and quality verdict to this
        one if this one aborts before writing its own."""
        for name in sorted(os.listdir(self.out_dir)):
            if name.startswith("scores-") and name.endswith(".jsonl"):
                os.unlink(os.path.join(self.out_dir, name))
        for name in (
            PROGRESS_FILE, "quarantine.jsonl", "summary.json", "quality.json",
        ):
            fp = os.path.join(self.out_dir, name)
            if os.path.exists(fp):
                os.unlink(fp)

    # -- commit -------------------------------------------------------------

    def absorb_output(self, data: bytes) -> None:
        """Feed committed score bytes into the rolling output digest (the
        writer calls this with exactly what it appended)."""
        self._hasher.update(data)

    def commit(
        self,
        *,
        rows: int,
        lines: int,
        bad_rows: int,
        shards: list[dict],
        quarantine_bytes: int,
    ) -> None:
        """Advance the committed prefix by one chunk and atomically
        publish. Call ONLY after the chunk's output bytes are flushed
        durable — the manifest must never run ahead of the data."""
        self.chunks += 1
        self.rows += int(rows)
        self.lines += int(lines)
        self.bad_rows += int(bad_rows)
        self.shards = shards
        self.quarantine_bytes = int(quarantine_bytes)
        atomic_json_write(self.path, self._record())

    def finish(self, summary: dict | None = None) -> None:
        self.done = True
        rec = self._record()
        if summary is not None:
            rec["summary"] = summary
        atomic_json_write(self.path, rec)

    def output_sha256(self) -> str:
        return self._hasher.hexdigest()

    def _record(self) -> dict[str, Any]:
        return {
            "format": _FORMAT,
            "fingerprint": self.fingerprint,
            "chunks": self.chunks,
            "rows": self.rows,
            "lines": self.lines,
            "bad_rows": self.bad_rows,
            "quarantine_bytes": self.quarantine_bytes,
            "shards": self.shards,
            "output_sha256": self.output_sha256(),
            "done": self.done,
        }

"""Ordered, sharded output for bulk scoring — the pipeline's sink stage.

Scores land as JSONL shards (``scores-00000.jsonl``, ...): one
``{"row": <global 0-based input row>, "p1": <float repr>}`` object per
scored row, in input order, rotating every ``rows_per_shard`` rows.
``repr(float)`` is the shortest round-trip representation, so parity
checks (``json.loads(line)["p1"] == float(expected)``) are exact, and the
byte stream is a pure function of the scores — the property the resume
contract's "byte-identical to an uninterrupted run" rides on.

Durability protocol (one chunk = one transaction, driven by the
pipeline): ``append`` buffers through the OS, ``sync`` flushes+fsyncs and
returns the committed state (per-shard rows/bytes + the bytes appended
since the last sync, which the progress ledger folds into its rolling
digest) — only then is the progress manifest advanced. On resume,
``restore`` truncates every shard back to its committed byte count and
deletes shards the manifest never committed, discarding whatever a killed
run wrote past its last commit.

The quarantine sidecar (``quarantine.jsonl``) follows the same protocol
with line-numbered records — the malformed-row policy's audit trail.
"""

from __future__ import annotations

import glob
import json
import os


class _AppendFile:
    """One append-only file with explicit sync/truncate-restore."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = None
        self._pending = bytearray()

    def _handle(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, data: bytes) -> None:
        self._handle().write(data)
        self._pending += data

    def sync(self, durable: bool = True) -> bytes:
        """Flush (+fsync when ``durable``) and return the bytes appended
        since the previous sync."""
        if self._f is not None:
            self._f.flush()
            if durable:
                os.fsync(self._f.fileno())
        out = bytes(self._pending)
        self._pending.clear()
        return out

    def truncate_to(self, n_bytes: int) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        if size < n_bytes:
            raise ValueError(
                f"{self.path!r} is {size} bytes, shorter than the "
                f"committed {n_bytes}"
            )
        if size > n_bytes:
            with open(self.path, "r+b") as f:
                f.truncate(n_bytes)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ShardedScoreWriter:
    """Rotating score shards, append-committed in input order."""

    SHARD_FMT = "scores-{:05d}.jsonl"

    def __init__(
        self, out_dir: str, rows_per_shard: int, durable: bool = True
    ) -> None:
        if rows_per_shard < 1:
            raise ValueError(
                f"rows_per_shard must be >= 1, got {rows_per_shard}"
            )
        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.rows_per_shard = int(rows_per_shard)
        self.durable = durable
        self.shards: list[dict] = []  # [{"name", "rows", "bytes"}]
        self._current: _AppendFile | None = None
        # Bytes flushed since the last sync() across EVERY shard touched —
        # a chunk can span a rotation, and the rolling output digest must
        # see the closing shard's tail too, in append order.
        self._synced = bytearray()

    # -- resume -------------------------------------------------------------

    def restore(self, shards: list[dict]) -> None:
        """Adopt the committed shard state: truncate each to its committed
        bytes, delete uncommitted stragglers, reopen the tail shard."""
        committed = {s["name"] for s in shards}
        for fp in glob.glob(os.path.join(self.out_dir, "scores-*.jsonl")):
            if os.path.basename(fp) not in committed:
                os.unlink(fp)
        self.shards = [dict(s) for s in shards]
        for s in self.shards:
            _AppendFile(os.path.join(self.out_dir, s["name"])).truncate_to(
                int(s["bytes"])
            )
        self._current = None

    # -- write --------------------------------------------------------------

    def _shard_for_append(self) -> tuple[dict, _AppendFile]:
        if not self.shards or self.shards[-1]["rows"] >= self.rows_per_shard:
            name = self.SHARD_FMT.format(len(self.shards))
            self.shards.append({"name": name, "rows": 0, "bytes": 0})
            if self._current is not None:
                # Rotation: the closing shard's unsynced tail must reach
                # both disk (durability follows the same per-commit
                # policy) and the pending-bytes ledger (digest ordering).
                self._synced += self._current.sync(durable=self.durable)
                self._current.close()
            self._current = None
        if self._current is None:
            self._current = _AppendFile(
                os.path.join(self.out_dir, self.shards[-1]["name"])
            )
        return self.shards[-1], self._current

    def append_chunk(self, start_row: int, line_nos, p1) -> None:
        """Append one chunk's scores: ``row`` is the global 0-based scored
        ordinal (``start_row`` onward), ``line`` the row's 1-based input
        line — the join key that survives quarantined gaps."""
        i = int(start_row)
        vals = [float(v) for v in p1]
        lines = [int(v) for v in line_nos]
        if len(vals) != len(lines):
            raise ValueError(
                f"{len(vals)} scores for {len(lines)} line numbers"
            )
        off = 0
        while off < len(vals):
            shard, f = self._shard_for_append()
            take = min(len(vals) - off, self.rows_per_shard - shard["rows"])
            data = "".join(
                '{"row":%d,"line":%d,"p1":%r}\n'
                % (i + k, lines[off + k], vals[off + k])
                for k in range(take)
            ).encode()
            f.append(data)
            shard["rows"] += take
            shard["bytes"] += len(data)
            i += take
            off += take

    def sync(self) -> tuple[list[dict], bytes]:
        """Commit point: flush the open shard; returns (deep-copied shard
        state, bytes appended since the last sync — every shard touched,
        in append order)."""
        if self._current is not None:
            self._synced += self._current.sync(durable=self.durable)
        data = bytes(self._synced)
        self._synced.clear()
        return [dict(s) for s in self.shards], data

    def close(self) -> None:
        if self._current is not None:
            self._current.close()
            self._current = None

    def shard_paths(self) -> list[str]:
        return [os.path.join(self.out_dir, s["name"]) for s in self.shards]


class QuarantineWriter:
    """The malformed-row sidecar: line-numbered, append-committed with the
    same truncate-on-resume protocol as the score shards."""

    FILE = "quarantine.jsonl"

    def __init__(self, out_dir: str, durable: bool = True) -> None:
        self.path = os.path.join(os.path.abspath(out_dir), self.FILE)
        self.durable = durable
        self._f = _AppendFile(self.path)
        self.bytes = 0

    def restore(self, committed_bytes: int) -> None:
        self._f.truncate_to(int(committed_bytes))
        self.bytes = int(committed_bytes)

    def append(self, entries) -> None:
        """``entries``: (line_no, error, snippet) triples from one chunk."""
        if not entries:
            return
        data = "".join(
            json.dumps(
                {"line": line, "error": err, "raw": snippet},
                separators=(",", ":"),
            ) + "\n"
            for line, err, snippet in entries
        ).encode()
        self._f.append(data)
        self.bytes += len(data)

    def sync(self) -> int:
        self._f.sync(durable=self.durable)
        return self.bytes

    def close(self) -> None:
        self._f.close()

"""Streaming cohort ingest for bulk scoring: raw blocks in, parsed chunks out.

Two source formats, one contract:

  * **JSONL** — one patient JSON object per line, the 17-variable
    inference contract (``data.examples.validate_patient``), the same
    format ``tools/loadgen.py --patients`` drives serving with. Parsed
    chunks are contract-order ``[n, 17]`` rows.
  * **.mat** — the reference cohort layout (``data.matloader``): raw
    64-wide rows (NaNs allowed — the KNN imputer's job) when the file
    carries the full schema, contract rows when it carries exactly the
    17 model inputs. The outcome column, if present, is ignored: scoring
    is label-free by definition.

**Malformed-row policy.** ``validate_patient`` raises on the first bad
variable — correct for an interactive ``predict`` and fatal for a bulk
run: an hours-long cohort score must not die at row 1,999,999 because one
EHR export line was truncated. Streaming ingest therefore *quarantines*:
a bad line (unparseable JSON, missing/unknown/non-numeric variables) is
recorded with its 1-based line number, the error, and a bounded raw
snippet, the row is excluded from the chunk, and the run continues.
The error budget is bounded (``ScorePipeline(max_bad_rows=...)``): a
cohort that is mostly garbage aborts loudly instead of silently scoring
its parseable minority.

Blocks are *fixed line-count* slices of the input (``chunk_rows`` lines
per block), so the input→chunk mapping is deterministic: a resumed run
skips exactly the committed lines and re-enters at the same block
boundary the killed run would have used.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from machine_learning_replications_tpu_torch.data.examples import validate_patient

#: Longest raw-line prefix a quarantine record keeps (whole lines could be
#: megabytes of garbage; the sidecar must stay proportionate to the error
#: count, not the error size).
QUARANTINE_SNIPPET_CHARS = 200


@dataclass
class RawBlock:
    """One input slice, pre-parse: ``seq`` is the 0-based chunk index over
    the whole input (resume-stable), ``start_line`` the 1-based input line
    (or row, for .mat) of its first entry."""

    seq: int
    start_line: int
    lines: list[str] | None = None   # JSONL payload
    rows: np.ndarray | None = None   # .mat payload

    def __len__(self) -> int:
        return len(self.lines) if self.lines is not None else len(self.rows)


@dataclass
class ParsedChunk:
    """One scoring-ready chunk: ``X[n, width]`` valid rows (n ≤ block
    lines), each row's 1-based input line number (``line_nos[n]`` — the
    output's join key back to the source file), the lines consumed from
    the input, and the quarantined entries ``(line_no, error, snippet)``
    in input order."""

    seq: int
    start_line: int
    X: np.ndarray
    line_nos: np.ndarray
    lines_consumed: int
    bad: list[tuple[int, str, str]] = field(default_factory=list)

    @property
    def n_rows(self) -> int:
        return int(self.X.shape[0])


def parse_patient_lines(
    lines: list[str], start_line: int
) -> tuple[np.ndarray, np.ndarray, list[tuple[int, str, str]]]:
    """Validate a block of JSONL patient lines against the 17-variable
    contract: ``(X[n, 17], line_nos[n], bad)``. A pure module-level
    function on purpose — it is the process-pool entry point for
    ``ScorePipeline(parse_procs=...)``, where ingest parsing runs in
    spawned worker processes so the GIL-bound JSON work stops competing
    with the parent's XLA dispatch (workers never touch a JAX device;
    everything here is stdlib + numpy and pickles cheaply)."""
    rows: list[np.ndarray] = []
    line_nos: list[int] = []
    bad: list[tuple[int, str, str]] = []
    for i, raw in enumerate(lines):
        line_no = start_line + i
        stripped = raw.strip()
        if not stripped:
            bad.append((line_no, "empty line", ""))
            continue
        try:
            patient = json.loads(stripped)
            rows.append(validate_patient(patient)[0])
            line_nos.append(line_no)
        except (ValueError, TypeError) as exc:
            # json.JSONDecodeError is a ValueError; validate_patient
            # raises ValueError with the variable-level diagnosis.
            bad.append((
                line_no,
                f"{type(exc).__name__}: {exc}",
                stripped[:QUARANTINE_SNIPPET_CHARS],
            ))
    X = np.stack(rows) if rows else np.empty((0, 17), np.float64)
    return X, np.asarray(line_nos, np.int64), bad


def parse_patient_lines_timed(lines: list[str], start_line: int):
    """``parse_patient_lines`` plus the worker-side elapsed seconds, so the
    parent's per-stage accounting can attribute remote parse time without
    conflating it with pool queueing."""
    import time

    t0 = time.perf_counter()
    X, line_nos, bad = parse_patient_lines(lines, start_line)
    return X, line_nos, bad, time.perf_counter() - t0


class JsonlCohortSource:
    """A JSONL patient cohort: sequential raw-line blocks + a parse step
    safe to run from several worker threads at once (pure function of the
    block) — or, via ``parse_patient_lines``, from worker processes."""

    kind = "contract"
    width = 17
    supports_process_parse = True

    def __init__(self, path: str, chunk_rows: int, limit: int | None = None):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self.path = os.path.abspath(path)
        self.chunk_rows = int(chunk_rows)
        self.limit = None if limit is None else int(limit)

    def blocks(
        self, skip_lines: int = 0, start_seq: int = 0
    ) -> Iterator[RawBlock]:
        """Sequential block reader (the single ingest thread): skips the
        already-committed prefix line-by-line without parsing, then yields
        ``chunk_rows``-line blocks until EOF (or ``limit`` input lines,
        counted from the file start)."""
        budget = None if self.limit is None else self.limit - skip_lines
        if budget is not None and budget <= 0:
            return
        seq = start_seq
        line_no = 0
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for _ in range(skip_lines):
                if not f.readline():
                    return
                line_no += 1
            while True:
                take = self.chunk_rows
                if budget is not None:
                    take = min(take, budget)
                    if take <= 0:
                        return
                lines: list[str] = []
                start = line_no + 1
                for _ in range(take):
                    line = f.readline()
                    if not line:
                        break
                    line_no += 1
                    lines.append(line)
                if not lines:
                    return
                if budget is not None:
                    budget -= len(lines)
                yield RawBlock(seq=seq, start_line=start, lines=lines)
                seq += 1

    def parse(self, block: RawBlock) -> ParsedChunk:
        """Validate every line of the block against the 17-variable
        contract; bad lines are quarantined, good rows packed into one
        ``[n, 17]`` float64 matrix."""
        X, line_nos, bad = parse_patient_lines(block.lines, block.start_line)
        return ParsedChunk(
            seq=block.seq, start_line=block.start_line, X=X,
            line_nos=line_nos, lines_consumed=len(block.lines), bad=bad,
        )


class MatCohortSource:
    """A reference-layout ``.mat`` cohort. The MAT-v5 container is not
    streamable (both backends materialize the matrix), so the file loads
    once on first use and blocks are row slices; at the multi-million-row
    scale the matrix is hundreds of MB — bounded — while the *output* side
    of the pipeline still streams. ``data.matloader.load_feature_matrix``
    owns the format details (outcome-column handling included)."""

    supports_process_parse = False  # parse is a free dtype view — threads

    def __init__(self, path: str, chunk_rows: int, limit: int | None = None):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self.path = os.path.abspath(path)
        self.chunk_rows = int(chunk_rows)
        self.limit = None if limit is None else int(limit)
        self._X: np.ndarray | None = None

    def _matrix(self) -> np.ndarray:
        if self._X is None:
            from machine_learning_replications_tpu_torch.data import matloader

            self._X = matloader.load_feature_matrix(self.path)
            if self.limit is not None:
                self._X = self._X[: self.limit]
        return self._X

    @property
    def kind(self) -> str:
        return "contract" if self._matrix().shape[1] == 17 else "x64"

    @property
    def width(self) -> int:
        return int(self._matrix().shape[1])

    def blocks(
        self, skip_lines: int = 0, start_seq: int = 0
    ) -> Iterator[RawBlock]:
        X = self._matrix()
        seq = start_seq
        for s in range(skip_lines, X.shape[0], self.chunk_rows):
            rows = X[s : s + self.chunk_rows]
            yield RawBlock(seq=seq, start_line=s + 1, rows=rows)
            seq += 1

    def parse(self, block: RawBlock) -> ParsedChunk:
        # Matrix rows cannot be malformed (fixed width; NaN is a legal
        # missing value for the imputer) — parse is a dtype normalization.
        n = len(block.rows)
        return ParsedChunk(
            seq=block.seq, start_line=block.start_line,
            X=np.asarray(block.rows, np.float64),
            line_nos=np.arange(
                block.start_line, block.start_line + n, dtype=np.int64
            ),
            lines_consumed=n,
        )


def open_cohort(
    path: str, chunk_rows: int, fmt: str = "auto", limit: int | None = None
):
    """Resolve a cohort path to its source: ``.jsonl``/``.json``/``.ndjson``
    → JSONL patient dicts, ``.mat`` → the reference matrix layout; ``fmt``
    overrides the extension sniff."""
    if fmt not in ("auto", "jsonl", "mat"):
        raise ValueError(f"unknown cohort format {fmt!r}; use auto|jsonl|mat")
    if fmt == "auto":
        ext = os.path.splitext(path)[1].lower()
        fmt = "mat" if ext == ".mat" else "jsonl"
    if fmt == "mat":
        return MatCohortSource(path, chunk_rows, limit=limit)
    return JsonlCohortSource(path, chunk_rows, limit=limit)

"""Durable small-file writes.

Copy of the JAX package's ``persist/atomicio.py`` (stdlib only):
``fsync_json_dump`` for files inside a tree that is itself published by one
rename (the checkpoint writer), ``atomic_json_write`` for a single JSON file
replaced whole (the incident recorder's manifest).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def fsync_json_dump(path: "str | os.PathLike", obj: Any, indent: int = 1) -> None:
    """Write ``obj`` as JSON at ``path`` with flush+fsync — durable but not
    atomic on its own."""
    with open(os.fspath(path), "w") as f:
        json.dump(obj, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())


def atomic_json_write(path: "str | os.PathLike", obj: Any, indent: int = 1) -> None:
    """Atomically replace ``path`` with ``obj`` as JSON: full content into
    a same-directory temp file (fsync'd), then one ``os.replace``. A crash
    at any point leaves the previous version intact."""
    path = os.path.abspath(os.fspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=indent)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise

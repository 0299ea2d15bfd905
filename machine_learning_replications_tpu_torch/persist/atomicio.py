"""Durable small-file writes.

Copy of ``fsync_json_dump`` from the JAX package's ``persist/atomicio.py``
(stdlib only): the half the checkpoint writer uses, for files inside a tree
that is itself published by one rename.
"""

from __future__ import annotations

import json
import os
from typing import Any


def fsync_json_dump(path: "str | os.PathLike", obj: Any, indent: int = 1) -> None:
    """Write ``obj`` as JSON at ``path`` with flush+fsync — durable but not
    atomic on its own."""
    with open(os.fspath(path), "w") as f:
        json.dump(obj, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())

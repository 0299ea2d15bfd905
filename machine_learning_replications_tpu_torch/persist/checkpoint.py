"""The port's model checkpoints: one tensor file, a JSON sidecar, an
integrity manifest, atomic publish and last-known-good rollback.

The semantics are those of the JAX package's ``persist/orbax_io``
(``save_model``, ``load_model``, ``load_model_versioned``,
``checkpoint_version``) and ``resilience/lastgood``; the files are the
port's own. A checkpoint directory holds:

  * ``tensors.npz`` — every tensor of the parameter tree, keyed by its
    dotted field path (``ensemble.svc.support_vectors``), written with
    ``numpy.savez`` and read with ``allow_pickle=False``: loading never runs
    code from the directory;
  * ``model.json`` — the sidecar: ``{"format": 1, "family": ..., "root":
    ...}``, the family (``PipelineParams``, ``StackingParams`` or
    ``TreeEnsembleParams``) and the field tree, each dataclass by class name
    (resolved against a fixed registry), each tensor by key, shape and
    dtype, each static field (``max_depth``) by value;
  * ``integrity.json`` — sha256 and size of every other file, the
    checkpoint's monotonic ``version`` (one past the largest of the primary
    and its last-known-good) and the publish time.

Publish: the whole tree is written into ``<path>.tmp.<pid>`` beside the
target, the manifest over it; a checkpoint already at ``<path>`` is rotated
to ``<path>.lastgood`` (only if its files still match their manifest sizes;
a rotten primary is dropped instead, so it never replaces a good
last-known-good); then one ``os.rename`` makes the new tree visible. A
crash leaves the old checkpoint, or in the window after the rotation the
last-known-good, which ``load_model`` falls back to. Load: the manifest is
checked (every file's size and sha256) before any tensor is read; a primary
that fails to load falls back to ``<path>.lastgood``, counted and journaled
(``resilience.lastgood``).
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import shutil
import sys
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device
from machine_learning_replications_tpu_torch.models import (
    knn_impute, linear, pipeline, scaler, stacking, svm, tree,
)
from machine_learning_replications_tpu_torch.obs import journal, torchmon
from machine_learning_replications_tpu_torch.persist.atomicio import fsync_json_dump
from machine_learning_replications_tpu_torch.resilience import lastgood

FORMAT = 1
TENSORS_FILE = "tensors.npz"
SIDECAR_FILE = "model.json"
INTEGRITY_FILE = "integrity.json"
LASTGOOD_SUFFIX = ".lastgood"
FAMILIES = ("PipelineParams", "StackingParams", "TreeEnsembleParams")
_CLASSES = {c.__name__: c for c in (
    pipeline.PipelineParams, stacking.StackingParams, scaler.ScalerParams, svm.SVCParams,
    tree.TreeEnsembleParams, linear.LinearParams, knn_impute.KNNImputerParams,
)}


class CheckpointIntegrityError(RuntimeError):
    """The checkpoint's files do not match its integrity manifest."""


def lastgood_path(path: "str | os.PathLike") -> str:
    """The sibling directory holding a checkpoint's previous version."""
    return os.path.abspath(os.fspath(path)).rstrip(os.sep) + LASTGOOD_SUFFIX


def checkpoint_version(path: "str | os.PathLike") -> int | None:
    """The version stamped into the checkpoint's manifest, or None (no
    checkpoint, or an unreadable manifest). Never raises."""
    try:
        with open(os.path.join(os.fspath(path), INTEGRITY_FILE)) as f:
            v = json.load(f).get("version")
        return int(v) if v is not None else None
    except (OSError, ValueError, TypeError, AttributeError):
        return None


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _payload_files(path: str) -> list[str]:
    out = []
    for root, _dirs, names in os.walk(path):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), path)
            if rel != INTEGRITY_FILE:
                out.append(rel)
    return sorted(out)


def verify_checkpoint(path: "str | os.PathLike", *, deep: bool = True) -> None:
    """Check every file against the manifest: present, of its size and
    (``deep``) of its sha256. Raises ``CheckpointIntegrityError``; a
    checkpoint without a manifest is refused too (the format always has
    one)."""
    path = os.path.abspath(os.fspath(path))
    try:
        with open(os.path.join(path, INTEGRITY_FILE)) as f:
            files = json.load(f)["files"]
    except (OSError, ValueError, KeyError, TypeError) as exc:
        raise CheckpointIntegrityError(
            f"no readable integrity manifest in {path!r}: {type(exc).__name__}: {exc}"
        ) from exc
    for rel, spec in sorted(files.items()):
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            raise CheckpointIntegrityError(f"checkpoint {path!r} is missing {rel!r}")
        size = os.path.getsize(fp)
        if size != spec["bytes"]:
            raise CheckpointIntegrityError(
                f"checkpoint file {rel!r} is {size} bytes, manifest says {spec['bytes']}")
        if deep and _sha256(fp) != spec["sha256"]:
            raise CheckpointIntegrityError(f"checkpoint file {rel!r} content hash mismatch")


def _encode(node: Any, arrays: dict[str, np.ndarray], key: str) -> Any:
    """Parameter tree → JSON sidecar node; tensors go into ``arrays``."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        name = type(node).__name__
        if name not in _CLASSES:
            raise TypeError(f"cannot checkpoint {name}: not a parameter class of the port")
        return {"cls": name, "fields": {
            f.name: _encode(getattr(node, f.name), arrays, f"{key}.{f.name}".lstrip("."))
            for f in dataclasses.fields(node)}}
    if isinstance(node, (torch.Tensor, np.ndarray)):
        a = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else node
        arrays[key] = a
        return {"array": {"key": key, "shape": list(a.shape), "dtype": str(a.dtype)}}
    if isinstance(node, dict):
        if not all(isinstance(k, str) for k in node):
            raise TypeError("cannot checkpoint a dict with non-string keys")
        return {"mapping": {k: _encode(v, arrays, f"{key}.{k}") for k, v in node.items()}}
    if isinstance(node, (tuple, list)):
        return {"seq": [_encode(v, arrays, f"{key}.{i}") for i, v in enumerate(node)],
                "tuple": isinstance(node, tuple)}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"static": node}
    raise TypeError(f"cannot checkpoint a {type(node).__name__} field")


def _decode(node: dict, arrays, dev: torch.device) -> Any:
    """Sidecar node → parameter tree with tensors on ``dev``."""
    if "cls" in node:
        cls = _CLASSES[node["cls"]]
        return cls(**{k: _decode(v, arrays, dev) for k, v in node["fields"].items()})
    if "array" in node:
        spec = node["array"]
        a = arrays[spec["key"]]
        if list(a.shape) != spec["shape"] or str(a.dtype) != spec["dtype"]:
            raise CheckpointIntegrityError(
                f"tensor {spec['key']!r} is {a.dtype}{list(a.shape)}, the sidecar says "
                f"{spec['dtype']}{spec['shape']}")
        return torchmon.device_put(a, dev)
    if "mapping" in node:
        return {k: _decode(v, arrays, dev) for k, v in node["mapping"].items()}
    if "seq" in node:
        items = [_decode(v, arrays, dev) for v in node["seq"]]
        return tuple(items) if node.get("tuple", True) else items
    if "static" in node:
        return node["static"]
    raise ValueError(f"malformed sidecar node: {sorted(node)}")


def save_model(path: "str | os.PathLike", params: Any, *, aot: bool = False) -> int:
    """Publish ``params`` (a ``PipelineParams``, ``StackingParams`` or
    ``TreeEnsembleParams``) at ``path`` atomically; a checkpoint already
    there becomes the last-known-good. Journals ``checkpoint_publish``.
    Returns the new version.

    ``aot=True`` also compiles the serving engine's program into the same
    publish (``persist.aot.export_aot``): replicas that restore this
    checkpoint load it instead of capturing every bucket. The compile is
    paid here, once, at publish time; the packages are checksummed with
    the other files."""
    family = type(params).__name__
    if family not in FAMILIES:
        raise TypeError(f"a checkpoint holds one of {FAMILIES}, not {family}")
    return _publish_journaled(path, params, family, aot=aot)


def _publish_journaled(path: "str | os.PathLike", params: Any, family: str, *,
                       aot: bool = False) -> int:
    version = _publish(path, params, family, aot=aot)
    journal.event("checkpoint_publish", path=os.path.abspath(os.fspath(path)), version=version)
    return version


def _publish(path: "str | os.PathLike", params: Any, family: str, *, aot: bool = False) -> int:
    path = os.path.abspath(os.fspath(path))
    prev = [v for v in (checkpoint_version(path), checkpoint_version(lastgood_path(path)))
            if v is not None]
    version = (max(prev) if prev else 0) + 1
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        os.makedirs(tmp)
        arrays: dict[str, np.ndarray] = {}
        root = _encode(params, arrays, "")
        with open(os.path.join(tmp, TENSORS_FILE), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        fsync_json_dump(os.path.join(tmp, SIDECAR_FILE),
                        {"format": FORMAT, "family": family, "root": root})
        if aot:
            from machine_learning_replications_tpu_torch.persist.aot import export_aot

            export_aot(tmp, params)
        files = {rel: {"sha256": _sha256(os.path.join(tmp, rel)),
                       "bytes": os.path.getsize(os.path.join(tmp, rel))}
                 for rel in _payload_files(tmp)}
        fsync_json_dump(os.path.join(tmp, INTEGRITY_FILE), {
            "format": FORMAT, "files": files, "version": version,
            "published": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        })
        if os.path.isdir(path):
            try:
                verify_checkpoint(path, deep=False)
            except CheckpointIntegrityError:
                shutil.rmtree(path)             # never rotate a rotten primary
            else:
                shutil.rmtree(lastgood_path(path), ignore_errors=True)
                os.rename(path, lastgood_path(path))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return version


def _load_at(path: str, dev: torch.device, families: tuple[str, ...] = FAMILIES) -> Any:
    verify_checkpoint(path)
    with open(os.path.join(path, SIDECAR_FILE)) as f:
        sidecar = json.load(f)
    if sidecar.get("format") != FORMAT or sidecar.get("family") not in families:
        raise ValueError(f"unknown checkpoint format or family in {path!r}: "
                         f"{sidecar.get('format')!r}, {sidecar.get('family')!r}")
    with np.load(os.path.join(path, TENSORS_FILE), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    params = _decode(sidecar["root"], arrays, dev)
    if sidecar["family"] in FAMILIES and type(params).__name__ != sidecar["family"]:
        raise ValueError(f"sidecar family {sidecar['family']!r} does not match its root")
    return params


def load_model_versioned(path: "str | os.PathLike", *, device=None) -> tuple[Any, dict]:
    """``(params, info)`` with ``info = {"path", "version", "rolled_back"}``:
    which directory actually loaded. A primary that fails to load (integrity,
    missing or torn files, a bad sidecar) falls back to its last-known-good,
    loudly (``resilience.lastgood.record_rollback``: counted, journaled as
    ``checkpoint_rollback``, a line on stderr; ``rolled_back`` True); without
    one the error propagates."""
    dev = resolve_device(device)
    path = os.path.abspath(os.fspath(path))
    try:
        params, used = _load_at(path, dev), path
    except Exception as exc:
        lg = lastgood_path(path)
        if not os.path.isdir(lg):
            raise
        params, used = _load_at(lg, dev), lg   # a bad last-known-good raises here
        lastgood.record_rollback(path, lg, f"{type(exc).__name__}: {exc}")
    return params, {"path": used, "version": checkpoint_version(used),
                    "rolled_back": used != path}


def load_model(path: "str | os.PathLike", *, device=None) -> Any:
    """The parameters of the checkpoint at ``path`` on ``device`` (default:
    the card), with ``load_model_versioned``'s fallback."""
    return load_model_versioned(path, device=device)[0]


# ---------------------------------------------------------------------------
# Training checkpoints: fit stages and boosting steps
# ---------------------------------------------------------------------------
#
# The same tree format (``tensors.npz`` + sidecar + integrity manifest,
# published by one rename) holds any tree ``_encode`` takes — tuples, dicts,
# tensors, statics and the parameter classes — under the sidecar family
# ``TREE_FAMILY``. A directory that exists under its final name is complete.

TREE_FAMILY = "tree"
FINGERPRINT_FILE = "fingerprint.json"
_STEP_PREFIX = "step_"


class SimulatedInterrupt(RuntimeError):
    """Raised by test hooks to emulate preemption mid-training."""


def save_tree(path: "str | os.PathLike", tree: Any) -> int:
    """Publish an arbitrary encodable tree at ``path`` atomically (a stage
    output: journaled as ``checkpoint_publish``, as ``save_model``)."""
    return _publish_journaled(path, tree, TREE_FAMILY)


def load_tree(path: "str | os.PathLike", *, device=None) -> Any:
    """The tree published at ``path`` (integrity checked first), tensors on
    ``device`` (default: the card)."""
    return _load_at(os.path.abspath(os.fspath(path)), resolve_device(device), (TREE_FAMILY,))


def _complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, INTEGRITY_FILE))


def _steps(directory: str) -> list[int]:
    """Completed boosting steps under ``directory``, newest first."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        tail = name[len(_STEP_PREFIX):]
        if name.startswith(_STEP_PREFIX) and tail.isdigit() and _complete(
                os.path.join(directory, name)):
            steps.append(int(tail))
    return sorted(steps, reverse=True)


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_STEP_PREFIX}{step:08d}")


def save_step(directory: "str | os.PathLike", step: int, carry: Any, *,
              max_to_keep: int = 2) -> None:
    """Publish a boosting carry as step ``step`` (stages completed) and keep
    only the newest ``max_to_keep`` steps — enough to survive a failure
    during a save."""
    directory = os.path.abspath(os.fspath(directory))
    os.makedirs(directory, exist_ok=True)
    _publish(_step_path(directory, step), carry, TREE_FAMILY)
    for old in _steps(directory)[max_to_keep:]:
        shutil.rmtree(_step_path(directory, old), ignore_errors=True)
        shutil.rmtree(lastgood_path(_step_path(directory, old)), ignore_errors=True)


def restore_latest_step(directory: "str | os.PathLike", *, device=None) -> tuple[int, Any]:
    """``(step, carry)`` of the newest step under ``directory`` that loads
    (an older one when the newest fails its integrity check), or ``(0,
    None)``."""
    directory = os.path.abspath(os.fspath(directory))
    for step in _steps(directory):
        try:
            return step, load_tree(_step_path(directory, step), device=device)
        except (CheckpointIntegrityError, OSError, ValueError, KeyError) as exc:
            print(f"boosting step {step} in {directory!r} failed to load "
                  f"({type(exc).__name__}: {exc}); trying an older one", file=sys.stderr)
    return 0, None


class StageCheckpointer:
    """Stage-level checkpoint/resume for multi-stage fits (the JAX package's
    ``persist/orbax_io.StageCheckpointer``). Each named stage's output tree
    is published durably under ``root/<name>``; on re-entry a completed
    stage is restored instead of recomputed. Stage outputs are
    deterministic, so a resumed fit equals an unbroken one. With ``root``
    None every stage runs straight through and nothing is written.

    ``fingerprint`` binds the directory to the fit's inputs: a directory
    written by a fit with other inputs, or one holding completed stages
    without a readable fingerprint, is refused. A stage whose checkpoint
    fails to load (torn or corrupt files) is discarded and recomputed.
    ``timings`` (a dict) receives each stage's seconds, its queued device
    work included. Every stage reports through ``obs.journal.stage_scope``
    (a ``stage:<name>`` span, ``stage_start``/``stage_done``/``stage_error``
    journaled, the JAX package's stderr lines, " (checkpointed)" when
    durable); a restored stage journals ``checkpoint_restore``, a discarded
    one ``checkpoint_corrupt``. ``_interrupt_after`` is the test hook that
    raises ``SimulatedInterrupt`` right after the named stage is durable.

    With ``mesh`` (a ``parallel`` mesh whose ranks all run this fit on one
    ``root``) rank 0 alone writes: the fingerprint and every stage. Each
    rank reads, and a stage is restored only where every rank loaded it, else
    every rank recomputes it; rank 0's writes are held to one outcome across
    the ranks (``parallel.mesh.agree``), so a failed publish raises on every
    rank instead of leaving the others in the next collective."""

    def __init__(self, root: "str | os.PathLike | None", *, device=None,
                 _interrupt_after: str | None = None, fingerprint: str | None = None,
                 timings: "dict | None" = None, mesh=None) -> None:
        self.root = None if root is None else os.path.abspath(os.fspath(root))
        self.device = resolve_device(device)
        self.timings = {} if timings is None else timings
        self._interrupt_after = _interrupt_after
        self.mesh = mesh
        self._writer = mesh is None or mesh.rank == 0
        if self.root is not None:
            def _open():
                os.makedirs(self.root, exist_ok=True)
                if fingerprint is not None:
                    self._check_fingerprint(fingerprint)

            self._agree(_open)

    def _agree(self, fn):
        from machine_learning_replications_tpu_torch.parallel.mesh import agree

        return agree(self.mesh, fn)

    def _check_fingerprint(self, fingerprint: str) -> None:
        fp_path = os.path.join(self.root, FINGERPRINT_FILE)
        stored = None
        try:
            with open(fp_path) as f:
                stored = json.load(f)["fingerprint"]
        except FileNotFoundError:
            pass
        except (OSError, ValueError, KeyError, TypeError):
            stored = None  # a torn write: treated as absent, below
        if stored is not None:
            if stored != fingerprint:
                raise RuntimeError(
                    f"checkpoint dir {self.root!r} was written by a fit with different "
                    f"inputs (stored fingerprint {str(stored)[:16]}…, this fit "
                    f"{fingerprint[:16]}…); pass a fresh checkpoint_dir or delete the stale one")
            return
        stray = [d for d in sorted(os.listdir(self.root))
                 if _complete(os.path.join(self.root, d))]
        if stray:
            raise RuntimeError(
                f"checkpoint dir {self.root!r} holds completed stages ({', '.join(stray)}) "
                "but no fingerprint recording which inputs produced them; pass a fresh "
                "checkpoint_dir or delete the stale one")
        if not self._writer:
            return
        tmp = f"{fp_path}.tmp.{os.getpid()}"
        fsync_json_dump(tmp, {"fingerprint": fingerprint})
        os.replace(tmp, fp_path)

    def completed(self, name: str) -> bool:
        return self.root is not None and _complete(os.path.join(self.root, name))

    def run(self, name: str, compute):
        """The stage's output: restored if previously completed (on every
        rank of the mesh), else ``compute()`` then published (before the
        interrupt hook fires)."""
        from machine_learning_replications_tpu_torch.device import synchronize
        from machine_learning_replications_tpu_torch.utils.trace import stage_say

        path = None if self.root is None else os.path.join(self.root, name)
        out, corrupt = None, None
        if self.completed(name):
            try:
                out = load_tree(path, device=self.device)
            except (CheckpointIntegrityError, OSError, ValueError, KeyError) as exc:
                corrupt = exc
        if self.root is not None and self.mesh is not None and self.mesh.groups is not None:
            from machine_learning_replications_tpu_torch.parallel.mesh import psum

            loaded = torch.tensor([float(out is not None)], device=self.device)
            if int(psum(loaded, self.mesh, None).item()) < self.mesh.size:
                out = None  # a rank could not load it: every rank recomputes
        if out is not None:
            stage_say(f"stage {name!r} restored from checkpoint")
            journal.event("checkpoint_restore", stage=name)
            return out
        if corrupt is not None:
            if self._writer:
                shutil.rmtree(path, ignore_errors=True)
            stage_say(f"stage {name!r}: checkpoint corrupt ({type(corrupt).__name__}) — "
                      "discarded, recomputing")
            journal.event("checkpoint_corrupt", stage=name, error=type(corrupt).__name__)
        with journal.stage_scope(name, done_suffix="" if self.root is None
                                 else " (checkpointed)") as stage:
            out = compute()
            synchronize(self.device)
            if self.root is not None:
                self._agree(lambda: save_tree(path, out) if self._writer else None)
        self.timings[name] = stage.seconds
        if self._interrupt_after == name:
            raise SimulatedInterrupt(f"after stage {name!r}")
        return out

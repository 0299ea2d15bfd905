"""AOT executable bundles — compile at publish time, restore at start time.

Port of the JAX package's ``persist/aot.py``: the same names, manifest and
fails-open contract. JAX compiles each bucket's core with ``jax.jit`` and
serializes the executable; the port's counterpart is AOTInductor.
``export_aot`` traces the serving engine's forward step
(``serve.engine.forward_step``, the body each bucket's CUDA graph captures)
with ``torch.export`` and compiles it with
``torch._inductor.aoti_compile_and_package`` into a ``.pt2`` package; a
replica loads it with torch's C++ package loader (what
``aoti_load_package`` wraps), with no compiler at load time, and runs it
instead of capturing the bucket.

**Artifact layout.** ``export_aot`` writes an ``aot/`` subtree into the
checkpoint directory being published (inside ``checkpoint.save_model``'s
atomic publish, so the blobs are covered by ``integrity.json`` like every
other checkpoint file and rotate through the ``.lastgood`` slot)::

    <checkpoint>/aot/manifest.json   fingerprints + blob index
    <checkpoint>/aot/<backend>.pt2   one package per backend

One package serves a backend's whole ladder: its batch dimension is
dynamic, from 1 to the top bucket. The manifest still lists one entry per
``(backend, bucket)``, as JAX's does, so a bucket the bundle does not cover
reads as ``missing_bucket``. The device ladder is compiled for the device
the publisher's parameters lie on and the host ladder
(``serve.hostpath.DEFAULT_HOST_BUCKETS``) for the CPU; on a CPU run the two
merge into one ``cpu`` package.

**Graph inputs, never constants.** Every parameter tensor, the lasso
support columns and the imputer block's distance columns enter the program
as inputs, so a bundle computes with the LIVE engine's parameters: a
same-shape bundle published from other weights serves these weights'
numbers. What the trace bakes in as Python values — the imputer block's
NaN columns, every input's shape and dtype, the member topology
(``max_depth``) — is the bundle's structure key; ``load_exec`` holds it to
the live engine's and raises on a mismatch (JAX's ``in_tree``/``out_tree``
check), so a same-shape bundle with another NaN pattern cannot impute the
wrong columns.

**Fingerprints.** A package is valid only where it was compiled: each
backend's fingerprint records the torch and CUDA versions, the backend,
the device kind (the card's name and ``sm_XY``; for ``cpu`` the vector ISA
Inductor compiled for, ``torch.backends.cpu.get_cpu_capability()``), the
parameters' dtype (JAX's ``x64`` flag) and the family. The structure key
rides in the fingerprint too, but is checked per bucket by ``load_exec``.

**Fails open.** A missing ``aot/`` tree, an unreadable manifest, a
fingerprint mismatch, a torn package or a structure mismatch each journal
``aot_fallback`` (counted in ``serve_aot_fallback_total{reason}``) and the
engine captures that bucket on the same device instead — slower, never
wrong. ``cli serve --no-aot`` (and the fleet passthrough) forces capture
outright. The ``persist.aot_restore`` faultpoint tears the restore path on
demand.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any

from machine_learning_replications_tpu_torch.resilience import faults

AOT_DIRNAME = "aot"
_MANIFEST = "manifest.json"

#: Parameter fields the forward step never reads: left out of the graph.
_UNUSED_FIELDS = ("quality", "support_mask")
#: Fingerprint keys checked by ``load_exec`` rather than ``unusable_reason``.
_STRUCTURE_KEY = "structure"


def _device_kind(backend: str) -> str | None:
    import torch

    if backend == "cpu":
        return "cpu"
    if backend == "cuda" and torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        return f"{torch.cuda.get_device_name()} sm_{major}{minor}"
    return None


def platform_fingerprint(backend: str, *, dtype=None, family=None, structure=None) -> dict:
    """The compatibility key a package is valid under: torch and CUDA
    versions, the backend, the concrete device kind, the CPU's vector ISA
    (``cpu`` only), the parameters' dtype and the family (and, recorded by
    ``export_aot``, the structure key)."""
    import torch

    fp = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": backend,
        "device_kind": _device_kind(backend),
        "cpu_capability": (
            torch.backends.cpu.get_cpu_capability() if backend == "cpu" else None),
        "dtype": None if dtype is None else str(dtype),
        "family": family,
    }
    if structure is not None:
        fp[_STRUCTURE_KEY] = structure
    return fp


def _fingerprint_diff(want: dict, have: dict) -> str | None:
    """Human-readable mismatch between a manifest fingerprint and the
    current platform (None when compatible)."""
    bad = [
        f"{k}={have.get(k)!r} (blob built for {want.get(k)!r})"
        for k in sorted(set(want) | set(have))
        if want.get(k) != have.get(k)
    ]
    return ", ".join(bad) if bad else None


# -- the graph's inputs --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Node:
    """A parameter dataclass with its tensors replaced by input slots."""

    cls: type
    fields: dict


@dataclasses.dataclass(frozen=True)
class _Slot:
    index: int


def _split(node: Any, key: str, leaves: list, names: list, statics: dict) -> Any:
    import torch

    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return _Node(type(node), {
            f.name: (None if f.name in _UNUSED_FIELDS else _split(
                getattr(node, f.name), f"{key}.{f.name}".lstrip("."), leaves, names, statics))
            for f in dataclasses.fields(node)})
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        names.append(key)
        return _Slot(len(leaves) - 1)
    if node is not None:
        statics[key] = node
    return node


def _join(tmpl: Any, leaves) -> Any:
    if isinstance(tmpl, _Node):
        return tmpl.cls(**{k: _join(v, leaves) for k, v in tmpl.fields.items()})
    if isinstance(tmpl, _Slot):
        return leaves[tmpl.index]
    return tmpl


def _spec(t) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


class GraphInputs:
    """An engine's forward step as a function of tensors only:
    ``inputs`` (every parameter tensor, then, for a pipeline, the support
    columns and the imputer block's NaN and distance columns), ``rebuild(inputs)``
    → ``(params, cols, block)``, and the ``structure`` key of everything the
    trace bakes in. ``export_aot`` and the restoring engine build it the
    same way from their own engines, so equal keys mean one program."""

    def __init__(self, engine) -> None:
        leaves: list = []
        names: list = []
        statics: dict = {}
        self._tmpl = _split(engine.params, "", leaves, names, statics)
        self._n_params = len(leaves)
        block = engine._block
        self._block = block
        extra = []
        if engine.family == "pipeline":
            extra.append(("support_columns", engine._cols))
            extra.append(("impute_block.nan_index", block.nan_index))
            if block.dist_index is not None:
                extra.append(("impute_block.dist_index", block.dist_index))
        self.inputs = tuple(leaves) + tuple(t for _, t in extra)
        names += [n for n, _ in extra]
        self.engine = engine
        width = (int(engine.params.support_mask.shape[0]) if engine.family == "pipeline"
                 else engine.n_features)
        self.structure = {
            "family": engine.family,
            "inputs": {n: _spec(t) for n, t in zip(names, self.inputs)},
            "rows": [["batch", width], str(engine._in_dtype).removeprefix("torch.")],
            "statics": statics,
            "impute_block": None if block is None else {
                "nan_cols": list(block.nan_cols),
                "masked_donor_cols": list(block.masked_donor_cols),
                "dist_cols": None if block.dist_cols is None else list(block.dist_cols),
            },
            "outputs": list(_OUTPUTS[engine.family]),
        }

    def rebuild(self, inputs):
        params = _join(self._tmpl, inputs[:self._n_params])
        extra = list(inputs[self._n_params:])
        cols = block = None
        if self.engine.family == "pipeline":
            cols = extra.pop(0)
            block = dataclasses.replace(self._block, nan_index=extra.pop(0))
            if block.dist_index is not None:
                block = dataclasses.replace(block, dist_index=extra.pop(0))
        return params, cols, block


#: What the package returns per family; the rest of ``(p1, members,
#: qrows)`` is the input rows themselves (or no members, for a forest).
_OUTPUTS = {"stacking": ("p1", "members"), "tree": ("p1",),
            "pipeline": ("p1", "members", "qrows")}


def outputs_to_step(family: str, outs, X):
    """A package's outputs → the engine's ``(p1, members, qrows)``."""
    outs = tuple(outs)
    if family == "tree":
        return outs[0], None, X
    if family == "stacking":
        return outs[0], outs[1], X
    return outs[0], outs[1], outs[2]


def _module(gi: GraphInputs):
    import torch

    from machine_learning_replications_tpu_torch.serve.engine import forward_step

    eng = gi.engine

    class _Forward(torch.nn.Module):
        def forward(self, inputs, X):
            params, cols, block = gi.rebuild(inputs)
            p1, members, qrows = forward_step(
                eng.family, eng._core, eng._dtype, params, cols, block, X)
            return (p1, members, qrows)[:len(_OUTPUTS[eng.family])]

    return _Forward()


@functools.lru_cache(maxsize=1)
def _openmp_cxx() -> str | None:
    """The first C++ compiler on this host that builds and runs an OpenMP
    program (``$CXX``, then ``g++``, ``c++``, ``clang++``): Inductor
    compiles every package's wrapper with ``-fopenmp``, and a toolchain
    without ``libgomp`` fails there. None keeps Inductor's own choice."""
    import subprocess

    probe = "#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n"
    tmp = tempfile.mkdtemp(prefix="aot_cxx_")
    try:
        src, exe = os.path.join(tmp, "omp.cpp"), os.path.join(tmp, "omp")
        with open(src, "w") as f:
            f.write(probe)
        for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                                 if c):
            path = shutil.which(cxx)
            if path is None:
                continue
            try:
                subprocess.run([path, "-fopenmp", src, "-o", exe], check=True,
                               capture_output=True, timeout=60)
                subprocess.run([exe], check=True, capture_output=True, timeout=60)
            except (OSError, subprocess.SubprocessError):
                continue
            return path
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _compile(gi: GraphInputs, top: int, package_path: str) -> None:
    """Trace the forward step at a dynamic batch of 1..``top`` rows and
    compile it into ``package_path``."""
    import numpy as np
    import torch
    from torch._inductor import aoti_compile_and_package, config

    from machine_learning_replications_tpu_torch.data.examples import patient_row
    from machine_learning_replications_tpu_torch.models import svm

    eng = gi.engine
    example = min(top, 8)
    X = torch.as_tensor(np.repeat(eng._host_rows(patient_row()), example, axis=0),
                        device=eng.device).to(eng._in_dtype)
    dynamic = None
    if top > 1:
        dynamic = ((None,) * len(gi.inputs),
                   {0: torch.export.Dim("batch", min=1, max=top)})
    cxx = _openmp_cxx()
    # The whole export under the compiler choice: Inductor also probes the
    # host's vector ISA with it.
    with torch.no_grad(), svm.coupling_as_scan(), config.patch(
            {} if cxx is None else {"cpp.cxx": (cxx,)}):
        ep = torch.export.export(_module(gi), (gi.inputs, X), dynamic_shapes=dynamic)
        aoti_compile_and_package(ep, package_path=package_path)


def _package(params, buckets, backend: str, device, aot_dir: str) -> tuple[list, "GraphInputs"]:
    """Compile one backend's package in this process: its manifest
    entries and the engine's graph inputs."""
    from machine_learning_replications_tpu_torch.serve.engine import BucketedPredictEngine

    gi = GraphInputs(BucketedPredictEngine(params, buckets=sorted(buckets), device=device))
    name = f"{backend}.pt2"
    _compile(gi, max(buckets), os.path.join(aot_dir, name))
    return _entries(backend, buckets, name, aot_dir, gi), gi


def _entries(backend: str, buckets, name: str, aot_dir: str, gi: "GraphInputs") -> list:
    size = os.path.getsize(os.path.join(aot_dir, name))
    width = int(gi.structure["rows"][0][1])
    return [{"backend": backend, "bucket": b, "file": name, "bytes": size, "width": width}
            for b in sorted(buckets)]


def _spawn_cpu_package(params, buckets, aot_dir: str, work: str):
    """Start the CPU package's compile in a child process (it runs beside
    the card's, which this process compiles: AOTInductor's host-side C++
    builds are serial, so two processes halve the publish's wall time).
    The parameters cross as a checkpoint tree in ``work``."""
    import subprocess
    import sys

    import numpy as np

    from machine_learning_replications_tpu_torch.persist import checkpoint

    arrays: dict = {}
    root = checkpoint._encode(params, arrays, "")
    with open(os.path.join(work, "params.npz"), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(work, "params.json"), "w") as f:
        json.dump({"root": root, "buckets": sorted(buckets)}, f)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(p for p in (pkg_root, os.environ.get("PYTHONPATH"))
                                          if p))
    return subprocess.Popen(
        [sys.executable, "-m", __name__, work, os.path.join(aot_dir, "cpu.pt2")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _child_main(argv: list) -> int:
    """The child of ``_spawn_cpu_package``: compile the CPU package."""
    import numpy as np
    import torch

    from machine_learning_replications_tpu_torch.persist import checkpoint

    work, package_path = argv
    with open(os.path.join(work, "params.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(work, "params.npz"), allow_pickle=False) as z:
        params = checkpoint._decode(spec["root"], {k: z[k] for k in z.files},
                                    torch.device("cpu"))
    from machine_learning_replications_tpu_torch.serve.engine import BucketedPredictEngine

    gi = GraphInputs(BucketedPredictEngine(params, buckets=spec["buckets"], device="cpu"))
    _compile(gi, max(spec["buckets"]), package_path)
    return 0


def export_aot(
    tree_dir: str | os.PathLike,
    params,
    device_buckets=None,
    host_buckets=None,
) -> dict:
    """Compile every bucket's program into ``<tree_dir>/aot/``: one package
    per backend, covering its ladder. Called inside ``save_model``'s
    publish (``tree_dir`` is the pre-rename temporary tree), so the
    packages land in the integrity manifest with everything else.

    The device ladder goes on the device ``params`` lie on, the host ladder
    on the CPU; with parameters on the CPU they merge into one package.
    Beside a card, the CPU package compiles in a child process while this
    one compiles the card's. Journals ``aot_export`` (with each backend's
    seconds). Returns the manifest."""
    import torch

    from machine_learning_replications_tpu_torch import convert
    from machine_learning_replications_tpu_torch.obs import journal
    from machine_learning_replications_tpu_torch.persist.atomicio import fsync_json_dump
    from machine_learning_replications_tpu_torch.serve.engine import (
        DEFAULT_BUCKETS, family_core, params_device, params_dtype,
    )
    from machine_learning_replications_tpu_torch.serve.hostpath import DEFAULT_HOST_BUCKETS

    t0 = time.perf_counter()
    if device_buckets is None:
        device_buckets = DEFAULT_BUCKETS
    if host_buckets is None:
        host_buckets = DEFAULT_HOST_BUCKETS
    device = params_device(params)
    plan: dict[str, set[int]] = {device.type: {int(b) for b in device_buckets}}
    plan.setdefault("cpu", set()).update(int(b) for b in host_buckets)
    plan = {k: v for k, v in plan.items() if v}

    family = family_core(params)[0]
    dtype = params_dtype(params)
    aot_dir = os.path.join(os.fspath(tree_dir), AOT_DIRNAME)
    os.makedirs(aot_dir, exist_ok=True)
    blobs: list[dict] = []
    fingerprints: dict[str, dict] = {}
    seconds: dict[str, float] = {}
    child = work = None
    if device.type != "cpu" and device.type in plan and "cpu" in plan:
        work = tempfile.mkdtemp(prefix="aot_cpu_")
        child = _spawn_cpu_package(convert.params_to(params, "cpu"), plan["cpu"], aot_dir, work)
    try:
        for backend, buckets in sorted(plan.items()):
            if child is not None and backend == "cpu":
                continue
            t1 = time.perf_counter()
            entries, gi = _package(params, buckets, backend, device if backend == device.type
                                   else torch.device("cpu"), aot_dir)
            blobs += entries
            fingerprints[backend] = platform_fingerprint(
                backend, dtype=dtype, family=family, structure=gi.structure)
            seconds[backend] = round(time.perf_counter() - t1, 3)
        if child is not None:
            log = child.communicate()[0]
            if child.returncode != 0:
                raise RuntimeError(f"the CPU package's compile failed (exit "
                                   f"{child.returncode}): {log[-3000:]}")
            seconds["cpu"] = round(time.perf_counter() - t0, 3)
            blobs += _entries("cpu", plan["cpu"], "cpu.pt2", aot_dir, gi)
            fingerprints["cpu"] = platform_fingerprint(
                "cpu", dtype=dtype, family=family, structure=gi.structure)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)
    manifest = {
        "format": 1,
        "family": family,
        "fingerprints": fingerprints,
        "blobs": sorted(blobs, key=lambda b: (b["backend"], b["bucket"])),
    }
    fsync_json_dump(os.path.join(aot_dir, _MANIFEST), manifest)
    journal.event(
        "aot_export", path=os.fspath(tree_dir), blobs=len(blobs),
        seconds=round(time.perf_counter() - t0, 3), backend_seconds=seconds,
    )
    return manifest


def load_bundle(checkpoint_dir: str | os.PathLike) -> "AotBundle | None":
    """The checkpoint's AOT bundle, or None when it ships none (or its
    manifest is unreadable — journaled and counted; the engine then
    captures, as it would for a checkpoint without a bundle)."""
    from machine_learning_replications_tpu_torch.obs import journal

    path = os.path.join(os.path.abspath(os.fspath(checkpoint_dir)), AOT_DIRNAME)
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.exists(manifest_path):
        return None
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("format") != 1:
            raise ValueError(f"unknown aot manifest format {manifest.get('format')!r}")
        manifest["blobs"] = list(manifest["blobs"])
        dict(manifest["fingerprints"])
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as exc:
        from machine_learning_replications_tpu_torch.serve.engine import AOT_FALLBACKS

        AOT_FALLBACKS.inc(reason="manifest_unreadable")
        journal.event(
            "aot_fallback", reason="manifest_unreadable", path=path,
            detail=f"{type(exc).__name__}: {exc}",
        )
        return None
    return AotBundle(path, manifest)


class AotBundle:
    """A loaded ``aot/`` tree: the manifest plus lazy package loads.
    ``for_backend`` narrows it to the view one engine consumes (the device
    engine its backend's package, the host scorer the CPU one)."""

    def __init__(self, path: str, manifest: dict) -> None:
        self.path = path
        self.manifest = manifest

    @property
    def family(self) -> str | None:
        return self.manifest.get("family")

    def for_backend(self, backend: str) -> "AotView":
        return AotView(self, str(backend))


class _Program:
    """A loaded package: ``program(inputs, X)`` → its outputs. Loaded by
    torch's C++ package loader alone: ``aoti_load_package`` would first
    import Inductor's compiler, seconds of every replica's start for
    nothing a restore needs. The flat argument order is the traced
    module's, ``(*inputs, X)``."""

    def __init__(self, path: str, device_index: int) -> None:
        import torch

        self._loader = torch._C._aoti.AOTIModelPackageLoader(path, "model", False, 1,
                                                               device_index)

    def __call__(self, inputs, X):
        return self._loader.boxed_run([*inputs, X])


class AotView:
    """One engine's restore interface (duck-typed by
    ``serve.engine.BucketedPredictEngine``): the fingerprint gate and
    per-bucket loads. Failures raise or return None — the ENGINE owns the
    journaled fallback. A backend's package is loaded once per device and
    shared by its buckets; a failed load is not kept."""

    def __init__(self, bundle: AotBundle, backend: str) -> None:
        self._bundle = bundle
        self.backend = backend
        self._blobs = {
            int(b["bucket"]): b
            for b in bundle.manifest.get("blobs", ())
            if b.get("backend") == backend
        }
        self._loaded: dict[tuple[str, int], Any] = {}
        self._lock = threading.Lock()

    def _fingerprint(self) -> dict | None:
        want = self._bundle.manifest.get("fingerprints", {}).get(self.backend)
        return want if isinstance(want, dict) else None

    def unusable_reason(self, family: str | None = None, *,
                        dtype=None) -> tuple[str, str] | None:
        """Why this view cannot restore anything (None = usable), as a
        ``(reason_code, detail)`` pair: the code is the bounded
        ``serve_aot_fallback_total{reason}`` label (missing_backend /
        family_mismatch / fingerprint_mismatch), the detail free text for
        the journal. ``dtype`` is the engine's parameter dtype (unchecked
        when None). Checked once per engine warmup."""
        if not self._blobs:
            return ("missing_backend", f"no aot blobs for backend {self.backend!r}")
        if family is not None and self._bundle.family != family:
            return ("family_mismatch",
                    f"aot blobs are for family {self._bundle.family!r}, "
                    f"engine serves {family!r}")
        want = self._fingerprint()
        if want is None:
            return ("fingerprint_mismatch",
                    f"no fingerprint recorded for backend {self.backend!r}")
        want = {k: v for k, v in want.items() if k != _STRUCTURE_KEY}
        have = platform_fingerprint(
            self.backend, dtype=want.get("dtype") if dtype is None else dtype,
            family=want.get("family") if family is None else family)
        diff = _fingerprint_diff(want, have)
        if diff:
            return ("fingerprint_mismatch", f"platform fingerprint mismatch: {diff}")
        return None

    def load_exec(self, bucket: int, structure: dict, device=None):
        """The loaded package that runs ``bucket`` (None when the manifest
        has no blob for it), on ``device`` (default: the current one of the
        backend). ``structure`` is the live engine's structure key
        (``GraphInputs.structure``): a package traced under another one
        raises. The ``persist.aot_restore`` faultpoint fires here: raise =
        a failing restore, corrupt = the package's bytes torn (loaded from
        a torn temporary copy, never kept)."""
        import torch

        entry = self._blobs.get(int(bucket))
        if entry is None:
            return None
        want = (self._fingerprint() or {}).get(_STRUCTURE_KEY)
        if want != structure:
            raise ValueError(
                "aot package structure differs from the live engine's: "
                + (_fingerprint_diff(want or {}, structure) or "unrecorded"))
        dev = torch.device(self.backend) if device is None else torch.device(device)
        index = -1 if dev.index is None else dev.index
        blob = os.path.join(self._bundle.path, entry["file"])
        if faults.fire("persist.aot_restore"):
            with open(blob, "rb") as f:
                payload = bytearray(f.read())
            if payload:
                payload[0] ^= 0xFF
            tmp = tempfile.mkdtemp(prefix="aot_torn_")
            try:
                torn = os.path.join(tmp, entry["file"])
                with open(torn, "wb") as f:
                    f.write(payload)
                return _Program(torn, index)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        key = (entry["file"], index)
        with self._lock:
            if key not in self._loaded:
                self._loaded[key] = _Program(blob, index)
            return self._loaded[key]


if __name__ == "__main__":
    import sys

    sys.exit(_child_main(sys.argv[1:]))

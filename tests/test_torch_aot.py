"""The port's AOT executable bundles (``persist/aot.py``, the engine's
restore path) against the JAX package's ``tests/test_aot.py``, case by case.

Parameters are those of ``tests/test_torch_serve_engine.py``: the committed
sklearn-layout fixture (``persist/testdata/stacking_small.pkl``) decoded by
the JAX package and bridged with ``convert.py``; its forest alone is the tree
family; the pipeline puts a 1-NN imputer over ``make_cohort(1427,
missing_rate=0.05)`` in front of it, with duplicated donors whose contract
columns tie and whose other columns differ, so the imputer's first-minimum
rule decides what is imputed. A restored bundle is held to the eager route
and to JAX's eager ``oracle_proba1`` at (1e-12, 1e-15), never to JAX's
restored executables.

Each AOTInductor compile costs 15-100 s on the CPU, so the file compiles
three bundles, shared by module-scoped fixtures: the stacking family through
``save_model(aot=True)`` (the checkpoint most tests copy), the forest and
the pipeline through ``export_aot``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import knn_impute as jknn
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.persist import aot as jaot
from machine_learning_replications_tpu.persist import sklearn_import as jimport
from machine_learning_replications_tpu.serve import engine as jengine
from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT, patient_row
from machine_learning_replications_tpu_torch.models import linear
from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.persist import aot, checkpoint
from machine_learning_replications_tpu_torch.resilience import faults
from machine_learning_replications_tpu_torch.serve import engine
from machine_learning_replications_tpu_torch.serve.engine import BucketedPredictEngine

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "machine_learning_replications_tpu_torch" / "persist" / "testdata" / \
    "stacking_small.pkl"
BUCKETS = (1, 8)
F64 = (1e-12, 1e-15)
FAMILIES = ("stacking", "tree", "pipeline")
#: The fingerprint's keys differ from JAX's by design: torch and CUDA
#: versions in place of jax/jaxlib, the CPU's vector ISA, the parameters'
#: dtype in place of the x64 flag, the family, and the structure key.
FINGERPRINT_KEYS = {"torch", "cuda", "backend", "device_kind", "cpu_capability", "dtype",
                    "family", "structure"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, and Inductor compiling in this process instead
    of a pool of one worker process per core: the compiles here share the
    host with the other test files."""
    from torch._inductor import config as inductor_config

    n, workers = torch.get_num_threads(), inductor_config.compile_threads
    torch.set_num_threads(1)
    inductor_config.compile_threads = 1
    yield
    torch.set_num_threads(n)
    inductor_config.compile_threads = workers


def _cohort_with_tied_donors():
    """``make_cohort(1427, missing_rate=0.05)`` with 40 extra donors: each a
    copy of a row's 17 (finite) contract columns with every other column
    shifted by 1, placed BEFORE its original, so a contract query at that
    row meets two donors at distance 0 that impute different values."""
    X64, _, _ = make_cohort(n=1427, seed=2020, missing_rate=0.05)
    sel = selected_indices()
    complete = np.flatnonzero(~np.isnan(X64[:, sel]).any(axis=1))[:40]
    twins = X64[complete].copy()
    other = np.setdiff1d(np.arange(64), sel)
    twins[:, other] += 1.0
    return np.concatenate([twins, X64]), complete + len(twins)


@pytest.fixture(scope="module")
def jax_families():
    ens = jimport.import_stacking(jimport.decode_pickle(str(FIXTURE)))
    X64, _ = _cohort_with_tied_donors()
    mask = np.zeros(64, bool)
    mask[selected_indices()] = True
    pipe = jpipeline.PipelineParams(imputer=jknn.fit(jnp.asarray(X64)),
                                    support_mask=jnp.asarray(mask), ensemble=ens)
    return {"stacking": ens, "tree": ens.gbdt, "pipeline": pipe}


def _bridge(jp):
    if isinstance(jp, jpipeline.PipelineParams):
        return convert.pipeline_params_from_arrays(jp, device="cpu", dtype=torch.float64)
    if hasattr(jp, "meta"):
        return convert.stacking_params_from_arrays(jp, device="cpu", dtype=torch.float64)
    return convert.tree_params_from_arrays(jp, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def families(jax_families):
    return {k: _bridge(v) for k, v in jax_families.items()}


@pytest.fixture(scope="module")
def params(families):
    return families["stacking"]


@pytest.fixture(scope="module")
def other_params(params):
    """The same model with other meta weights: the same shapes (its
    packages load and run against ``params``), other numbers."""
    import dataclasses

    return dataclasses.replace(params, meta=linear.LinearParams(
        coef=params.meta.coef * 1.5 + 0.25, intercept=params.meta.intercept - 0.5))


@pytest.fixture(scope="module")
def ckpt(params, tmp_path_factory):
    """One checkpoint published WITH its bundle (the stacking compile):
    ``(restored params, bundle, path)``."""
    path = str(tmp_path_factory.mktemp("aot") / "model")
    checkpoint.save_model(path, params, aot=True)
    return checkpoint.load_model(path, device="cpu"), aot.load_bundle(path), path


@pytest.fixture(scope="module")
def bundles(families, ckpt, tmp_path_factory):
    """Each family's bundle directory: the stacking checkpoint's, and one
    ``export_aot`` each for the forest and the pipeline."""
    out = {"stacking": ckpt[2]}
    for fam in ("tree", "pipeline"):
        path = str(tmp_path_factory.mktemp(f"aot_{fam}"))
        aot.export_aot(path, families[fam])
        out[fam] = path
    return out


@pytest.fixture()
def captured_journal(tmp_path):
    path = tmp_path / "journal.jsonl"
    jrn = journal.RunJournal(path, command="test")
    journal.set_journal(jrn)
    try:
        yield path
    finally:
        journal.set_journal(None)
        jrn.close()


def _events(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _fallbacks(path) -> list[dict]:
    return [e for e in _events(path) if e["kind"] == "aot_fallback"]


def _query_rows(n: int = 70) -> np.ndarray:
    base = np.asarray([[63, 1, 1, 1, 0, 0, 0, 1, 0, 1, 0, 145, 1, 20, 1.2, 38, 140]],
                      np.float64)
    return np.repeat(base, n, axis=0) * (1.0 + 0.001 * np.arange(n)[:, None])


def _engine(p, buckets=BUCKETS, **kw):
    return BucketedPredictEngine(p, buckets=buckets, device="cpu", **kw)


def _copy_ckpt(ckpt, tmp_path) -> str:
    dst = str(tmp_path / "model")
    shutil.copytree(ckpt[2], dst)
    return dst


def _tear(path: str) -> None:
    with open(path, "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))


def _remanifest(path: str) -> None:
    """Rewrite the checkpoint's integrity manifest over its files as they
    are now (a blob torn before publish, a bundle installed afterwards)."""
    man_path = os.path.join(path, checkpoint.INTEGRITY_FILE)
    with open(man_path) as f:
        man = json.load(f)
    man["files"] = {rel: {"sha256": checkpoint._sha256(os.path.join(path, rel)),
                          "bytes": os.path.getsize(os.path.join(path, rel))}
                    for rel in checkpoint._payload_files(path)}
    with open(man_path, "w") as f:
        json.dump(man, f)


def _counts() -> dict:
    return engine.AOT_FALLBACKS.snapshot()


def _counted(before: dict, reason: str) -> float:
    key = f"reason={reason}"
    return _counts()[key] - before.get(key, 0)


# -- export / publish --------------------------------------------------------


def test_publish_with_aot_integrity_roundtrip(ckpt, tmp_path):
    """The packages are ordinary checkpoint payload: covered by
    integrity.json and deep-verified; the manifest indexes the files on disk
    and has JAX's keys (the fingerprint's aside, ``FINGERPRINT_KEYS``)."""
    _params, bundle, path = ckpt
    checkpoint.verify_checkpoint(path, deep=True)
    with open(os.path.join(path, checkpoint.INTEGRITY_FILE)) as f:
        integrity = json.load(f)
    aot_files = sorted(k for k in integrity["files"] if k.startswith("aot/"))
    assert aot_files == ["aot/cpu.pt2", "aot/manifest.json"]
    blobs = bundle.manifest["blobs"]
    assert {f"aot/{b['file']}" for b in blobs} == {"aot/cpu.pt2"}
    # The default export covers the device ladder ∪ the host ladder on the CPU.
    assert [b["bucket"] for b in blobs] == list(engine.DEFAULT_BUCKETS)
    assert all(b["backend"] == "cpu" and b["width"] == 17 for b in blobs)
    assert {b["bytes"] for b in blobs} == {os.path.getsize(os.path.join(path, "aot/cpu.pt2"))}
    assert bundle.family == "stacking"
    # JAX's manifest, from one cheap bucket of its own export.
    jdir = tmp_path / "jax"
    jman = jaot.export_aot(str(jdir), jimport.import_stacking(jimport.decode_pickle(str(FIXTURE))),
                           device_buckets=(1,), host_buckets=())
    assert set(bundle.manifest) == set(jman)
    assert set(blobs[0]) == set(jman["blobs"][0])
    assert set(bundle.manifest["fingerprints"]["cpu"]) == FINGERPRINT_KEYS
    assert set(jman["fingerprints"]["cpu"]) == {"jax", "jaxlib", "backend", "device_kind",
                                                "x64"}
    fp = bundle.manifest["fingerprints"]["cpu"]
    assert fp["dtype"] == "torch.float64" and fp["family"] == "stacking"
    assert fp["cpu_capability"] == torch.backends.cpu.get_cpu_capability()


def test_corrupting_a_blob_fails_deep_verification(ckpt, tmp_path):
    """Blob rot after publish is caught where all checkpoint rot is: the
    integrity check, before anything loads it."""
    path = _copy_ckpt(ckpt, tmp_path)
    _tear(os.path.join(path, "aot", "cpu.pt2"))
    with pytest.raises(checkpoint.CheckpointIntegrityError):
        checkpoint.verify_checkpoint(path, deep=True)


# -- restore: the happy path -------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_aot_restore_equals_eager_and_jax_oracle_and_compiles_nothing(
        families, jax_families, bundles, family, captured_journal):
    """A restored engine captures nothing at warmup and serves what the
    eager route and JAX's eager oracle serve, per bucket, across split
    plans; the pipeline's rows sit on tied donors."""
    p = families[family]
    bundle = aot.load_bundle(bundles[family])
    traced = _engine(p)
    traced.warmup()
    restored = _engine(p, aot=bundle.for_backend("cpu"))
    restored.warmup()
    assert restored.compile_count() == 0, restored.trace_counts
    assert traced.compile_count() == len(BUCKETS)
    assert sorted(restored._aot_execs) == sorted(BUCKETS)
    rows = _query_rows(70)
    if family == "pipeline":
        X64, twins = _cohort_with_tied_donors()
        rows = np.concatenate([rows[:30], X64[twins][:, selected_indices()]])
    for n in (1, 3, 8, len(rows)):
        got, eager = restored.predict(rows[:n]), traced.predict(rows[:n])
        want = jengine.oracle_proba1(jax_families[family], rows[:n])
        np.testing.assert_allclose(got, eager, rtol=F64[0], atol=F64[1])
        np.testing.assert_allclose(got, want, rtol=F64[0], atol=F64[1])
    assert restored.compile_count() == 0
    kinds = [e["kind"] for e in _events(captured_journal)]
    assert kinds.count("aot_restore") == len(BUCKETS)
    assert "aot_fallback" not in kinds


def test_host_scorer_restores_from_cpu_view(ckpt):
    from machine_learning_replications_tpu_torch.serve.hostpath import HostScorer

    p, bundle, _path = ckpt
    scorer = HostScorer(p, buckets=(1, 8), aot=bundle.for_backend("cpu"))
    scorer.warmup()
    assert scorer.compile_count() == 0 and sorted(scorer._aot_execs) == [1, 8]
    traced = HostScorer(p, buckets=(1, 8))
    traced.warmup()
    row = _query_rows(1)
    np.testing.assert_allclose(scorer.predict(row), traced.predict(row), rtol=F64[0],
                               atol=F64[1])


def test_missing_bucket_falls_back_to_trace_for_that_bucket_only(ckpt, captured_journal):
    """A ladder bucket the bundle never exported (13) is captured; the
    covered buckets still restore."""
    p, bundle, _path = ckpt
    before = _counts()
    eng = _engine(p, buckets=(1, 8, 13), aot=bundle.for_backend("cpu"))
    eng.warmup()
    assert sorted(eng._aot_execs) == [1, 8]
    assert eng.compile_count() == 1
    fb = _fallbacks(captured_journal)
    assert [(e["bucket"], e["reason"], e["role"]) for e in fb] == [(13, "missing_bucket",
                                                                    "device")]
    assert _counted(before, "missing_bucket") == 1


# -- restore: the fails-open ladder ------------------------------------------


def test_fingerprint_mismatch_falls_back_to_tracing(ckpt, tmp_path, captured_journal):
    p = ckpt[0]
    path = _copy_ckpt(ckpt, tmp_path)
    man_path = os.path.join(path, "aot", "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["fingerprints"]["cpu"]["torch"] = "0.0.0-not-this-torch"
    with open(man_path, "w") as f:
        json.dump(man, f)
    before = _counts()
    eng = _engine(p, aot=aot.load_bundle(path).for_backend("cpu"))
    eng.warmup()
    assert not eng._aot_execs
    assert eng.compile_count() == len(BUCKETS)
    fb = _fallbacks(captured_journal)
    assert len(fb) == 1 and fb[0]["reason"] == "fingerprint_mismatch"
    assert "torch" in fb[0]["detail"]
    assert _counted(before, "fingerprint_mismatch") == 1
    assert eng.predict(_query_rows(3)).shape == (3,)


def test_wrong_family_bundle_rejected(ckpt):
    _p, bundle, _path = ckpt
    view = bundle.for_backend("cpu")
    bad = view.unusable_reason("pipeline")
    assert bad is not None and bad[0] == "family_mismatch"
    assert view.unusable_reason("stacking") is None
    assert view.unusable_reason(None) is None
    assert view.unusable_reason("stacking", dtype=torch.float64) is None
    bad = view.unusable_reason("stacking", dtype=torch.float32)
    assert bad is not None and bad[0] == "fingerprint_mismatch" and "dtype" in bad[1]
    # A backend the bundle never exported reads as missing_backend, not skew.
    bad = bundle.for_backend("cuda").unusable_reason("stacking")
    assert bad is not None and bad[0] == "missing_backend"


def test_family_mismatch_is_journaled_and_counted(ckpt, families, captured_journal):
    before = _counts()
    eng = _engine(families["tree"], aot=ckpt[1].for_backend("cpu"))
    eng.warmup()
    assert not eng._aot_execs and eng.compile_count() == len(BUCKETS)
    assert [e["reason"] for e in _fallbacks(captured_journal)] == ["family_mismatch"]
    assert _counted(before, "family_mismatch") == 1


def test_corrupt_blob_deserialize_falls_back(ckpt, tmp_path, captured_journal):
    """A package torn AT PUBLISH (then re-manifested, so the checkpoint
    verifies): its load fails, each bucket journals a fallback and is
    captured, and the answers stay right."""
    p = ckpt[0]
    path = _copy_ckpt(ckpt, tmp_path)
    _tear(os.path.join(path, "aot", "cpu.pt2"))
    _remanifest(path)
    checkpoint.verify_checkpoint(path, deep=True)
    before = _counts()
    eng = _engine(p, aot=aot.load_bundle(path).for_backend("cpu"))
    eng.warmup()
    assert not eng._aot_execs
    assert eng.compile_count() == len(BUCKETS)
    fb = _fallbacks(captured_journal)
    assert len(fb) == len(BUCKETS) and {e["reason"] for e in fb} == {"deserialize_error"}
    assert _counted(before, "deserialize_error") == len(BUCKETS)
    traced = _engine(p)
    traced.warmup()
    rows = _query_rows(5)
    assert (eng.predict(rows) == traced.predict(rows)).all()


def test_foreign_same_shape_bundle_serves_live_params_bits(ckpt, other_params, tmp_path,
                                                          captured_journal):
    """Parameters enter the program as inputs, so a package is
    weight-agnostic: a bundle published from same-shape parameters with
    other weights restores cleanly and computes with the LIVE engine's."""
    path = str(tmp_path / "other")
    checkpoint.save_model(path, other_params)
    shutil.copytree(os.path.join(ckpt[2], "aot"), os.path.join(path, "aot"))
    eng = _engine(other_params, aot=aot.load_bundle(path).for_backend("cpu"))
    eng.warmup()
    assert sorted(eng._aot_execs) == sorted(BUCKETS) and eng.compile_count() == 0
    traced = _engine(other_params)
    traced.warmup()
    rows = _query_rows(5)
    np.testing.assert_allclose(eng.predict(rows), traced.predict(rows), rtol=F64[0],
                               atol=F64[1])
    assert np.abs(eng.predict(rows) - _engine(ckpt[0]).predict(rows)).max() > 1e-3
    assert not _fallbacks(captured_journal)


def test_structure_key_mismatch_on_the_pipeline_imputer_block(families, bundles,
                                                              captured_journal):
    """A same-shape pipeline whose donors miss another column (so the
    imputer block masks another donor column): the package, traced under
    the other block, refuses to load for every bucket; each is captured
    and answers the eager oracle."""
    import dataclasses

    p = families["pipeline"]
    donors = p.imputer.donors.clone()
    block = engine.BucketedPredictEngine(p, buckets=(1,), device="cpu")._block
    col = next(c for c in block.nan_cols if c not in block.masked_donor_cols)
    donors[5, col] = float("nan")
    q = dataclasses.replace(p, imputer=dataclasses.replace(p.imputer, donors=donors))
    before = _counts()
    eng = _engine(q, aot=aot.load_bundle(bundles["pipeline"]).for_backend("cpu"))
    eng.warmup()
    assert not eng._aot_execs and eng.compile_count() == len(BUCKETS)
    fb = _fallbacks(captured_journal)
    assert [e["reason"] for e in fb] == ["deserialize_error"] * len(BUCKETS)
    assert all("masked_donor_cols" in e["detail"] for e in fb)
    assert _counted(before, "deserialize_error") == len(BUCKETS)
    rows = _query_rows(9)
    np.testing.assert_allclose(eng.predict(rows), engine.oracle_proba1(q, rows), rtol=F64[0],
                               atol=F64[1])


class _FakeView:
    """A view whose runner gives wrong numbers or raises."""

    backend = "cpu"

    def __init__(self, mode: str) -> None:
        self.mode = mode

    def unusable_reason(self, family=None, *, dtype=None):
        return None

    def load_exec(self, bucket, structure, device=None):
        def fn(inputs, X):
            if self.mode == "raise":
                raise RuntimeError("the program faulted")
            n = int(X.shape[0])
            return torch.full((n,), 0.123, dtype=torch.float64), torch.zeros((n, 3))
        return fn


@pytest.mark.parametrize("mode,reason", [("wrong", "parity_mismatch"), ("raise", "exec_error")])
def test_parity_and_exec_failures_discard_the_restored_program(params, mode, reason,
                                                               captured_journal):
    """The warmup probe: a restored program that disagrees with the eager
    oracle, or fails to run, is dropped per bucket; the bucket is captured
    and the engine serves the oracle's numbers."""
    before = _counts()
    eng = _engine(params, aot=_FakeView(mode))
    eng.warmup()
    assert not eng._aot_execs and eng.warm
    assert eng.compile_count() == len(BUCKETS)
    fb = _fallbacks(captured_journal)
    assert {e["reason"] for e in fb} == {reason}
    assert sorted(e["bucket"] for e in fb) == sorted(BUCKETS)
    assert _counted(before, reason) == len(BUCKETS)
    traced = _engine(params)
    traced.warmup()
    rows = _query_rows(5)
    assert (eng.predict(rows) == traced.predict(rows)).all()


def test_aot_restore_faultpoint_raise_and_corrupt(ckpt, captured_journal):
    """``persist.aot_restore``: raise = a failing restore, corrupt = the
    package's bytes torn in flight; both are journaled fallbacks, never an
    unready engine. A failed load is not kept for the next bucket."""
    p, bundle, _path = ckpt
    try:
        faults.arm("persist.aot_restore:raise@n=1")
        eng = _engine(p, aot=bundle.for_backend("cpu"))
        eng.warmup()
        assert sorted(eng._aot_execs) == [8]
        assert eng.compile_count() == 1
        faults.arm("persist.aot_restore:corrupt")
        eng2 = _engine(p, aot=bundle.for_backend("cpu"))
        eng2.warmup()
        assert not eng2._aot_execs and eng2.warm
    finally:
        faults.reset()
    events = _events(captured_journal)
    kinds = [e["kind"] for e in events]
    assert "fault_injected" in kinds
    assert [e["reason"] for e in events if e["kind"] == "aot_fallback"] == \
        ["deserialize_error"] * 3


# -- serving stack wiring ----------------------------------------------------


def test_make_server_serves_identical_bits_with_and_without_aot(ckpt):
    """make_server(aot_bundle=...) answers /predict as a --no-aot stack
    does, and its warmup, restore and fallback families render a strictly
    valid exposition."""
    from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
    from machine_learning_replications_tpu_torch.serve import make_server

    p, bundle, _path = ckpt

    def one_probability(**kw):
        handle = make_server(p, port=0, buckets=BUCKETS, max_wait_ms=1.0, host_path=True,
                             host_buckets=BUCKETS, device="cpu", **kw).start_background()
        try:
            assert handle.use_aot == kw.get("use_aot", True)
            restored = sorted(handle.engine._engine._aot_execs)
            host, port = handle.address
            req = urllib.request.Request(
                f"http://{host}:{port}/predict", data=json.dumps(dict(EXAMPLE_PATIENT)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())["probability"], restored, handle.host.scorer
        finally:
            handle.shutdown()

    p_aot, restored, scorer = one_probability(aot_bundle=bundle)
    assert sorted(scorer._aot_execs) == list(BUCKETS)
    p_traced, captured, scorer = one_probability(aot_bundle=bundle, use_aot=False)
    assert not scorer._aot_execs and not captured
    assert p_aot == p_traced and restored == list(BUCKETS)

    sys.path.insert(0, str(REPO / "tools"))
    try:
        from validate_metrics import validate
    finally:
        sys.path.pop(0)
    page = REGISTRY.render_prometheus()
    for family in ("serve_warmup_seconds", "serve_aot_restore_seconds",
                   "serve_aot_fallback_total"):
        assert family in page
    assert not validate(page)


def test_missing_bundle_is_silently_absent(params, tmp_path):
    path = str(tmp_path / "model")
    checkpoint.save_model(path, params)
    assert aot.load_bundle(path) is None
    assert not os.path.exists(os.path.join(path, "aot"))


def test_unreadable_manifest_fails_open(ckpt, tmp_path, captured_journal):
    path = _copy_ckpt(ckpt, tmp_path)
    with open(os.path.join(path, "aot", "manifest.json"), "w") as f:
        f.write("{not json")
    before = _counts()
    assert aot.load_bundle(path) is None
    fb = _fallbacks(captured_journal)
    assert len(fb) == 1 and fb[0]["reason"] == "manifest_unreadable"
    assert _counted(before, "manifest_unreadable") == 1


def test_fleet_replica_spec_no_aot_passthrough():
    from machine_learning_replications_tpu_torch.fleet.lifecycle import ReplicaSpec

    spec = ReplicaSpec(model="/m", register_url="http://r", no_aot=True)
    assert "--no-aot" in spec.command("r1", 9000)
    spec = ReplicaSpec(model="/m", register_url="http://r")
    assert "--no-aot" not in spec.command("r1", 9000)


_CHILD = """
import json, sys
from machine_learning_replications_tpu_torch.persist import aot, checkpoint
from machine_learning_replications_tpu_torch.serve import engine
p = checkpoint.load_model(sys.argv[1], device="cpu")
eng = engine.BucketedPredictEngine(p, buckets=(1, 8), device="cpu",
                                   aot=aot.load_bundle(sys.argv[1]).for_backend("cpu"))
eng.warmup()
rows = json.loads(sys.argv[2])
print(json.dumps({"restored": sorted(eng._aot_execs), "captures": eng.compile_count(),
                  "p1": eng.predict(rows).tolist()}))
"""


def test_bundle_loads_in_a_fresh_interpreter(ckpt):
    """The point of AOT: a process that never compiled restores every
    bucket and answers as this one does."""
    p, _bundle, path = ckpt
    rows = _query_rows(9)
    proc = subprocess.run([sys.executable, "-c", _CHILD, path, json.dumps(rows.tolist())],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["restored"] == [1, 8] and got["captures"] == 0
    np.testing.assert_allclose(got["p1"], engine.oracle_proba1(p, rows), rtol=F64[0],
                               atol=F64[1])


def _install_bundle(src_ckpt: str, dst: str) -> None:
    shutil.copytree(os.path.join(src_ckpt, "aot"), os.path.join(dst, "aot"))
    _remanifest(dst)


def test_cold_start_rollback_serves_lastgood_version_and_bundle(ckpt, params, other_params,
                                                                tmp_path):
    """A replica cold-started on a corrupt primary rolls back to the
    last-known-good and takes its VERSION and its BUNDLE from the directory
    that restored: v1's numbers labelled v1, restored from v1's package
    (the corrupt v2 ships none)."""
    path = str(tmp_path / "model")
    checkpoint.save_model(path, params)                 # v1
    _install_bundle(ckpt[2], path)
    checkpoint.save_model(path, other_params)           # v2; v1 -> lastgood
    _tear(os.path.join(path, checkpoint.TENSORS_FILE))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    jpath = str(tmp_path / "serve.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "machine_learning_replications_tpu_torch", "serve", "--device",
         "cpu", "--model", path, "--port", str(port), "--buckets", "1,8", "--journal", jpath],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        base = f"http://127.0.0.1:{port}"
        t0 = time.monotonic()
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=2) as r:
                    health = json.loads(r.read())
                if health["warm"]:
                    break
            except Exception:
                pass
            assert proc.poll() is None, "serve exited"
            assert time.monotonic() - t0 < 240, "never warmed"
            time.sleep(0.2)
        assert health["model_version"] == 1, health
        req = urllib.request.Request(base + "/predict",
                                     data=json.dumps(dict(EXAMPLE_PATIENT)).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            prob = json.loads(r.read())["probability"]
        v1 = float(engine.oracle_proba1(params, patient_row())[0])
        v2 = float(engine.oracle_proba1(other_params, patient_row())[0])
        assert abs(prob - v1) <= 1e-12 and abs(prob - v2) > 1e-3, (prob, v1, v2)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
    events = _events(jpath)
    kinds = {e["kind"] for e in events}
    assert "checkpoint_rollback" in kinds
    assert "aot_restore" in kinds and "aot_fallback" not in kinds
    assert {(e["role"], e["bucket"]) for e in events if e["kind"] == "aot_restore"} == \
        {("device", 1), ("device", 8), ("host", 1), ("host", 8)}

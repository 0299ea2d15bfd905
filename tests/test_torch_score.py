"""The port's bulk scoring (``score/`` and ``cli score``) vs the JAX package's.

The cases of ``tests/test_score.py``, at its sizes (500-row cohorts,
``chunk_rows=64``), on the port with ``device="cpu"``. Within the port the
output is held bit for bit where JAX holds it: the overlapped run equals the
sequential one, process parse equals thread parse, a killed run resumes to
the same bytes, and ``p1`` equals the eager ``cli predict`` route on the
same rows. Across frameworks the same JSONL (or ``.mat``) goes through
JAX's ``ScorePipeline`` and the port's: row ids, line numbers, quarantine
entries and ``progress.json``'s counts are equal, and ``p1`` agrees at
``serve.engine.parity_tolerance()`` on the contract, pipeline and ``.mat``
routes. The parameters are JAX's (a sklearn-fitted ensemble imported by
the JAX package, a JAX ``knn_impute.fit`` imputer, a JAX reference
profile), carried over by ``convert.py``.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data import matloader as jmatloader
from machine_learning_replications_tpu.data import sharding as jsharding
from machine_learning_replications_tpu.data.schema import SELECTED_17, selected_indices, variable_names
from machine_learning_replications_tpu.models import knn_impute as jknn
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.models import stacking as jstacking
from machine_learning_replications_tpu.obs import quality as jquality
from machine_learning_replications_tpu.score import ScorePipeline as JScorePipeline
from machine_learning_replications_tpu.score import open_cohort as jopen_cohort
from machine_learning_replications_tpu_torch import cli, convert
from machine_learning_replications_tpu_torch.data import matloader, sharding
from machine_learning_replications_tpu_torch.models import pipeline, stacking
from machine_learning_replications_tpu_torch.obs import journal
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.persist import checkpoint
from machine_learning_replications_tpu_torch.score import (
    JsonlCohortSource,
    ScoreBudgetExceeded,
    ScorePipeline,
    ScoreResumeError,
    open_cohort,
)
from machine_learning_replications_tpu_torch.score.pipeline import ChunkScorer, ScoreInterrupted
from machine_learning_replications_tpu_torch.serve.engine import parity_tolerance

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
try:
    import validate_metrics
finally:
    sys.path.pop(0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fixtures: JAX parameters, bridged
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_stacking():
    """The JAX suite's contract-route ensemble: sklearn-fitted, imported by
    the JAX package."""
    from sklearn.ensemble import GradientBoostingClassifier, StackingClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC

    from machine_learning_replications_tpu.persist import import_stacking

    rng = np.random.default_rng(7)
    n, f = 200, 17
    X = rng.normal(size=(n, f))
    X[:, :10] = (X[:, :10] > 0.3).astype(float)
    y = (X @ rng.normal(size=f) + rng.normal(size=n) > 0.2).astype(float)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf = StackingClassifier(
            estimators=[
                ("svc", make_pipeline(StandardScaler(), SVC(probability=True, random_state=0))),
                ("gbc", GradientBoostingClassifier(n_estimators=5, max_depth=1, random_state=0)),
                ("lg", LogisticRegression()),
            ],
            final_estimator=LogisticRegression(),
        ).fit(X, y)
    return import_stacking(clf)


@pytest.fixture(scope="module")
def jax_pipeline(jax_stacking):
    """A full JAX PipelineParams from real fitted pieces (the JAX suite's)."""
    X64, y, _ = make_cohort(n=300, seed=3, missing_rate=0.05)
    imp, X_imp = jknn.fit_transform(jnp.asarray(X64))
    mask = np.zeros(64, bool)
    mask[selected_indices()] = True
    X17 = np.asarray(X_imp)[:, np.where(mask)[0]]
    scores = np.asarray(jstacking.predict_proba1(jax_stacking, jnp.asarray(X17)))
    prof = jquality.build_reference_profile(X17, scores, y=y)
    return jpipeline.PipelineParams(imputer=imp, support_mask=jnp.asarray(mask),
                                    ensemble=jax_stacking,
                                    quality={k: jnp.asarray(v) for k, v in prof.items()})


@pytest.fixture(scope="module")
def stacking_params(jax_stacking):
    return convert.stacking_params_from_arrays(jax_stacking, device="cpu")


@pytest.fixture(scope="module")
def pipeline_params(jax_pipeline):
    return convert.pipeline_params_from_arrays(jax_pipeline, device="cpu")


@pytest.fixture(scope="module")
def cohort_rows():
    """500 contract-order rows drawn from the schema-matched generator."""
    X64, _, _ = make_cohort(n=500, seed=11, missing_rate=0.0)
    return X64[:, selected_indices()]


def _write_jsonl(path, rows, bad_at=()):
    """Patient-dict JSONL; ``bad_at`` inserts malformed lines BEFORE the
    given 0-based row positions (the JAX suite's cycle of bad lines)."""
    bad_cycle = [
        "{definitely not json",
        json.dumps({"Gender": 1}),
        json.dumps(dict(zip(SELECTED_17, [None] * 17))),
        "",
    ]
    lines = 0
    with open(path, "w") as f:
        for i, row in enumerate(rows):
            if i in bad_at:
                f.write(bad_cycle[lines % len(bad_cycle)] + "\n")
                lines += 1
            f.write(json.dumps({k: float(v) for k, v in zip(SELECTED_17, row)}) + "\n")
            lines += 1
    return lines


def _write_mat(path, X, y=None):
    import scipy.io

    data = X if y is None else np.concatenate([X, y.reshape(-1, 1)], axis=1)
    names = (np.array([variable_names()], dtype=object) if X.shape[1] == 64
             else np.empty((1, 0), object))
    scipy.io.savemat(str(path), {"data_tb": data, "clin_var_names": names})


def _run(params, cohort_path, out_dir, chunk_rows=64, **kw):
    kw.setdefault("model_digest", "test-model")
    kw.setdefault("rows_per_shard", 150)
    kw.setdefault("device", "cpu")
    src = open_cohort(str(cohort_path), chunk_rows)
    return ScorePipeline(params, src, str(out_dir), **kw).run()


def _jrun(params, cohort_path, out_dir, chunk_rows=64, **kw):
    kw.setdefault("model_digest", "test-model")
    kw.setdefault("rows_per_shard", 150)
    src = jopen_cohort(str(cohort_path), chunk_rows)
    return JScorePipeline(params, src, str(out_dir), **kw).run()


def _read_scores(out_dir):
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("scores-") and name.endswith(".jsonl"):
            with open(os.path.join(out_dir, name)) as f:
                recs += [json.loads(line) for line in f]
    return recs


def _tree_bytes(out_dir):
    """Every output shard and the quarantine sidecar, concatenated — the
    byte-identical comparison domain."""
    out = b""
    names = sorted(n for n in os.listdir(out_dir)
                   if n.startswith("scores-") or n == "quarantine.jsonl")
    for name in names:
        with open(os.path.join(out_dir, name), "rb") as f:
            out += name.encode() + b"\0" + f.read() + b"\0"
    return out


def _p1(out_dir):
    return np.asarray([r["p1"] for r in _read_scores(out_dir)])


# ---------------------------------------------------------------------------
# the copies' helpers: padding and the .mat feature loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["zero", "edge"])
def test_pad_rows_to_equals_jax(mode):
    x = np.arange(15.0).reshape(5, 3)
    for rows in (5, 8):
        got, n = sharding.pad_rows_to(x, rows, mode=mode)
        want, jn = jsharding.pad_rows_to(x, rows, mode=mode)
        np.testing.assert_array_equal(got, want)
        assert n == jn == 5
    with pytest.raises(ValueError, match="cannot pad"):
        sharding.pad_rows_to(x, 3)


@pytest.mark.parametrize("width", [64, 65, 17, 18])
def test_load_feature_matrix_equals_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    X = rng.normal(size=(12, width))
    X[3, 2] = np.nan
    path = tmp_path / "c.mat"
    import scipy.io

    scipy.io.savemat(str(path), {"data_tb": X, "clin_var_names": np.empty((1, 0), object)})
    got = matloader.load_feature_matrix(str(path))
    want = jmatloader.load_feature_matrix(str(path), backend="scipy")
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == {64: 64, 65: 64, 17: 17, 18: 17}[width]


def test_load_feature_matrix_refuses(tmp_path):
    import scipy.io

    path = tmp_path / "c.mat"
    scipy.io.savemat(str(path), {"data_tb": np.zeros((3, 20)), "clin_var_names": np.empty((1, 0), object)})
    with pytest.raises(ValueError, match="20 columns wide"):
        matloader.load_feature_matrix(str(path))
    with pytest.raises(NotImplementedError, match="native/matio"):
        matloader.load_feature_matrix(str(path), backend="native")


def test_reader_imports_no_torch():
    """Spawned parse workers import ``score.reader`` only: it must not pull
    in torch (so it cannot initialise CUDA in a worker)."""
    probe = ("import sys, machine_learning_replications_tpu_torch.score.reader, "
             "machine_learning_replications_tpu_torch.score; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')[:3])")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# reader + quarantine policy
# ---------------------------------------------------------------------------


def test_jsonl_reader_chunks_lines_and_quarantine(tmp_path, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:100], bad_at=(5, 50))
    src = JsonlCohortSource(str(path), chunk_rows=32)
    chunks = [src.parse(b) for b in src.blocks()]
    assert [c.lines_consumed for c in chunks] == [32, 32, 32, 6]
    assert sum(c.n_rows for c in chunks) == 100
    bad_lines = [line for c in chunks for (line, _err, _raw) in c.bad]
    assert bad_lines == [6, 52]
    all_lines = np.concatenate([c.line_nos for c in chunks])
    assert len(all_lines) == 100 and 6 not in all_lines and 52 not in all_lines
    np.testing.assert_array_equal(chunks[0].X[0], cohort_rows[0])


def test_reader_skip_lines_resume_alignment(tmp_path, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:100])
    src = JsonlCohortSource(str(path), chunk_rows=32)
    full = [src.parse(b) for b in src.blocks()]
    resumed = [src.parse(b) for b in src.blocks(skip_lines=64, start_seq=2)]
    assert [c.seq for c in resumed] == [2, 3]
    np.testing.assert_array_equal(resumed[0].X, full[2].X)
    np.testing.assert_array_equal(resumed[0].line_nos, full[2].line_nos)


def test_budget_abort(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "bad.jsonl"
    _write_jsonl(path, cohort_rows[:60], bad_at=(1, 2, 3, 4, 5))
    with pytest.raises(ScoreBudgetExceeded):
        _run(stacking_params, path, tmp_path / "out", chunk_rows=16, max_bad_rows=3,
             overlap=False)
    prog_path = tmp_path / "out" / "progress.json"
    prog = json.load(open(prog_path)) if prog_path.exists() else {"done": False}
    assert not prog.get("done")


def test_budget_abort_flushes_triggering_rows(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "bad.jsonl"
    _write_jsonl(path, cohort_rows[:40], bad_at=(2, 3))
    out = tmp_path / "out"
    with pytest.raises(ScoreBudgetExceeded):
        _run(stacking_params, path, out, chunk_rows=64, max_bad_rows=1, overlap=False)
    entries = [json.loads(line) for line in open(out / "quarantine.jsonl")]
    assert len(entries) == 2 and all(e["error"] for e in entries)


def test_bare_ensemble_mat_nan_rows_quarantined(tmp_path, stacking_params):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(50, 17))
    X[7, 3] = np.nan
    X[31, 0] = np.nan
    path = tmp_path / "cohort17.mat"
    _write_mat(path, X)
    out = tmp_path / "out"
    summary = _run(stacking_params, path, out, chunk_rows=16)
    assert summary["rows"] == 48 and summary["bad_rows"] == 2
    recs = _read_scores(out)
    assert len(recs) == 48 and all(np.isfinite(r["p1"]) for r in recs)
    quar = [json.loads(line) for line in open(out / "quarantine.jsonl")]
    assert {q["line"] for q in quar} == {8, 32}
    assert all("non-finite" in q["error"] for q in quar)


def test_fresh_start_clears_stale_summary(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:200])
    out = tmp_path / "out"
    _run(stacking_params, path, out, chunk_rows=64)
    assert (out / "summary.json").exists()
    with pytest.raises(ScoreInterrupted):
        _run(stacking_params, path, out, chunk_rows=64, _interrupt_after_chunks=1)
    assert not (out / "summary.json").exists()


def test_quarantine_sidecar_contents(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:80], bad_at=(10, 40))
    out = tmp_path / "out"
    summary = _run(stacking_params, path, out, chunk_rows=32, overlap=False)
    assert summary["bad_rows"] == 2 and summary["rows"] == 80
    entries = [json.loads(line) for line in open(out / "quarantine.jsonl")]
    assert [e["line"] for e in entries] == [11, 42]
    assert all(e["error"] for e in entries)


# ---------------------------------------------------------------------------
# parity: bit for bit with the port's own cli predict route
# ---------------------------------------------------------------------------


def test_contract_route_parity_bitwise(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows)
    out = tmp_path / "out"
    summary = _run(stacking_params, path, out, chunk_rows=64)
    assert summary["rows"] == len(cohort_rows)
    expect = stacking.predict_proba1(stacking_params, torch.as_tensor(cohort_rows),
                                     device="cpu").numpy()
    np.testing.assert_array_equal(_p1(out), expect)


def test_pipeline_route_parity_bitwise(tmp_path, pipeline_params, cohort_rows):
    rows = cohort_rows[:200]
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, rows)
    out = tmp_path / "out"
    summary = _run(pipeline_params, path, out, chunk_rows=64)
    assert summary["route"] == "contract"
    expect = pipeline.pipeline_predict_proba1_contract(pipeline_params, rows, device="cpu")
    np.testing.assert_array_equal(_p1(out), expect.numpy())


def test_mat_x64_route_parity_bitwise(tmp_path, pipeline_params):
    X64, y, _ = make_cohort(n=150, seed=23, missing_rate=0.04)
    path = tmp_path / "cohort.mat"
    _write_mat(path, X64, y)
    out = tmp_path / "out"
    summary = _run(pipeline_params, path, out, chunk_rows=64)
    assert summary["route"] == "x64" and summary["rows"] == 150
    expect = pipeline.pipeline_predict_proba1(pipeline_params, X64, device="cpu")
    np.testing.assert_array_equal(_p1(out), expect.numpy())


def test_x64_route_requires_pipeline_params(tmp_path, stacking_params):
    X64, _, _ = make_cohort(n=20, seed=5, missing_rate=0.0)
    path = tmp_path / "cohort.mat"
    _write_mat(path, X64)
    with pytest.raises(TypeError, match="PipelineParams"):
        _run(stacking_params, path, tmp_path / "out", overlap=False)


@pytest.mark.parametrize("family", ["stacking", "tree", "pipeline"])
def test_chunks_in_flight_each_equal_the_eager_route(family, stacking_params, pipeline_params,
                                                    cohort_rows):
    """Three chunks submitted before the first is finished (three slots in
    flight on the card): each equals the eager route on its own padded
    chunk, the tail's pad rows sliced off."""
    from machine_learning_replications_tpu_torch.serve.engine import oracle_proba1

    params = {"stacking": stacking_params, "tree": stacking_params.gbdt,
              "pipeline": pipeline_params}[family]
    scorer = ChunkScorer(params, 64, "contract", device="cpu")
    chunks = [cohort_rows[:64], cohort_rows[64:128], cohort_rows[128:150]]
    pending = [scorer.submit(scorer.prep(c)) for c in chunks]
    for c, handle in zip(chunks, pending):
        p1, members, rows = scorer.finish(handle)
        padded, _ = sharding.pad_rows_to(c, 64, mode="edge")
        np.testing.assert_array_equal(p1, oracle_proba1(params, padded)[:len(c)])
        assert (members is None) == (family == "tree")
        assert rows.shape == (len(c), 17)


def test_mesh_is_refused_naming_item_7(stacking_params):
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        ChunkScorer(stacking_params, 64, "contract", mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# overlap vs sequential, shards, no new work
# ---------------------------------------------------------------------------


def test_overlap_equals_sequential_bytes(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows, bad_at=(17, 333))
    seq = _run(stacking_params, path, tmp_path / "seq", chunk_rows=64, overlap=False)
    ovl = _run(stacking_params, path, tmp_path / "ovl", chunk_rows=64, overlap=True,
               parse_workers=3, prefetch=3)
    assert seq["output_sha256"] == ovl["output_sha256"]
    assert _tree_bytes(tmp_path / "seq") == _tree_bytes(tmp_path / "ovl")
    assert ovl["rows"] == seq["rows"] == len(cohort_rows)
    for s in (seq, ovl):
        assert set(s["stage_seconds"]) >= {"read", "parse", "device", "write"}


def test_process_parse_mode_identical(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:200], bad_at=(30, 90))
    thr = _run(stacking_params, path, tmp_path / "thr", chunk_rows=64)
    proc = _run(stacking_params, path, tmp_path / "proc", chunk_rows=64, parse_procs=1)
    assert proc["parse_procs"] == 1 and thr["parse_procs"] == 0
    assert proc["output_sha256"] == thr["output_sha256"]
    assert _tree_bytes(tmp_path / "proc") == _tree_bytes(tmp_path / "thr")
    assert proc["bad_rows"] == 2


def test_shard_rotation_and_row_ids(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows)
    out = tmp_path / "out"
    summary = _run(stacking_params, path, out, chunk_rows=64, rows_per_shard=120)
    assert [s["rows"] for s in summary["shards"]] == [120, 120, 120, 120, 20]
    recs = _read_scores(out)
    assert [r["row"] for r in recs] == list(range(500))
    assert [r["line"] for r in recs] == list(range(1, 501))
    for s in summary["shards"]:
        assert os.path.getsize(out / s["name"]) == s["bytes"]


def test_fixed_chunk_shape_adds_no_new_work(tmp_path, stacking_params, cohort_rows):
    """A second cohort scored in the same process captures no graph and
    builds no kernel (the JAX suite's one-compile bound, in the port's
    accounting); the summary states the counters."""
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:300])
    first = _run(stacking_params, path, tmp_path / "warm", chunk_rows=64)
    again = _run(stacking_params, path, tmp_path / "again", chunk_rows=64)
    for key in ("torch_graph_captures", "torch_kernel_builds"):
        assert again[key] == first[key]


def test_summary_keys_are_jax_keys(tmp_path, jax_stacking, stacking_params, cohort_rows):
    """The run summary keeps JAX's keys; only its XLA compile accounting is
    replaced by the port's capture/build counters."""
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:100])
    got = _run(stacking_params, path, tmp_path / "port", chunk_rows=64)
    want = _jrun(jax_stacking, path, tmp_path / "jax", chunk_rows=64)
    assert set(got) == (set(want) - {"jax_compiles", "jax_compile_seconds"}) | {
        "torch_graph_captures", "torch_kernel_builds", "torch_kernel_build_seconds"}
    summary = json.load(open(tmp_path / "port" / "summary.json"))
    assert set(summary) == set(got)


# ---------------------------------------------------------------------------
# across frameworks: the same cohort through JAX's pipeline and the port's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["contract", "pipeline", "mat"])
def test_same_outputs_as_jax(tmp_path, route, jax_stacking, jax_pipeline, stacking_params,
                             pipeline_params, cohort_rows):
    if route == "mat":
        X64, y, _ = make_cohort(n=150, seed=23, missing_rate=0.04)
        path = tmp_path / "cohort.mat"
        _write_mat(path, X64, y)
    else:
        path = tmp_path / "cohort.jsonl"
        _write_jsonl(path, cohort_rows[:300], bad_at=(5, 77, 200))
    jp, pp = ((jax_stacking, stacking_params) if route == "contract"
              else (jax_pipeline, pipeline_params))
    got = _run(pp, path, tmp_path / "port", chunk_rows=64)
    want = _jrun(jp, path, tmp_path / "jax", chunk_rows=64)
    for key in ("route", "rows", "chunks", "bad_rows"):
        assert got[key] == want[key], key
    recs, jrecs = _read_scores(tmp_path / "port"), _read_scores(tmp_path / "jax")
    assert [(r["row"], r["line"]) for r in recs] == [(r["row"], r["line"]) for r in jrecs]
    rtol, atol = parity_tolerance(pp)
    np.testing.assert_allclose(_p1(tmp_path / "port"), _p1(tmp_path / "jax"), rtol=rtol, atol=atol)
    quarantine = [(tmp_path / d / "quarantine.jsonl") for d in ("port", "jax")]
    assert [q.read_text() if q.exists() else "" for q in quarantine][0] == \
        [q.read_text() if q.exists() else "" for q in quarantine][1]
    prog = [json.load(open(tmp_path / d / "progress.json")) for d in ("port", "jax")]
    for key in ("lines", "chunks", "rows", "bad_rows", "done"):
        assert prog[0][key] == prog[1][key], key
    assert [s["rows"] for s in prog[0]["shards"]] == [s["rows"] for s in prog[1]["shards"]]


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def test_kill_resume_byte_identical(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows, bad_at=(100, 260))
    golden = _run(stacking_params, path, tmp_path / "golden", chunk_rows=64)
    out = tmp_path / "out"
    with pytest.raises(ScoreInterrupted):
        _run(stacking_params, path, out, chunk_rows=64, _interrupt_after_chunks=3)
    prog = json.load(open(out / "progress.json"))
    assert prog["chunks"] >= 3 and not prog["done"]
    jrn_path = tmp_path / "resume.jsonl"
    jrn = journal.RunJournal(str(jrn_path), command="score")
    journal.set_journal(jrn)
    try:
        resumed = _run(stacking_params, path, out, chunk_rows=64)
    finally:
        journal.set_journal(None)
        jrn.close()
    assert resumed["resumed"] and resumed["resumed_chunks"] >= 3
    assert resumed["rows"] == golden["rows"] == len(cohort_rows)
    assert resumed["output_sha256"] == golden["output_sha256"]
    assert _tree_bytes(out) == _tree_bytes(tmp_path / "golden")
    kinds = [json.loads(line).get("kind") for line in open(jrn_path)]
    assert "score_resume" in kinds and "score_done" in kinds
    assert kinds.count("score_chunk") == resumed["chunks"] - resumed["resumed_chunks"]


def test_resume_truncates_uncommitted_tail(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:300])
    golden = _run(stacking_params, path, tmp_path / "golden", chunk_rows=64)
    out = tmp_path / "out"
    with pytest.raises(ScoreInterrupted):
        _run(stacking_params, path, out, chunk_rows=64, _interrupt_after_chunks=2)
    shard = sorted(n for n in os.listdir(out) if n.startswith("scores-"))[-1]
    with open(out / shard, "ab") as f:
        f.write(b'{"row":999999,"line":999999,"p1":0.5}\n')
    resumed = _run(stacking_params, path, out, chunk_rows=64)
    assert resumed["output_sha256"] == golden["output_sha256"]
    assert _tree_bytes(out) == _tree_bytes(tmp_path / "golden")


def test_resume_fingerprint_mismatch(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:200])
    out = tmp_path / "out"
    with pytest.raises(ScoreInterrupted):
        _run(stacking_params, path, out, chunk_rows=64, _interrupt_after_chunks=1)
    with pytest.raises(ScoreResumeError, match="chunk_rows"):
        _run(stacking_params, path, out, chunk_rows=32)
    with pytest.raises(ScoreResumeError, match="params"):
        _run(stacking_params, path, out, chunk_rows=64, model_digest="other-model")
    summary = _run(stacking_params, path, out, chunk_rows=32, fresh=True)
    assert not summary["resumed"] and summary["rows"] == 200


# ---------------------------------------------------------------------------
# telemetry: metrics exposition + cohort quality
# ---------------------------------------------------------------------------


def test_score_metrics_exposition_valid(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:200], bad_at=(3,))
    _run(stacking_params, path, tmp_path / "out", chunk_rows=64)
    text = REGISTRY.render_prometheus()
    assert validate_metrics.validate(text) == []
    for family in ("score_rows_total", "score_chunks_total", "score_quarantined_rows_total",
                   "score_chunk_seconds", "score_queue_depth", "score_stage_seconds_total"):
        assert family in text


def test_cohort_quality_snapshot(tmp_path, pipeline_params, jax_pipeline, cohort_rows):
    rows = cohort_rows[:250]
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, rows)
    out = tmp_path / "out"
    summary = _run(pipeline_params, path, out, chunk_rows=64, quality_window=4096)
    q = summary["quality"]
    assert q is not None and q["enabled"] and q["rows"] == 250
    assert q["status"] in ("ok", "warn", "alert")
    snap = json.load(open(out / "quality.json"))
    assert snap["rows_total"] == 250 and len(snap["features"]) == 17
    assert "Max_Wall_Thick" in {f["name"] for f in snap["features"]}
    want = _jrun(jax_pipeline, path, tmp_path / "jax", chunk_rows=64, quality_window=4096)
    assert {k: q[k] for k in ("status", "worst_feature")} == \
        {k: want["quality"][k] for k in ("status", "worst_feature")}
    np.testing.assert_allclose(q["score_psi"], want["quality"]["score_psi"], rtol=1e-9)


def test_quality_absent_for_bare_ensemble(tmp_path, stacking_params, cohort_rows):
    path = tmp_path / "cohort.jsonl"
    _write_jsonl(path, cohort_rows[:60])
    summary = _run(stacking_params, path, tmp_path / "out", chunk_rows=64, overlap=False)
    assert summary["quality"] is None
    assert not (tmp_path / "out" / "quality.json").exists()


# ---------------------------------------------------------------------------
# cli score end to end, and the cli predict join
# ---------------------------------------------------------------------------


def test_cli_score_end_to_end(tmp_path, pipeline_params, cohort_rows, capsys):
    ckpt = tmp_path / "ckpt"
    checkpoint.save_model(str(ckpt), pipeline_params)
    rows = cohort_rows[:130]
    cohort = tmp_path / "cohort.jsonl"
    _write_jsonl(cohort, rows, bad_at=(7,))
    out = tmp_path / "out"
    metrics = tmp_path / "metrics.txt"
    rc = cli.main(["score", "--model", str(ckpt), "--cohort", str(cohort), "--out", str(out),
                   "--chunk-rows", "64", "--quality-window", "4096",
                   "--metrics-out", str(metrics), "--device", "cpu"])
    assert rc == 0
    assert "scored 130 rows" in capsys.readouterr().out
    summary = json.load(open(out / "summary.json"))
    assert summary["rows"] == 130 and summary["bad_rows"] == 1
    assert validate_metrics.validate(open(metrics).read()) == []
    pick = _read_scores(out)[41]
    patient = tmp_path / "patient.json"
    with open(patient, "w") as f:
        json.dump({k: float(v) for k, v in zip(SELECTED_17, rows[41])}, f)
    assert cli.main(["predict", "--model", str(ckpt), "--patient", str(patient),
                     "--device", "cpu"]) == 0
    assert f"{100.0 * pick['p1']:.2f} %" in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["--pkl", "x.pkl", "--mesh", "2", "--device", "cpu"], "ROADMAP item 7"),
    (["--pkl", "x.pkl", "--distributed", "--device", "cpu"], "ROADMAP item 7"),
    (["--device", "cpu"], "hf_predict_model.pkl"),
    (["--pkl", "x.pkl"], "CUDA is not available"),
])
def test_cli_score_refusals(tmp_path, monkeypatch, argv, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["score", "--cohort", str(tmp_path / "c.jsonl"), "--out", str(tmp_path / "o")]
    with pytest.raises(SystemExit, match=message):
        cli.main(base + argv)

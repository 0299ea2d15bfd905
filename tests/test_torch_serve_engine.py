"""The port's serving engine (``serve/engine.py``) vs the JAX package's.

Parameters: the committed sklearn-layout fixture
(``persist/testdata/stacking_small.pkl``: the reference topology fitted on
250 seeded rows, 10 stumps) decoded by the JAX package and bridged with
``convert.py``; its GBDT member alone is the tree family; the pipeline
family puts a JAX ``knn_impute.fit`` imputer over ``make_cohort(1427,
missing_rate=0.05)`` and the contract's 17 columns as support mask in front
of it. The port is held to JAX's eager ``oracle_proba1`` (the ``cli
predict`` route), never to the JAX engine's output: float64 at (1e-12,
1e-15), float32 at (1e-5, 1e-8). The float32 cases run the same rows
through both engines. On the CPU the port captures nothing: a bucket's
first run counts as its one "compile", so the JAX suite's compile bound
carries over.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import knn_impute as jknn
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.persist import sklearn_import as jimport
from machine_learning_replications_tpu.serve import engine as jengine
from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.data.examples import patient_row
from machine_learning_replications_tpu_torch.resilience import faults
from machine_learning_replications_tpu_torch.serve import engine
from machine_learning_replications_tpu_torch.serve.hostpath import HostScorer

FIXTURE = (Path(__file__).resolve().parents[1] / "machine_learning_replications_tpu_torch"
           / "persist" / "testdata" / "stacking_small.pkl")
F64 = (1e-12, 1e-15)
F32 = (1e-5, 1e-8)
FAMILIES = ("stacking", "tree", "pipeline")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_families():
    ens = jimport.import_stacking(jimport.decode_pickle(str(FIXTURE)))
    X64, _, _ = make_cohort(n=1427, seed=2020, missing_rate=0.05)
    mask = np.zeros(64, bool)
    mask[selected_indices()] = True
    pipe = jpipeline.PipelineParams(imputer=jknn.fit(jnp.asarray(X64)),
                                    support_mask=jnp.asarray(mask), ensemble=ens)
    return {"stacking": ens, "tree": ens.gbdt, "pipeline": pipe}


def _bridge(jp, dtype=torch.float64):
    if isinstance(jp, jpipeline.PipelineParams):
        return convert.pipeline_params_from_arrays(jp, device="cpu", dtype=dtype)
    if hasattr(jp, "meta"):
        return convert.stacking_params_from_arrays(jp, device="cpu", dtype=dtype)
    return convert.tree_params_from_arrays(jp, device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def families(jax_families):
    return {k: _bridge(v) for k, v in jax_families.items()}


def _f32(jp):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)


@pytest.fixture(scope="module")
def rows():
    """Contract rows around the example patient (all positive, as the
    contract's variables are), 1100 of them: past two top buckets."""
    rng = np.random.default_rng(13)
    return patient_row() * (1.0 + 0.1 * rng.standard_normal((1100, 17)))


def _engine(params, buckets=engine.DEFAULT_BUCKETS, **kw):
    return engine.BucketedPredictEngine(params, buckets=buckets, device="cpu", **kw)


def test_plan_batch_equals_jax_for_every_n(jax_families, families):
    eng = _engine(families["stacking"])
    jeng = jengine.BucketedPredictEngine(jax_families["stacking"])
    assert eng.buckets == jeng.buckets == engine.DEFAULT_BUCKETS
    for n in range(1, 1101):
        assert eng.plan_batch(n) == jeng.plan_batch(n), n
        assert eng.bucket_for(n) == jeng.bucket_for(n), n
    assert eng.plan_batch(0) == () and eng.plan_batch(65) == (64, 1)
    assert (engine.DEFAULT_SPLIT_PENALTY_ROWS, engine.DEFAULT_MAX_SPLIT) == (
        jengine.DEFAULT_SPLIT_PENALTY_ROWS, jengine.DEFAULT_MAX_SPLIT)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [1, 9, 70, 1100])
def test_engine_matches_jax_oracle_float64(jax_families, families, rows, family, n):
    eng = _engine(families[family])
    got = eng.predict(rows[:n])
    want = jengine.oracle_proba1(jax_families[family], rows[:n])
    assert got.shape == (n,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=F64[0], atol=F64[1])
    assert engine.parity_tolerance(families[family]) == F64 == jengine.parity_tolerance()


def _float32_pair(jax_families, family):
    """The family with a float32 ensemble on both sides; a pipeline keeps
    its imputer in float64, as a ``fit_pipeline`` checkpoint does."""
    jp = jax_families[family]
    if family != "pipeline":
        jp = _f32(jp)
        return jp, _bridge(jp, torch.float32)
    jp = jpipeline.PipelineParams(imputer=jp.imputer, support_mask=jp.support_mask,
                                  ensemble=_f32(jp.ensemble))
    from machine_learning_replications_tpu_torch.models.pipeline import PipelineParams

    port = PipelineParams(
        imputer=convert.knn_imputer_params_from_arrays(jp.imputer, device="cpu"),
        support_mask=convert.pipeline_params_from_arrays(jp, device="cpu").support_mask,
        ensemble=convert.stacking_params_from_arrays(jp.ensemble, device="cpu",
                                                     dtype=torch.float32))
    return jp, port


@pytest.mark.parametrize("family", FAMILIES)
def test_both_engines_float32_match_jax_oracle(jax_families, rows, family):
    jp, port = _float32_pair(jax_families, family)
    assert engine.parity_tolerance(port) == F32
    X = rows[:70]
    want = jengine.oracle_proba1(jp, X)
    got = _engine(port, buckets=(1, 8, 64)).predict(X)
    jgot = jengine.BucketedPredictEngine(jp, buckets=(1, 8, 64)).predict(X)
    np.testing.assert_allclose(got, want, rtol=F32[0], atol=F32[1])
    np.testing.assert_allclose(jgot, want, rtol=F32[0], atol=F32[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_padding_is_bit_neutral(families, rows, family):
    eng = _engine(families[family], buckets=(1, 8, 64))
    assert eng.plan_batch(2) == eng.plan_batch(7) == (8,)
    assert eng.plan_batch(40) == eng.plan_batch(63) == (64,)
    np.testing.assert_array_equal(eng.predict(rows[:7])[:2], eng.predict(rows[:2]))
    np.testing.assert_array_equal(eng.predict(rows[:63])[:40], eng.predict(rows[:40]))
    assert eng.plan_batch(9) == (8, 1)
    np.testing.assert_array_equal(
        eng.predict(rows[:9]), np.concatenate([eng.predict(rows[:8]), eng.predict(rows[8:9])]))


@pytest.mark.parametrize("family", FAMILIES)
def test_compile_count_bound(families, rows, family):
    eng = _engine(families[family], buckets=(1, 8, 64))
    assert eng.compile_count() == 0 and not eng.warm
    times = eng.warmup()
    assert eng.warm and set(times) == {1, 8, 64}
    assert eng.trace_counts == {1: 1, 8: 1, 64: 1}
    for n in (1, 2, 3, 5, 7, 8, 9, 30, 64, 65, 70, 200):
        eng.predict(rows[:n])
    assert eng.trace_counts == {1: 1, 8: 1, 64: 1}


def test_oversize_batch_chunks(jax_families, families, rows):
    eng = _engine(families["stacking"], buckets=(1, 8))
    got = eng.predict(rows[:70])          # 70 rows through 8-row chunks
    np.testing.assert_allclose(got, jengine.oracle_proba1(jax_families["stacking"], rows[:70]),
                               rtol=F64[0], atol=F64[1])
    assert eng.plan_batch(70) == (8,) * 8 + (8,) and set(eng.trace_counts) <= {1, 8}
    assert eng.predict(np.empty((0, 17))).shape == (0,)
    with pytest.raises(ValueError, match="contract rows"):
        eng.predict(np.zeros((3, 5)))


class _Feed:
    """Records what the engine hands the quality monitor."""

    def __init__(self):
        self.batches = []

    def observe_batch(self, X, probs, members):
        self.batches.append((np.array(X), np.array(probs),
                             None if members is None else np.array(members)))


@pytest.mark.parametrize("family", FAMILIES)
def test_quality_fed_only_real_rows(jax_families, families, rows, family):
    feed, jfeed = _Feed(), _Feed()
    eng = _engine(families[family], buckets=(1, 8), quality=feed)
    jeng = jengine.BucketedPredictEngine(jax_families[family], buckets=(1, 8), quality=jfeed)
    eng.warmup()
    assert feed.batches == []               # warmup bypasses the window
    for n in (3, 20):                       # padded to 8; chunked past the top bucket
        eng.predict(rows[:n])
        jeng.predict(rows[:n])
    assert [b[0].shape[0] for b in feed.batches] == [3, 20]
    for (X, p, m), (jX, jp, jm) in zip(feed.batches, jfeed.batches):
        np.testing.assert_allclose(X, np.asarray(jX), rtol=1e-12, atol=0)
        np.testing.assert_allclose(p, jp, rtol=F64[0], atol=F64[1])
        assert (m is None) == (jm is None) == (family == "tree")
        if m is not None:
            np.testing.assert_allclose(m, jm, rtol=1e-12, atol=1e-15)


def test_quality_feed_failure_is_quarantined(families, rows):
    class Broken:
        disabled = None

        def observe_batch(self, *a):
            raise RuntimeError("mis-sized profile")

        def disable(self, reason):
            self.disabled = reason

    mon = Broken()
    eng = _engine(families["stacking"], buckets=(1, 8), quality=mon)
    assert eng.predict(rows[:3]).shape == (3,)       # the prediction still succeeds
    assert eng.quality is None and "mis-sized" in mon.disabled


def test_nan_contract_rows_take_the_eager_route(jax_families, families, rows):
    X = rows[:5].copy()
    X[1, 3] = np.nan
    eng = _engine(families["pipeline"], buckets=(1, 8))
    eng.warmup()
    got = eng.predict(X)
    want = jengine.oracle_proba1(jax_families["pipeline"], X)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=F64[0], atol=F64[1])
    assert eng.trace_counts == {1: 1, 8: 1}


def test_host_scorer_is_the_engine_on_a_cpu_copy(families, rows):
    eng = _engine(families["pipeline"], buckets=(1, 8))
    host = HostScorer(families["pipeline"])
    assert host.buckets == (1, 8) and not host.warm
    host.warmup()
    assert host.warm and host.trace_counts == {1: 1, 8: 1}
    for r in rows[:5]:
        np.testing.assert_array_equal(host.predict(r[None, :]), eng.predict(r[None, :]))


def test_warmup_probe_and_faultpoint(families, monkeypatch):
    eng = _engine(families["stacking"], buckets=(1, 8))
    faults.arm("engine.warmup:raise@count=1")
    try:
        with pytest.raises(faults.InjectedFault):
            eng.warmup()
    finally:
        faults.reset()
    assert not eng.warm
    real = eng._forward
    monkeypatch.setattr(eng, "_forward", lambda Xs: (real(Xs)[0] * 1.001,) + real(Xs)[1:])
    with pytest.raises(RuntimeError, match="does not reproduce the eager oracle"):
        eng.warmup()
    assert not eng.warm


def test_parity_tolerance_keys_on_the_parameters_dtype(jax_families, families):
    assert engine.parity_tolerance(families["tree"]) == F64
    for family in FAMILIES:
        assert engine.parity_tolerance(_float32_pair(jax_families, family)[1]) == F32
    assert engine.parity_tolerance() == (F64 if torch.get_default_dtype() == torch.float64 else F32)


def test_family_and_ladder_validation(families, monkeypatch):
    with pytest.raises(ValueError):
        _engine(families["stacking"], buckets=())
    with pytest.raises(ValueError):
        _engine(families["stacking"], buckets=(0, 4))
    with pytest.raises(TypeError):
        _engine(object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.BucketedPredictEngine(families["stacking"])

"""The port's continual learning (``learn/{capture,shadow,retrain,trigger,
promote,loop}`` and ``cli learn``) vs the JAX package's.

The shadow comparator (``score_divergence``, ``mean_disagreement``,
``cohort_quality``, ``judge``) is held to JAX's on the same arrays, and to
the JAX suite's golden values. ``replay_scores`` is held to JAX's on the
same converted parameters (a JAX ``fit_stacking`` on 300 cohort rows with a
reference profile, and a full pipeline around it) at (1e-5, 1e-8), and bit
for bit to the port's own eager route. ``warm_refit`` refits on 300
captured rows (``min_rows`` lowered) and is held to JAX at the train
route's tolerances: masks and forests equal, members and ``p1`` within
1e-6. The bare-ensemble refit is JAX's ``warm_refit`` itself; for a full
pipeline the port first fills the captured rows' 47 unobserved columns with
the live imputer (``learn/retrain.py``'s docstring: JAX's own refit stops on
them), so it is held to JAX's ``fit_pipeline`` on the rows JAX's imputer
completes the same way, with JAX's distilled labels.

The router half: the trigger (a verbatim copy) and the promotion gate run
the JAX suite's tests on the port's modules; ``loop.run_cycle`` without a
router gives JAX's verdict and statistics on the same live parameters and
captured rows; with a router it drives a refit, the shadow verdict and a
rolling deploy across two in-process CPU replicas.
"""

import json
import os
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import ExperimentConfig as JExperimentConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.learn import loop as jloop
from machine_learning_replications_tpu.learn import retrain as jretrain
from machine_learning_replications_tpu.learn import shadow as jshadow
from machine_learning_replications_tpu.models import knn_impute as jknn
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.obs import quality as jquality
from machine_learning_replications_tpu_torch import cli, convert
from machine_learning_replications_tpu_torch.config import ExperimentConfig
from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT
from machine_learning_replications_tpu_torch.learn import capture as capturemod
from machine_learning_replications_tpu_torch.learn import loop as loopmod
from machine_learning_replications_tpu_torch.learn import promote as promotemod
from machine_learning_replications_tpu_torch.learn import retrain
from machine_learning_replications_tpu_torch.learn import shadow as shadowmod
from machine_learning_replications_tpu_torch.learn import trigger as triggermod
from machine_learning_replications_tpu_torch.models import pipeline, stacking
from machine_learning_replications_tpu_torch.obs import journal, quality
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY
from machine_learning_replications_tpu_torch.persist import checkpoint

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
try:
    import validate_metrics
finally:
    sys.path.pop(0)

FAST = {
    "gbdt": {"n_estimators": 5},
    "svc": {"platt_cv": 2, "max_iter": 2000},
    "stacking": {"cv_folds": 2},
    "select": {"cv_folds": 3, "n_alphas": 20},
}
N = 300


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# comparator math: against JAX's, and the JAX suite's golden values
# ---------------------------------------------------------------------------


def _streams():
    rng = np.random.default_rng(5)
    p = rng.uniform(0.02, 0.98, 400)
    return {
        "identical": (p, p.copy()),
        "shift": (np.array([0.10, 0.30, 0.45, 0.48, 0.60, 0.80]),
                  np.array([0.10, 0.30, 0.45, 0.48, 0.60, 0.80]) + 0.1),
        "random": (p, np.clip(p + rng.normal(0, 0.08, 400), 0, 1)),
        "empty": (np.zeros(0), np.zeros(0)),
    }


@pytest.mark.parametrize("case", ["identical", "shift", "random", "empty"])
def test_score_divergence_equals_jax(case):
    live, cand = _streams()[case]
    assert shadowmod.score_divergence(live, cand) == jshadow.score_divergence(live, cand)


def test_score_divergence_golden_and_edges():
    p = np.linspace(0.05, 0.95, 200)
    d = shadowmod.score_divergence(p, p.copy())
    assert d["rows"] == 200 and d["divergence_max"] == 0.0 and d["score_psi"] == 0.0
    d = shadowmod.score_divergence(*_streams()["shift"])
    assert d["divergence_mean"] == pytest.approx(0.1) and d["flip_rate"] == pytest.approx(2 / 6)
    empty = shadowmod.score_divergence(np.zeros(0), np.zeros(0))
    json.dumps(empty, allow_nan=False)
    assert all(empty[k] is None for k in ("divergence_mean", "flip_rate", "score_psi"))
    with pytest.raises(ValueError, match="differ in length"):
        shadowmod.score_divergence(np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError, match="finite"):
        shadowmod.score_divergence(np.array([0.1, np.nan]), np.array([0.1, 0.2]))


@pytest.mark.parametrize("members", [
    np.column_stack([np.full(10, 0.4), np.full(10, 0.6)]),
    np.tile(np.array([0.2, 0.4, 0.8]), (5, 1)),
    np.random.default_rng(3).uniform(size=(50, 3)),
    None,
    np.zeros((5, 1)),
    np.zeros((0, 3)),
])
def test_mean_disagreement_equals_jax(members):
    assert shadowmod.mean_disagreement(members) == jshadow.mean_disagreement(members)


def test_mean_disagreement_golden():
    m = np.column_stack([np.full(10, 0.4), np.full(10, 0.6)])
    assert shadowmod.mean_disagreement(m) == pytest.approx(0.2)
    assert shadowmod.mean_disagreement(np.tile(np.array([0.2, 0.4, 0.8]), (5, 1))) == \
        pytest.approx(0.4)


def test_cohort_quality_equals_jax():
    rng = np.random.default_rng(11)
    prof = quality.build_reference_profile(rng.normal(size=(4000, 3)), np.full(4000, 0.5))
    same = rng.normal(size=(2000, 3))
    shifted = same.copy()
    shifted[:, 1] += 3.0
    for rows in (same, shifted):
        assert shadowmod.cohort_quality(prof, rows) == jshadow.cohort_quality(prof, rows)
    assert shadowmod.cohort_quality(prof, same)["status"] == "ok"
    drifted = shadowmod.cohort_quality(prof, shifted)
    assert drifted["status"] == "alert" and drifted["worst_feature_index"] == 1
    with pytest.raises(ValueError, match="describes 3 features"):
        shadowmod.cohort_quality(prof, np.zeros((10, 4)))
    with pytest.raises(ValueError, match="finite"):
        shadowmod.cohort_quality(prof, np.full((10, 3), np.nan))


def _stats(**overrides):
    base = {
        "rows": 500, "divergence_mean": 0.05, "divergence_p95": 0.10, "divergence_max": 0.20,
        "flip_rate": 0.02, "score_psi": 0.5, "disagreement_delta": 0.01,
        "candidate_quality": {"status": "ok", "worst_psi": 0.05, "rows": 500},
    }
    base.update(overrides)
    return base


@pytest.mark.parametrize("key,bound_attr", [
    ("divergence_mean", "max_divergence_mean"),
    ("divergence_p95", "max_divergence_p95"),
    ("flip_rate", "max_flip_rate"),
    ("score_psi", "max_score_psi"),
    ("disagreement_delta", "max_disagreement_delta"),
])
def test_judge_each_threshold_equals_jax(key, bound_attr):
    th, jth = shadowmod.ShadowThresholds(), jshadow.ShadowThresholds()
    assert th.as_dict() == jth.as_dict()
    bound = getattr(th, bound_attr)
    for v in (bound, bound + 1e-6):
        got = shadowmod.judge(_stats(**{key: v}), th)
        assert got == jshadow.judge(_stats(**{key: v}), jth)
        assert got["pass"] == (v == bound)


@pytest.mark.parametrize("overrides", [
    {},
    {"rows": 63},
    {"candidate_quality": None},
    {"candidate_quality": {"status": "alert", "worst_psi": 0.9, "rows": 500}},
    {"divergence_mean": float("nan")},
])
def test_judge_fails_closed_like_jax(overrides):
    for require in (True, False):
        th = shadowmod.ShadowThresholds(require_candidate_profile=require)
        jth = jshadow.ShadowThresholds(require_candidate_profile=require)
        got = shadowmod.judge(_stats(**overrides), th)
        assert got == jshadow.judge(_stats(**overrides), jth)
        json.dumps(got, allow_nan=False)
    assert not shadowmod.judge(_stats(rows=63), shadowmod.ShadowThresholds())["pass"]


def test_shadow_gauges_validator_clean_in_all_states():
    page = REGISTRY.render_prometheus()
    assert validate_metrics.validate(page) == []
    for name in ("learn_shadow_divergence_mean", "learn_shadow_flip_rate",
                 "learn_shadow_score_psi", "learn_shadow_candidate_worst_psi",
                 "learn_shadow_rows", "learn_shadow_evaluations_total",
                 "learn_capture_rows_total", "learn_retrain_total"):
        assert name in page, f"{name} missing from scrape"
    shadowmod._export({"rows": 0})
    assert validate_metrics.validate(REGISTRY.render_prometheus()) == []
    assert REGISTRY.snapshot()["learn_shadow_divergence_mean"] is None
    shadowmod._export(_stats())
    assert validate_metrics.validate(REGISTRY.render_prometheus()) == []
    snap = REGISTRY.snapshot()
    assert snap["learn_shadow_divergence_mean"] == pytest.approx(0.05)
    assert snap["learn_shadow_candidate_status"] == 0.0


# ---------------------------------------------------------------------------
# capture buffer (a verbatim copy; the JAX suite's cases on the port)
# ---------------------------------------------------------------------------


def _patient_line(**overrides) -> bytes:
    p = dict(EXAMPLE_PATIENT)
    p.update(overrides)
    return json.dumps(p).encode()


def test_capture_rotates_and_bounds_the_window(tmp_path):
    cap = capturemod.CohortCapture(tmp_path, rows_per_shard=4, max_shards=2)
    for i in range(20):
        cap.append_line(_patient_line(Max_Wall_Thick=40 + i))
    stats = cap.stats()
    assert stats["shards"] == 2 and stats["rows_appended"] == 20 and stats["rows_retained"] == 8
    assert sorted(os.listdir(tmp_path)) == ["cohort-00003.jsonl", "cohort-00004.jsonl"]
    cap.close()
    cap2 = capturemod.CohortCapture(tmp_path, rows_per_shard=4, max_shards=2)
    cap2.append_line(_patient_line(Max_Wall_Thick=99))
    assert "cohort-00005.jsonl" in os.listdir(tmp_path)
    cap2.close()


def test_load_recent_newest_rows_oldest_first_with_quarantine(tmp_path):
    cap = capturemod.CohortCapture(tmp_path, rows_per_shard=8)
    ages = list(range(30, 50))
    for age in ages:
        cap.append_line(_patient_line(Max_Wall_Thick=age))
    cap.append_line(b'{"not": "a patient"}')
    cap.append_line(b"garbage {{{")
    cap.close()
    X, n_bad = capturemod.load_recent(tmp_path, max_rows=10)
    assert n_bad == 2
    col = list(EXAMPLE_PATIENT).index("Max_Wall_Thick")
    assert list(X[:, col]) == [float(a) for a in ages[-8:]]
    with pytest.raises(ValueError, match="max_rows"):
        capturemod.load_recent(tmp_path, max_rows=0)
    with pytest.raises(ValueError):
        capturemod.CohortCapture(tmp_path, rows_per_shard=0)


# ---------------------------------------------------------------------------
# replay, warm refit, shadow on a real (small) ensemble
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_live():
    """A JAX ``fit_stacking`` on 300 cohort rows with its reference profile
    (the JAX suite's live model, at the refit's row count), and a full
    pipeline around it: a JAX imputer over 300 rows with missing values,
    the contract columns as support mask."""
    cfg = JExperimentConfig.from_dict(FAST)
    X64, y, _ = make_cohort(n=N, seed=7, missing_rate=0.0)
    X17 = np.asarray(X64[:, selected_indices()], np.float64)
    y = np.asarray(y, np.float64)
    ens = jpipeline.fit_stacking(X17, y, cfg)
    scores = jpipeline._ensemble_scores(ens, X17, chunk_rows=cfg.svc.predict_chunk_rows)
    prof = {k: jnp.asarray(v) for k, v in jquality.build_reference_profile(X17, scores, y=y).items()}
    stack = ens.replace(quality=prof)
    Xi, _, _ = make_cohort(n=N, seed=9, missing_rate=0.05)
    mask = np.zeros(64, bool)
    mask[selected_indices()] = True
    pipe = jpipeline.PipelineParams(imputer=jknn.fit(jnp.asarray(Xi)),
                                    support_mask=jnp.asarray(mask), ensemble=ens, quality=prof)
    return {"stacking": stack, "pipeline": pipe}


@pytest.fixture(scope="module")
def live(jax_live):
    return {"stacking": convert.stacking_params_from_arrays(jax_live["stacking"], device="cpu"),
            "pipeline": convert.pipeline_params_from_arrays(jax_live["pipeline"], device="cpu")}


@pytest.fixture(scope="module")
def shifted():
    """The captured cohort: 300 rows of another seed, column 0 shifted."""
    X64, _, _ = make_cohort(n=N, seed=8, missing_rate=0.0)
    X17 = np.asarray(X64[:, selected_indices()], np.float64)
    X17[:, 0] += 1.0
    return X17


@pytest.mark.parametrize("family", ["stacking", "pipeline"])
def test_replay_scores_equals_jax_and_the_eager_route(family, live, jax_live, shifted):
    from machine_learning_replications_tpu_torch.serve.engine import oracle_proba1

    p1, members, rows = shadowmod.replay_scores(live[family], shifted, chunk_rows=128,
                                                device="cpu")
    jp1, jmembers, jrows = jshadow.replay_scores(jax_live[family], shifted, chunk_rows=128)
    np.testing.assert_allclose(p1, jp1, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(members, jmembers, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(rows, jrows, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(p1, oracle_proba1(live[family], shifted))
    if family == "stacking":
        _, direct = stacking.predict_proba1_with_members(live[family], torch.as_tensor(shifted),
                                                         device="cpu")
        np.testing.assert_array_equal(members, direct.numpy())
        np.testing.assert_array_equal(rows, shifted)


def test_warm_refit_validates_input(live, shifted, tmp_path):
    cfg = ExperimentConfig.from_dict(FAST)
    params = live["stacking"]
    out = str(tmp_path / "x")
    with pytest.raises(ValueError, match="min_rows"):
        retrain.warm_refit(params, shifted[:10], out, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match=r"\[n, 17\]"):
        retrain.warm_refit(params, shifted[:, :5], out, cfg=cfg, device="cpu")
    bad = shifted.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="finite"):
        retrain.warm_refit(params, bad, out, cfg=cfg, min_rows=100, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        retrain.warm_refit(params, shifted, out, cfg=cfg, labels=np.ones(shifted.shape[0] - 1),
                           min_rows=100, device="cpu")
    import unittest.mock as mock

    with mock.patch.object(retrain, "pseudo_labels", return_value=np.zeros(shifted.shape[0])):
        with pytest.raises(ValueError, match="single-class"):
            retrain.warm_refit(params, shifted, out, cfg=cfg, min_rows=100, device="cpu")
    with pytest.raises(TypeError, match="cannot warm-refit"):
        retrain.warm_refit(object(), shifted, out, cfg=cfg, min_rows=100, device="cpu")
    from machine_learning_replications_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="mesh's ranks compute on meta"):
        retrain.warm_refit(params, shifted, out, cfg=cfg, min_rows=100,
                           mesh=Mesh(1, 1, torch.device("meta")), device="cpu")
    assert not os.path.exists(out)


def _assert_members_close(ens, jens):
    g, jg = ens.gbdt, jens.gbdt
    for f in ("feature", "threshold", "left", "right"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)))
    np.testing.assert_allclose(g.value.numpy(), np.asarray(jg.value), rtol=1e-10, atol=1e-12)
    for got, want in ((ens.svc.dual_coef, jens.svc.dual_coef), (ens.svc.prob_a, jens.svc.prob_a),
                      (ens.logreg.coef, jens.logreg.coef), (ens.meta.coef, jens.meta.coef),
                      (ens.meta.intercept, jens.meta.intercept)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def stacking_refit(live, jax_live, shifted, tmp_path_factory):
    root = tmp_path_factory.mktemp("refit")
    cfg = ExperimentConfig.from_dict(FAST)
    cand, info = retrain.warm_refit(live["stacking"], shifted, str(root / "cand"), cfg=cfg,
                                    min_rows=200, device="cpu")
    jcand, jinfo = jretrain.warm_refit(jax_live["stacking"], shifted, str(root / "jcand"),
                                       cfg=JExperimentConfig.from_dict(FAST), min_rows=200)
    return cand, info, jcand, jinfo, str(root / "cand")


def test_warm_refit_stacking_equals_jax(stacking_refit, shifted):
    cand, info, jcand, jinfo, _ = stacking_refit
    assert info["labels_source"] == jinfo["labels_source"] == "distilled"
    assert info["version"] == jinfo["version"] == 1
    assert info["family"] == jinfo["family"] == "StackingParams"
    assert list(info["stage_seconds"])[:3] == ["member_svc", "member_gbdt", "member_lg"]
    _assert_members_close(cand, jcand)
    p1 = shadowmod.replay_scores(cand, shifted, device="cpu")[0]
    jp1 = jshadow.replay_scores(jcand, shifted)[0]
    np.testing.assert_allclose(p1, jp1, rtol=1e-6)
    assert set(cand.quality) == set(jcand.quality)
    for k in jcand.quality:
        np.testing.assert_allclose(cand.quality[k].numpy(), np.asarray(jcand.quality[k]),
                                   rtol=1e-10, atol=1e-12, err_msg=k)
    reloaded = checkpoint.load_model(stacking_refit[4], device="cpu")
    assert reloaded.quality["bin_counts"].shape == cand.quality["bin_counts"].shape


def test_warm_refit_pipeline_equals_jax_fit_on_completed_rows(live, jax_live, shifted, tmp_path):
    """The pipeline refit: the live imputer fills the 47 unobserved columns
    (equal to JAX's imputer on the same rows), then the fit equals JAX's
    ``fit_pipeline`` on those rows and JAX's distilled labels."""
    cfg = ExperimentConfig.from_dict(FAST)
    cand, info = retrain.warm_refit(live["pipeline"], shifted, str(tmp_path / "cand"), cfg=cfg,
                                    min_rows=200, device="cpu")
    assert info["family"] == "PipelineParams" and info["version"] == 1
    jl = jax_live["pipeline"]
    x64 = np.asarray(jknn.transform(jl.imputer, jpipeline.contract_rows_to_x64(jl, shifted)))
    np.testing.assert_array_equal(retrain.complete_with_live_imputer(live["pipeline"], shifted),
                                  x64)
    y = jretrain.pseudo_labels(jl, shifted)
    np.testing.assert_array_equal(retrain.pseudo_labels(live["pipeline"], shifted, device="cpu"), y)
    jcand, _ = jpipeline.fit_pipeline(x64, y, JExperimentConfig.from_dict(FAST))
    np.testing.assert_array_equal(cand.support_mask.numpy(), np.asarray(jcand.support_mask))
    np.testing.assert_array_equal(cand.imputer.donors.numpy(), np.asarray(jcand.imputer.donors))
    _assert_members_close(cand.ensemble, jcand.ensemble)
    p1 = pipeline.pipeline_predict_proba1_contract(cand, shifted, device="cpu").numpy()
    jp1 = np.asarray(jpipeline.pipeline_predict_proba1_contract(jcand, shifted))
    np.testing.assert_allclose(p1, jp1, rtol=1e-6)
    assert np.isfinite(p1).all()


def test_refit_shadow_gate_arc_equals_jax(stacking_refit, live, jax_live, shifted, tmp_path):
    """The shadow verdict on the refit candidate against the live model
    equals JAX's on the same pair (pass or fail, the failed gates, the
    candidate's self-quality) and its statistics agree within the refit's
    tolerance; an impossibly strict gate refuses."""
    cand, info, jcand, _, _ = stacking_refit
    path = tmp_path / "j.jsonl"
    jrn = journal.RunJournal(str(path), command="test")
    journal.set_journal(jrn)
    try:
        verdict = shadowmod.evaluate(live["stacking"], cand, shifted,
                                     candidate_version=info["version"], device="cpu")
    finally:
        journal.set_journal(None)
        jrn.close()
    events = [json.loads(line) for line in open(path)]
    assert [e["kind"] for e in events[1:]] == ["learn_shadow_verdict"]
    jverdict = jshadow.evaluate(jax_live["stacking"], jcand, shifted,
                                candidate_version=info["version"])
    assert set(verdict) == set(jverdict) and set(verdict["stats"]) == set(jverdict["stats"])
    assert verdict["pass"] == jverdict["pass"]
    assert [r.split()[0] for r in verdict["reasons"]] == \
        [r.split()[0] for r in jverdict["reasons"]]
    assert verdict["thresholds"] == jverdict["thresholds"]
    assert verdict["stats"]["candidate_quality"] == jverdict["stats"]["candidate_quality"]
    for k in ("divergence_mean", "divergence_p95", "divergence_max", "flip_rate",
              "disagreement_delta"):
        assert verdict["stats"][k] == pytest.approx(jverdict["stats"][k], abs=2e-6), k
    assert verdict["stats"]["divergence_mean"] > 0.0
    json.dumps(verdict, allow_nan=False)
    strict = shadowmod.ShadowThresholds(max_divergence_mean=0.0)
    assert not shadowmod.evaluate(live["stacking"], cand, shifted, thresholds=strict,
                                  device="cpu")["pass"]


# ---------------------------------------------------------------------------
# cli learn
# ---------------------------------------------------------------------------


def test_cli_learn_parser_roundtrip():
    ap = cli.build_parser()
    args = ap.parse_args(["learn", "run", "--model", "/ck", "--capture", "/cap",
                          "--router", "http://r", "--alert-streak", "2", "--cooldown", "5",
                          "--max-cycles", "1"])
    assert args.role == "run" and args.alert_streak == 2
    args = ap.parse_args(["learn", "shadow", "--model", "/ck", "--capture", "/cap",
                          "--max-flip-rate", "0.2", "--out", "/tmp/v.json", "--device", "cpu"])
    assert args.role == "shadow" and args.max_flip_rate == 0.2 and args.device == "cpu"
    args = ap.parse_args(["learn", "promote", "--model", "/ck", "--router", "http://r",
                          "--verdict", "/tmp/v.json"])
    assert args.role == "promote" and args.verdict == "/tmp/v.json"
    args = ap.parse_args(["learn", "retrain", "--model", "/ck", "--capture", "/cap",
                          "--resume-dir", "/r", "--min-rows", "50"])
    assert args.role == "retrain" and args.min_rows == 50 and args.rows == 8192
    assert ap.parse_args(["learn", "status", "--router", "http://r"]).role == "status"


@pytest.mark.parametrize("argv,message", [
    (["run", "--model", "/ck", "--capture", "/cap", "--router", "http://r"],
     "CUDA is not available"),
    (["promote", "--model", "/ck", "--router", "http://r"], "pass --verdict"),
    (["status", "--router", "http://127.0.0.1:9"], "learn status request"),
])
def test_cli_learn_router_roles_name_the_roadmap_item(argv, message, monkeypatch):
    """The router roles are ported: each now exits with its own usage
    error — ``run`` wants the card unless ``--device cpu``, ``promote``
    refuses without a verdict, ``status`` names the unreachable router."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=message):
        cli.main(["learn", *argv])


def test_cli_learn_retrain_then_shadow(live, shifted, tmp_path, capsys):
    model, cap, cand = tmp_path / "live", tmp_path / "cap", tmp_path / "cand"
    checkpoint.save_model(str(model), live["stacking"])
    capture = capturemod.CohortCapture(cap, rows_per_shard=128)
    names = list(EXAMPLE_PATIENT)
    for row in shifted:
        capture.append_line({k: float(v) for k, v in zip(names, row)})
    capture.append_line(b"not json")
    capture.close()
    cfg = tmp_path / "fast.json"
    cfg.write_text(ExperimentConfig.from_dict(FAST).to_json())
    journal_path = tmp_path / "j.jsonl"
    assert cli.main(["learn", "retrain", "--model", str(model), "--capture", str(cap),
                     "--candidate", str(cand), "--config", str(cfg), "--min-rows", "200",
                     "--journal", str(journal_path), "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "captured cohort: 300 rows (1 malformed dropped)" in out.err
    info = json.loads(out.out)
    assert info["version"] == 1 and info["rows"] == 300
    kinds = [json.loads(line)["kind"] for line in open(journal_path)]
    assert kinds.index("learn_retrain_start") < kinds.index("learn_retrain_done")
    assert kinds[-1] == "run_done"
    verdict_path = tmp_path / "verdict.json"
    rc = cli.main(["learn", "shadow", "--model", str(model), "--capture", str(cap),
                   "--candidate", str(cand), "--out", str(verdict_path), "--device", "cpu"])
    verdict = json.loads(verdict_path.read_text())
    assert rc == (0 if verdict["pass"] else 1)
    assert set(verdict) == {"pass", "reasons", "stats", "thresholds", "candidate_version"}
    assert verdict["candidate_version"] == 1 and verdict["stats"]["rows"] == 300


# ---------------------------------------------------------------------------
# the router half: trigger, promotion gate, the loop
# ---------------------------------------------------------------------------


def _journaled(tmp_path, fn):
    """Run ``fn`` under a fresh journal; return its parsed events."""
    path = tmp_path / "journal.jsonl"
    jrn = journal.RunJournal(path, command="test")
    journal.set_journal(jrn)
    try:
        fn()
    finally:
        journal.set_journal(None)
        jrn.close()
    return [json.loads(line) for line in open(path)]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _poll(status, url="http://r1", psi=0.5, feature="Syncope"):
    return {"url": url, "ok": status is not None, "status": status,
            "worst_feature": feature, "worst_psi": psi, "transitions": []}


def test_trigger_debounce_then_fire_then_cooldown(tmp_path):
    clk = _Clock()
    policy = triggermod.TriggerPolicy(alert_streak=3, cooldown_s=60.0, clock=clk)
    decisions = []

    def drive():
        for _ in range(2):
            decisions.append(policy.observe([_poll("alert", psi=2.0)]))
            clk.t += 1
        decisions.append(policy.observe([_poll("alert", psi=2.5)]))
        clk.t += 1
        for _ in range(3):  # alert again at once: suppressed by the cooldown
            decisions.append(policy.observe([_poll("alert")]))
            clk.t += 1
        clk.t += 60         # past the cooldown the rebuilt streak fires again
        decisions.append(policy.observe([_poll("alert", psi=3.0)]))

    events = _journaled(tmp_path, drive)
    assert decisions[0] is None and decisions[1] is None
    assert decisions[2]["reason"] == "alert" and decisions[2]["worst_feature"] == "Syncope"
    assert decisions[2]["worst_psi"] == 2.5
    assert decisions[3] is None and decisions[4] is None and decisions[5] is None
    assert decisions[6] is not None and decisions[6]["worst_psi"] == 3.0
    kinds = [(e["fired"], e.get("suppressed_by")) for e in events if e["kind"] == "learn_trigger"]
    assert kinds == [(False, "debounce"), (False, "debounce"), (True, None),
                     (False, "debounce"), (False, "debounce"), (False, "cooldown"),
                     (True, None)]


def test_trigger_streak_resets_on_clean_poll():
    clk = _Clock()
    policy = triggermod.TriggerPolicy(alert_streak=2, cooldown_s=0, clock=clk)
    assert policy.observe([_poll("alert")]) is None
    assert policy.observe([_poll("ok")]) is None       # reset
    assert policy.observe([_poll("alert")]) is None
    assert policy.observe([_poll("alert")]) is not None
    # an unreachable fleet neither advances nor resets the streak
    policy2 = triggermod.TriggerPolicy(alert_streak=2, cooldown_s=0, clock=clk)
    assert policy2.observe([_poll("alert")]) is None
    assert policy2.observe([_poll(None)]) is None
    assert policy2.observe([_poll("alert")]) is not None


def test_trigger_schedule_fires_without_drift(tmp_path):
    clk = _Clock()
    policy = triggermod.TriggerPolicy(alert_streak=2, cooldown_s=30.0, schedule_s=100.0,
                                      clock=clk)
    fired = []

    def drive():
        for step in (99, 2, 20, 81, None):
            fired.append(policy.observe([_poll("ok")]))
            if step is not None:
                clk.t += step

    events = _journaled(tmp_path, drive)
    assert fired[0] is None and fired[1] is None
    assert fired[2]["reason"] == "schedule" and fired[3] is None
    assert fired[4]["reason"] == "schedule"
    assert [e["reason"] for e in events if e["kind"] == "learn_trigger" and e["fired"]] == \
        ["schedule", "schedule"]


def test_trigger_policy_validates_construction():
    for kw in ({"alert_streak": 0}, {"cooldown_s": -1}, {"schedule_s": 0}):
        with pytest.raises(ValueError):
            triggermod.TriggerPolicy(**kw)


def test_park_writes_refusal_and_blocks_publish(tmp_path):
    cand = tmp_path / "candidate"
    cand.mkdir()
    verdict = {"pass": False, "reasons": ["flip_rate 0.4 exceeds 0.1"]}
    paths = []
    events = _journaled(tmp_path, lambda: paths.append(promotemod.park(cand, verdict)))
    assert os.path.basename(paths[0]) == promotemod.REFUSED_FILE
    refused = json.load(open(paths[0]))
    assert refused["kind"] == "learn_promotion_refused"
    assert refused["verdict"]["reasons"] == verdict["reasons"]
    assert promotemod.is_parked(cand)
    assert [e["result"] for e in events if e["kind"] == "learn_promotion"] == ["refused"]
    with pytest.raises(RuntimeError, match="refused"):
        promotemod.publish_candidate(cand, tmp_path / "live")


def test_promote_refuses_failing_verdict_without_touching_fleet(tmp_path, live):
    """A refused verdict parks the candidate and never reaches the router
    (an unroutable URL) or the live checkpoint."""
    live_dir, cand = tmp_path / "live", tmp_path / "cand"
    checkpoint.save_model(str(live_dir), live["stacking"])
    checkpoint.save_model(str(cand), live["stacking"])
    out = promotemod.promote(cand, live_dir, "http://127.0.0.1:9",
                             {"pass": False, "reasons": ["rows below min"],
                              "candidate_version": 1})
    assert out["result"] == "refused" and promotemod.is_parked(cand)
    assert checkpoint.checkpoint_version(live_dir) == 1
    with pytest.raises(ValueError, match="re-run `learn shadow`"):
        promotemod.promote(cand, live_dir, "http://127.0.0.1:9",
                           {"pass": True, "reasons": [], "candidate_version": 7})


def test_promote_via_router_reads_deploy_report():
    from machine_learning_replications_tpu_torch.serve.transport import EventLoopHttpServer

    class _StubRouter:
        def __init__(self):
            self.bodies, self.code = [], 200
            self.response = {"deploy": {"result": "ok", "replicas": []}}

        def handle_request(self, req, rsp):
            self.bodies.append(json.loads(req.body))
            rsp.send_json(self.code, self.response)

        def handle_protocol_error(self, exc, rsp):
            rsp.send_json(exc.code, {"error": exc.message}, close=True)

    stub = _StubRouter()
    httpd = EventLoopHttpServer(("127.0.0.1", 0), stub)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert promotemod.promote_via_router(url, "/ck/model")["result"] == "ok"
        assert stub.bodies == [{"model": "/ck/model"}]
        # an error reply that still carries a deploy report is returned
        stub.code, stub.response = 409, {"deploy": {"result": "failed", "error": "in progress"}}
        assert promotemod.promote_via_router(url, "/ck/model")["result"] == "failed"
        # an error reply without one is a transport failure
        stub.code, stub.response = 500, {"error": "boom"}
        with pytest.raises(RuntimeError, match="boom"):
            promotemod.promote_via_router(url, "/ck/model")
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(RuntimeError, match="failed"):
        promotemod.promote_via_router("http://127.0.0.1:9", "/ck/model", timeout_s=0.5)


def test_publish_candidate_rotates_the_live_path(tmp_path, live):
    live_dir, cand = tmp_path / "live", tmp_path / "cand"
    checkpoint.save_model(str(live_dir), live["stacking"])
    checkpoint.save_model(str(cand), live["pipeline"])
    assert promotemod.publish_candidate(cand, live_dir) == 2
    assert type(checkpoint.load_model(str(live_dir), device="cpu")).__name__ == "PipelineParams"
    assert checkpoint.checkpoint_version(checkpoint.lastgood_path(live_dir)) == 1
    assert checkpoint.checkpoint_version(cand) == 1       # the candidate stays


def _write_capture(cap, rows):
    capture = capturemod.CohortCapture(cap, rows_per_shard=128)
    names = list(EXAMPLE_PATIENT)
    for row in rows:
        capture.append_line({k: float(v) for k, v in zip(names, row)})
    capture.close()


def test_run_cycle_without_router_equals_jax(live, jax_live, shifted, tmp_path):
    """The same live parameters (through ``convert``), the same captured
    rows and the same distilled labels: JAX's ``run_cycle`` and the port's
    give the same outcome, verdict, gates and retrain record, and
    statistics within the refit's tolerance."""
    from machine_learning_replications_tpu.persist import orbax_io

    cap = tmp_path / "cap"
    _write_capture(cap, shifted)
    checkpoint.save_model(str(tmp_path / "live"), live["stacking"])
    orbax_io.save_model(str(tmp_path / "jlive"), jax_live["stacking"])
    got = loopmod.run_cycle(str(tmp_path / "live"), str(cap), str(tmp_path / "cand"), None,
                            cfg=ExperimentConfig.from_dict(FAST), min_rows=200, device="cpu")
    want = jloop.run_cycle(str(tmp_path / "jlive"), str(cap), str(tmp_path / "jcand"), None,
                           cfg=JExperimentConfig.from_dict(FAST), min_rows=200)
    assert got["outcome"] == want["outcome"] and got["from_version"] == want["from_version"] == 1
    for k in ("version", "rows", "labels_source", "family"):
        assert got["retrain"][k] == want["retrain"][k], k
    v, jv = got["verdict"], want["verdict"]
    assert v["pass"] == jv["pass"] and v["thresholds"] == jv["thresholds"]
    assert [r.split()[0] for r in v["reasons"]] == [r.split()[0] for r in jv["reasons"]]
    assert v["stats"]["candidate_quality"] == jv["stats"]["candidate_quality"]
    assert set(v["stats"]) == set(jv["stats"])
    for k in ("rows", "divergence_mean", "divergence_p95", "divergence_max", "flip_rate",
              "score_psi", "disagreement_delta"):
        assert v["stats"][k] == pytest.approx(jv["stats"][k], abs=2e-6), k
    assert promotemod.is_parked(tmp_path / "cand") == (not v["pass"])


@pytest.mark.parametrize("gate", ["open", "default"])
def test_learn_loop_promotes_through_the_router(gate, live, shifted, tmp_path):
    """``LearnLoop`` on a schedule trigger over two in-process CPU replicas
    behind the router: the refit on the router's captured rows, the shadow
    verdict, then either the rolling deploy (gates opened: every replica at
    v2, serving the candidate) or, at the default gates (the seeded refit
    moves too far for them), a parked candidate and an untouched fleet."""
    from machine_learning_replications_tpu_torch.fleet import make_router
    from machine_learning_replications_tpu_torch.serve import make_server

    model, cap = str(tmp_path / "live"), str(tmp_path / "cap")
    checkpoint.save_model(model, live["stacking"])
    replicas = [make_server(checkpoint.load_model(model, device="cpu"), port=0, buckets=(1, 8),
                            max_wait_ms=2.0, model_version=1, replica_id=rid,
                            admin_endpoint=True, device="cpu").start_background()
                for rid in ("r1", "r2")]
    router = make_router(port=0, probe_interval_s=0.1, capture_dir=cap,
                         replicas=[(rid, f"http://{h.address[0]}:{h.address[1]}")
                                   for rid, h in zip(("r1", "r2"), replicas)]).start_background()
    rurl = f"http://{router.address[0]}:{router.address[1]}"
    thresholds = None if gate == "default" else shadowmod.ShadowThresholds(
        max_divergence_mean=1.0, max_divergence_p95=1.0, max_flip_rate=1.0,
        max_score_psi=1e6, max_candidate_psi=1e6, max_disagreement_delta=1.0)
    try:
        import time
        import urllib.request

        deadline = time.monotonic() + 30
        while router.registry.ready_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        names = list(EXAMPLE_PATIENT)
        for row in shifted:      # traffic through the router fills its capture
            body = json.dumps({k: float(v) for k, v in zip(names, row)}).encode()
            with urllib.request.urlopen(urllib.request.Request(rurl + "/predict", data=body),
                                        timeout=30) as resp:
                assert resp.status == 200
        loop = loopmod.LearnLoop(model, cap, str(tmp_path / "cand"), rurl,
                                 policy=triggermod.TriggerPolicy(schedule_s=0.01),
                                 cfg=ExperimentConfig.from_dict(FAST), thresholds=thresholds,
                                 poll_interval_s=0.05, min_rows=200, recovery_timeout_s=0.5,
                                 settle_timeout_s=0, device="cpu")
        events = _journaled(tmp_path, lambda: loop.run(max_cycles=1))
        (cycle,) = loop.cycles
        kinds = [e["kind"] for e in events]
        assert kinds.index("learn_trigger") < kinds.index("learn_retrain_start") < \
            kinds.index("learn_shadow_verdict") < kinds.index("learn_cycle_done")
        if gate == "open":
            assert cycle["outcome"] == "promoted", cycle
            assert cycle["promotion"]["deploy"]["result"] == "ok"
            assert kinds.index("fleet_deploy_start") < kinds.index("fleet_deploy_done") < \
                kinds.index("learn_promotion")
            assert checkpoint.checkpoint_version(model) == 2
            assert all(h.model_version == 2 for h in replicas)
            deadline = time.monotonic() + 10      # the registry learns it by probe
            while [r["version"] for r in router.registry.snapshot()] != [2, 2]:
                assert time.monotonic() < deadline, router.registry.snapshot()
                time.sleep(0.05)
        else:
            assert cycle["outcome"] == "refused" and not cycle["verdict"]["pass"]
            assert promotemod.is_parked(tmp_path / "cand")
            assert checkpoint.checkpoint_version(model) == 1
            assert [r["version"] for r in router.registry.snapshot()] == [1, 1]
    finally:
        router.shutdown()
        for h in replicas:
            h.shutdown()

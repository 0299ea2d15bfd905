"""The port's ``train`` route vs the JAX package: ``fit_pipeline`` end to end,
the GBDT member's splitter switch, resumable fits and ``cli train``.

The pipeline cases fit the CLI's development half (``make_cohort(2 · 160,
seed=2020, missing_rate=0.03)``, first 160 rows) with the fast config of
``tests/test_cli.py``; the JAX side runs on the CPU under x64
(``conftest.py``), the port with ``device="cpu"``. The port must select the
same 17 columns, keep the same imputer donors, grow the same forest, and
predict the select half within 1e-6. Resumed fits — a boosting carry every
few stages, or a pipeline stage directory — must equal unbroken ones bit for
bit, and a stage directory written for other inputs is refused.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import ExperimentConfig as JExperimentConfig
from machine_learning_replications_tpu.config import GBDTConfig as JGBDTConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import gbdt as jgbdt
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.utils import metrics as jmetrics
from machine_learning_replications_tpu_torch import cli
from machine_learning_replications_tpu_torch.config import ExperimentConfig, GBDTConfig
from machine_learning_replications_tpu_torch.data.examples import patient_row
from machine_learning_replications_tpu_torch.models import gbdt, pipeline
from machine_learning_replications_tpu_torch.persist import checkpoint

FAST = {
    "gbdt": {"n_estimators": 5},
    "svc": {"platt_cv": 2, "max_iter": 2000},
    "stacking": {"cv_folds": 2},
    "select": {"cv_folds": 3, "n_alphas": 20},
}
N = 160


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The solvers step small tensors many times. Under the suite's xdist
    workers, which share the cores, one intra-op thread per worker keeps
    OpenMP and MKL threads from spinning against each other's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(node):
    """Every tensor/array/static of a parameter tree, in field order."""
    if dataclasses.is_dataclass(node):
        return [x for f in dataclasses.fields(node) for x in _leaves(getattr(node, f.name))]
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _leaves(node[k])]
    if isinstance(node, (tuple, list)):
        return [x for v in node for x in _leaves(v)]
    return [node]


def _assert_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.numpy(), y.numpy())   # NaN donors equal NaN
        else:
            assert x == y


@pytest.fixture(scope="module")
def halves():
    X, y, _ = make_cohort(n=2 * N, seed=2020, missing_rate=0.03)
    return X[:N], y[:N], X[N:], y[N:]


@pytest.fixture(scope="module")
def port_fit(halves):
    Xd, yd, _, _ = halves
    X_before = Xd.copy()
    params, info = pipeline.fit_pipeline(Xd, yd, ExperimentConfig.from_dict(FAST), device="cpu")
    np.testing.assert_array_equal(Xd, X_before)     # the caller's array is never written
    return params, info


@pytest.fixture(scope="module")
def jax_fit(halves):
    Xd, yd, _, _ = halves
    return jpipeline.fit_pipeline(Xd, yd, JExperimentConfig.from_dict(FAST))


def test_fit_pipeline_matches_jax(halves, port_fit, jax_fit):
    Xd, yd, Xs, ys = halves
    params, info = port_fit
    jparams, jinfo = jax_fit
    np.testing.assert_array_equal(params.support_mask.numpy(), np.asarray(jparams.support_mask))
    assert info["n_selected"] == jinfo["n_selected"] == 17
    np.testing.assert_allclose(info["selection"]["alpha_"], jinfo["selection"]["alpha_"],
                               rtol=1e-12)
    np.testing.assert_array_equal(params.imputer.donors.numpy(), np.asarray(jparams.imputer.donors))
    np.testing.assert_allclose(params.imputer.col_means.numpy(),
                               np.asarray(jparams.imputer.col_means), rtol=1e-14)
    g, jg = params.ensemble.gbdt, jparams.ensemble.gbdt
    for f in ("feature", "threshold", "left", "right"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)))
    np.testing.assert_allclose(g.value.numpy(), np.asarray(jg.value), rtol=1e-10, atol=1e-12)
    e, je = params.ensemble, jparams.ensemble
    for got, want in ((e.svc.dual_coef, je.svc.dual_coef), (e.svc.intercept, je.svc.intercept),
                      (e.svc.prob_a, je.svc.prob_a), (e.svc.prob_b, je.svc.prob_b),
                      (e.logreg.coef, je.logreg.coef), (e.meta.coef, je.meta.coef),
                      (e.meta.intercept, je.meta.intercept)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    p1 = pipeline.pipeline_predict_proba1(params, Xs, device="cpu").numpy()
    jp1 = np.asarray(jpipeline.pipeline_predict_proba1(jparams, Xs))
    np.testing.assert_allclose(p1, jp1, rtol=0, atol=1e-6)
    # the quality reference profile rides along, as in JAX
    assert set(params.quality) == set(jparams.quality)
    for k in jparams.quality:
        np.testing.assert_allclose(params.quality[k].numpy(), np.asarray(jparams.quality[k]),
                                   rtol=1e-10, atol=1e-12, err_msg=k)


def test_fit_pipeline_reports_stages_and_solves(port_fit):
    _, info = port_fit
    assert list(info["stage_seconds"]) == [
        "impute", "select", "member_svc", "member_gbdt", "member_lg", "meta_svc_oof",
        "meta_gbdt_oof", "meta_lg_oof", "meta", "quality_profile"]
    its = info["svc_iterations"]
    assert len(its["member_svc"]) == 1 and len(its["member_svc"][0]) == 1 + FAST["svc"]["platt_cv"]
    # the stacking CV's fold fits: one batched solve, (1 + platt_cv) lanes per fold
    assert [len(lanes) for lanes in its["meta_svc_oof"]] == [2 * (1 + FAST["svc"]["platt_cv"])]


@pytest.mark.parametrize("rows", [713, 16_383, 16_384, 50_000, 60_000, 99_999, 100_000])
@pytest.mark.parametrize("features", [17, 64])
def test_scaled_member_cfg_matches_jax(rows, features):
    for cfg, jcfg in ((GBDTConfig(), JGBDTConfig()),
                      (GBDTConfig(max_depth=2), JGBDTConfig(max_depth=2)),
                      (GBDTConfig(splitter="hist"), JGBDTConfig(splitter="hist"))):
        got = gbdt.scaled_member_cfg(cfg, rows, features)
        want = jgbdt.scaled_member_cfg(jcfg, rows, features)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert gbdt._stump_layout_bytes(rows, features, rows) == jgbdt._stump_layout_bytes(
        rows, features, rows)


@pytest.fixture(scope="module")
def x17():
    X, y, _ = make_cohort(n=500, seed=2020)
    return np.ascontiguousarray(X[:, selected_indices()]), y


@pytest.mark.parametrize("depth", [1, 2])
def test_fit_resumable_resumes_bit_identical(tmp_path, x17, depth):
    X, y = x17
    cfg = GBDTConfig(n_estimators=12, max_depth=depth)
    unbroken, aux = gbdt.fit_resumable(X, y, cfg, checkpoint_dir=str(tmp_path / "a"),
                                       checkpoint_every=5, device="cpu")
    ck = str(tmp_path / "b")
    with pytest.raises(checkpoint.SimulatedInterrupt):
        gbdt.fit_resumable(X, y, cfg, checkpoint_dir=ck, checkpoint_every=5,
                           _interrupt_after_chunks=2, device="cpu")
    assert checkpoint._steps(ck) == [10, 5]
    resumed, aux2 = gbdt.fit_resumable(X, y, cfg, checkpoint_dir=ck, checkpoint_every=5,
                                       device="cpu")
    _assert_identical(resumed, unbroken)
    np.testing.assert_array_equal(aux2["train_deviance"], aux["train_deviance"])
    assert checkpoint._steps(ck) == [12, 10]          # the newest two are kept
    # the same fit as the one-shot grower on the same host bins, and as JAX's
    direct, daux = gbdt.fit(X, y, cfg, device="cpu")
    _assert_identical(unbroken, direct)
    jparams, jaux = jgbdt.fit_resumable(X, y, JGBDTConfig(n_estimators=12, max_depth=depth),
                                        checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=5)
    for f in ("feature", "threshold", "left", "right"):
        np.testing.assert_array_equal(getattr(unbroken, f).numpy(), np.asarray(getattr(jparams, f)))
    np.testing.assert_allclose(unbroken.value.numpy(), np.asarray(jparams.value), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(aux["train_deviance"], np.asarray(jaux["train_deviance"]),
                               rtol=1e-10)


def test_fit_resumable_skips_a_corrupt_step(tmp_path, x17):
    X, y = x17
    cfg = GBDTConfig(n_estimators=9)
    ck = str(tmp_path / "c")
    with pytest.raises(checkpoint.SimulatedInterrupt):
        gbdt.fit_resumable(X, y, cfg, checkpoint_dir=ck, checkpoint_every=3,
                           _interrupt_after_chunks=2, device="cpu")
    newest = checkpoint._step_path(ck, 6)
    with open(os.path.join(newest, checkpoint.TENSORS_FILE), "r+b") as f:
        f.write(b"torn")
    resumed, _ = gbdt.fit_resumable(X, y, cfg, checkpoint_dir=ck, checkpoint_every=3,
                                    device="cpu")
    _assert_identical(resumed, gbdt.fit(X, y, cfg, device="cpu")[0])


def test_stage_checkpointer_guards(tmp_path):
    calls = {"n": 0}

    def compute():
        calls["n"] += 1
        return (torch.arange(4.0), {"b": torch.ones(3)}, 2.5, -1)

    root = str(tmp_path / "s")
    ck = checkpoint.StageCheckpointer(root, device="cpu", fingerprint="f" * 64)
    out = ck.run("a", compute)
    again = checkpoint.StageCheckpointer(root, device="cpu", fingerprint="f" * 64).run("a", compute)
    assert calls["n"] == 1
    _assert_identical(again, out)
    assert isinstance(again, tuple) and again[2] == 2.5 and again[3] == -1
    with pytest.raises(RuntimeError, match="different inputs"):
        checkpoint.StageCheckpointer(root, device="cpu", fingerprint="0" * 64)
    # completed stages but no (readable) fingerprint: refused
    with open(os.path.join(root, checkpoint.FINGERPRINT_FILE), "w") as f:
        f.write('{"fingerp')
    with pytest.raises(RuntimeError, match="no fingerprint"):
        checkpoint.StageCheckpointer(root, device="cpu", fingerprint="f" * 64)
    # a torn fingerprint over an empty directory is simply rewritten
    empty = str(tmp_path / "e")
    os.makedirs(empty)
    with open(os.path.join(empty, checkpoint.FINGERPRINT_FILE), "w") as f:
        f.write("{")
    checkpoint.StageCheckpointer(empty, device="cpu", fingerprint="1" * 64)
    with open(os.path.join(empty, checkpoint.FINGERPRINT_FILE)) as f:
        assert json.load(f) == {"fingerprint": "1" * 64}
    # a torn stage is discarded and recomputed, then whole again
    ck = checkpoint.StageCheckpointer(str(tmp_path / "t"), device="cpu")
    ck.run("a", compute)
    with open(os.path.join(str(tmp_path / "t"), "a", checkpoint.SIDECAR_FILE), "w") as f:
        f.write('{"format": 1, "root": {"seq": [')
    _assert_identical(ck.run("a", compute), out)
    assert calls["n"] == 3
    ck.run("a", compute)
    assert calls["n"] == 3


@pytest.mark.parametrize("stop_after", ["member_gbdt", "meta_gbdt_oof"])
def test_pipeline_stage_resume_equals_unbroken(tmp_path, halves, port_fit, stop_after):
    Xd, yd, _, _ = halves
    cfg = ExperimentConfig.from_dict(FAST)
    ckdir = str(tmp_path / "stages")
    with pytest.raises(checkpoint.SimulatedInterrupt):
        pipeline.fit_pipeline(Xd, yd, cfg, checkpoint_dir=ckdir, _interrupt_after=stop_after,
                              device="cpu")
    ck = checkpoint.StageCheckpointer(ckdir, device="cpu")
    assert ck.completed("impute") and ck.completed(stop_after) and not ck.completed("meta")
    resumed, info = pipeline.fit_pipeline(Xd, yd, cfg, checkpoint_dir=ckdir, device="cpu")
    assert "impute" not in info["stage_seconds"]          # restored, not recomputed
    assert ck.completed("quality_profile")
    _assert_identical(resumed, port_fit[0])
    with pytest.raises(RuntimeError, match="different inputs"):
        pipeline.fit_pipeline(Xd[:150], yd[:150], cfg, checkpoint_dir=ckdir, device="cpu")


def _run_cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli_train(tmp_path_factory):
    """``cli train --device cpu --synthetic 160 --config <fast> --save DIR``:
    ``(stdout, config path, checkpoint path)``."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = tmp / "fast.json"
    cfg_path.write_text(json.dumps(FAST))
    model = str(tmp / "model")
    out = _run_cli(["train", "--device", "cpu", "--synthetic", str(N), "--config",
                    str(cfg_path), "--save", model])
    return out, cfg_path, model


def test_cli_train_then_predict(cli_train, halves, jax_fit):
    out, _, model = cli_train
    # the JAX package's evaluation of its own fit on the same select half
    _, _, Xs, ys = halves
    jp1 = np.asarray(jpipeline.pipeline_predict_proba1(jax_fit[0], Xs))
    auc = float(jmetrics.roc_auc(jnp.asarray(ys), jnp.asarray(jp1)))
    ap = float(jmetrics.average_precision(jnp.asarray(ys), jnp.asarray(jp1)))
    assert f"AUC-ROC {auc:.4f}   average precision {ap:.4f}" in out
    rep = jmetrics.classification_report(jnp.asarray(ys), jnp.asarray((jp1 > 0.5).astype(float)))
    assert jmetrics.report_text(rep) in out
    params = checkpoint.load_model(model, device="cpu")
    assert isinstance(params, pipeline.PipelineParams) and params.quality is not None
    line = _run_cli(["predict", "--model", model, "--device", "cpu"]).strip()
    want = cli.predict_proba1(params, patient_row(), torch.device("cpu"))
    assert line == f"Probability of progressive HF is: {100.0 * want:.2f} %"


def test_cli_train_reads_mat_cohorts(tmp_path, halves, cli_train):
    from machine_learning_replications_tpu_torch.data import load_data, save_data

    out, cfg_path, _ = cli_train
    Xd, yd, Xs, ys = halves
    names = np.array([[f"v{i}" for i in range(64)]], dtype=object)
    save_data(str(tmp_path / "dev.mat"), Xd, yd, names)
    save_data(str(tmp_path / "sel.mat"), Xs, ys, names)
    np.testing.assert_array_equal(load_data(str(tmp_path / "dev.mat"))[0], Xd)
    mat = _run_cli(["train", "--device", "cpu", "--develop", str(tmp_path / "dev.mat"),
                    "--select", str(tmp_path / "sel.mat"), "--config", str(cfg_path)])
    assert mat == out


def test_cli_train_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["train", "--synthetic", "40"])

"""The port's data-parallel paths (``parallel/``) vs the JAX package's.

The port runs one process per rank on ``torch.distributed`` with gloo on the
CPU; JAX runs one process over conftest's 8 virtual CPU devices under x64.
Each multi-rank world — meshes ``(2, 1)``, ``(1, 2)`` and ``(2, 2)`` — is
spawned once, as ranks of this file run as a script with a rendezvous on a
free localhost port; every rank runs every check of its mesh shape and
writes its results to an ``.npz``. The ``(1, 1)`` mesh runs in this process
without a process group. The worlds start first and run while this process
computes JAX's side, so the file costs a few interpreter starts.

Tolerances are those of ``tests/test_distributed.py`` and
``tests/test_hist_trainer.py`` (float64): split features equal, thresholds
to rtol 1e-12, leaf values to rtol 1e-9 / atol 1e-12, deviance to rtol 1e-9;
the cross-validated meta-features to rtol 1e-7 / atol 1e-9. Every rank's
results must be bit-identical: the forests are replicated by construction.

The ``(2, 1)`` world also runs a stage-checkpointed ``fit_pipeline`` that
is interrupted and resumed on a directory both ranks share, and
``warm_refit(mesh=)`` against the single-device refit on the same rows.

The two-rank ``cli train --mesh 2 --distributed --resume-dir`` runs as two
CPU processes; its AUC line must equal JAX's ``cli train --mesh 2``, and
rank 1 must write nothing into its ``--save`` or ``--journal`` path. The
pair then runs again on the stages an interruption after ``meta_svc_oof``
would have left, restores them on both ranks and prints the same line.

The card's cases (a one-rank NCCL world, two gloo ranks sharing the card)
are in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from machine_learning_replications_tpu_torch.config import (  # noqa: E402
    ExperimentConfig,
    GBDTConfig,
    SweepConfig,
)
from machine_learning_replications_tpu_torch.data import make_cohort, selected_indices  # noqa: E402
from machine_learning_replications_tpu_torch.ops import binning  # noqa: E402
from machine_learning_replications_tpu_torch.utils.cv import stratified_kfold_test_masks  # noqa: E402
from machine_learning_replications_tpu_torch.parallel import (  # noqa: E402
    distributed,
    fit_gbdt_sharded,
    hist_trainer,
    make_mesh,
    select_trainer,
    single_device_mesh,
    stump_trainer,
)

FAST = {
    "gbdt": {"n_estimators": 5},
    "svc": {"platt_cv": 2, "max_iter": 2000},
    "stacking": {"cv_folds": 2},
    "select": {"cv_folds": 3, "n_alphas": 20},
}
N_HALF = 160
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]

# The checks each mesh shape runs (every shape runs 'stump').
CASES = {
    (1, 1): ("stump",),
    (2, 1): ("stump", "weighted", "guard", "hist2", "lasso", "cvmeta", "sweep", "pipeline",
             "resume", "refit", "agree"),
    (1, 2): ("stump", "padded"),
    (2, 2): ("stump", "padded", "weighted", "hist3", "lasso"),
}


# ---------------------------------------------------------------------------
# inputs (numpy only: the same arrays go to both packages)
# ---------------------------------------------------------------------------


def train_data():
    """``tests/test_distributed.py``'s fixture: 700 x 17, binary and
    few-valued columns."""
    rng = np.random.default_rng(13)
    n, f = 700, 17
    X = rng.normal(size=(n, f))
    X[:, :12] = (X[:, :12] > 0.4).astype(float)
    X[:, 12:] = np.round(X[:, 12:] * 6) / 3
    w = rng.normal(size=f)
    y = (X @ w + 0.8 * rng.normal(size=n) > 0.3).astype(float)
    return X, y


def fold_weights(n: int) -> np.ndarray:
    return (np.arange(n) % 4 != 0).astype(float)


def cohort17():
    X, y, _ = make_cohort(n=1427, seed=2020)
    return X[:, selected_indices()], y


def halves():
    X, y, _ = make_cohort(n=2 * N_HALF, seed=2020, missing_rate=0.03)
    return X[:N_HALF], y[:N_HALF], X[N_HALF:], y[N_HALF:]


def lasso_data():
    X, y, _ = make_cohort(n=403, seed=7)
    return X, y


# ---------------------------------------------------------------------------
# the port's side: every check of a mesh shape, on one rank
# ---------------------------------------------------------------------------


def _forest(params, aux) -> dict:
    return {"feature": params.feature.numpy(), "threshold": params.threshold.numpy(),
            "value": params.value.numpy(), "init_raw": params.init_raw.numpy(),
            "deviance": np.asarray(aux["train_deviance"])}


PIPELINE_KEYS = ("support_mask", "donors", "gbdt_feature", "gbdt_threshold", "gbdt_value",
                 "svc_dual_coef", "svc_prob_a", "logreg_coef", "meta_coef")


def _pipeline_arrays(params) -> dict:
    """``PIPELINE_KEYS`` of a fitted ``PipelineParams`` as numpy arrays."""
    e = params.ensemble
    return {
        "support_mask": params.support_mask.numpy(),
        "donors": params.imputer.donors.numpy(),
        "gbdt_feature": e.gbdt.feature.numpy(), "gbdt_threshold": e.gbdt.threshold.numpy(),
        "gbdt_value": e.gbdt.value.numpy(),
        "svc_dual_coef": e.svc.dual_coef.numpy(), "svc_prob_a": e.svc.prob_a.numpy(),
        "logreg_coef": e.logreg.coef.numpy(), "meta_coef": e.meta.coef.numpy(),
    }


# The stages an interruption right after 'meta_svc_oof' leaves undone
# ('meta' holds the three meta_*_oof stages).
UNDONE_AFTER_META_SVC = ("meta", "meta_gbdt_oof", "meta_lg_oof", "quality_profile")


def run_checks(mesh, workdir: str) -> dict:
    """Every check of ``mesh``'s shape → a flat dict of numpy arrays.
    ``workdir`` is a directory every rank of the mesh shares."""
    from machine_learning_replications_tpu_torch.learn.retrain import warm_refit
    from machine_learning_replications_tpu_torch.models import pipeline, sweep
    from machine_learning_replications_tpu_torch.parallel import stump_trainer as st
    from machine_learning_replications_tpu_torch.parallel.mesh import agree
    from machine_learning_replications_tpu_torch.persist.checkpoint import (
        SimulatedInterrupt,
        load_model,
    )

    shape = (mesh.shape["data"], mesh.shape["model"])
    out = {}

    def put(case, d):
        out.update({f"{case}.{k}": np.asarray(v) for k, v in d.items()})

    X, y = train_data()
    for case in CASES[shape]:
        if case == "stump":
            put(case, _forest(*stump_trainer.fit(mesh, X, y, GBDTConfig(n_estimators=12))))
        elif case == "padded":  # 697 rows, 5 features: padding on both axes
            put(case, _forest(*stump_trainer.fit(mesh, X[:697, :5], y[:697],
                                                 GBDTConfig(n_estimators=8))))
        elif case == "weighted":
            cfg = GBDTConfig(n_estimators=10, splitter="hist")
            put(case, _forest(*stump_trainer.fit(mesh, X, y, cfg, bins=binning.bin_features(X, 256),
                                                 sample_weight=fold_weights(len(y)))))
        elif case == "guard":
            cfg = GBDTConfig(n_estimators=6, splitter="hist")
            try:
                stump_trainer.fit(mesh, X, y, cfg, max_layout_bytes=64)
                refused = ""
            except RuntimeError as exc:
                refused = str(exc)
            old, st.MAX_LAYOUT_BYTES = st.MAX_LAYOUT_BYTES, 64
            try:
                put(case, {**_forest(*fit_gbdt_sharded(mesh, X, y, cfg)), "refused": refused})
            finally:
                st.MAX_LAYOUT_BYTES = old
        elif case in ("hist2", "hist3"):
            Xc, yc = cohort17()
            cfg = GBDTConfig(n_estimators=6, max_depth=int(case[-1]), splitter="hist", n_bins=32)
            put(case, _forest(*hist_trainer.fit(mesh, Xc, yc, cfg)))
        elif case == "lasso":
            Xl, yl = lasso_data()
            put(case, {k: v.numpy() for k, v in
                       select_trainer.lasso_fold_stats_sharded(mesh, Xl, yl, 5).items()})
        elif case == "cvmeta":
            meta = pipeline.cross_val_member_probas(X[:N_HALF], y[:N_HALF],
                                                    ExperimentConfig.from_dict(FAST), mesh=mesh,
                                                    device="cpu")
            put(case, {"meta": meta.numpy()})
        elif case == "sweep":
            scfg = SweepConfig(n_estimators_grid=(5, 12), max_depth_grid=(1, 2), cv_folds=3)
            res = sweep.cv_sweep(X, y, scfg, mesh=mesh, device="cpu")
            refit, _ = sweep.refit_best(X, y, res, mesh=mesh, device="cpu")
            put(case, {"fold_auc": res.fold_auc, "best": [res.best_max_depth,
                                                          res.best_n_estimators],
                       "refit_feature": refit.feature.numpy(), "refit_value": refit.value.numpy()})
        elif case == "pipeline":
            Xd, yd, Xs, _ = halves()
            params, info = pipeline.fit_pipeline(Xd, yd, ExperimentConfig.from_dict(FAST),
                                                 mesh=mesh, device="cpu")
            put(case, {
                **_pipeline_arrays(params),
                "alpha_": info["selection"]["alpha_"],
                "p1": pipeline.pipeline_predict_proba1(params, Xs, mesh=mesh,
                                                       device="cpu").numpy(),
                "p1_chunked": pipeline.pipeline_predict_proba1(params, Xs, 37, mesh=mesh,
                                                               device="cpu").numpy(),
                "X_imp": pipeline.knn_impute.transform(params.imputer, Xs, chunk_rows=50,
                                                       mesh=mesh).numpy(),
            })
        elif case == "resume":  # interrupted, then resumed, on one shared directory
            Xd, yd, _, _ = halves()
            ckpt = os.path.join(workdir, "pipeline_ckpt")
            cfg = ExperimentConfig.from_dict(FAST)
            try:
                pipeline.fit_pipeline(Xd, yd, cfg, ckpt, "meta_svc_oof", mesh=mesh, device="cpu")
                interrupted = False
            except SimulatedInterrupt:
                interrupted = True
            params, info = pipeline.fit_pipeline(Xd, yd, cfg, ckpt, mesh=mesh, device="cpu")
            put(case, {**_pipeline_arrays(params), "interrupted": interrupted,
                       "recomputed": sorted(info["stage_seconds"])})
        elif case == "refit":  # the live model is the pipeline case's
            _, _, Xs, ys = halves()
            X17 = pipeline.knn_impute.transform(params.imputer, Xs).numpy()[:, selected_indices()]
            kw = dict(cfg=ExperimentConfig.from_dict(FAST), labels=ys, min_rows=100,
                      device="cpu")
            cand, info = warm_refit(params, X17, os.path.join(workdir, "candidate"),
                                    resume_dir=os.path.join(workdir, "refit_ckpt"), mesh=mesh,
                                    **kw)
            one, _ = warm_refit(params, X17, os.path.join(workdir, f"one{mesh.rank}"), **kw)
            saved = load_model(os.path.join(workdir, "candidate"), device="cpu")
            put(case, {**_pipeline_arrays(cand), "version": info["version"],
                       **{f"one_{k}": v for k, v in _pipeline_arrays(one).items()},
                       **{f"saved_{k}": v for k, v in _pipeline_arrays(saved).items()}})
        elif case == "agree":  # rank 0's host work fails: every rank raises
            def publish():
                if mesh.rank == 0:
                    raise OSError("simulated failed publish")

            try:
                agree(mesh, publish)
                raised = ""
            except Exception as exc:
                raised = type(exc).__name__
            out[f"{case}.raised.rank{mesh.rank}"] = np.asarray(raised)
    return out


def _worker(data: int, model: int, rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize_distributed(f"127.0.0.1:{port}", data * model, rank, device="cpu")
    try:
        res = run_checks(make_mesh(data, model, device="cpu"), out_dir)
    finally:
        distributed.shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the worlds (spawned once) and JAX's side
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    return env


def _spawn_worlds(tmp: Path) -> list:
    procs = []
    for data, model in SHAPES[1:]:
        port = _free_port()
        out = tmp / f"world_{data}x{model}"
        out.mkdir()
        for rank in range(data * model):
            procs.append(((data, model), rank, subprocess.Popen(
                [sys.executable, __file__, str(data), str(model), str(rank), str(port), str(out)],
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _cli_pair(tmp: Path, tag: str) -> list:
    """Two ranks of ``cli train --mesh 2 --distributed`` on one shared
    ``--resume-dir`` → ``[(stdout, stderr, returncode)]`` per rank."""
    cfg = tmp / "fast.json"
    cfg.write_text(json.dumps(FAST))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank))
        argv = ["train", "--device", "cpu", "--synthetic", str(N_HALF), "--config", str(cfg),
                "--mesh", "2", "--distributed", "--save", str(tmp / f"save{tag}{rank}"),
                "--journal", str(tmp / f"journal{tag}{rank}.jsonl"),
                "--resume-dir", str(tmp / "cli_ckpt")]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "machine_learning_replications_tpu_torch", *argv], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return [p.communicate(timeout=600) + (p.returncode,) for p in procs]


def _cli_runs(tmp: Path) -> dict:
    """The CLI pair on a fresh ``--resume-dir``, then again on what an
    interruption after 'meta_svc_oof' would have left there."""
    first = _cli_pair(tmp, "")
    if any(rc for _, _, rc in first):
        return {"first": first, "resumed": []}
    for stage in UNDONE_AFTER_META_SVC:
        shutil.rmtree(tmp / "cli_ckpt" / stage)
    return {"first": first, "resumed": _cli_pair(tmp, "resumed")}


def _jax_side(tmp: Path) -> dict:
    """JAX's results for every (shape, case) the worlds run, and its ``cli
    train --mesh 2`` line."""
    from machine_learning_replications_tpu import cli as jcli
    from machine_learning_replications_tpu.config import ExperimentConfig as JExp
    from machine_learning_replications_tpu.config import GBDTConfig as JG
    from machine_learning_replications_tpu.config import SweepConfig as JSweep
    from machine_learning_replications_tpu.data import make_cohort as jcohort
    from machine_learning_replications_tpu.models import gbdt as jgbdt
    from machine_learning_replications_tpu.models import knn_impute as jimpute
    from machine_learning_replications_tpu.models import pipeline as jpipeline
    from machine_learning_replications_tpu.models import sweep as jsweep
    from machine_learning_replications_tpu.ops import binning as jbinning
    from machine_learning_replications_tpu.parallel import fit_gbdt_sharded as jfit_sharded
    from machine_learning_replications_tpu.parallel import hist_trainer as jht
    from machine_learning_replications_tpu.parallel import make_mesh as jmesh
    from machine_learning_replications_tpu.parallel import select_trainer as jsel
    from machine_learning_replications_tpu.parallel import stump_trainer as jst

    np.testing.assert_array_equal(jcohort(n=1427, seed=2020)[0], make_cohort(n=1427, seed=2020)[0])

    def forest(res):
        p, aux = res
        return {"feature": np.asarray(p.feature), "threshold": np.asarray(p.threshold),
                "value": np.asarray(p.value), "init_raw": np.asarray(p.init_raw),
                "deviance": np.asarray(aux["train_deviance"])}

    X, y = train_data()
    want = {}
    for shape in SHAPES:
        m = jmesh(*shape)
        for case in CASES[shape]:
            key = (shape, case)
            if case == "stump":
                want[key] = forest(jst.fit(m, X, y, JG(n_estimators=12)))
            elif case == "padded":
                want[key] = forest(jst.fit(m, X[:697, :5], y[:697], JG(n_estimators=8)))
            elif case == "weighted":
                w = fold_weights(len(y))
                cfg = JG(n_estimators=10, splitter="hist")
                bins = jbinning.bin_features(X, 256)
                want[key] = forest(jst.fit(m, X, y, cfg, bins=bins, sample_weight=w))
                sub = jbinning.BinnedFeatures(binned=bins.binned[w > 0],
                                              thresholds=bins.thresholds, n_bins=bins.n_bins)
                want[(shape, "subset")] = forest(jgbdt.fit(X[w > 0], y[w > 0], cfg, bins=sub))
            elif case == "guard":
                old, jst.MAX_LAYOUT_BYTES = jst.MAX_LAYOUT_BYTES, 64
                try:
                    want[key] = forest(jfit_sharded(m, X, y, JG(n_estimators=6, splitter="hist")))
                finally:
                    jst.MAX_LAYOUT_BYTES = old
            elif case in ("hist2", "hist3"):
                Xc, yc = cohort17()
                cfg = JG(n_estimators=6, max_depth=int(case[-1]), splitter="hist", n_bins=32)
                want[key] = forest(jht.fit(m, Xc, yc, cfg))
            elif case == "lasso":
                Xl, yl = lasso_data()
                want[key] = {k: np.asarray(v) for k, v in
                             jsel.lasso_fold_stats_sharded(m, Xl, yl, 5).items()}
            elif case == "cvmeta":
                # the pipeline case's shapes and config: JAX compiles once
                want[key] = {"meta": jpipeline.cross_val_member_probas(
                    X[:N_HALF], y[:N_HALF], JExp.from_dict(FAST), mesh=m)}
            elif case == "sweep":
                scfg = JSweep(n_estimators_grid=(5, 12), max_depth_grid=(1, 2), cv_folds=3)
                res = jsweep.cv_sweep(X, y, scfg, mesh=m)
                refit, _ = jsweep.refit_best(X, y, res, mesh=m)
                want[key] = {"fold_auc": res.fold_auc,
                             "best": np.asarray([res.best_max_depth, res.best_n_estimators]),
                             "refit_feature": np.asarray(refit.feature),
                             "refit_value": np.asarray(refit.value)}
            elif case == "pipeline":
                Xd, yd, Xs, _ = halves()
                params, info = jpipeline.fit_pipeline(Xd, yd, JExp.from_dict(FAST), mesh=m)
                e = params.ensemble
                want[key] = {
                    "support_mask": np.asarray(params.support_mask),
                    "donors": np.asarray(params.imputer.donors),
                    "alpha_": np.asarray(info["selection"]["alpha_"]),
                    "gbdt_feature": np.asarray(e.gbdt.feature),
                    "gbdt_threshold": np.asarray(e.gbdt.threshold),
                    "gbdt_value": np.asarray(e.gbdt.value),
                    "svc_dual_coef": np.asarray(e.svc.dual_coef),
                    "svc_prob_a": np.asarray(e.svc.prob_a),
                    "logreg_coef": np.asarray(e.logreg.coef),
                    "meta_coef": np.asarray(e.meta.coef),
                    "p1": np.asarray(jpipeline.pipeline_predict_proba1(params, Xs, mesh=m)),
                    "X_imp": np.asarray(jimpute.transform(params.imputer, Xs, chunk_rows=50,
                                                          mesh=m)),
                }
    cfg = tmp / "jax_fast.json"
    cfg.write_text(json.dumps(FAST))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert jcli.main(["train", "--synthetic", str(N_HALF), "--config", str(cfg),
                          "--mesh", "2"]) == 0
    want["cli_line"] = buf.getvalue().strip().splitlines()[-1]
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"port": {shape: [per-rank dict]}, "jax": {...}, "cli": [(out, err)],
    "tmp": dir}``: the worlds and the CLI pair start, JAX computes its side
    meanwhile, the (1, 1) mesh runs here, then every process is awaited."""
    tmp = tmp_path_factory.mktemp("parallel")
    worlds = _spawn_worlds(tmp)
    with ThreadPoolExecutor(1) as pool:
        cli_runs = pool.submit(_cli_runs, tmp)
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            jax_want = _jax_side(tmp)
            port = {(1, 1): [run_checks(single_device_mesh(device="cpu"), str(tmp))]}
        finally:
            torch.set_num_threads(n_threads)
            logs = {}
            for shape, rank, p in worlds:
                logs[(shape, rank)] = p.communicate(timeout=600)[0]
            cli = cli_runs.result()
    for shape, rank, p in worlds:
        assert p.returncode == 0, f"rank {rank} of {shape}:\n{logs[(shape, rank)][-3000:]}"
        with np.load(tmp / f"world_{shape[0]}x{shape[1]}" / f"rank{rank}.npz") as z:
            port.setdefault(shape, []).append(dict(z))
    for run in ("first", "resumed"):
        assert len(cli[run]) == 2, f"the {run} CLI pair did not run"
        for _, err, rc in cli[run]:
            assert rc == 0, err[-3000:]
    return {"port": port, "jax": jax_want, "cli": cli, "tmp": tmp}


def _case(runs, shape, case) -> dict:
    """Rank 0's results of ``case`` at ``shape``, after holding every other
    rank's to them bit for bit."""
    ranks = runs["port"][shape]
    got = {k[len(case) + 1:]: v for k, v in ranks[0].items()
           if k.startswith(case + ".") and ".rank" not in k}
    assert got, f"no {case} results at {shape}"
    for other in ranks[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(other[f"{case}.{k}"], v, err_msg=f"replica {k}")
    return got


def _assert_forest(got: dict, want: dict, value_rtol=1e-9, value_atol=1e-12) -> None:
    np.testing.assert_array_equal(got["feature"], want["feature"])
    np.testing.assert_allclose(got["threshold"], want["threshold"], rtol=1e-12)
    np.testing.assert_allclose(got["value"], want["value"], rtol=value_rtol, atol=value_atol)
    np.testing.assert_allclose(got["init_raw"], want["init_raw"], rtol=1e-12)
    np.testing.assert_allclose(got["deviance"], want["deviance"], rtol=1e-9)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_stump_trainer_matches_jax(runs, shape):
    _assert_forest(_case(runs, shape, "stump"), runs["jax"][(shape, "stump")])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_padded_model_shards_and_uneven_rows_match_jax(runs, shape):
    got = _case(runs, shape, "padded")
    _assert_forest(got, runs["jax"][(shape, "padded")])
    assert got["feature"].max() < 5


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sample_weight_matches_jax_and_the_subset_fit(runs, shape):
    got = _case(runs, shape, "weighted")
    _assert_forest(got, runs["jax"][(shape, "weighted")])
    subset = runs["jax"][(shape, "subset")]
    np.testing.assert_array_equal(got["feature"], subset["feature"])
    np.testing.assert_allclose(got["value"], subset["value"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["init_raw"], subset["init_raw"], rtol=1e-12)


def test_layout_guard_refuses_then_falls_through_to_hist_trainer(runs):
    got = _case(runs, (2, 1), "guard")
    assert "per-shard working set" in str(got["refused"])
    assert got["feature"].shape == (6, 3)
    _assert_forest(got, runs["jax"][((2, 1), "guard")])


@pytest.mark.parametrize("shape,case", [((2, 1), "hist2"), ((2, 2), "hist3")])
def test_hist_trainer_matches_jax(runs, shape, case):
    _assert_forest(_case(runs, shape, case), runs["jax"][(shape, case)])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_lasso_fold_stats_match_jax(runs, shape):
    got, want = _case(runs, shape, "lasso"), runs["jax"][(shape, "lasso")]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9, err_msg=k)


def test_lasso_fold_stats_equal_the_single_device_stats():
    from machine_learning_replications_tpu_torch.models import solvers

    X, y = lasso_data()
    got = select_trainer.lasso_fold_stats_sharded(single_device_mesh(device="cpu"), X, y, 5)
    want = solvers.lasso_fold_stats(torch.as_tensor(X), torch.as_tensor(y), 5)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-9)


def test_cross_val_member_probas_matches_jax(runs):
    got, want = _case(runs, (2, 1), "cvmeta"), runs["jax"][((2, 1), "cvmeta")]
    np.testing.assert_allclose(got["meta"], want["meta"], rtol=1e-7, atol=1e-9)


def test_cv_sweep_and_refit_match_jax(runs):
    """The fold AUCs may differ by one discordant pair: the two ranks add
    their partial sums in another order than JAX's two devices do, which
    moves leaf values by ~1e-15 (JAX's own (2, 1) leaves differ from its
    single-device leaves by as much), and two held-out rows whose
    probabilities tie to within that can swap ranks."""
    got, want = _case(runs, (2, 1), "sweep"), runs["jax"][((2, 1), "sweep")]
    X, y = train_data()
    one_pair = min(1.0 / (tm @ y * tm @ (1 - y))
                   for tm in stratified_kfold_test_masks(y, 3))
    np.testing.assert_allclose(got["fold_auc"], want["fold_auc"], rtol=0,
                               atol=one_pair * (1 + 1e-9))
    np.testing.assert_array_equal(got["best"], want["best"])
    np.testing.assert_array_equal(got["refit_feature"], want["refit_feature"])
    np.testing.assert_allclose(got["refit_value"], want["refit_value"], rtol=1e-9, atol=1e-12)


def test_fit_pipeline_on_a_mesh_matches_jax(runs):
    """The slice as a whole: impute, select, stack, profile and predict with
    every row-parallel stage sharded over two ranks."""
    got, want = _case(runs, (2, 1), "pipeline"), runs["jax"][((2, 1), "pipeline")]
    np.testing.assert_array_equal(got["support_mask"], want["support_mask"])
    np.testing.assert_array_equal(got["donors"], want["donors"])
    np.testing.assert_allclose(got["alpha_"], want["alpha_"], rtol=1e-12)
    np.testing.assert_array_equal(got["gbdt_feature"], want["gbdt_feature"])
    np.testing.assert_array_equal(got["gbdt_threshold"], want["gbdt_threshold"])
    np.testing.assert_allclose(got["gbdt_value"], want["gbdt_value"], rtol=1e-10, atol=1e-12)
    for k in ("svc_dual_coef", "svc_prob_a", "logreg_coef", "meta_coef"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["p1"], want["p1"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["p1_chunked"], got["p1"])
    np.testing.assert_array_equal(got["X_imp"], want["X_imp"])


def _assert_same_pipeline(got: dict, want: dict, prefix: str = "") -> None:
    """Mesh vs single-device fits: trees and masks equal, leaf values and
    the replicated members' coefficients to the partial sums' order."""
    for k in ("support_mask", "donors", "gbdt_feature", "gbdt_threshold"):
        np.testing.assert_array_equal(got[k], want[prefix + k], err_msg=k)
    np.testing.assert_allclose(got["gbdt_value"], want[prefix + "gbdt_value"], rtol=1e-10,
                               atol=1e-12)
    for k in ("svc_dual_coef", "svc_prob_a", "logreg_coef", "meta_coef"):
        np.testing.assert_allclose(got[k], want[prefix + k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_fit_pipeline_on_a_mesh_resumes_from_a_shared_checkpoint_dir(runs):
    """Both ranks checkpoint into one directory (rank 0 writing), are
    interrupted after 'meta_svc_oof', and resume: the finished stages are
    restored on both ranks, the rest recomputed, and the model equals the
    unbroken fit's bit for bit."""
    got = _case(runs, (2, 1), "resume")
    unbroken = _case(runs, (2, 1), "pipeline")
    assert bool(got["interrupted"])
    assert sorted(got["recomputed"]) == sorted(UNDONE_AFTER_META_SVC)
    for k in PIPELINE_KEYS:
        np.testing.assert_array_equal(got[k], unbroken[k], err_msg=k)
    ckpt = runs["tmp"] / "world_2x1" / "pipeline_ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == sorted(
        ["fingerprint.json", "impute", "select", "member_svc", "member_gbdt", "member_lg",
         "meta_svc_oof", *UNDONE_AFTER_META_SVC])


def test_warm_refit_on_a_mesh_equals_the_single_device_refit(runs):
    """``warm_refit(mesh=)``: every rank returns the candidate rank 0
    published, equal to the single-device refit on the same rows."""
    got = _case(runs, (2, 1), "refit")
    _assert_same_pipeline(got, got, "one_")
    for k in PIPELINE_KEYS:
        np.testing.assert_array_equal(got["saved_" + k], got[k], err_msg=k)
    assert int(got["version"]) >= 1
    assert not (runs["tmp"] / "world_2x1" / "candidate.lastgood").exists()


def test_a_failure_on_rank0_raises_on_every_rank(runs):
    ranks = runs["port"][(2, 1)]
    assert [str(r[f"agree.raised.rank{i}"]) for i, r in enumerate(ranks)] == [
        "OSError", "RuntimeError"]


def test_cli_train_on_two_ranks_prints_jax_line_and_rank1_writes_nothing(runs):
    tmp = runs["tmp"]
    (out0, err0, _), (out1, err1, _) = runs["cli"]["first"]
    want = runs["jax"]["cli_line"]
    assert want.startswith("AUC-ROC ")
    assert out0.strip().splitlines()[-1] == want
    assert out1.strip().splitlines()[-1] == want
    assert "distributed runtime up (gloo: 2 rank(s) on the CPU" in err0
    assert "mesh {'data': 2, 'model': 1}" in err1
    assert (tmp / "save0" / "model.json").exists() and not (tmp / "save1").exists()
    assert not (tmp / "journal1.jsonl").exists()
    for rank in range(2):
        path = tmp / (f"journal{rank}.jsonl" + ("" if rank == 0 else ".rank1"))
        records = [json.loads(line) for line in path.read_text().splitlines()]
        man = records[0]
        assert man["kind"] == "manifest" and man["mesh"] == {"data": 2, "model": 1}
        assert man["rank"] == rank and man["distributed"]["backend"] == "gloo"
        assert records[-1]["kind"] == "run_done"


def test_cli_train_on_two_ranks_resumes_from_its_resume_dir(runs):
    """The pair rerun on the stages an interruption after 'meta_svc_oof'
    leaves: both ranks restore the finished stages, recompute the rest
    (sharded GBDT fold fits included) and print JAX's line."""
    want = runs["jax"]["cli_line"]
    for rank, (out, err, _) in enumerate(runs["cli"]["resumed"]):
        assert out.strip().splitlines()[-1] == want
        for stage in ("impute", "select", "member_svc", "member_gbdt", "member_lg",
                      "meta_svc_oof"):
            assert f"stage '{stage}' restored from checkpoint" in err, (rank, stage)
        for stage in UNDONE_AFTER_META_SVC:
            assert f"stage '{stage}' done" in err, (rank, stage)
    assert (runs["tmp"] / "saveresumed0" / "model.json").exists()
    assert not (runs["tmp"] / "saveresumed1").exists()


def test_initialize_distributed_noop_and_malformed(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed(auto=False, device="cpu") is False
    assert distributed.initialize_distributed(device="cpu") is False  # a second call too
    assert distributed.process_info() == (0, 1)
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups is None
    monkeypatch.setenv("WORLD_SIZE", "not-a-number")
    with pytest.raises(ValueError):
        distributed.initialize_distributed(auto=False, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="address"):
        distributed.initialize_distributed(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        distributed.initialize_distributed(device="cpu")


@pytest.mark.parametrize("n,shards", [(697, 4), (8, 4), (5, 8)])
def test_pad_and_shard_rows_match_jax_padding(n, shards):
    """``pad_rows`` as JAX's; ``shard_rows`` hands each rank its contiguous
    block of JAX's padded array (the row layout of ``NamedSharding(P('data'))``)."""
    from machine_learning_replications_tpu.data import sharding as jsharding
    from machine_learning_replications_tpu_torch.data import sharding
    from machine_learning_replications_tpu_torch.parallel import Mesh

    x = np.arange(n * 3, dtype=np.float64).reshape(n, 3)
    want, n_want = jsharding.pad_rows(x, shards)
    got, n_got = sharding.pad_rows(x, shards)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want == n
    per = want.shape[0] // shards
    for d in range(shards):
        (block, yb), rows = sharding.shard_rows(Mesh(shards, 1, torch.device("cpu"), rank=d),
                                                x, np.arange(n))
        np.testing.assert_array_equal(block.numpy(), want[d * per:(d + 1) * per])
        assert rows == n and yb.shape == (per,)


def test_replicate_moves_every_tensor_to_the_rank_device():
    from machine_learning_replications_tpu_torch.models.knn_impute import KNNImputerParams
    from machine_learning_replications_tpu_torch.parallel import Mesh, rowwise

    p = KNNImputerParams(donors=torch.ones(2, 3), col_means=torch.zeros(3))
    r = rowwise.replicate(Mesh(1, 1, torch.device("meta")), {"imputer": p, "k": 1})
    assert r["imputer"].donors.device.type == "meta" and r["k"] == 1


def test_mesh_shapes_and_backend_choice():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, 1, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.axis_index("data"), mesh.axis_index("model")) == (0, 0)
    assert distributed.choose_backend(torch.device("cpu"), 4)[0] == "gloo"


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:5]), sys.argv[5])

"""The port's command line vs the JAX package's: ``sweep`` (with ``--save``),
``train --plots --trace-dir --journal``, ``predict --trace-dir --journal``,
and the float32 CV sweep.

Every command runs with ``--device cpu`` and must print what the JAX CLI
prints on the same inputs (JAX on the CPU under x64, ``conftest.py``).
``train`` repeats every assertion of ``tests/test_cli.py``'s train round
trip, with ``obs.torchmon``'s totals in the place of ``jax_compiles``; its
manifest's ``config_hash`` must equal the JAX hash of the same config.
Without ``--device`` and without CUDA every command exits non-zero.
"""

import contextlib
import hashlib
import io
import json
import re

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu import cli as jcli
from machine_learning_replications_tpu.config import ExperimentConfig as JExperimentConfig
from machine_learning_replications_tpu.config import SweepConfig as JSweepConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import sweep as jsweep
from machine_learning_replications_tpu_torch import cli
from machine_learning_replications_tpu_torch.config import SweepConfig
from machine_learning_replications_tpu_torch.data.examples import patient_row
from machine_learning_replications_tpu_torch.models import pipeline, sweep, tree
from machine_learning_replications_tpu_torch.obs import spans, torchmon
from machine_learning_replications_tpu_torch.persist import checkpoint

FAST = {
    "gbdt": {"n_estimators": 5},
    "svc": {"platt_cv": 2, "max_iter": 2000},
    "stacking": {"cv_folds": 2},
    "select": {"cv_folds": 3, "n_alphas": 20},
}
SWEEP = ["sweep", "--synthetic", "200", "--n-estimators", "5", "10", "--max-depth", "1", "2",
         "--folds", "2"]
TORCHMON_KEYS = ("torch_graph_captures_total", "torch_kernel_builds_total",
                 "torch_kernel_build_seconds_total", "torch_kernel_launches_total",
                 "torch_transfer_bytes_total")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _x(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def _inside(child, parent) -> bool:
    return parent["ts"] <= child["ts"] and \
        child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    port_dir, jax_dir = str(tmp / "port"), str(tmp / "jax")
    port_out = _run(cli.main, SWEEP + ["--save", port_dir, "--device", "cpu"])
    jax_out = _run(jcli.main, SWEEP + ["--save", jax_dir])
    return port_out, jax_out, port_dir, jax_dir


def test_sweep_prints_the_jax_grid(sweeps):
    port_out, jax_out, _, _ = sweeps
    assert port_out == jax_out
    lines = port_out.splitlines()
    assert lines[0] == " depth m=    5 m=   10" and len(lines) == 4
    assert re.fullmatch(r"best: n_estimators=\d+ max_depth=\d mean AUC=\d\.\d{4}", lines[-1])


def test_sweep_save_predicts_the_jax_line(sweeps):
    port_out, _, port_dir, jax_dir = sweeps
    params = checkpoint.load_model(port_dir, device="cpu")
    assert isinstance(params, tree.TreeEnsembleParams)
    best = re.search(r"n_estimators=(\d+) max_depth=(\d)", port_out)
    assert params.feature.shape[0] == int(best.group(1))
    assert params.max_depth == int(best.group(2))
    line = _run(cli.main, ["predict", "--model", port_dir, "--device", "cpu"])
    assert line == _run(jcli.main, ["predict", "--model", jax_dir])
    want = float(tree.predict_proba1(params, torch.as_tensor(patient_row()))[0])
    assert line == f"Probability of progressive HF is: {100.0 * want:.2f} %\n"


def test_sweep_without_nan_matches_jax():
    argv = ["sweep", "--synthetic", "120", "--missing-rate", "0", "--n-estimators", "4",
            "--max-depth", "2", "--folds", "3", "--seed", "7"]
    assert _run(cli.main, argv + ["--device", "cpu"]) == _run(jcli.main, argv)


def test_sweep_float32_matches_jax():
    """``cv_sweep`` in float32 (inputs cast; JAX keeps float32 inputs in
    float32 under x64): mean-AUC grid within 0.005 of JAX's, the best cell
    equal unless another cell ties it within 0.005."""
    X, y, _ = make_cohort(n=1500, seed=2020)
    X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
    y32 = np.asarray(y, dtype=np.float32)
    grid = dict(n_estimators_grid=(10, 25), max_depth_grid=(1, 2, 3), cv_folds=3)
    res = sweep.cv_sweep(X17, y32, SweepConfig(**grid), device="cpu")
    jres = jsweep.cv_sweep(X17, y32, JSweepConfig(**grid))
    jmean = np.asarray(jres.mean_auc)
    diff = float(np.abs(res.mean_auc - jmean).max())
    assert np.isfinite(res.fold_auc).all() and res.fold_auc.shape == (3, 2, 3)
    assert diff <= 0.005, diff
    if (res.best_max_depth, res.best_n_estimators) != (jres.best_max_depth,
                                                       jres.best_n_estimators):
        di = grid["max_depth_grid"].index(res.best_max_depth)
        ei = grid["n_estimators_grid"].index(res.best_n_estimators)
        assert abs(float(jmean[di, ei]) - float(jres.best_mean_auc)) <= 0.005


# ---------------------------------------------------------------------------
# train / predict with plots, trace and journal
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def observed_train(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    cfg_path = tmp / "fast.json"
    cfg_path.write_text(json.dumps(FAST))
    paths = {"ckpt": tmp / "model", "plots": tmp / "plots", "trace": tmp / "traces",
             "journal": tmp / "run.jsonl", "cfg": cfg_path}
    out = _run(cli.main, [
        "train", "--device", "cpu", "--synthetic", "160", "--config", str(cfg_path),
        "--save", str(paths["ckpt"]), "--plots", str(paths["plots"]),
        "--trace-dir", str(paths["trace"]), "--journal", str(paths["journal"]),
    ])
    return out, paths


def test_train_save_plots_trace_journal(observed_train):
    out, paths = observed_train
    assert "AUC-ROC" in out and "precision" in out
    assert (paths["plots"] / "roc.png").exists() and (paths["plots"] / "pr.png").exists()
    assert spans.get_tracer() is None

    records = _read_jsonl(paths["journal"])
    man = records[0]
    assert man["kind"] == "manifest" and man["command"] == "train"
    assert len(man["git_sha"]) == 40
    cfg_json = JExperimentConfig.from_json(paths["cfg"].read_text()).to_json()
    assert man["config_hash"] == hashlib.sha256(cfg_json.encode()).hexdigest()
    assert ("device" in man) == torch.cuda.is_available()
    kinds = [r["kind"] for r in records[1:]]
    assert kinds.count("stage_start") >= 6
    assert kinds[-1] == "run_done"
    done = records[-1]
    assert all(k in done for k in TORCHMON_KEYS)
    totals = torchmon.totals()
    for k in ("torch_graph_captures_total", "torch_kernel_launches_total"):
        assert done[k] == totals[k]              # nothing on the card since (CPU run: 0, {})
    assert kinds.count("checkpoint_publish") == 1

    with open(paths["trace"] / "trace.json") as f:
        events = _x(json.load(f))
    names = [e["name"] for e in events]
    assert "train" in names and "fit_pipeline" in names and "evaluate" in names
    root = next(e for e in events if e["name"] == "train")
    stage_evs = [e for e in events if e["name"].startswith("stage:")]
    assert {e["name"] for e in stage_evs} >= {"stage:impute", "stage:select", "stage:meta"}
    assert all(_inside(e, root) for e in events)
    fit = next(e for e in events if e["name"] == "fit_pipeline")
    assert all(_inside(e, fit) for e in stage_evs)
    # each stage span lasts what the journal's stage_done says, to the host clock's noise
    done_s = {r["stage"]: r["seconds"] for r in records if r["kind"] == "stage_done"}
    for e in stage_evs:
        assert abs(e["dur"] / 1e6 - done_s[e["name"][len("stage:"):]]) <= 0.01

    line = _run(cli.main, ["predict", "--model", str(paths["ckpt"]), "--device", "cpu"])
    m = re.search(r"Probability of progressive HF is: (\d+\.\d{2}) %", line)
    assert m
    params = checkpoint.load_model(str(paths["ckpt"]), device="cpu")
    x64 = np.full((1, int(params.support_mask.shape[0])), np.nan)
    x64[0, selected_indices()] = patient_row().ravel()
    prob = float(pipeline.pipeline_predict_proba1(params, x64, device="cpu")[0])
    assert abs(float(m.group(1)) - 100 * prob) < 0.005


def test_predict_trace_and_journal(observed_train, tmp_path):
    _, paths = observed_train
    line = _run(cli.main, ["predict", "--model", str(paths["ckpt"]), "--device", "cpu",
                           "--trace-dir", str(tmp_path / "tr"),
                           "--journal", str(tmp_path / "p.jsonl")])
    assert line == _run(cli.main, ["predict", "--model", str(paths["ckpt"]), "--device", "cpu"])
    recs = _read_jsonl(tmp_path / "p.jsonl")
    assert recs[0]["kind"] == "manifest" and recs[0]["command"] == "predict"
    assert recs[0]["config_hash"] is None and recs[-1]["kind"] == "run_done"
    with open(tmp_path / "tr" / "trace.json") as f:
        events = {e["name"]: e for e in _x(json.load(f))}
    assert set(events) == {"predict", "load_params", "predict_proba"}
    assert events["load_params"]["args"] == {"family": "PipelineParams", "parent": "predict"}
    assert _inside(events["load_params"], events["predict"])
    assert _inside(events["predict_proba"], events["predict"])


def test_failed_run_journals_run_error_and_clears_globals(tmp_path):
    from machine_learning_replications_tpu_torch.obs import journal

    with pytest.raises(Exception):
        cli.main(["predict", "--model", str(tmp_path / "absent"), "--device", "cpu",
                  "--journal", str(tmp_path / "j.jsonl"), "--trace-dir", str(tmp_path / "tr")])
    recs = _read_jsonl(tmp_path / "j.jsonl")
    assert recs[-1]["kind"] == "run_error" and "absent" in recs[-1]["error"]
    assert journal.get_journal() is None and spans.get_tracer() is None
    assert (tmp_path / "tr" / "trace.json").exists()


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["train", "--synthetic", "40"],
    ["predict", "--pkl", "absent.pkl"],
    ["sweep", "--synthetic", "40"],
    ["import-sklearn", "--out", "o"],
])
def test_commands_want_the_card_by_default(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(argv)


def test_parser_has_the_jax_commands_and_flags():
    parser = cli.build_parser()
    sub = next(a for a in parser._actions if a.dest == "command")
    jsub = next(a for a in jcli.build_parser()._actions if a.dest == "command")
    assert set(sub.choices) == {"train", "predict", "sweep", "import-sklearn", "serve", "score",
                                "learn", "fleet"}
    flags = {name: {o for a in p._actions for o in a.option_strings}
             for name, p in sub.choices.items()}
    assert {"--plots", "--trace-dir", "--journal", "--save", "--resume-dir",
            "--aot"} <= flags["train"]
    assert {"--model", "--pkl", "--patient", "--trace-dir", "--journal"} <= flags["predict"]
    assert {"--n-estimators", "--max-depth", "--folds", "--save"} <= flags["sweep"]
    assert "--trace-dir" not in flags["sweep"]      # JAX's sweep has no obs flags
    assert {"--pkl", "--out", "--aot"} <= flags["import-sklearn"]
    # --aot as the JAX parser has it on both publishing commands
    for name in ("train", "import-sklearn"):
        jflags = {o for a in jsub.choices[name]._actions for o in a.option_strings}
        assert "--aot" in jflags, name
    # serve: every flag of the JAX parser's, plus --device and the private
    # --worker-id a multi-worker parent hands its workers; fleet: every role
    # and flag of the JAX parser's, no --device (no fleet role uses the card)
    jserve = {o for a in jsub.choices["serve"]._actions for o in a.option_strings}
    assert flags["serve"] == jserve | {"--device", "--worker-id"}
    froles = next(a for a in sub.choices["fleet"]._actions if a.dest == "role").choices
    jfroles = next(a for a in jsub.choices["fleet"]._actions if a.dest == "role").choices
    assert set(froles) == set(jfroles) == {"router", "deploy", "autoscale", "status"}
    for role, p in froles.items():
        got = {o for a in p._actions for o in a.option_strings}
        assert got == {o for a in jfroles[role]._actions for o in a.option_strings}, role
    # score: every flag of the JAX parser's, plus --device; learn: every role
    # and flag, --device on the roles that fit or replay a model and on
    # promote (where its AOT bundle is compiled)
    jscore = {o for a in jsub.choices["score"]._actions for o in a.option_strings}
    assert flags["score"] == jscore | {"--device"}
    roles = next(a for a in sub.choices["learn"]._actions if a.dest == "role").choices
    jroles = next(a for a in jsub.choices["learn"]._actions if a.dest == "role").choices
    assert set(roles) == set(jroles) == {"run", "retrain", "shadow", "promote", "status"}
    for role, p in roles.items():
        got = {o for a in p._actions for o in a.option_strings}
        want = {o for a in jroles[role]._actions for o in a.option_strings}
        assert got == want | ({"--device"} if role != "status" else set()), role
    defaults = parser.parse_args(["sweep"])
    jdefaults = jcli.build_parser().parse_args(["sweep"])
    for k in ("n_estimators", "max_depth", "folds", "synthetic", "missing_rate", "seed"):
        assert getattr(defaults, k) == getattr(jdefaults, k), k


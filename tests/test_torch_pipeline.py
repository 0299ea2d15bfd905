"""The port's full-pipeline predict route, checkpoints and ``cli predict``
vs the JAX package.

The model: a JAX ``knn_impute.fit`` imputer over the 64-variable cohort
(``missing_rate=0.05``), ``selected_indices()`` as the support mask, and the
stacked ensemble of ``fit_stacking(make_cohort(160))`` (the recipe of
``tests/test_torch_stacking.py``), bridged with ``convert.py``. The JAX
side runs on the CPU under x64 (``conftest.py``); probabilities are held at
``serve.engine.parity_tolerance()``, imputed values (copied donor values) at
1e-12.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.config import ExperimentConfig
from machine_learning_replications_tpu.config import GBDTConfig as JGBDTConfig
from machine_learning_replications_tpu.config import SVCConfig
from machine_learning_replications_tpu.data import make_cohort
from machine_learning_replications_tpu.data import examples as jexamples
from machine_learning_replications_tpu.data.schema import selected_indices
from machine_learning_replications_tpu.models import knn_impute as jknn
from machine_learning_replications_tpu.models import pipeline as jpipeline
from machine_learning_replications_tpu.serve.engine import oracle_proba1, parity_tolerance
from machine_learning_replications_tpu_torch import cli, convert
from machine_learning_replications_tpu_torch.data import examples
from machine_learning_replications_tpu_torch.models import pipeline, stacking, tree
from machine_learning_replications_tpu_torch.persist import checkpoint, load_inference_params

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_params():
    X, y, _ = make_cohort(n=160, seed=0)
    cfg = ExperimentConfig(gbdt=JGBDTConfig(n_estimators=5), svc=SVCConfig(platt_cv=2))
    ens = jpipeline.fit_stacking(X[:, selected_indices()], y, cfg)
    X64, _, _ = make_cohort(n=1427, seed=2020, missing_rate=0.05)
    mask = np.zeros(64, bool)
    mask[selected_indices()] = True
    return jpipeline.PipelineParams(
        imputer=jknn.fit(jnp.asarray(X64)), support_mask=jnp.asarray(mask), ensemble=ens,
        quality={"score_edges": jnp.linspace(0.0, 1.0, 11), "n_rows": jnp.asarray(1427.0)})


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.pipeline_params_from_arrays(jax_params, device="cpu")


def _close(got, want):
    rtol, atol = parity_tolerance()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _contract_rows(n, seed):
    return make_cohort(n=n, seed=seed)[0][:, selected_indices()]


def test_bridge_keeps_the_pipeline(jax_params, params):
    assert params.support_mask.dtype == torch.bool and int(params.support_mask.sum()) == 17
    assert params.imputer.donors.dtype == torch.float64
    np.testing.assert_array_equal(params.imputer.donors.numpy(), np.asarray(jax_params.imputer.donors))
    np.testing.assert_array_equal(params.quality["score_edges"].numpy(),
                                  np.asarray(jax_params.quality["score_edges"]))


@pytest.mark.parametrize("rows", [1, 300])
def test_contract_predict_matches_jax(jax_params, params, rows):
    X17 = examples.patient_row() if rows == 1 else _contract_rows(rows, 4)
    got = pipeline.pipeline_predict_proba1_contract(params, X17, device="cpu")
    assert got.shape == (rows,)
    _close(got, jpipeline.pipeline_predict_proba1_contract(jax_params, X17))


def test_raw_predict_matches_jax(jax_params, params):
    """64-wide rows with scattered NaNs, the stacked pass in chunks of 64."""
    X64 = make_cohort(n=300, seed=5, missing_rate=0.1)[0]
    got = pipeline.pipeline_predict_proba1(params, X64, chunk_rows=64, device="cpu")
    _close(got, jpipeline.pipeline_predict_proba1(jax_params, X64, chunk_rows=64))


def test_same_donor_as_jax(jax_params, params):
    """The imputed contract rows, before the support mask, equal JAX's: the
    47 imputed values are copies of the same donors' values."""
    X64 = pipeline.contract_rows_to_x64(params, _contract_rows(400, 6))
    np.testing.assert_array_equal(X64, jpipeline.contract_rows_to_x64(jax_params,
                                                                        _contract_rows(400, 6)))
    block = pipeline.resolve_contract_block_fn(params)
    got = pipeline.knn_impute.transform(params.imputer, X64, block_fn=block)
    want = jknn.transform(jax_params.imputer, jnp.asarray(X64),
                          block_fn=jpipeline.resolve_contract_block_fn(jax_params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    idx, ok = block.donors(params.imputer, torch.as_tensor(X64))
    donors = np.asarray(jax_params.imputer.donors)
    for k, f in enumerate(block.nan_cols):
        hit = ok[:, k].numpy()
        np.testing.assert_array_equal(np.asarray(want)[hit, f], donors[idx[hit, k].numpy(), f])
    sel = pipeline.impute_select(params, X64, block_fn=block)
    _close(sel, jpipeline.impute_select(jax_params, X64))


def test_support_feature_names_match_jax(jax_params, params):
    assert pipeline.support_feature_names(params) == jpipeline.support_feature_names(jax_params)


def test_example_patient_matches_jax():
    assert examples.EXAMPLE_PATIENT == jexamples.EXAMPLE_PATIENT
    np.testing.assert_array_equal(examples.patient_row(), jexamples.patient_row())
    bad = dict(examples.EXAMPLE_PATIENT, Syncope=float("nan"))
    for fn in (examples.validate_patient, jexamples.validate_patient):
        with pytest.raises(ValueError, match="non-finite"):
            fn(bad)


def test_predict_wants_the_params_on_its_device(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.pipeline_predict_proba1_contract(params, examples.patient_row())


def _same(a, b):
    """Equal parameter trees: tensors equal (NaN = NaN) in dtype and shape."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a) is type(b)
        for name in a.__dataclass_fields__:
            _same(getattr(a, name), getattr(b, name))
    else:
        assert a == b


def test_checkpoint_round_trip_version_and_rollback(params, tmp_path):
    path = tmp_path / "model"
    assert checkpoint.save_model(path, params) == 1
    assert sorted(os.listdir(path)) == ["integrity.json", "model.json", "tensors.npz"]
    sidecar = json.loads((path / "model.json").read_text())   # JSON, not a pickle
    assert sidecar["family"] == "PipelineParams" and sidecar["format"] == 1
    assert sidecar["root"]["fields"]["ensemble"]["fields"]["gbdt"]["fields"]["max_depth"] == {
        "static": 1}
    loaded, info = checkpoint.load_model_versioned(path, device="cpu")
    _same(loaded, params)
    assert info == {"path": str(path), "version": 1, "rolled_back": False}

    assert checkpoint.save_model(path, params) == 2          # the old one is retained
    assert checkpoint.checkpoint_version(checkpoint.lastgood_path(path)) == 1
    assert checkpoint.checkpoint_version(path) == 2
    blob = bytearray((path / "tensors.npz").read_bytes())
    blob[len(blob) // 2] ^= 0xFF                              # rot one byte of the primary
    (path / "tensors.npz").write_bytes(bytes(blob))
    with pytest.raises(checkpoint.CheckpointIntegrityError, match="hash mismatch"):
        checkpoint.verify_checkpoint(path)
    loaded, info = checkpoint.load_model_versioned(path, device="cpu")
    assert info["rolled_back"] and info["version"] == 1
    _same(loaded, params)
    # a torn primary (sizes off its manifest: the check each publish makes)
    # is dropped, never rotated over the good last-known-good
    (path / "tensors.npz").write_bytes(bytes(blob[:100]))
    assert checkpoint.save_model(path, params) == 3
    assert checkpoint.checkpoint_version(checkpoint.lastgood_path(path)) == 1


def test_checkpoint_without_fallback_raises(params, tmp_path):
    path = tmp_path / "model"
    checkpoint.save_model(path, params.ensemble)
    (path / "model.json").write_text("{}")
    with pytest.raises(checkpoint.CheckpointIntegrityError, match="model.json"):
        checkpoint.load_model(path, device="cpu")
    with pytest.raises(TypeError, match="a checkpoint holds one of"):
        checkpoint.save_model(tmp_path / "imputer", params.imputer)


@pytest.mark.parametrize("family", ["PipelineParams", "StackingParams", "TreeEnsembleParams"])
def test_cli_predict_prints_the_contract_line(jax_params, params, family, tmp_path, capsys):
    """``cli predict --model`` on each family prints JAX's probability as
    ``predict_hf.py:38-40`` formats it."""
    port, jax_side = {
        "PipelineParams": (params, jax_params),
        "StackingParams": (params.ensemble, jax_params.ensemble),
        "TreeEnsembleParams": (params.ensemble.gbdt, jax_params.ensemble.gbdt),
    }[family]
    checkpoint.save_model(tmp_path / "m", port)
    assert type(load_inference_params(str(tmp_path / "m"), device="cpu")) is type(port)
    assert cli.main(["predict", "--model", str(tmp_path / "m"), "--device", "cpu"]) == 0
    prob = float(oracle_proba1(jax_side, jexamples.patient_row())[0])
    assert capsys.readouterr().out == f"Probability of progressive HF is: {100.0 * prob:.2f} %\n"


def test_cli_predict_patient_json_and_bad_patient(params, tmp_path, capsys):
    checkpoint.save_model(tmp_path / "m", params)
    patient = dict(examples.EXAMPLE_PATIENT, Ejection_Fraction=35)
    (tmp_path / "p.json").write_text(json.dumps(patient))
    cli.main(["predict", "--model", str(tmp_path / "m"), "--patient", str(tmp_path / "p.json"),
              "--device", "cpu"])
    prob = float(pipeline.pipeline_predict_proba1_contract(
        params, examples.patient_row(patient), device="cpu")[0])
    assert capsys.readouterr().out.strip() == f"Probability of progressive HF is: {100 * prob:.2f} %"
    del patient["Syncope"]
    (tmp_path / "bad.json").write_text(json.dumps(patient))
    with pytest.raises(SystemExit, match="missing: Syncope"):
        cli.main(["predict", "--model", str(tmp_path / "m"), "--patient",
                  str(tmp_path / "bad.json"), "--device", "cpu"])


def test_cli_predict_without_cuda_needs_device_cpu(params, tmp_path, monkeypatch):
    checkpoint.save_model(tmp_path / "m", params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["predict", "--model", str(tmp_path / "m")])


def test_python_dash_m_predict(params, tmp_path):
    """The module entry point, in a fresh interpreter."""
    checkpoint.save_model(tmp_path / "m", params)
    out = subprocess.run([sys.executable, "-m", "machine_learning_replications_tpu_torch",
                          "predict", "--model", str(tmp_path / "m"), "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    prob = float(pipeline.pipeline_predict_proba1_contract(params, examples.patient_row(),
                                                           device="cpu")[0])
    assert out.stdout == f"Probability of progressive HF is: {100.0 * prob:.2f} %\n"


def test_stacking_and_tree_families_cast_the_row(params):
    """A float32 checkpoint takes the float64 contract row in its own dtype."""
    ens32 = convert.stacking_params_from_arrays(params.ensemble, device="cpu", dtype=torch.float32)
    x = examples.patient_row()
    want = float(stacking.predict_proba1(ens32, torch.as_tensor(x, dtype=torch.float32),
                                         device="cpu")[0])
    assert cli.predict_proba1(ens32, x, torch.device("cpu")) == want
    want = float(tree.predict_proba1(ens32.gbdt, torch.as_tensor(x, dtype=torch.float32))[0])
    assert cli.predict_proba1(ens32.gbdt, x, torch.device("cpu")) == want

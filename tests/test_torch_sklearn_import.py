"""The port's sklearn import vs the JAX package's, and ``cli import-sklearn``.

A seeded live ``StackingClassifier`` of the reference's topology (the one
``tests/test_dualpath.py`` fits) is pickled to ``tmp_path`` with protocol 3,
as the shipped model was. The port's ``decode_pickle`` + ``import_stacking``
must give JAX's parameters field by field (float64, exact), from the pickle
and from the live estimator; its probabilities must meet
``serve.engine.parity_tolerance()`` against ``serve.engine.oracle_proba1``;
and ``cli import-sklearn`` → ``predict --model`` and ``predict --pkl`` must
print JAX's line.

The committed fixture ``persist/testdata/stacking_small.pkl`` is the same
estimator's pickle, for the card's machine, which has no sklearn. A test
rebuilds the estimator and asserts that the committed file decodes to the
same parameters, so a stale fixture fails. To rewrite it (sklearn needed):
``python tests/test_torch_sklearn_import.py``.
"""

import contextlib
import dataclasses
import io
import os
import pickle
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from machine_learning_replications_tpu import cli as jcli
from machine_learning_replications_tpu.models import stacking as jstacking
from machine_learning_replications_tpu.persist import sklearn_import as jimport
from machine_learning_replications_tpu_torch import cli
from machine_learning_replications_tpu_torch.data.examples import patient_row
from machine_learning_replications_tpu_torch.models import stacking
from machine_learning_replications_tpu_torch.persist import (
    checkpoint,
    load_inference_params,
    sklearn_import,
)

FIXTURE = (Path(sklearn_import.__file__).resolve().parent / "testdata" / "stacking_small.pkl")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_estimator():
    """The seeded reference-topology ``StackingClassifier`` of
    ``tests/test_dualpath.py``: 250 rows × 17 features, 10 binary columns."""
    from sklearn.ensemble import GradientBoostingClassifier, StackingClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC

    rng = np.random.default_rng(11)
    n, f = 250, 17
    X = rng.normal(size=(n, f))
    X[:, :10] = (X[:, :10] > 0.3).astype(float)
    y = (X @ rng.normal(size=f) + rng.normal(size=n) > 0.1).astype(float)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return StackingClassifier(
            estimators=[
                ("svc", make_pipeline(StandardScaler(), SVC(probability=True, random_state=2020))),
                ("gbc", GradientBoostingClassifier(n_estimators=10, max_depth=1,
                                                   random_state=2020)),
                ("lg", LogisticRegression()),
            ],
            final_estimator=LogisticRegression(),
        ).fit(X, y)


def query_rows():
    rng = np.random.default_rng(29)
    X = rng.normal(size=(80, 17))
    X[:, :10] = (X[:, :10] > 0.3).astype(float)
    return X


@pytest.fixture(scope="module")
def estimator():
    return build_estimator()


@pytest.fixture(scope="module")
def pkl_path(estimator, tmp_path_factory):
    path = tmp_path_factory.mktemp("pkl") / "stacking.pkl"
    with open(path, "wb") as f:
        pickle.dump(estimator, f, protocol=3)
    return str(path)


def _assert_same_fields(port, jax_params):
    """Every field equal: same shape, float64 (or the same integer type),
    same values — no tolerance."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(jax_params, f.name)
        if dataclasses.is_dataclass(got):
            _assert_same_fields(got, want)
        elif isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.device.type == "cpu"
            assert got.numpy().dtype == want.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        else:
            assert got == want, f.name


def test_decoded_pickle_matches_jax_field_by_field(pkl_path):
    port = sklearn_import.import_stacking(sklearn_import.decode_pickle(pkl_path), device="cpu")
    want = jimport.import_stacking(jimport.decode_pickle(pkl_path))
    _assert_same_fields(port, want)
    assert port.gbdt.threshold.dtype == torch.float64
    assert port.gbdt.feature.dtype == torch.int32 and port.gbdt.max_depth == 1


def test_live_estimator_matches_jax_and_the_pickle(estimator, pkl_path):
    live = sklearn_import.import_stacking(estimator, device="cpu")
    _assert_same_fields(live, jimport.import_stacking(estimator))
    _assert_same_fields(live, jimport.import_stacking(jimport.decode_pickle(pkl_path)))


@pytest.mark.parametrize("part", ["scaler", "svc", "gbdt", "linear"])
def test_member_converters_match_jax(estimator, part):
    pipe, gbc, lg = list(estimator.estimators_)
    sc, svc = [s[1] for s in pipe.steps]
    obj, port_fn, jax_fn = {
        "scaler": (sc, sklearn_import.import_scaler, jimport.import_scaler),
        "svc": (svc, sklearn_import.import_svc, jimport.import_svc),
        "gbdt": (gbc, sklearn_import.import_gbdt, jimport.import_gbdt),
        "linear": (lg, sklearn_import.import_linear, jimport.import_linear),
    }[part]
    _assert_same_fields(port_fn(obj, device="cpu"), jax_fn(obj))


def test_probabilities_meet_the_oracle_tolerance(pkl_path, estimator):
    from machine_learning_replications_tpu.serve.engine import oracle_proba1, parity_tolerance

    X = query_rows()
    params = sklearn_import.import_stacking(sklearn_import.decode_pickle(pkl_path), device="cpu")
    p = stacking.predict_proba(params, X, device="cpu").numpy()
    want = oracle_proba1(jimport.import_stacking(jimport.decode_pickle(pkl_path)), X)
    rtol, atol = parity_tolerance()
    np.testing.assert_allclose(p[:, 1], want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(p[:, 1], estimator.predict_proba(X)[:, 1], rtol=1e-12, atol=1e-14)


def test_stub_unpickler_runs_no_pickled_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("exit 3",))

    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"a": np.arange(3.0), "b": Evil()}, f, protocol=3)
    out = sklearn_import.decode_pickle(str(path))
    np.testing.assert_array_equal(out["a"], np.arange(3.0))
    assert isinstance(out["b"], sklearn_import._Stub)      # os.system was never called


@pytest.mark.parametrize("module,other", [
    ("numpy.core.multiarray", "numpy._core.multiarray"),
    ("numpy._core.multiarray", "numpy.core.multiarray"),
    ("numpy._core", "numpy.core"),
])
def test_numpy_module_spelling(module, other, monkeypatch):
    """A spelling this numpy imports is kept; one it cannot import maps to
    the other major version's."""
    import importlib

    assert sklearn_import._numpy_module("numpy") == "numpy"
    real = importlib.import_module

    def only_other(name, *a, **k):
        if name == module:
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(importlib, "import_module", only_other)
    assert sklearn_import._numpy_module(module) == other


def test_committed_fixture_is_this_estimator(estimator):
    assert FIXTURE.is_file() and FIXTURE.stat().st_size < 100_000
    with open(FIXTURE, "rb") as f:
        assert f.read(2) == b"\x80\x03"                        # pickle protocol 3
    _assert_same_fields(
        sklearn_import.import_stacking(sklearn_import.decode_pickle(str(FIXTURE)), device="cpu"),
        jimport.import_stacking(estimator))


def _run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_cli_import_then_predict_prints_jax_line(pkl_path, tmp_path):
    out = str(tmp_path / "imported")
    assert _run_cli(cli.main, ["import-sklearn", "--pkl", pkl_path, "--out", out,
                               "--device", "cpu"]) == f"imported {pkl_path} -> {out}\n"
    params = checkpoint.load_model(out, device="cpu")
    assert isinstance(params, stacking.StackingParams)
    by_model = _run_cli(cli.main, ["predict", "--model", out, "--device", "cpu"])
    by_pkl = _run_cli(cli.main, ["predict", "--pkl", pkl_path, "--device", "cpu"])
    jax_line = _run_cli(jcli.main, ["predict", "--pkl", pkl_path])
    assert by_model == by_pkl == jax_line
    want = jstacking.predict_proba1(jimport.import_stacking(jimport.decode_pickle(pkl_path)),
                                    patient_row())
    assert jax_line == f"Probability of progressive HF is: {100.0 * float(want[0]):.2f} %\n"


def test_load_inference_params_sources(pkl_path, tmp_path):
    params = load_inference_params(pkl=pkl_path, device="cpu")
    assert isinstance(params, stacking.StackingParams)
    missing = str(tmp_path / "absent.pkl")
    with pytest.raises(FileNotFoundError, match="absent.pkl"):
        load_inference_params(pkl=missing, device="cpu")
    with pytest.raises(SystemExit, match="absent.pkl"):
        cli.main(["predict", "--pkl", missing, "--device", "cpu"])
    with pytest.raises(SystemExit, match="absent.pkl"):
        cli.main(["import-sklearn", "--pkl", missing, "--out", str(tmp_path / "o"),
                  "--device", "cpu"])


def test_reference_pickle_path_names_the_reference_model(tmp_path):
    """The port has no default pickle (the reference's lies outside the
    checkout): without --model or --pkl each entry point exits naming the
    file and the directory the JAX package reads it from, whether or not
    that file exists."""
    jax_dir = os.path.basename(os.path.dirname(jimport.REFERENCE_PKL_PATH))
    msg = sklearn_import.NO_DEFAULT_PKL
    assert "hf_predict_model.pkl" in msg and jax_dir in msg
    with pytest.raises(ValueError, match="hf_predict_model.pkl"):
        load_inference_params(device="cpu")
    for argv in (["predict", "--device", "cpu"],
                 ["import-sklearn", "--out", str(tmp_path / "o"), "--device", "cpu"]):
        with pytest.raises(SystemExit, match="--pkl PICKLE") as exc:
            cli.main(argv)
        assert "hf_predict_model.pkl" in str(exc.value) and jax_dir in str(exc.value)
    assert not (tmp_path / "o").exists()


@pytest.mark.skipif(not os.path.exists(jimport.REFERENCE_PKL_PATH), reason="reference pkl absent")
def test_reference_pickle_matches_jax():
    port = sklearn_import.import_stacking(
        sklearn_import.decode_pickle(jimport.REFERENCE_PKL_PATH), device="cpu")
    _assert_same_fields(port, jimport.import_stacking(jimport.decode_pickle()))
    assert _run_cli(cli.main, ["predict", "--pkl", jimport.REFERENCE_PKL_PATH,
                               "--device", "cpu"]) == _run_cli(jcli.main, ["predict"])


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    with open(FIXTURE, "wb") as f:
        pickle.dump(build_estimator(), f, protocol=3)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

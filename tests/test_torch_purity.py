"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX package.

Two checks. An AST scan of every ``.py`` in the port package (and of
``chip_smoke.py``, which drives the port on the card) rejects any import of
those names. A fresh interpreter that imports every port module then shows
none of them in ``sys.modules`` beyond what a bare interpreter of the same
environment already holds (an ambient ``sitecustomize`` may preload
something; it is no fault of the port's).

A third check: an entry point called without ``device=`` on a machine
without CUDA raises instead of quietly running on the CPU.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import machine_learning_replications_tpu_torch as port
from machine_learning_replications_tpu_torch import convert, device
from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.models import gbdt, stacking

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax")
JAX_PACKAGE = "machine_learning_replications_tpu"


def _forbidden(name: str) -> bool:
    """``machine_learning_replications_tpu_torch`` shares the JAX package's
    prefix, so the package is matched as a whole dotted component."""
    if name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + "."):
        return True
    return name.split(".")[0] in FORBIDDEN_ROOTS


def _port_files():
    return sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        rel = path.relative_to(PORT_DIR.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
            for alias in node.names:
                yield node.lineno, f"{node.module}.{alias.name}"


@pytest.mark.parametrize(
    "name,bad",
    [("jax", True), ("jax.numpy", True), ("flax.struct", True), (JAX_PACKAGE, True),
     (JAX_PACKAGE + ".ops.histogram", True), (JAX_PACKAGE + "_torch", False),
     (JAX_PACKAGE + "_torch.ops", False), ("jaxtyping", False), ("torch", False)],
)
def test_forbidden_name_rule(name, bad):
    assert _forbidden(name) is bad


def test_no_forbidden_import_in_port_sources():
    files = _port_files()
    assert len(files) >= 16
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        found += [f"{path.relative_to(REPO)}:{line}: {name}"
                  for line, name in _imported_names(tree) if _forbidden(name)]
    assert not found, "\n".join(found)


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "machine_learning_replications_tpu_torch.ops.cuda_histogram" in mods
    probe = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps({'before': sorted(before), 'after': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    added = set(seen["after"]) - set(seen["before"])
    assert set(mods) <= added | set(seen["before"])
    assert not sorted(m for m in added if _forbidden(m))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_without_device_raise_not_fall_back(no_cuda):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    y = (rng.random(200) < 0.3).astype(np.float64)
    cfg = GBDTConfig(splitter="hist", n_estimators=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gbdt.fit(X, y, cfg)
    lin = {"coef": np.ones(3), "intercept": 0.0}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.linear_params_from_arrays(lin)
    cpu_lin = convert.linear_params_from_arrays(lin, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_to(cpu_lin, None)
    params = stacking.StackingParams(
        scaler=None, svc=None, gbdt=None, logreg=cpu_lin, meta=cpu_lin)
    for fn in (stacking.predict_proba, stacking.predict_proba1,
               stacking.predict_proba1_with_members):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(params, X)

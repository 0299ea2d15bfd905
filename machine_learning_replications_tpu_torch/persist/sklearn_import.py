"""Legacy sklearn pickle import, without sklearn and without running pickled code.

Port of the JAX package's ``persist/sklearn_import.py``. The shipped model
(``hf_predict_model.pkl``, sklearn 0.23.2, pickle protocol 3) cannot be
loaded by a modern sklearn, and executing an old pickled object graph is
unnecessary anyway: only the fitted arrays are needed. ``decode_pickle``
deserializes with a *class-stubbing* unpickler — numpy (and scipy) globals
resolve for real, so ndarrays reconstruct; every other class becomes an
inert attribute bag — and the ``import_*`` converters read those bags into
the port's parameter classes (``models/{scaler,svm,tree,linear,stacking}``),
as float64 tensors on ``device=`` (default: the card). sklearn is never
imported: a machine without it decodes and imports the same pickle.

The converters also accept live fitted sklearn estimators (they read the
same attributes), which is how the tests hold the port to the JAX import.

Field conventions (those of the JAX module):
  * binary SVC's public ``dual_coef_``/``intercept_`` are the negation of the
    private ``_dual_coef_``/``_intercept_``; the public pair satisfies
    ``dec = K @ dual_coef + intercept``;
  * GBC trees store sklearn node structs ``(left_child, right_child, feature,
    threshold, ...)``; leaves have children == -1 and become self-loops with
    +inf thresholds for the fixed-depth descent in ``models.tree``.
"""

from __future__ import annotations

import builtins
import importlib
import io
import pickle
from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import resolve_device
from machine_learning_replications_tpu_torch.models.linear import LinearParams
from machine_learning_replications_tpu_torch.models.scaler import ScalerParams
from machine_learning_replications_tpu_torch.models.stacking import StackingParams
from machine_learning_replications_tpu_torch.models.svm import SVCParams
from machine_learning_replications_tpu_torch.models.tree import TreeEnsembleParams

#: Why the port has no default pickle: it reads nothing outside its own
#: checkout, and the reference's shipped model lies outside it. Said by every
#: entry point that is given neither a port checkpoint nor a pickle.
NO_DEFAULT_PKL = (
    "no model given: pass --model DIR (a port checkpoint) or --pkl PICKLE "
    "(a sklearn pickle). The reference's shipped model is hf_predict_model.pkl, "
    "which the JAX package reads from '../reference/Machine Learning for "
    "Predicting Heart Failure Progression/' beside its checkout; the port reads "
    "no path outside its own checkout by default."
)


class _Stub(dict):
    """Inert stand-in for a pickled class: records ctor args and state.

    Subclasses ``dict`` so dict-subclass pickles (e.g. ``sklearn.utils.Bunch``)
    replay their SETITEMS opcodes; attribute lookup falls back to dict keys,
    matching Bunch semantics.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        self._ctor_args = args
        self._ctor_kwargs = kwargs

    def __setstate__(self, state: Any) -> None:
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self._state = state

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<stub {type(self).__module__}.{type(self).__name__}>"


# Only array-reconstruction machinery and inert containers resolve for real —
# notably NOT builtins.* wholesale (builtins.exec/eval would make the
# "no pickled code executes" guarantee false for a crafted pickle).
_SAFE_GLOBALS: dict[tuple[str, str], Any] = {
    ("builtins", n): getattr(builtins, n)
    for n in (
        "object", "tuple", "list", "dict", "set", "frozenset",
        "bytearray", "complex", "bytes", "str", "int", "float", "bool",
        "slice", "range",
    )
}


def _numpy_module(module: str) -> str:
    """numpy 2 pickles name ``numpy._core.*`` where numpy 1 has
    ``numpy.core.*`` (and the reverse): the spelling this numpy imports."""
    try:
        importlib.import_module(module)
        return module
    except ImportError:
        for a, b in (("numpy._core", "numpy.core"), ("numpy.core", "numpy._core")):
            if module == a or module.startswith(a + "."):
                return b + module[len(a):]
        raise


class _StubUnpickler(pickle.Unpickler):
    """Resolve numpy/scipy + inert builtins for real; stub everything else."""

    def __init__(self, f: io.IOBase) -> None:
        super().__init__(f)
        self._stubs: dict[tuple[str, str], type] = {}

    def find_class(self, module: str, name: str) -> Any:
        root = module.split(".")[0]
        if root == "numpy":
            return super().find_class(_numpy_module(module), name)
        if root == "scipy":
            return super().find_class(module, name)
        if (module, name) in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[(module, name)]
        if (module, name) == ("collections", "OrderedDict"):
            import collections

            return collections.OrderedDict
        key = (module, name)
        if key not in self._stubs:
            cls = type(name, (_Stub,), {"__module__": module})
            self._stubs[key] = cls
        return self._stubs[key]


def decode_pickle(path: str) -> Any:
    """Decode a (possibly ancient) sklearn pickle into stub attribute bags."""
    with open(path, "rb") as f:
        return _StubUnpickler(f).load()


# ---------------------------------------------------------------------------
# Converters: stub bag OR live sklearn estimator → the port's parameters
# ---------------------------------------------------------------------------


def _arr(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _on(a: Any, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev)


def import_scaler(obj: Any, *, device=None) -> ScalerParams:
    dev = resolve_device(device)
    return ScalerParams(mean=_on(_arr(obj.mean_), dev), scale=_on(_arr(obj.scale_), dev))


def import_svc(obj: Any, *, device=None) -> SVCParams:
    dev = resolve_device(device)
    try:
        dual = _arr(obj.dual_coef_)[0]
        intercept = _arr(obj.intercept_).reshape(())
    except AttributeError:  # only the private (libsvm-orientation) fields present
        dual = -_arr(obj._dual_coef_)[0]
        intercept = -_arr(obj._intercept_).reshape(())
    return SVCParams(
        support_vectors=_on(_arr(obj.support_vectors_), dev),
        dual_coef=_on(dual, dev),
        intercept=_on(intercept, dev),
        gamma=_on(_arr(obj._gamma).reshape(()), dev),
        prob_a=_on(_arr(obj._probA).reshape(()), dev),
        prob_b=_on(_arr(obj._probB).reshape(()), dev),
    )


def _tree_arrays(tree_obj: Any) -> dict[str, np.ndarray]:
    """Node arrays from a live ``sklearn.tree._tree.Tree`` or its stub.

    Stubs hold the pickled state dict: ``nodes`` is the structured node
    array, ``values`` is ``[node_count, 1, 1]``.
    """
    if hasattr(tree_obj, "nodes"):  # stub path
        nodes = tree_obj.nodes
        return {
            "feature": np.asarray(nodes["feature"], np.int32),
            "threshold": _arr(nodes["threshold"]),
            "left": np.asarray(nodes["left_child"], np.int32),
            "right": np.asarray(nodes["right_child"], np.int32),
            "value": _arr(tree_obj.values)[:, 0, 0],
        }
    return {
        "feature": np.asarray(tree_obj.feature, np.int32),
        "threshold": _arr(tree_obj.threshold),
        "left": np.asarray(tree_obj.children_left, np.int32),
        "right": np.asarray(tree_obj.children_right, np.int32),
        "value": _arr(tree_obj.value)[:, 0, 0],
    }


def import_gbdt(obj: Any, *, device=None) -> TreeEnsembleParams:
    """GradientBoostingClassifier (binary) → dense forest tensors.

    Leaves (children == -1) become self-loops with +inf thresholds so the
    fixed-depth descent parks on them; shorter trees are padded with inert
    nodes to the ensemble-wide max node count.
    """
    dev = resolve_device(device)
    estimators = np.asarray(obj.estimators_).ravel()
    trees = [_tree_arrays(e.tree_) for e in estimators]
    n_nodes = max(t["feature"].shape[0] for t in trees)
    T = len(trees)
    feature = np.zeros((T, n_nodes), np.int32)
    threshold = np.full((T, n_nodes), np.inf)
    left = np.tile(np.arange(n_nodes, dtype=np.int32), (T, 1))
    right = left.copy()
    value = np.zeros((T, n_nodes))
    max_depth = 1
    for i, t in enumerate(trees):
        k = t["feature"].shape[0]
        is_leaf = t["left"] < 0
        idx = np.arange(k, dtype=np.int32)
        feature[i, :k] = np.where(is_leaf, 0, t["feature"])
        threshold[i, :k] = np.where(is_leaf, np.inf, t["threshold"])
        left[i, :k] = np.where(is_leaf, idx, t["left"])
        right[i, :k] = np.where(is_leaf, idx, t["right"])
        value[i, :k] = t["value"]
        max_depth = max(max_depth, _tree_depth(t["left"], t["right"]))

    prior1 = float(_arr(obj.init_.class_prior_)[1])
    init_raw = np.log(prior1 / (1.0 - prior1))
    return TreeEnsembleParams(
        feature=_on(feature, dev),
        threshold=_on(threshold, dev),
        left=_on(left, dev),
        right=_on(right, dev),
        value=_on(value, dev),
        init_raw=_on(np.float64(init_raw), dev),
        learning_rate=_on(np.float64(obj.learning_rate), dev),
        max_depth=int(max_depth),
    )


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Longest root→leaf path; sklearn stores parents before children."""
    depth = np.zeros(left.shape[0], np.int32)
    for i in range(left.shape[0]):
        for c in (left[i], right[i]):
            if c >= 0 and c != i:
                depth[c] = depth[i] + 1
    return int(depth.max()) if depth.size else 0


def import_linear(obj: Any, *, device=None) -> LinearParams:
    dev = resolve_device(device)
    return LinearParams(coef=_on(_arr(obj.coef_)[0], dev),
                        intercept=_on(_arr(obj.intercept_).reshape(()), dev))


def import_stacking(obj: Any, *, device=None) -> StackingParams:
    """StackingClassifier (fitted, reference topology) → StackingParams.

    Expects the reference's member order (``train_ensemble_public.py:43-47``):
    [Pipeline(StandardScaler, SVC), GradientBoostingClassifier, LogisticRegression].
    """
    dev = resolve_device(device)
    pipe, gbc, lg = list(obj.estimators_)
    sc, svc = [s[1] for s in pipe.steps]
    return StackingParams(
        scaler=import_scaler(sc, device=dev),
        svc=import_svc(svc, device=dev),
        gbdt=import_gbdt(gbc, device=dev),
        logreg=import_linear(lg, device=dev),
        meta=import_linear(obj.final_estimator_, device=dev),
    )

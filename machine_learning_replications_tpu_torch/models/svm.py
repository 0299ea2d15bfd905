"""RBF support-vector classifier (inference side).

The probability path reproduces libsvm's binary semantics exactly, as the
JAX package's ``models/svm.py`` does, including its two quirks:

  1. the pairwise Platt probability is clipped to ``[1e-7, 1 - 1e-7]``;
  2. binary class probabilities still go through libsvm's iterative
     pairwise-coupling solver, which stops at tolerance ``0.005/k`` — so its
     output differs from the plain sigmoid by up to ~3e-3. The iteration is
     replicated (vectorised over samples, converged lanes masked), never the
     closed form.

Sign conventions: ``dec = K(X, SV) @ dual_coef + intercept``; libsvm's
internal decision value is ``f = -dec``, and Platt gives
``r₀ = σ(-(A·f + B))`` as the pairwise probability of class 0.
"""

from __future__ import annotations

import dataclasses

import torch

from machine_learning_replications_tpu_torch.device import float_dtype
from machine_learning_replications_tpu_torch.ops.linalg import rbf_kernel

_MIN_PROB = 1e-7  # libsvm svm_predict_probability clipping
_COUPLING_MAX_ITER = 100  # libsvm: max(100, k)
_COUPLING_EPS = 0.005 / 2  # libsvm: 0.005 / k, k = 2


@dataclasses.dataclass(frozen=True)
class SVCParams:
    support_vectors: torch.Tensor  # [S, F] (in scaler-transformed space)
    dual_coef: torch.Tensor        # [S] — public-convention y_i α_i
    intercept: torch.Tensor        # scalar — public convention
    gamma: torch.Tensor            # scalar — fitted γ
    prob_a: torch.Tensor           # scalar — libsvm _probA
    prob_b: torch.Tensor           # scalar — libsvm _probB


def decision_function(params: SVCParams, Xt: torch.Tensor) -> torch.Tensor:
    """``dec[n]`` over *scaler-transformed* inputs; positive → class 1."""
    Xt = Xt.to(float_dtype(Xt, params.support_vectors))
    K = rbf_kernel(Xt, params.support_vectors, params.gamma)
    return K @ params.dual_coef + params.intercept


def _binary_coupling(r0: torch.Tensor) -> torch.Tensor:
    """libsvm ``multiclass_probability`` specialised to k=2, vectorised.

    ``r0`` is the clipped pairwise probability of class 0; returns
    P(class 1). All 100 iterations run from the ``p = [0.5, 0.5]`` start,
    including the mid-update renormalisations; a lane that has met the
    tolerance keeps its value (the ``done`` mask), so the trajectory is
    libsvm's without a host sync per iteration.
    """
    r1 = 1.0 - r0
    q00, q01, q11 = r1 * r1, -r1 * r0, r0 * r0
    p0 = torch.full_like(r0, 0.5)
    p1 = torch.full_like(r0, 0.5)
    done = torch.zeros_like(r0, dtype=torch.bool)
    for _ in range(_COUPLING_MAX_ITER):
        qp0 = q00 * p0 + q01 * p1
        qp1 = q01 * p0 + q11 * p1
        pqp = p0 * qp0 + p1 * qp1
        err = torch.maximum(torch.abs(qp0 - pqp), torch.abs(qp1 - pqp))
        done = done | (err < _COUPLING_EPS)

        # t = 0 update (libsvm also updates Qp[0] here; it is recomputed
        # from p at the top of the next iteration, so it is not carried)
        diff = (-qp0 + pqp) / q00
        n_p0 = p0 + diff
        d1 = 1 + diff
        n_pqp = (pqp + diff * (2 * qp0 + diff * q00)) / (d1 * d1)
        n_qp1 = (qp1 + diff * q01) / d1
        n_p0, n_p1 = n_p0 / d1, p1 / d1
        # t = 1 update
        diff = (-n_qp1 + n_pqp) / q11
        n_p1 = n_p1 + diff
        n_p0, n_p1 = n_p0 / (1 + diff), n_p1 / (1 + diff)

        p0 = torch.where(done, p0, n_p0)
        p1 = torch.where(done, p1, n_p1)
    return p1


def predict_proba1(params: SVCParams, Xt: torch.Tensor) -> torch.Tensor:
    """P(class 1), exact libsvm binary semantics (see module docstring)."""
    dec = decision_function(params, Xt)
    f = -dec  # libsvm internal orientation
    r0 = torch.sigmoid(-(params.prob_a * f + params.prob_b))
    r0 = torch.clamp(r0, _MIN_PROB, 1.0 - _MIN_PROB)
    return _binary_coupling(r0)

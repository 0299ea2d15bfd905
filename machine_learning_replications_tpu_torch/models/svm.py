"""RBF support-vector classifier: inference, then training.

Reference member: ``SVC(class_weight='balanced', probability=True)`` inside
a StandardScaler pipeline (``train_ensemble_public.py:44``). The probability
path reproduces libsvm's binary semantics exactly, as the
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

Training (the second half, ``svc_fit`` and friends) ports the JAX package's
dual solver: accelerated projected gradient on libsvm's dual, a bisection
projection onto the box ∩ hyperplane, and Platt's Newton fit. Where the JAX
package ``vmap``s solves (the Platt CV folds, the stacking CV's fold fits),
the port carries lane dimensions: every solve of one ``svc_fit`` shares one
``Q`` (only the box ``C`` differs per lane), so each step's ``Q @ z`` is one
matrix product over all lanes; lanes that have converged are frozen, as in
a batched ``lax.while_loop``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from machine_learning_replications_tpu_torch.device import float_dtype, to_host
from machine_learning_replications_tpu_torch.models.solvers import (
    _power_lmax,
    balanced_class_weights,
    balanced_class_weights_masked,
)
from machine_learning_replications_tpu_torch.ops.linalg import rbf_kernel
from machine_learning_replications_tpu_torch.ops.steps import momentum_table, run_blocks
from machine_learning_replications_tpu_torch.utils.cv import stratified_kfold_test_masks

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


def predict_proba1_chunked(params: SVCParams, Xt, chunk_rows: int = 65_536) -> np.ndarray:
    """``predict_proba1`` over row chunks of ``Xt`` (on the parameters'
    device), bounding the ``[chunk, n_sv]`` kernel block: the scaled-regime
    predict path. Returns host numpy."""
    dev = params.support_vectors.device
    Xt = torch.as_tensor(Xt, device=dev)
    n = Xt.shape[0]
    if n <= chunk_rows:
        return to_host(predict_proba1(params, Xt))
    return np.concatenate([to_host(predict_proba1(params, Xt[s:s + chunk_rows]))
                           for s in range(0, n, chunk_rows)])


# ---------------------------------------------------------------------------
# Training: dual QP + Platt calibration (replaces libsvm's SMO)
# ---------------------------------------------------------------------------
#
# Accelerated projected gradient on the dual
#       max_α 1ᵀα − ½ αᵀ(ssᵀ⊙K)α   s.t. 0 ≤ α_i ≤ C_i,  sᵀα = 0,
# one n×n product per step plus a projection onto the box ∩ hyperplane by
# bisection on the hyperplane multiplier. Per-sample C_i doubles as the fold
# mask: rows with C_i = 0 stay at α = 0, so fold and Platt sub-solves share
# one shape.
#
# Shapes below: ``Q [..., n, n]`` (leading dimensions: stacking folds),
# ``s [..., 1, n]``, and ``C``, ``α`` ``[..., L, n]`` with L lanes per ``Q``.


def _project_box_hyperplane(v, s, C, iters: int = 64):
    """Project each lane of ``v`` onto {0 ≤ α ≤ C} ∩ {sᵀα = 0} (Euclidean).

    α(λ) = clip(v − λ s, 0, C); g(λ) = sᵀα(λ) is nonincreasing — bisect, a
    fixed ``iters`` steps for every lane, with no host sync."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    bound = torch.amax(torch.abs(v), dim=-1) + torch.amax(C, dim=-1) + 1.0
    lo, hi = -bound, bound
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        g = torch.sum(s * torch.clamp(v - mid[..., None] * s, min=zero, max=C), dim=-1)
        up = g > 0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    lam = 0.5 * (lo + hi)
    return torch.clamp(v - lam[..., None] * s, min=zero, max=C)


_KKT_CHECK_EVERY = 8  # optimality matvec every k iterations


def _matvec(Q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``Q @ a`` for every lane of ``a [..., L, n]``: one product."""
    return a @ Q.transpose(-1, -2)


def solve_dual(K, s, C, tol: float = 1e-5, max_iter: int = 3000, *, iterations=None):
    """Accelerated projected-gradient ascent on the SVC dual → α.

    ``K [..., n, n]``, ``s [..., n]`` (±1), ``C`` per sample: ``[..., n]`` for
    one solve, ``[..., L, n]`` for L lanes sharing ``K`` (class weights × C ×
    fold mask). Stops on libsvm's optimality measure, the maximal KKT
    violation ``m(α) − M(α)`` over the working sets, evaluated after every
    block of ``_KKT_CHECK_EVERY`` steps: ``tol`` means what sklearn's
    ``SVC(tol=...)`` means. A lane that meets it is frozen; the host checks
    once per block whether any lane runs. ``iterations`` (a list), when
    given, receives the steps each lane took."""
    one = C.dim() == s.dim()
    if one:
        C = C.unsqueeze(-2)
    s = s.unsqueeze(-2)
    Q = (s.transpose(-1, -2) * s) * K
    step = (1.0 / torch.clamp_min(_power_lmax(Q), 1e-12))[..., None, None]
    lanes = C.shape[:-1]
    dt, dev = C.dtype, C.device
    inf = torch.tensor(torch.inf, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    up_pos, low_pos = s > 0, s < 0
    active_rows = C > 0  # fold-masked rows are frozen at α=0, outside both sets

    def kkt_violation(a):
        # libsvm minimizes f(α) = ½αᵀQα − 1ᵀα over {0≤α≤C, sᵀα=0};
        # v_i = −s_i ∇f_i; stop when max_{I_up} v − min_{I_low} v ≤ tol.
        v = -s * (_matvec(Q, a) - 1.0)
        up = ((up_pos & (a < C)) | (low_pos & (a > 0))) & active_rows
        low = ((up_pos & (a > 0)) | (low_pos & (a < C))) & active_rows
        m = torch.amax(torch.where(up, v, -inf), dim=-1)
        M = torch.amin(torch.where(low, v, inf), dim=-1)
        return m - M

    a = torch.zeros(lanes + s.shape[-1:], dtype=dt, device=dev)
    z = torch.zeros_like(a)
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    viol = torch.full(lanes, torch.inf, dtype=dt, device=dev)
    n_blocks = -(-max_iter // _KKT_CHECK_EVERY)
    betas = momentum_table(n_blocks * _KKT_CHECK_EVERY, dt, dev)
    k0 = torch.zeros((), dtype=torch.long, device=dev)
    offsets = torch.arange(_KKT_CHECK_EVERY, device=dev)

    def block():
        # A fixed block of steps, then ONE optimality matvec; a lane that has
        # met the tolerance (or max_iter) keeps its state.
        active = viol >= tol
        if max_iter % _KKT_CHECK_EVERY:
            active = active & (it < max_iter)
        bs = betas.index_select(0, k0 + offsets)
        a_b, z_b = a, z
        for j in range(_KKT_CHECK_EVERY):
            grad = 1.0 - _matvec(Q, z_b)
            a_new = _project_box_hyperplane(z_b + step * grad, s, C)
            z_b = a_new + bs[j] * (a_new - a_b)
            # keep the extrapolated point feasible enough: re-clip the box
            z_b = torch.clamp(z_b, min=zero, max=C)
            a_b = a_new
        viol_b = kkt_violation(a_b)
        keep = active[..., None]
        a.copy_(torch.where(keep, a_b, a))
        z.copy_(torch.where(keep, z_b, z))
        viol.copy_(torch.where(active, viol_b, viol))
        it.add_(active.to(torch.int32), alpha=_KKT_CHECK_EVERY)
        k0.add_(_KKT_CHECK_EVERY)

    run_blocks(block, n_blocks, lambda: bool(torch.any(viol >= tol)), dev)
    if iterations is not None:
        iterations.append(to_host(it).ravel().tolist())
    return a[..., 0, :] if one else a


def _intercept_from_alpha(K, s, C, alpha):
    """b from KKT: the mean of s_i − f_i over free SVs; without free SVs the
    midpoint of the KKT-feasible interval (libsvm ``calculate_rho``).
    ``alpha``, ``C`` ``[..., L, n]`` (or ``[..., n]``), ``s [..., n]``."""
    one = alpha.dim() == s.dim()
    if one:
        alpha, C = alpha.unsqueeze(-2), C.unsqueeze(-2)
    s = s.unsqueeze(-2)
    f = _matvec(K, alpha * s)
    tau = 1e-8 * torch.clamp_min(torch.amax(C, dim=-1, keepdim=True), 1.0)
    free = (alpha > tau) & (alpha < C - tau) & (C > 0)
    n_free = torch.sum(free, dim=-1)
    b_free = (torch.sum(torch.where(free, s - f, 0.0), dim=-1)
              / torch.clamp_min(n_free, 1).to(alpha.dtype))
    lower = (((alpha < C - tau) & (s > 0)) | ((alpha > tau) & (s < 0))) & (C > 0)
    upper = (((alpha < C - tau) & (s < 0)) | ((alpha > tau) & (s > 0))) & (C > 0)
    lo_b = torch.amax(torch.where(lower, s - f, -torch.inf), dim=-1)
    hi_b = torch.amin(torch.where(upper, s - f, torch.inf), dim=-1)
    b = torch.where(n_free > 0, b_free, 0.5 * (lo_b + hi_b))
    return b[..., 0] if one else b


def platt_sigmoid_train(dec, y, sample_mask=None, n_iter: int = 100):
    """libsvm ``sigmoid_train``: Newton fit of (A, B) on held-out decision
    values with Platt's smoothed targets, over lanes ``dec [..., n]``.
    Each Newton step's backtracking line search halves until the objective
    decreases; a lane whose search is done is frozen while others halve."""
    mask = torch.ones_like(dec) if sample_mask is None else sample_mask.to(dec.dtype)
    prior1 = torch.sum(torch.where(y > 0.5, mask, 0.0), dim=-1)
    prior0 = torch.sum(mask, dim=-1) - prior1
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = torch.where(y > 0.5, hi[..., None], lo[..., None])
    sigma = 1e-12
    zero = torch.zeros((), dtype=dec.dtype, device=dec.device)

    def nll(A, B):
        fApB = dec * A[..., None] + B[..., None]
        # log(1 + e^{fApB}) − t·fApB, exact (softplus cuts over to x above 20)
        return torch.sum((torch.logaddexp(zero, fApB) - t * fApB) * mask, dim=-1)

    # Our orientation is P(t=1) = σ(A·dec + B) (libsvm fits the mirrored
    # σ(-(A·f+B))), so the prior-matching init is log((n₊+1)/(n₋+1)).
    A = torch.zeros_like(prior1)
    B = torch.log((prior1 + 1.0) / (prior0 + 1.0))
    for _ in range(n_iter):
        fApB = dec * A[..., None] + B[..., None]
        p = torch.sigmoid(fApB)
        d1 = (p - t) * mask
        d2 = p * (1.0 - p) * mask
        g0, g1 = torch.sum(dec * d1, dim=-1), torch.sum(d1, dim=-1)
        h11 = torch.sum(dec * dec * d2, dim=-1) + sigma
        h22 = torch.sum(d2, dim=-1) + sigma
        h12 = torch.sum(dec * d2, dim=-1)
        det = h11 * h22 - h12 * h12
        dA = -(h22 * g0 - h12 * g1) / det
        dB = -(-h12 * g0 + h11 * g1) / det
        gstep = g0 * dA + g1 * dB
        f0 = nll(A, B)
        stepsize = torch.full_like(A, 2.0)
        fnew = torch.full_like(A, torch.inf)
        while True:
            searching = (fnew > f0 + 1e-4 * stepsize * gstep) & (stepsize > 1e-10)
            if not bool(searching.any()):
                break
            half = stepsize * 0.5
            f_half = nll(A + half * dA, B + half * dB)
            stepsize = torch.where(searching, half, stepsize)
            fnew = torch.where(searching, f_half, fnew)
        A, B = A + stepsize * dA, B + stepsize * dB
    return A, B


def scale_gamma(Xt: torch.Tensor) -> torch.Tensor:
    """sklearn ``gamma='scale'``: 1 / (n_features · X.var()) over all entries
    (population variance)."""
    return 1.0 / (Xt.shape[-1] * torch.var(Xt, correction=0))


def _fit_lanes(Xt, y, Cvec, platt_test_masks, gamma, tol, max_iter, sample_mask,
               iterations):
    """The full solve and the Platt CV solves of one ``Q`` as lanes of one
    batched solve (lane 0: ``Cvec``; lane 1 + j: ``Cvec`` without Platt fold
    j's rows), then the intercepts and Platt's sigmoid on the out-of-fold
    decision values. Each lane is the solve the JAX package runs alone."""
    dtype = Xt.dtype
    s = 2.0 * y - 1.0
    gamma = torch.as_tensor(gamma, dtype=dtype, device=Xt.device)
    K = rbf_kernel(Xt, Xt, gamma[..., None, None])     # one [n, n] kernel per fold
    tm = platt_test_masks.to(dtype)
    Cl = torch.cat([Cvec.unsqueeze(-2), Cvec.unsqueeze(-2) * (1.0 - tm)], dim=-2)
    alpha = solve_dual(K, s, Cl, tol, max_iter, iterations=iterations)
    b = _intercept_from_alpha(K, s, Cl, alpha)
    dec = (_matvec(K, alpha[..., 1:, :] * s.unsqueeze(-2)) + b[..., 1:, None]) * tm
    A_fit, B_fit = platt_sigmoid_train(torch.sum(dec, dim=-2), y, sample_mask=sample_mask)
    # Stored convention (see predict_proba1): P(class 0) = σ(A·dec − B)
    return SVCParams(
        support_vectors=Xt,
        dual_coef=alpha[..., 0, :] * s,
        intercept=b[..., 0],
        gamma=gamma.expand(Xt.shape[:-2]).contiguous(),
        prob_a=-A_fit,
        prob_b=B_fit,
    )


def svc_fit(
    Xt: torch.Tensor,
    y: torch.Tensor,
    C: float = 1.0,
    gamma=None,
    balanced: bool = True,
    probability: bool = True,
    platt_cv: int = 5,
    tol: float = 1e-5,
    max_iter: int = 20_000,
    *,
    iterations=None,
) -> SVCParams:
    """Fit the RBF SVC on *scaler-transformed* ``Xt [n, F]``.

    One full dual solve plus (for Platt) ``platt_cv`` masked fold solves, all
    lanes of one batched solve sharing ``K`` — the reference runs these six
    libsvm solves one after another. Platt's CV uses deterministic stratified
    contiguous folds, as in the JAX package. Every row is kept as a "support
    vector" (zero-coefficient rows are inert); ``trim_support`` compacts."""
    dtype = Xt.dtype
    y = torch.as_tensor(y, device=Xt.device).to(dtype)
    if gamma is None:
        gamma = scale_gamma(Xt)
    cw = balanced_class_weights(y) if balanced else torch.ones_like(y)
    Cvec = C * cw
    if probability:
        tm = torch.as_tensor(stratified_kfold_test_masks(to_host(y), platt_cv),
                             dtype=dtype, device=Xt.device)
        return _fit_lanes(Xt, y, Cvec, tm, gamma, tol, max_iter, None, iterations)
    s = 2.0 * y - 1.0
    K = rbf_kernel(Xt, Xt, gamma)
    alpha = solve_dual(K, s, Cvec, tol, max_iter, iterations=iterations)
    nan = torch.tensor(torch.nan, dtype=dtype, device=Xt.device)
    return SVCParams(support_vectors=Xt, dual_coef=alpha * s,
                     intercept=_intercept_from_alpha(K, s, Cvec, alpha),
                     gamma=torch.as_tensor(gamma, dtype=dtype, device=Xt.device),
                     prob_a=nan, prob_b=nan)


def svc_fit_masked(
    Xt: torch.Tensor,                # [..., n, F] scaler-transformed (fold scaler)
    y: torch.Tensor,                 # [..., n]
    train_mask: torch.Tensor,        # [..., n] 1.0 = row in this fit
    platt_test_masks: torch.Tensor,  # [..., k, n] Platt-CV test masks ⊂ train_mask
    C: float = 1.0,
    gamma=None,
    balanced: bool = True,
    tol: float = 1e-5,
    max_iter: int = 20_000,
    *,
    iterations=None,
) -> SVCParams:
    """``svc_fit`` over a masked row subset with one shape for every fold —
    the unit of the stacking CV's fold fan-out. Leading dimensions of ``Xt``
    are folds, each with its own kernel matrix; the returned parameters carry
    them.

    A row with ``C_i = 0`` never receives dual weight, so ``Cvec ·
    train_mask`` excludes it while keeping the shapes; excluded rows stay in
    the support-vector array with zero coefficient. ``gamma=None`` is
    sklearn's ``'scale'`` over the masked rows."""
    dtype = Xt.dtype
    m = train_mask.to(dtype)
    y = y.to(dtype)
    if gamma is None:
        # masked 'scale': 1 / (F · var(train rows, all entries))
        F = Xt.shape[-1]
        n_eff = torch.sum(m, dim=-1) * F
        mu = torch.sum(Xt * m[..., None], dim=(-2, -1)) / n_eff
        var = torch.sum(((Xt - mu[..., None, None]) ** 2) * m[..., None], dim=(-2, -1)) / n_eff
        gamma = 1.0 / (F * var)
    cw = balanced_class_weights_masked(y, m) if balanced else torch.ones_like(m)
    Cvec = C * cw * m
    return _fit_lanes(Xt, y, Cvec, platt_test_masks, gamma, tol, max_iter, m, iterations)


def trim_support(params: SVCParams, tol: float = 1e-10) -> SVCParams:
    """Drop zero-coefficient rows (host-side decision; dynamic shapes)."""
    keep = torch.as_tensor(np.abs(to_host(params.dual_coef)) > tol,
                           device=params.dual_coef.device)
    return dataclasses.replace(params, support_vectors=params.support_vectors[keep],
                               dual_coef=params.dual_coef[keep])

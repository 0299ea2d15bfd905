"""Convex solvers for the linear members, on tensors.

Port of the JAX package's ``models/solvers.py`` (its mesh path aside). The
reference reaches three native optimizers (SURVEY.md §2.4): coordinate
descent (LassoCV, ``train_ensemble_public.py:51``), liblinear's newGLMNET
(L1 logistic regression, ``:46``) and lbfgs (meta learner, ``:48``). All
three problems are convex, so the same objectives are solved with
accelerated proximal gradient (FISTA) and damped Newton, as in the JAX
package:

  * Lasso:    1/(2n)·Σ w_i(y_i − x_i·β)² + α‖β‖₁
  * L1-LR:    ‖β̃‖₁ + C·Σ cw_i log(1+exp(−ỹ_i x̃_i·β̃))   (bias column penalized)
  * L2-LR:    ½‖β‖² + C·Σ cw_i log(1+exp(−ỹ_i(x_i·β + b)))  (intercept free)

Batched lanes. Where the JAX package ``vmap``s a ``lax.while_loop`` (the
LassoCV folds, the stacking CV's L1-LR folds), the port carries a leading
lane axis. A batched ``while_loop`` keeps stepping while any lane runs, but a
lane whose condition is false is frozen: its state is selected, not updated.
``_fista_while`` does the same with ``torch.where``, so each lane's result is
its unbatched run. The host asks whether any lane is still active only every
``_SYNC_EVERY`` steps; frozen lanes do not move, so the extra steps change
nothing.
"""

from __future__ import annotations

import math

import torch

from machine_learning_replications_tpu_torch.models.linear import LinearParams
from machine_learning_replications_tpu_torch.ops.steps import momentum_table, run_blocks

_SYNC_EVERY = 8  # FISTA steps per block: the host asks "is any lane running" once a block


def soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def balanced_class_weights(y: torch.Tensor) -> torch.Tensor:
    """sklearn's ``class_weight='balanced'``: w_i = n / (2 · n_{class(i)})."""
    n = y.shape[-1]
    n1 = torch.sum(y, dim=-1, keepdim=True)
    n0 = n - n1
    return torch.where(y > 0.5, n / (2.0 * n1), n / (2.0 * n0))


def balanced_class_weights_masked(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Balanced weights over the rows of ``mask`` (``[..., n]`` lanes)."""
    n = torch.sum(mask, dim=-1, keepdim=True)
    n1 = torch.sum(y * mask, dim=-1, keepdim=True)
    n0 = n - n1
    return torch.where(y > 0.5, n / (2.0 * n1), n / (2.0 * n0))


def _power_lmax(G: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Largest eigenvalue of a PSD matrix ``[..., d, d]`` by power iteration."""
    d = G.shape[-1]
    v = torch.ones(G.shape[:-1], dtype=G.dtype, device=G.device) / math.sqrt(d)
    for _ in range(iters):
        w = (G @ v[..., None])[..., 0]
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1, keepdim=True), 1e-30)
    return torch.sum(v * (G @ v[..., None])[..., 0], dim=-1)


# ---------------------------------------------------------------------------
# Lasso (weighted, for masked CV folds)
# ---------------------------------------------------------------------------


def _fista_while(prox_step, w0: torch.Tensor, tol: float, max_iter: int):
    """Accelerated-proximal-gradient driver with residual early exit, over
    ``w0 [..., d]`` (leading dimensions are lanes).

    ``prox_step(z) -> w_new`` is one proximal gradient step from the
    extrapolated point. A lane stops when its iterate change falls below
    ``tol · (1 + ‖w‖∞)`` or at ``max_iter``, and is frozen from then on.
    Returns ``(w, n_done)``, ``n_done`` the steps each lane took."""
    lanes, dt, dev = w0.shape[:-1], w0.dtype, w0.device
    w, z = w0.clone(), w0.clone()
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    delta = torch.full(lanes, torch.inf, dtype=dt, device=dev)
    n_blocks = -(-max_iter // _SYNC_EVERY)
    betas = momentum_table(n_blocks * _SYNC_EVERY, dt, dev)
    k0 = torch.zeros((), dtype=torch.long, device=dev)
    offsets = torch.arange(_SYNC_EVERY, device=dev)

    def block():
        bs = betas.index_select(0, k0 + offsets)
        for j in range(_SYNC_EVERY):
            active = delta >= tol
            if max_iter % _SYNC_EVERY:  # a running lane's `it` is the step count
                active = active & (it < max_iter)
            w_new = prox_step(z)
            diff = w_new - w
            z_new = w_new + bs[j] * diff
            d_new = (torch.amax(torch.abs(diff), dim=-1)
                     / (1.0 + torch.amax(torch.abs(w_new), dim=-1)))
            a = active[..., None]
            w.copy_(torch.where(a, w_new, w))
            z.copy_(torch.where(a, z_new, z))
            delta.copy_(torch.where(active, d_new, delta))
            it.add_(active)
        k0.add_(_SYNC_EVERY)

    run_blocks(block, n_blocks, lambda: bool(torch.any(delta >= tol)), dev)
    return w, it


def lasso_fista(
    X: torch.Tensor,            # [n, F] raw (uncentered)
    y: torch.Tensor,            # [n]
    alpha,
    sample_mask: torch.Tensor,  # [n] 1.0 = in this fit
    w0: torch.Tensor,
    lmax,                       # λmax of (X_cᵀ diag(mask) X_c)/n_eff, precomputed
    tol: float = 1e-6,
    max_iter: int = 1000,
) -> torch.Tensor:
    """Weighted-row Lasso coefficients (no intercept — the caller centers)."""
    n_eff = torch.sum(sample_mask)
    xm = (sample_mask @ X) / n_eff
    ym = (sample_mask @ y) / n_eff
    Xc = (X - xm) * sample_mask[:, None]
    yc = (y - ym) * sample_mask
    step = 1.0 / torch.clamp_min(torch.as_tensor(lmax, dtype=X.dtype, device=X.device), 1e-12)

    def prox_step(z):
        grad = (Xc.T @ (Xc @ z - yc)) / n_eff
        return soft_threshold(z - step * grad, step * alpha)

    return _fista_while(prox_step, w0, tol, max_iter)[0]


def lasso_intercept(X, y, w, sample_mask):
    n_eff = torch.sum(sample_mask)
    return (sample_mask @ y) / n_eff - ((sample_mask @ X) / n_eff) @ w


def _alpha_ratios(n_alphas: int, eps: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.logspace(0, log10(eps), n_alphas)`` built as JAX builds it:
    ``10 ** linspace`` with the linspace formed as ``stop · i/(A−1)`` and the
    last point set to ``stop`` exactly, in float64, then cast."""
    stop = torch.log10(torch.tensor(eps, dtype=torch.float64, device=device))
    div = n_alphas - 1
    if div > 0:
        steps = torch.arange(div, dtype=torch.float64, device=device) / div
        lin = torch.cat([stop * steps, stop[None]])
    else:
        lin = torch.zeros(n_alphas, dtype=torch.float64, device=device)
    return torch.pow(10.0, lin).to(dtype)


def alpha_grid(X: torch.Tensor, y: torch.Tensor, n_alphas: int, eps: float) -> torch.Tensor:
    """sklearn ``_alpha_grid``: α_max = max|X_cᵀ y_c|/n on the *full* centered
    data; log-spaced down to ``eps·α_max``, descending."""
    n = X.shape[0]
    Xc = X - torch.mean(X, dim=0)
    yc = y - torch.mean(y)
    amax = torch.amax(torch.abs(Xc.T @ yc)) / n
    return _alpha_ratios(n_alphas, eps, X.dtype, X.device) * amax


def lasso_path(
    X, y, alphas, sample_mask, tol: float = 1e-6, max_iter: int = 1000
) -> torch.Tensor:
    """Warm-started path over a descending alpha grid → coefs ``[A, F]``."""
    n_eff = torch.sum(sample_mask)
    xm = (sample_mask @ X) / n_eff
    Xc = (X - xm) * sample_mask[:, None]
    lmax = _power_lmax(Xc.T @ Xc) / n_eff
    w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    coefs = []
    for alpha in alphas:
        w = lasso_fista(X, y, alpha, sample_mask, w, lmax, tol, max_iter)
        coefs.append(w)
    return torch.stack(coefs)


# ---------------------------------------------------------------------------
# LassoCV in covariance (sufficient-statistics) form
#
# The weighted-lasso objective touches the data only through Σ x xᵀ, Σ x y,
# Σ x, Σ y, Σ y² per train fold. Those are taken per TEST fold (train =
# total − test, since contiguous KFold partitions the rows), so the whole
# 10-fold × 100-alpha CV path is F-dimensional work after K slice-Gram
# products over the rows.
# ---------------------------------------------------------------------------


def fold_bounds(n: int, k: int) -> list[tuple[int, int]]:
    """sklearn ``KFold(shuffle=False)`` boundaries: first ``n % k`` folds get
    one extra row; contiguous, partitioning ``range(n)``."""
    base, extra = divmod(n, k)
    bounds, start = [], 0
    for i in range(k):
        end = start + base + (1 if i < extra else 0)
        bounds.append((start, end))
        start = end
    return bounds


def _slice_stats(Xs: torch.Tensor, ys: torch.Tensor) -> dict:
    """Second-order statistics of one row block (uncentered)."""
    return {
        "sxx": Xs.T @ Xs,             # [F, F]
        "sx": torch.sum(Xs, dim=0),   # [F]
        "sxy": Xs.T @ ys,             # [F]
        "sy": torch.sum(ys),
        "syy": ys @ ys,
        "m": torch.tensor(Xs.shape[0], dtype=Xs.dtype, device=Xs.device),
    }


def lasso_fold_stats(X: torch.Tensor, y: torch.Tensor, cv_folds: int) -> dict:
    """Per-TEST-fold sufficient statistics, stacked on a leading [K] axis,
    of the MEAN-SHIFTED data, plus the shift itself (``mu`` [F], ``nu``).

    The shift keeps float32 sane: the centered Gram ``sxx − m·x̄x̄ᵀ`` cancels
    catastrophically when column means dominate the spread. Shifting by the
    global column means first makes x̄ ≈ 0 in every fold. A common shift is
    exact for everything downstream (centered Grams, cross-moments, the
    alpha grid, held-out residuals); only the final intercept needs the
    un-shift (``lasso_cv_from_stats``)."""
    mu = torch.mean(X, dim=0)
    nu = torch.mean(y)
    Xs, ys = X - mu, y - nu
    per_fold = [_slice_stats(Xs[s:e], ys[s:e]) for s, e in fold_bounds(X.shape[0], cv_folds)]
    stats = {k: torch.stack([st[k] for st in per_fold]) for k in per_fold[0]}
    stats["mu"] = mu
    stats["nu"] = nu
    return stats


def _centered_form(st: dict):
    """(Gc, c, xm, ym) of a stats dict (leading dimensions are folds): the
    centered Gram ``XcᵀXc``, the centered cross-moment ``Xcᵀyc`` and the
    means."""
    m = torch.clamp_min(st["m"], 1.0)
    xm = st["sx"] / m[..., None]
    ym = st["sy"] / m
    Gc = st["sxx"] - st["m"][..., None, None] * (xm[..., :, None] * xm[..., None, :])
    c = st["sxy"] - st["m"][..., None] * xm * ym[..., None]
    return Gc, c, xm, ym


def lasso_fista_stats(
    Gc: torch.Tensor, c: torch.Tensor, alpha, m, w0: torch.Tensor, lmax,
    tol: float, max_iter: int,
) -> torch.Tensor:
    """``lasso_fista`` on the centered covariance form (leading dimensions are
    lanes): 1/(2m)·‖yc − Xc β‖² + α‖β‖₁ has gradient (Gc β − c)/m."""
    step = 1.0 / torch.clamp_min(lmax, 1e-12)

    def prox_step(z):
        grad = ((Gc @ z[..., None])[..., 0] - c) / m[..., None]
        return soft_threshold(z - step[..., None] * grad, (step * alpha)[..., None])

    return _fista_while(prox_step, w0, tol, max_iter)[0]


def _lasso_path_stats(train_st: dict, alphas: torch.Tensor, tol, max_iter) -> torch.Tensor:
    """Warm-started descending-alpha paths on the train folds' stats, all
    folds as lanes → ``[K, A, F]``."""
    Gc, cvec, _, _ = _centered_form(train_st)
    m = torch.clamp_min(train_st["m"], 1.0)
    lmax = _power_lmax(Gc) / m
    w = torch.zeros(cvec.shape, dtype=Gc.dtype, device=Gc.device)
    coefs = []
    for a in range(alphas.shape[0]):
        w = lasso_fista_stats(Gc, cvec, alphas[a], m, w, lmax, tol, max_iter)
        coefs.append(w)
    return torch.stack(coefs, dim=1)


def _holdout_mse(test_st: dict, coefs: torch.Tensor, intercepts: torch.Tensor) -> torch.Tensor:
    """Held-out MSE of (coefs [K, A, F], intercepts [K, A]) from the test
    folds' stats: Σ(x·w + b − y)² expands into the second-order statistics."""
    quad = torch.einsum("kaf,kfg,kag->ka", coefs, test_st["sxx"], coefs)
    sse = (
        quad
        + 2.0 * intercepts * (coefs @ test_st["sx"][..., None])[..., 0]
        - 2.0 * (coefs @ test_st["sxy"][..., None])[..., 0]
        + test_st["m"][:, None] * intercepts**2
        - 2.0 * intercepts * test_st["sy"][:, None]
        + test_st["syy"][:, None]
    )
    return sse / torch.clamp_min(test_st["m"], 1.0)[:, None]


def lasso_cv_from_stats(
    test_stats: dict,
    *,
    n_alphas: int = 100,
    eps: float = 1e-3,
    tol: float = 1e-6,
    max_iter: int = 1000,
):
    """The CV-path/selection half of ``lasso_cv``, from per-test-fold stats
    ([K, ...] leading axis) of mean-shifted data: F-dimensional work only.
    Every fold arithmetic happens in the shifted frame; the returned
    intercept is un-shifted at the end."""
    test_stats = dict(test_stats)
    mu = test_stats.pop("mu", None)
    nu = test_stats.pop("nu", None)
    totals = {k: torch.sum(v, dim=0) for k, v in test_stats.items()}
    n = totals["m"]

    # alpha grid from the full-data centered cross-moments (sklearn _alpha_grid)
    _, c_full, _, _ = _centered_form(totals)
    amax = torch.amax(torch.abs(c_full)) / n
    alphas = _alpha_ratios(n_alphas, eps, c_full.dtype, c_full.device) * amax

    train_stats = {k: totals[k][None] - test_stats[k] for k in totals}
    coefs = _lasso_path_stats(train_stats, alphas, tol, max_iter)        # [K, A, F]
    _, _, xm, ym = _centered_form(train_stats)
    intercepts = ym[:, None] - (coefs @ xm[..., None])[..., 0]         # [K, A]
    mse_path = _holdout_mse(test_stats, coefs, intercepts).T             # [A, K]
    best = torch.argmin(torch.mean(mse_path, dim=1))
    alpha_ = alphas[best]

    Gc, cvec, xm, ym = _centered_form(totals)
    lmax = _power_lmax(Gc) / n
    coef = lasso_fista_stats(Gc, cvec, alpha_, n, torch.zeros_like(cvec), lmax,
                             tol, 2 * max_iter)
    intercept = ym - coef @ xm
    if mu is not None:
        # Un-shift: b = (ym' − x̄'·w) + ν − μ·w for X' = X − μ, y' = y − ν.
        intercept = intercept + nu - coef @ mu
    return coef, intercept, alpha_, alphas, mse_path


def lasso_cv(
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    cv_folds: int = 10,
    n_alphas: int = 100,
    eps: float = 1e-3,
    tol: float = 1e-6,
    max_iter: int = 1000,
):
    """LassoCV (reference ``train_ensemble_public.py:51``): contiguous
    unshuffled K-folds, shared full-data alpha grid, per-fold held-out MSE,
    best alpha by mean MSE (first of equal means), final refit on all rows.

    Returns ``(coef [F], intercept, alpha_, alphas [A], mse_path [A, K])`` as
    tensors on ``X``'s device."""
    stats = lasso_fold_stats(X, y.to(X.dtype), cv_folds)
    return lasso_cv_from_stats(stats, n_alphas=n_alphas, eps=eps, tol=tol, max_iter=max_iter)


# ---------------------------------------------------------------------------
# Logistic regressions
# ---------------------------------------------------------------------------


def logreg_l1_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    C: float = 1.0,
    sample_mask: "torch.Tensor | None" = None,
    balanced: bool = True,
    tol: float = 1e-5,
    max_iter: int = 2000,
) -> LinearParams:
    """liblinear-equivalent L1 logistic regression (bias column penalized).

    ``sample_mask`` ``[..., n]`` makes each leading index a lane of its own —
    the stacking CV's fold fits — over the shared rows ``X [n, F]``; the
    returned coefficients carry the lane dimensions."""
    n, F = X.shape
    dt, dev = X.dtype, X.device
    y = y.to(dt)
    mask = torch.ones(n, dtype=dt, device=dev) if sample_mask is None else sample_mask.to(dt)
    cw = balanced_class_weights_masked(y, mask) if balanced else torch.ones_like(mask)
    ccw = C * (cw * mask)                                    # [..., n]
    Xt = torch.cat([X, torch.ones((n, 1), dtype=dt, device=dev)], dim=1)  # bias column
    s = 2.0 * y - 1.0                                        # ±1 labels

    G = Xt.T @ (Xt * ccw[..., :, None])
    lmax = 0.25 * _power_lmax(G)
    step = 1.0 / torch.clamp_min(lmax, 1e-12)

    def grad_fn(w):
        m = s * (w @ Xt.T)
        sig = torch.sigmoid(-m)  # d/dm log(1+e^{-m}) = -σ(-m)
        return (-ccw * sig * s) @ Xt

    def prox_step(z):
        return soft_threshold(z - step[..., None] * grad_fn(z), step[..., None])

    w0 = torch.zeros(ccw.shape[:-1] + (F + 1,), dtype=dt, device=dev)
    w, _ = _fista_while(prox_step, w0, tol, max_iter)
    return LinearParams(coef=w[..., :F], intercept=w[..., F])


def logreg_l2_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    C: float = 1.0,
    sample_mask: "torch.Tensor | None" = None,
    balanced: bool = True,
    tol: float = 1e-8,
    max_iter: int = 60,
) -> LinearParams:
    """lbfgs-equivalent L2 logistic regression by damped Newton (3
    meta-features + intercept). Stops on the Newton step's ∞-norm or at
    ``max_iter``."""
    n, F = X.shape
    dt, dev = X.dtype, X.device
    y = y.to(dt)
    mask = torch.ones(n, dtype=dt, device=dev) if sample_mask is None else sample_mask.to(dt)
    cw = (balanced_class_weights_masked(y, mask) if balanced else torch.ones_like(mask)) * mask
    ccw = C * cw
    Xt = torch.cat([X, torch.ones((n, 1), dtype=dt, device=dev)], dim=1)
    s = 2.0 * y - 1.0
    reg = torch.cat([torch.ones(F, dtype=dt, device=dev),
                     torch.zeros(1, dtype=dt, device=dev)])  # no bias penalty
    eye = torch.eye(F + 1, dtype=dt, device=dev)
    w = torch.zeros(F + 1, dtype=dt, device=dev)
    for _ in range(max_iter):
        m = s * (Xt @ w)
        sig = torch.sigmoid(-m)
        grad = Xt.T @ (-ccw * sig * s) + reg * w
        D = ccw * sig * (1.0 - sig)
        H = Xt.T @ (Xt * D[:, None]) + torch.diag(reg)
        H = H + 1e-12 * eye
        step = torch.linalg.solve(H, grad)
        w = w - step
        if not bool(torch.amax(torch.abs(step)) >= tol):
            break
    return LinearParams(coef=w[:F], intercept=w[F])

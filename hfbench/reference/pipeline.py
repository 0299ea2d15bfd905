"""Plain reference of the served pipeline's predict route.

``HF/predict_hf.py`` behind ``HF/train_ensemble_public.py``'s pipeline,
written from the published semantics in plain PyTorch, on the weights dict
of ``hfbench.gen.pipeline`` (nothing the program made):

  1. a contract row (17 variables, contract order) is embedded at its schema
     positions in a row of NaN;
  2. sklearn's ``KNNImputer(n_neighbors=1)``: a missing value takes the
     value of the nearest donor that has it, by the nan-euclidean distance
     (squared differences over coordinates present in both, scaled by
     columns / present; the lowest donor index among equals); with no such
     donor, the column mean. Only the columns the model reads are imputed:
     the others are dropped by step 3 and cannot reach the output;
  3. the support columns, ascending;
  4. the stacked members: libsvm's RBF-SVC probability (Platt pairwise
     probability clipped to [1e-7, 1 - 1e-7], then libsvm's
     ``multiclass_probability`` coupling iteration for k = 2, 100 steps at
     most, tolerance 0.005 / k, a lane stopping once it meets it), the
     boosted stumps (go left iff x <= threshold), the logistic L1-LR;
  5. the logistic meta-learner over the three members' P(class 1).

``dtype`` is the working precision: float64 is the reference, float32 its
control. Float32 products never run in TF32 here.
"""

from __future__ import annotations

import torch

MIN_PROB = 1e-7
COUPLING_ITERS = 100
COUPLING_EPS = 0.005 / 2


def _nan_euclidean_sq(x: torch.Tensor, donors: torch.Tensor) -> torch.Tensor:
    """``[nq, nd]`` squared nan-euclidean distances; NaN where no coordinate
    is shared."""
    diff = x[:, None, :] - donors[None, :, :]
    both = ~torch.isnan(diff)
    sq = torch.where(both, diff * diff, 0.0).sum(-1)
    present = both.sum(-1)
    d = sq * (x.shape[1] / torch.clamp_min(present, 1))
    return torch.where(present > 0, d, torch.nan)


def impute(x64: torch.Tensor, donors: torch.Tensor, col_means: torch.Tensor,
           cols: list[int]) -> torch.Tensor:
    """``x64`` with its missing entries in ``cols`` filled by 1-NN."""
    out = x64.clone()
    need = [c for c in cols if bool(torch.isnan(x64[:, c]).any())]
    if not need:
        return out
    d = _nan_euclidean_sq(x64, donors)
    d = torch.where(torch.isnan(d), torch.inf, d)
    order = torch.arange(donors.shape[0], device=d.device)
    for c in need:
        has = ~torch.isnan(donors[:, c])
        dc = torch.where(has[None, :], d, torch.inf)
        best = dc.min(dim=1, keepdim=True).values
        first = torch.where(dc == best, order, donors.shape[0]).min(dim=1).values
        finite = torch.isfinite(best[:, 0])
        val = torch.where(finite, donors[torch.clamp_max(first, donors.shape[0] - 1), c],
                          col_means[c])
        out[:, c] = torch.where(torch.isnan(x64[:, c]), val, x64[:, c])
    return out


def coupling_p1(r0: torch.Tensor) -> torch.Tensor:
    """libsvm ``multiclass_probability`` for two classes, per lane: the
    pairwise probability of class 0 in, P(class 1) out."""
    r1 = 1.0 - r0
    Q = ((r1 * r1, -r1 * r0), (-r1 * r0, r0 * r0))
    p = [torch.full_like(r0, 0.5), torch.full_like(r0, 0.5)]
    live = torch.ones_like(r0, dtype=torch.bool)
    for _ in range(COUPLING_ITERS):
        Qp = [Q[t][0] * p[0] + Q[t][1] * p[1] for t in range(2)]
        pQp = p[0] * Qp[0] + p[1] * Qp[1]
        err = torch.maximum(torch.abs(Qp[0] - pQp), torch.abs(Qp[1] - pQp))
        live = live & ~(err < COUPLING_EPS)
        new = list(p)
        for t in range(2):
            diff = (-Qp[t] + pQp) / Q[t][t]
            new[t] = new[t] + diff
            pQp = (pQp + diff * (diff * Q[t][t] + 2 * Qp[t])) / (1 + diff) / (1 + diff)
            for j in range(2):
                Qp[j] = (Qp[j] + diff * Q[t][j]) / (1 + diff)
                new[j] = new[j] / (1 + diff)
        p = [torch.where(live, new[t], p[t]) for t in range(2)]
    return p[1]


def members(w: dict, X: torch.Tensor) -> torch.Tensor:
    """``[n, 3]``: P(class 1) of the SVC, the stumps and the L1-LR on the
    support columns ``X``."""
    dt = X.dtype
    Z = (X - w["scaler_mean"].to(dt)) / w["scaler_scale"].to(dt)
    sv = w["sv"].to(dt)
    sq = ((Z[:, None, :] - sv[None, :, :]) ** 2).sum(-1)
    dec = torch.exp(-w["gamma"].to(dt) * sq) @ w["dual_coef"].to(dt) + w["svc_intercept"].to(dt)
    f = -dec                                     # libsvm's orientation
    fApB = f * w["prob_a"].to(dt) + w["prob_b"].to(dt)
    r0 = torch.where(fApB >= 0, torch.exp(-fApB) / (1.0 + torch.exp(-fApB)),
                     1.0 / (1.0 + torch.exp(fApB)))
    p_svc = coupling_p1(torch.clamp(r0, MIN_PROB, 1 - MIN_PROB))
    xf = X[:, w["stump_feature"]]                               # [n, T]
    leaf = torch.where(xf <= w["stump_threshold"].to(dt), w["stump_left"].to(dt),
                       w["stump_right"].to(dt))
    raw = w["gbdt_init"].to(dt) + w["gbdt_lr"].to(dt) * leaf.sum(1)
    p_gbc = torch.sigmoid(raw)
    p_lr = torch.sigmoid(X @ w["lr_coef"].to(dt) + w["lr_intercept"].to(dt))
    return torch.stack([p_svc, p_gbc, p_lr], dim=1)


def predict_p1(w: dict, rows17: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """P(class 1) for contract rows ``[n, 17]`` (contract order)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        donors = w["donors"].to(dtype)
        x64 = torch.full((rows17.shape[0], donors.shape[1]), torch.nan, dtype=dtype,
                         device=rows17.device)
        x64[:, w["selected"]] = rows17.to(dtype)
        support = w["support"].tolist()
        x = impute(x64, donors, w["col_means"].to(dtype), support)[:, w["support"]]
        m = members(w, x)
        return torch.sigmoid(m @ w["meta_coef"].to(dtype) + w["meta_intercept"].to(dtype))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

"""Plain reference of the GBDT member's 'hist' fit.

sklearn's ``GradientBoostingClassifier`` (binomial deviance, friedman_mse
split scoring, no subsampling) over quantile-binned features, written from
its published semantics in plain PyTorch, on the inputs the benchmark draws
(nothing the program made):

  * binning: each column sorted; ``n_bins`` candidates at ranks
    round(i / (n_bins - 1) · (n - 1)) (half to even); a threshold is the
    midpoint of two neighbouring candidates, or the lower one where the
    midpoint rounds up to the upper (sklearn's guard); a value's bin is the
    number of thresholds strictly below it, so "split at boundary b" sends
    a row left iff bin <= b, iff x <= threshold b;
  * stages: F0 = prior log-odds; residual g = y - p, hessian h = p(1 - p);
    a node's candidate splits are scored by the friedman proxy
    (mean_l - mean_r)² · n_l · n_r over boundaries leaving a row on both
    sides, the first of equal scores in (feature, boundary) order; a node
    stays a leaf when its residual variance is at most machine epsilon or it
    holds fewer than 2 rows; leaves take the Newton value Σg / Σh (0 where
    |Σh| < 1e-150); F += lr · leaf; the deviance after each stage is
    -2 · mean(y·F - log(1 + e^F));
  * depth d: level by level, node ids in heap order (children 2i+1, 2i+2),
    rows of a node that does not split stay in it.

Per-bin sums come from prefix sums over each column's rows sorted by bin,
accumulated in ``acc`` (float64 for the reference). ``work`` is the
precision of the scores, residuals and thresholds: the configuration's
float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import torch

IMPURITY_EPS = 2.220446049250313e-16
NEWTON_GUARD = 1e-150


def bin_columns(X: torch.Tensor, n_bins: int):
    """``(bins [n, F] int64, thresholds [F, n_bins - 1])`` in ``X``'s dtype."""
    n, F = X.shape
    Xs = torch.sort(X, dim=0).values
    ranks = torch.round(torch.arange(n_bins, dtype=torch.float64, device=X.device)
                        / (n_bins - 1) * (n - 1)).long()
    u = Xs[ranks]                                         # [B, F]
    mid = (u[:-1] + u[1:]) / 2
    mid = torch.where(mid == u[1:], u[:-1], mid)          # [B-1, F]
    thr = mid.T.contiguous()
    bins = torch.empty((n, F), dtype=torch.long, device=X.device)
    for f in range(F):
        bins[:, f] = torch.searchsorted(thr[f].float(), X[:, f].contiguous().float(), right=False)
    return bins, thr


class _Sorted:
    """Each column's rows in bin order, and the count of rows with bin <= b."""

    def __init__(self, bins: torch.Tensor, n_bins: int):
        self.order = [torch.argsort(bins[:, f], stable=True) for f in range(bins.shape[1])]
        self.ends = torch.stack([torch.cumsum(torch.bincount(bins[:, f], minlength=n_bins), 0)
                                 for f in range(bins.shape[1])])          # [F, B]

    def left_sums(self, v: torch.Tensor) -> torch.Tensor:
        """``[F, B-1]``: Σ v over rows with bin <= b, per feature."""
        out = []
        for f, order in enumerate(self.order):
            cs = torch.cat([v.new_zeros(1), torch.cumsum(v[order], 0)])
            out.append(cs[self.ends[f, :-1]])
        return torch.stack(out)


def _newton(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    tiny = torch.abs(den) < NEWTON_GUARD
    return torch.where(tiny, torch.zeros_like(num), num / torch.where(tiny, 1.0, den))


def _best_split(GL, CL, GT, CT, G2, thr):
    """First best (feature, boundary) of one node and whether it splits."""
    GR, CR = GT - GL, CT - CL
    valid = (CL >= 1) & (CR >= 1) & torch.isfinite(thr)
    diff = GL / torch.clamp_min(CL, 1) - GR / torch.clamp_min(CR, 1)
    proxy = torch.where(valid, diff * diff * CL * CR, -torch.inf)
    best = int(torch.argmax(proxy.reshape(-1)))
    f, b = divmod(best, proxy.shape[1])
    impurity = G2 / max(float(CT), 1.0) - (GT / max(float(CT), 1.0)) ** 2
    do = float(CT) >= 2 and float(impurity) > IMPURITY_EPS and bool(torch.isfinite(proxy[f, b]))
    return do, f, b


def fit(X: torch.Tensor, y: torch.Tensor, *, n_estimators: int, learning_rate: float,
        max_depth: int, n_bins: int, work=torch.float32, acc=torch.float64) -> dict:
    """The forest (heap layout, ``[T, 2^(d+1) - 1]``: ``feature``,
    ``threshold``, ``split``, ``value``), ``init`` and the ``deviance`` path
    (float64), and ``raw``, the training rows' final scores."""
    n, F = X.shape
    Xw = X.to(work)
    bins, thr = bin_columns(Xw, n_bins)
    srt = _Sorted(bins, n_bins)
    CL_all = srt.ends[:, :-1].to(acc)
    yw = y.to(work)
    p1 = y.to(torch.float64).mean()
    f0 = torch.log(p1 / (1 - p1)).to(work)
    raw = torch.full((n,), float(f0), dtype=work, device=X.device)
    NN = 2 ** (max_depth + 1) - 1
    feat = torch.zeros((n_estimators, NN), dtype=torch.long)
    thr_t = torch.full((n_estimators, NN), torch.inf, dtype=torch.float64)
    split = torch.zeros((n_estimators, NN), dtype=torch.bool)
    value = torch.zeros((n_estimators, NN), dtype=torch.float64)
    deviance = torch.zeros(n_estimators, dtype=torch.float64)
    for t in range(n_estimators):
        p = torch.sigmoid(raw)
        g = yw - p
        h = p * (1 - p)
        ga, ha = g.to(acc), h.to(acc)
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        for level in range(max_depth):
            for j in range(2 ** level - 1, 2 ** (level + 1) - 1):
                if max_depth == 1:
                    m, gm = None, ga
                    GL, CL, CT = srt.left_sums(ga), CL_all, torch.tensor(float(n), dtype=acc)
                else:
                    m = node == j
                    gm = torch.where(m, ga, 0.0)
                    ma = m.to(acc)
                    CT = ma.sum()
                    if float(CT) == 0:
                        continue
                    GL, CL = srt.left_sums(gm), srt.left_sums(ma)
                do, f, b = _best_split(GL, CL, gm.sum(), CT, (gm * gm).sum(), thr)
                if not do:
                    continue
                feat[t, j], thr_t[t, j], split[t, j] = f, float(thr[f, b]), True
                left = bins[:, f] <= b
                child = torch.where(left, 2 * j + 1, 2 * j + 2)
                node = child if m is None else torch.where(m, child, node)
        leaf_g = torch.stack([torch.where(node == j, ga, 0.0).sum() for j in range(NN)])
        leaf_h = torch.stack([torch.where(node == j, ha, 0.0).sum() for j in range(NN)])
        vals = _newton(leaf_g, leaf_h)
        value[t] = vals.double().cpu()
        raw = raw + (learning_rate * vals.to(work))[node]
        r = raw.to(acc)
        deviance[t] = float(-2.0 * torch.mean(y.to(acc) * r - torch.logaddexp(
            torch.zeros((), dtype=acc, device=X.device), r)))
    return {"feature": feat, "threshold": thr_t, "split": split, "value": value,
            "init": float(f0), "learning_rate": learning_rate, "deviance": deviance,
            "raw": raw.to(torch.float64)}


def forest_scores(X: torch.Tensor, forest: dict, rows: int = 1 << 20) -> torch.Tensor:
    """``[n]`` float64 raw scores of a heap-layout forest (``feature``,
    ``threshold``, ``value``, and ``left``/``right`` child ids, self at a
    leaf) on ``X``: descend ``depth`` steps, add lr · leaf per tree."""
    dev = X.device
    feat = forest["feature"].to(dev).long()
    thr = forest["threshold"].to(dev).double()
    left = forest["left"].to(dev).long()
    right = forest["right"].to(dev).long()
    value = forest["value"].to(dev).double()
    T = feat.shape[0]
    tix = torch.arange(T, device=dev)[:, None]
    out = []
    for s in range(0, X.shape[0], rows):
        x = X[s:s + rows].double()
        idx = torch.zeros((T, x.shape[0]), dtype=torch.long, device=dev)
        r = torch.arange(x.shape[0], device=dev)[None, :]
        for _ in range(forest["depth"]):
            go = x[r, feat[tix, idx]] <= thr[tix, idx]
            idx = torch.where(go, left[tix, idx], right[tix, idx])
        out.append(forest["init"] + forest["learning_rate"] * value[tix, idx].sum(0))
    return torch.cat(out)


def heap_children(split: torch.Tensor):
    """``(left, right)`` child ids of a heap-layout forest: 2i+1 / 2i+2 at a
    split node, the node itself at a leaf."""
    idx = torch.arange(split.shape[1])[None, :]
    return torch.where(split, 2 * idx + 1, idx), torch.where(split, 2 * idx + 2, idx)

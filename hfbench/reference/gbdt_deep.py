"""Plain reference of a deep GBDT 'hist' fit, organised level by level.

The semantics are ``gbdt.py``'s (its docstring): the same binning, friedman
proxy, first of equal scores in (feature, boundary) order, the >= 2-row and
impurity-epsilon leaf rules, Newton leaves with the 1e-150 guard, heap node
ids, and the rows of a node that does not split staying in it. Only the
order of the work differs, so that a depth-8 fit of millions of rows runs in
seconds where ``gbdt.py``'s node-by-node loop takes minutes:

  * one pass per level: every node's per-bin sums of g and of row counts
    from ``index_add_`` over the cell ``node·F·B + f·B + bin``, a few
    features at a time, accumulated in ``acc`` (float64 for the
    reference); rows that sit in no node of the level (their node stopped
    earlier) go to a cell block that is dropped. Below the root the pass
    reads the rows of left children only, and a right child's sums are its
    parent's less its sibling's (0 under a parent that did not split);
  * each node's total of g, of g² and of rows from its cells of feature 0;
  * the split search vectorised over the level's nodes: cumulative sums
    over bins, the proxy, ``argmax`` (the first of equal values);
  * the leaf sums over the ``2^(d+1) - 1`` heap nodes by ``index_add_``.

``work`` is the precision of the scores, residuals and thresholds: the
configuration's float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import torch

from . import gbdt as base

FEATURES_PER_PASS = 4


def level_sums(fb: torch.Tensor, local: torch.Tensor, ga: torch.Tensor, K: int, B: int,
                acc) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(G, C, G2)``: per-(node, feature, bin) sums of g and of rows,
    ``[K, F, B]``, and per-(node, bin) sums of g² over feature 0's bins,
    ``[K, B]``. ``fb`` is ``f·B + bin`` ``[n, F]`` (int32); ``local`` the
    rows' node within the level, -1 for none."""
    n, F = fb.shape
    cells = (K + 1) * F * B                       # block K: rows of no node here
    off = (torch.where(local >= 0, local, K) * (F * B)).to(torch.int32)
    G = torch.zeros(cells, dtype=acc, device=fb.device)
    C = torch.zeros(cells, dtype=acc, device=fb.device)
    step = min(F, FEATURES_PER_PASS)
    ones = torch.ones(n * step, dtype=acc, device=fb.device)
    for f0 in range(0, F, step):
        w = min(step, F - f0)
        key = (off[:, None] + fb[:, f0:f0 + w]).reshape(-1)
        G.index_add_(0, key, ga[:, None].expand(n, w).reshape(-1))
        C.index_add_(0, key, ones[:n * w])
    G2 = torch.zeros(cells, dtype=acc, device=fb.device)
    G2.index_add_(0, off + fb[:, 0], ga * ga)
    shape = (K + 1, F, B)
    return (G.view(shape)[:K], C.view(shape)[:K], G2.view(shape)[:K, 0])


def child_sums(fb: torch.Tensor, local: torch.Tensor, ga: torch.Tensor, K: int, B: int,
               acc, parent: tuple) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``level_sums`` of a level below the root from its parents' sums and
    whether each parent split (``parent``: ``(G, C, G2, do)`` of the level
    above): the left children (even ``local``) summed from their rows, each
    right child as its parent less its left sibling."""
    *sums, do = parent
    rows = torch.nonzero((local >= 0) & (local % 2 == 0))[:, 0]
    left = level_sums(fb[rows], local[rows] // 2, ga[rows], K // 2, B, acc)
    keep = do.to(acc)
    out = []
    for whole, lo in zip(sums, left):
        hi = (whole - lo) * keep.reshape(-1, *(1,) * (whole.dim() - 1))
        out.append(torch.stack([lo, hi], dim=1).reshape(K, *whole.shape[1:]))
    return tuple(out)


def proxies(G, C, G2, finite):
    """``(proxy [K, F·(B-1)], CT [K], impurity [K])`` of a level's nodes from
    ``level_sums``: each candidate's friedman proxy (-inf where a side
    would be empty or the threshold is not finite), flat in (feature,
    boundary) order, each node's row count and residual variance."""
    K, F, B = G.shape
    GT, CT, S2 = G[:, 0].sum(-1), C[:, 0].sum(-1), G2.sum(-1)
    GL = torch.cumsum(G, -1)[..., :-1]
    CL = torch.cumsum(C, -1)[..., :-1]
    GR, CR = GT[:, None, None] - GL, CT[:, None, None] - CL
    valid = (CL >= 1) & (CR >= 1) & finite
    diff = GL / torch.clamp_min(CL, 1) - GR / torch.clamp_min(CR, 1)
    proxy = torch.where(valid, diff * diff * CL * CR, -torch.inf).reshape(K, -1)
    ct = torch.clamp_min(CT, 1.0)
    return proxy, CT, S2 / ct - (GT / ct) ** 2


def _best_splits(G, C, G2, finite):
    """Per node of the level: whether it splits, its feature and boundary
    (``[K]`` each), as ``gbdt._best_split`` decides for one node."""
    proxy, CT, impurity = proxies(G, C, G2, finite)
    best = torch.argmax(proxy, dim=1)
    top = torch.gather(proxy, 1, best[:, None])[:, 0]
    do = (CT >= 2) & (impurity > base.IMPURITY_EPS) & torch.isfinite(top)
    B = G.shape[-1]
    return do, best // (B - 1), best % (B - 1)


def fit(X: torch.Tensor, y: torch.Tensor, *, n_estimators: int, learning_rate: float,
        max_depth: int, n_bins: int, work=torch.float32, acc=torch.float64) -> dict:
    """The forest (heap layout, ``[T, 2^(d+1) - 1]``: ``feature``,
    ``threshold``, ``split``, ``value``), ``init`` and the ``deviance`` path
    (float64), and ``raw``, the training rows' final scores: the keys of
    ``gbdt.fit``."""
    n, F = X.shape
    B = n_bins
    dev = X.device
    bins, thr = base.bin_columns(X.to(work), n_bins)
    fb = (bins + torch.arange(F, device=dev) * B).to(torch.int32)
    bins = bins.to(torch.int32)
    finite = torch.isfinite(thr)
    yw = y.to(work)
    p1 = y.to(torch.float64).mean()
    f0 = torch.log(p1 / (1 - p1)).to(work)
    raw = torch.full((n,), float(f0), dtype=work, device=dev)
    NN = 2 ** (max_depth + 1) - 1
    feat = torch.zeros((n_estimators, NN), dtype=torch.long)
    thr_t = torch.full((n_estimators, NN), torch.inf, dtype=torch.float64)
    split = torch.zeros((n_estimators, NN), dtype=torch.bool)
    value = torch.zeros((n_estimators, NN), dtype=torch.float64)
    deviance = torch.zeros(n_estimators, dtype=torch.float64)
    zero = torch.zeros((), dtype=acc, device=dev)
    for t in range(n_estimators):
        p = torch.sigmoid(raw)
        g = yw - p
        h = p * (1 - p)
        ga, ha = g.to(acc), h.to(acc)
        node = torch.zeros(n, dtype=torch.long, device=dev)
        levels, above = [], None
        for level in range(max_depth):
            first, K = 2 ** level - 1, 2 ** level
            local = node - first                  # < 0: the row's node stopped earlier
            sums = (level_sums(fb, local, ga, K, B, acc) if above is None
                    else child_sums(fb, local, ga, K, B, acc, above))
            do, f, b = _best_splits(*sums, finite)
            above = (*sums, do)
            levels.append((do, f, thr[f, b]))
            at = torch.clamp_min(local, 0)
            splits = (local >= 0) & do[at]
            left = torch.gather(bins, 1, f[at][:, None])[:, 0] <= b[at]
            node = torch.where(splits, torch.where(left, 2 * node + 1, 2 * node + 2), node)
        for level, (do, f, th) in enumerate(levels):
            first, K = 2 ** level - 1, 2 ** level
            do = do.cpu()
            feat[t, first:first + K] = torch.where(do, f.cpu(), 0)
            thr_t[t, first:first + K] = torch.where(do, th.cpu().double(), torch.inf)
            split[t, first:first + K] = do
        leaf_g = torch.zeros(NN, dtype=acc, device=dev).index_add_(0, node, ga)
        leaf_h = torch.zeros(NN, dtype=acc, device=dev).index_add_(0, node, ha)
        vals = base._newton(leaf_g, leaf_h)
        value[t] = vals.double().cpu()
        raw = raw + (learning_rate * vals.to(work))[node]
        r = raw.to(acc)
        deviance[t] = float(-2.0 * torch.mean(y.to(acc) * r - torch.logaddexp(zero, r)))
    return {"feature": feat, "threshold": thr_t, "split": split, "value": value,
            "init": float(f0), "learning_rate": learning_rate, "deviance": deviance,
            "raw": raw.to(torch.float64)}

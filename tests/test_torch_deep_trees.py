"""The level-wise grower at depth 8, at the HIGGS configuration's widths
(``hfbench/configs/higgs_10m.json``: 28 columns, 256 bins).

On the CPU the program (``models.gbdt.fit``, its plain histogram and leaf
sums) is held to the benchmark's plain level-wise reference
(``hfbench/reference/gbdt_deep.py``), and that reference to the node-by-node
one (``hfbench/reference/gbdt.py``). The program sums in float32 and the
reference in float64; at stage 0 every residual is one of two values, so two
candidate splits with the same left count and left positives tie exactly, and
in the small nodes of a depth-8 tree over 20,000 rows such ties are the best
split of some node on every seed tried. The reference takes the first of
them, the program the one its float32 rounding puts ahead, and the trees
part from there. Likewise the program's float32 residual variance of a node
whose rows' residuals are all equal, or nearly (a node of two rows), is
rounding: it may read above machine epsilon where the reference's is 0, or 0
where the reference's is just above, and the program splits such a node
where the reference keeps it whole, or the reverse. So the program is held
to the reference decision by decision: each of its splits, recomputed in the
reference's float64 sums at the node the program routed it to, has the best
proxy there; it splits exactly the nodes the reference would split, but for
nodes whose variance is below 1e-6 of their mean squared residual (what
float32 cannot resolve); each leaf is the reference's Newton value of its
rows.

Also here: the node kernel's plan at depth 8 (tiles and row passes per
level), the span set of a depth-8 stage, and rows parked at nodes that stop
early. The ``cuda`` tests run the node kernel at K = 128, F = 28, the
leaf-sum kernel at 512 segments and one depth-8 stage on the card, with the
row-pass counts. The file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from hfbench.gen import cohort
from hfbench.reference import gbdt as ref_gbdt
from hfbench.reference import gbdt_deep
from machine_learning_replications_tpu_torch.config import GBDTConfig
from machine_learning_replications_tpu_torch.models import gbdt
from machine_learning_replications_tpu_torch.obs import spans, torchmon
from machine_learning_replications_tpu_torch.ops import cuda_histogram, histogram

CPU = torch.device("cpu")
DEPTH, B, LR = 8, 256, 0.1
H100_SMEM = 232_448            # the H100's opt-in shared memory per CTA
HIGGS_ROW_BYTES = (28, 4, 4, 4)  # one-byte bins of 28 columns, int32 node ids, float32 g and h
PASSES_PER_LEVEL = [1, 1, 2, 4, 10, 28, 56, 84]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def device_bins(monkeypatch):
    """The fit's device quantile binning (the reference's) at any row count."""
    monkeypatch.setattr(gbdt, "DEVICE_BINNING_MIN_ROWS", 1)


def _higgs(n: int, seed: int, dev=CPU):
    return cohort.gbdt_cohort(n, seed, dev, spec_name="higgs")


def _cfg(stages: int, depth: int = DEPTH) -> GBDTConfig:
    return GBDTConfig(n_estimators=stages, max_depth=depth, splitter="hist", n_bins=B)


def _replay(X, y, params):
    """Each tree of the program's forest, level by level, in the reference's
    float64 sums at the rows the program routed to each node: per level the
    reference's proxies, counts and impurities (``gbdt_deep.proxies``) and
    which nodes' impurities float32 cannot tell from 0, and
    per tree the rows' final nodes, g and h in float64, and the scores after
    the tree. The residuals are the program's own (float32 scores updated
    as ``gbdt`` updates them)."""
    n, F = X.shape
    bins, thr = ref_gbdt.bin_columns(X, B)
    fb = (bins + torch.arange(F) * B).to(torch.int32)
    finite = torch.isfinite(thr)
    feat, th = params.feature.long(), params.threshold
    split = params.left.long() != torch.arange(params.left.shape[1])[None]
    raw = torch.full((n,), float(params.init_raw), dtype=torch.float32)
    rows = torch.arange(n)
    for t in range(feat.shape[0]):
        p = torch.sigmoid(raw)
        ga, ha = (y - p).double(), (p * (1 - p)).double()
        node = torch.zeros(n, dtype=torch.long)
        levels = []
        for level in range(DEPTH):
            first, K = 2 ** level - 1, 2 ** level
            local = node - first
            G, C, G2 = gbdt_deep.level_sums(fb, local, ga, K, B, torch.float64)
            proxy, CT, impurity = gbdt_deep.proxies(G, C, G2, finite)
            unresolved = impurity <= 1e-6 * G2.sum(-1) / torch.clamp_min(CT, 1)
            levels.append((first, K, proxy, CT, impurity, unresolved))
            at = first + torch.clamp_min(local, 0)
            go_left = X[rows, feat[t, at]] <= th[t, at]
            moves = (local >= 0) & split[t, at]
            node = torch.where(moves, torch.where(go_left, 2 * node + 1, 2 * node + 2), node)
        raw = raw + LR * params.value[t][node]
        yield t, levels, node, ga, ha, raw


@pytest.mark.parametrize("n,seed", [(20_000, 2**31 + 17), (400, 2**31 + 18)])
def test_depth8_fit_decision_by_decision_against_the_reference(device_bins, n, seed):
    """At 20,000 and at 400 rows (where most nodes stop early and park their
    rows): the program's root splits are the reference's, and
    every decision of its depth-8 forest is the reference's best at that
    node (a split at the best float64 proxy, within float32 rounding; a
    split exactly where the reference would split, but at nodes whose
    variance float32 cannot resolve), every leaf the reference's Newton value of its rows, and the
    deviance path that of its own forest."""
    X, y = _higgs(n, seed)
    params, aux = gbdt.fit(X, y, _cfg(3), device="cpu")
    ref = gbdt_deep.fit(X, y, n_estimators=3, learning_rate=LR, max_depth=DEPTH, n_bins=B)
    assert torch.equal(params.feature[:, 0].long(), ref["feature"][:, 0])
    assert torch.equal(params.threshold[:, 0].double(), ref["threshold"][:, 0])
    split = params.left.long() != torch.arange(params.left.shape[1])[None]
    bins_thr = ref_gbdt.bin_columns(X, B)[1]
    deepest, parked = 0, False
    for t, levels, node, ga, ha, raw in _replay(X, y, params):
        for first, K, proxy, CT, impurity, unresolved in levels:
            ids = torch.arange(first, first + K)
            best = proxy.max(dim=1).values
            would = (CT >= 2) & (impurity > ref_gbdt.IMPURITY_EPS) & torch.isfinite(best)
            assert torch.equal(split[t, ids][~unresolved], would[~unresolved]), (t, first)
            for j in ids[split[t, ids]].tolist():
                f = int(params.feature[t, j])
                b = int(torch.searchsorted(bins_thr[f], params.threshold[t, j].reshape(1)))
                got, top = float(proxy[j - first, f * (B - 1) + b]), float(best[j - first])
                assert got >= top * (1 - 1e-6), (t, j, got, top)
                deepest = max(deepest, first)
        NN = params.value.shape[1]
        sums = torch.zeros((2, NN), dtype=torch.float64)
        sums[0].index_add_(0, node, ga)
        sums[1].index_add_(0, node, ha)
        leaves = torch.unique(node)
        want = histogram.newton_leaf_value(sums[0], sums[1])[leaves]
        torch.testing.assert_close(params.value[t][leaves].double(), want, rtol=1e-5, atol=1e-7)
        parked |= bool((leaves < 2 ** DEPTH - 1).any())
        r = raw.double()
        dev = float(-2.0 * torch.mean(y.double() * r - torch.logaddexp(torch.zeros(()), r)))
        assert aux["train_deviance"][t] == pytest.approx(dev, rel=1e-6)
    assert deepest == 2 ** (DEPTH - 1) - 1 and parked  # splits on the last level, leaves above


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_level_wise_reference_equals_the_node_loop(depth):
    """``gbdt_deep.fit`` against ``gbdt.fit`` of the references on small
    data: equal features, thresholds and splits, values within 1e-12."""
    X, y = _higgs(3000, 2**31 + 11)
    kw = dict(n_estimators=2, learning_rate=LR, max_depth=depth, n_bins=B)
    want, got = ref_gbdt.fit(X, y, **kw), gbdt_deep.fit(X, y, **kw)
    for key in ("feature", "threshold", "split"):
        assert torch.equal(got[key], want[key]), key
    torch.testing.assert_close(got["value"], want["value"], rtol=1e-12, atol=1e-300)
    torch.testing.assert_close(got["deviance"], want["deviance"], rtol=1e-12, atol=0)
    torch.testing.assert_close(got["raw"], want["raw"], rtol=1e-12, atol=1e-12)
    assert int(got["split"].sum()) > (2 ** depth - 1) // 2


def test_parked_rows_stay_at_nodes_that_stop_early():
    """A depth-8 tree over 300 rows: nodes stop early (too few rows or pure)
    and keep their rows to the end of the tree, where the leaf sums count
    them at that node; no row of a stopped node reaches a deeper level, and
    the forest's descent lands each row on the node the grower left it at."""
    X, y = _higgs(300, 2**31 + 19)
    bins = gbdt.default_bins(X, _cfg(1), CPU)
    binned = torch.as_tensor(bins.binned)
    thresholds = torch.as_tensor(bins.thresholds, dtype=torch.float32)
    grow = gbdt.make_tree_grower(binned, thresholds, depth=DEPTH, max_bins=bins.max_bins,
                                 min_samples_split=2, min_samples_leaf=1,
                                 kernels=gbdt.histogram_kernels(GBDTConfig(histogram_backend="xla")))
    p = torch.full((300,), float(y.mean()))
    g, h = (y - p)[None], (p * (1 - p))[None]
    feat, thr, val, split, node = grow(g, h)
    node = node[0].long()
    NN = 2 ** (DEPTH + 1) - 1
    ids = torch.arange(NN)
    parent_split = torch.cat([torch.ones(1, dtype=torch.bool), split[0][(ids[1:] - 1) // 2]])
    assert not bool((split[0] & ~parent_split).any())          # only under a split parent
    assert not bool(split[0][node].any())                      # every row ends at a leaf
    level = torch.floor(torch.log2((node + 1).double())).long()
    parked = level < DEPTH
    assert bool(parked.any()) and bool((~parked).any())
    assert int((node >= 0).sum()) == 300
    params = gbdt.forest_to_params(feat, thr, val, split, torch.tensor(0.0), LR, DEPTH)
    at = torch.zeros(300, dtype=torch.long)
    for _ in range(DEPTH):
        f = params.feature[0][at].long()
        go = X[torch.arange(300), f] <= params.threshold[0][at]
        at = torch.where(go, params.left[0][at].long(), params.right[0][at].long())
    assert torch.equal(at, node)
    num = torch.zeros(NN, dtype=torch.float64).index_add_(0, node, g[0].double())
    den = torch.zeros(NN, dtype=torch.float64).index_add_(0, node, h[0].double())
    leaves = torch.unique(node)
    want = histogram.newton_leaf_value(num, den)[leaves].float()
    torch.testing.assert_close(val[0][leaves], want, rtol=1e-6, atol=1e-7)
    assert not bool(val[0][split[0]].any())                    # internal nodes hold 0


@pytest.mark.parametrize("level", range(DEPTH))
def test_node_plan_row_passes_at_depth8_widths(level):
    """The node kernel's plan at F = 28 and K = 2^level nodes of 256 bins on
    the H100's budget: 186 row passes a depth-8 tree, the deep levels cut
    single features into cell ranges (levels 6 and 7)."""
    F, K = 28, 2 ** level
    tf, tc, rows = cuda_histogram.tile_plan(F, 4, K * B, 4, H100_SMEM, HIGGS_ROW_BYTES)
    assert cuda_histogram.row_passes(F, K * B, tf, tc) == PASSES_PER_LEVEL[level]
    assert (tc < K * B) == (level >= 6)
    assert sum(PASSES_PER_LEVEL) == 186


@pytest.mark.parametrize("level", range(DEPTH))
def test_node_walk_choice_at_depth8_widths(level):
    """The node entry's walk at F = 28: levels 1-7 sort their rows by node and
    walk them once, in 1024-row blocks with all 28 features of one node held
    (114.7 KB); the root level keeps the tiled walk's one pass."""
    F, K = 28, 2 ** level
    plan = cuda_histogram.node_plan(F, K, B, 4, H100_SMEM, 1)
    assert plan.partitioned == (level >= 1)
    assert cuda_histogram.node_row_passes(F, K, B, plan) == 1
    assert (plan.tile_features, plan.tile_cells, plan.block_rows) == (F, B, 1024)
    assert 4 * F * B * 4 == 114_688
    if plan.partitioned:   # the scatter stages 2048-row sub-blocks, two blocks an SM
        assert plan.stage_rows == 2048
        assert 2 * cuda_histogram.scatter_smem(K, 2048, F, 4) <= 228 * 1024


@pytest.mark.parametrize("K,itemsize,folds,partitioned", [
    (1, 4, 1, False),   # depth 3's root: one node
    (2, 4, 1, False),   # one pass in 1024-row blocks either way
    (4, 4, 1, False),   # the last level: two tiled passes of full blocks
    (2, 8, 1, False),   # float64: two passes of full blocks
    (4, 8, 1, True),    # float64: three passes
    (4, 4, 5, False),   # the 5-fold fits: fold launches stay tiled
    (4, 8, 5, False),
])
def test_node_walk_choice_at_depth3_widths(K, itemsize, folds, partitioned):
    """At the cohort's 17 features the tiled walk stays where its plan is at
    most two passes of 1024-row blocks (depth 3's last level: 1.86 ms tiled
    against 2.52 ms partitioned at 10M rows on an H100) and for fold
    launches; a partitioned plan is one pass."""
    plan = cuda_histogram.node_plan(17, K, B, itemsize, H100_SMEM, 1, folds)
    assert plan.partitioned == partitioned
    if partitioned:
        assert cuda_histogram.node_row_passes(17, K, B, plan) == 1


def test_node_walk_choice_keeps_the_tiled_walk_where_it_cannot_partition():
    """Past ``PARTITION_MAX_NODES`` nodes, or where one feature's cells of one
    node are over a CTA (int32 bins of 40,000 values), the tiled walk stays."""
    many = cuda_histogram.PARTITION_MAX_NODES * 2
    assert not cuda_histogram.node_plan(28, many, B, 4, H100_SMEM, 1).partitioned
    wide = cuda_histogram.node_plan(3, 4, 40_000, 4, H100_SMEM, 4)
    assert not wide.partitioned and wide.tile_cells < 4 * 40_000
    assert cuda_histogram.partitioned_plan(3, 4, 40_000, 4, H100_SMEM, 4) is None
    # 64 int32 bins and float64 values: a 1024-row scatter sub-block is 283 KB
    assert cuda_histogram.partitioned_plan(64, 2, B, 8, H100_SMEM, 4) is None
    assert cuda_histogram.partitioned_plan(28, 2, B, 8, H100_SMEM, 4).stage_rows == 1024


def _stable_order(node, K):
    """The active rows of each fit by node, in row order: ``torch.argsort``
    (stable) of the node ids with parked rows keyed last."""
    key = torch.where((node >= 0) & (node < K), node.long(), K)
    return torch.argsort(key, dim=-1, stable=True)


@pytest.mark.parametrize("case", ["one_fit", "folds", "empty_nodes", "all_parked", "foreign_ids"])
def test_partition_rows_is_a_stable_counting_sort(case):
    """``histogram.partition_rows`` against a stable ``argsort``: each node's
    rows in row order, the ``[K + 1]`` offsets, parked rows (−1 or an id
    outside ``[0, K)``) dropped, empty nodes, a fit with every row parked, a
    fold axis."""
    gen = torch.Generator().manual_seed(2**31 + 30)
    K, n = 16, 3001
    node = torch.randint(-1, K, (1 if case == "one_fit" else 4, n), generator=gen,
                         dtype=torch.int32)
    if case == "empty_nodes":
        node = torch.where((node == 3) | (node == K - 1), -1, node)
    elif case == "all_parked":
        node[2] = -1
    elif case == "foreign_ids":
        node[:, ::7] = K + 5
    order, offsets = histogram.partition_rows(node[0] if case == "one_fit" else node, K)
    assert order.shape == node.shape and offsets.shape == (node.shape[0], K + 1)
    assert offsets.dtype == torch.int32
    want = _stable_order(node, K)
    for f in range(node.shape[0]):
        active = (node[f] >= 0) & (node[f] < K)
        total = int(offsets[f, -1])
        assert total == int(active.sum())
        assert torch.equal(order[f, :total], want[f, :total])
        assert bool((order[f, total:] == -1).all())
        sizes = torch.bincount(node[f][active].long(), minlength=K)
        assert torch.equal(offsets[f].diff().long(), sizes)
        assert int(offsets[f, 0]) == 0
    if case == "empty_nodes":
        assert bool((offsets[:, 4] == offsets[:, 3]).all())
    if case == "all_parked":
        assert not bool(offsets[2].any())


@pytest.mark.parametrize("K,folds,fold_bins", [(2, None, False), (16, 3, False), (128, 2, True)])
def test_sums_over_sorted_rows_equal_node_histograms(K, folds, fold_bins):
    """``node_partition`` (the rows' bins, g and h copied in that order) then
    ``sorted_node_histograms`` (each node's segment summed) give
    ``node_histograms`` of the unsorted rows: counts equal, sums within
    float64 rounding."""
    rng = np.random.default_rng(K)
    n, F = 2003, 5
    lead = () if folds is None else (folds,)
    binned = torch.as_tensor(rng.integers(0, B, size=lead * fold_bins + (n, F)).astype(np.uint8))
    node = torch.as_tensor(rng.integers(-1, K, size=lead + (n,)).astype(np.int32))
    g = torch.as_tensor(rng.normal(size=lead + (n,)))
    h = torch.as_tensor(rng.uniform(0, 0.25, size=lead + (n,)))
    part = histogram.node_partition(binned, node, g, h, K)
    got = histogram.sorted_node_histograms(part, K, B)
    want = histogram.node_histograms(binned, node[None] if folds is None else node,
                                     g.expand(1, n) if folds is None else g,
                                     h.expand(1, n) if folds is None else h, K, B)
    assert torch.equal(got.count, want.count)
    for stat in ("grad", "hess", "grad2"):
        torch.testing.assert_close(getattr(got, stat), getattr(want, stat), rtol=1e-12,
                                   atol=1e-12)
    assert torch.equal(cuda_histogram.node_partition_cuda(binned, node, g, h, K).offsets,
                       part.offsets)


@pytest.mark.parametrize("depth,passes", [(1, 1), (3, 1), (4, 2), (8, 32)])
def test_leaf_row_passes_by_depth(depth, passes):
    """The leaf-sum kernel walks its rows once per 16 of the tree's
    2^(depth+1) segments (heap nodes and the parked rows' segment)."""
    assert cuda_histogram.leaf_row_passes(2 ** (depth + 1)) == passes


def test_depth8_stage_span_set_and_no_passes_off_the_card():
    """A traced depth-8 fit opens ``gbdt.hist``, ``gbdt.split`` and
    ``gbdt.route`` once at each level 0-7 of each stage and one
    ``gbdt.leaf_sums`` a stage; on the CPU no kernel runs, so no launch and
    no row pass is counted."""
    X, y = _higgs(600, 2**31 + 20)
    launches, passes = dict(cuda_histogram.LAUNCHES), dict(cuda_histogram.ROW_PASSES)
    tracer = spans.Tracer("test")
    spans.set_tracer(tracer)
    try:
        gbdt.fit(X, y, _cfg(2), device="cpu")
    finally:
        spans.set_tracer(None)
    evs = [e for e in tracer.export()["traceEvents"] if e["ph"] == "X"]
    for name in ("gbdt.hist", "gbdt.split", "gbdt.route"):
        levels = sorted(e["args"]["level"] for e in evs if e["name"] == name)
        assert levels == sorted(list(range(DEPTH)) * 2), name
    assert sum(e["name"] == "gbdt.leaf_sums" for e in evs) == 2
    assert sum(e["name"] == "gbdt.stage" for e in evs) == 2
    assert cuda_histogram.LAUNCHES == launches and cuda_histogram.ROW_PASSES == passes


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_node_kernel_at_k128_f28_matches_plain(cuda_device):
    """Depth 8's last level: 128 nodes of 28 features and 256 bins, one
    launch that sorts the rows by node and walks them once (one feature
    tile); counts exactly equal, the float32 sums within 1e-5 of each cell's
    absolute mass (plus 1e-4)."""
    rng = np.random.default_rng(128)
    n, F, K = 300_000, 28, 128
    binned = torch.as_tensor(rng.integers(0, B, size=(n, F)).astype(np.uint8), device=cuda_device)
    node = torch.as_tensor(rng.integers(-1, K, size=n).astype(np.int32), device=cuda_device)
    g = torch.as_tensor(rng.uniform(-1, 1, size=n).astype(np.float32), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0, 0.25, size=n).astype(np.float32), device=cuda_device)
    launches, passes = cuda_histogram.LAUNCHES["node_histograms"], \
        cuda_histogram.ROW_PASSES["node_histograms"]
    partitions = cuda_histogram.LAUNCHES["node_partition"]
    got = cuda_histogram.node_histograms_cuda(binned, node, g, h, K, B)
    torch.cuda.synchronize()
    assert cuda_histogram.LAUNCHES["node_histograms"] == launches + 1
    assert cuda_histogram.ROW_PASSES["node_histograms"] == passes + 1
    assert cuda_histogram.LAUNCHES["node_partition"] == partitions + 1
    want = histogram.node_histograms(binned, node, g.double(), h.double(), K, B)
    mass = histogram.node_histograms(binned, node, g.double().abs(), h.double(), K, B)
    assert torch.equal(got.count.double(), want.count)
    for stat, m in (("grad", mass.grad), ("hess", mass.hess), ("grad2", mass.grad2)):
        err = (getattr(got, stat).double() - getattr(want, stat)).abs()
        assert bool((err <= 1e-5 * m + 1e-4).all()), (stat, float(err.max()))


@pytest.mark.cuda
def test_leaf_sums_kernel_at_512_segments(cuda_device):
    """A depth-8 tree's leaf sums: 511 heap nodes and the parked rows'
    segment in 32 tiles, against the float64 ``index_add_`` pair within
    1e-12 of each segment's absolute mass; 32 row passes a launch."""
    rng = np.random.default_rng(512)
    n, NN = 1_000_003, 511
    node = np.where(rng.random(n) < 0.1, -1, rng.integers(0, NN, size=n)).astype(np.int32)
    node = torch.as_tensor(node[None], device=cuda_device)
    g = torch.as_tensor(rng.uniform(-1, 1, size=(1, n)).astype(np.float32), device=cuda_device)
    h = torch.as_tensor(rng.uniform(0, 0.25, size=(1, n)).astype(np.float32), device=cuda_device)
    passes = cuda_histogram.ROW_PASSES["leaf_sums"]
    got = cuda_histogram.leaf_sums_cuda(node, g, h, 1, NN)
    torch.cuda.synchronize()
    assert cuda_histogram.ROW_PASSES["leaf_sums"] == passes + 32
    want = histogram.leaf_sums(node, g, h, 1, NN)
    mass = histogram.leaf_sums(node, g.abs(), h, 1, NN)
    err = (got - want)[..., :NN].abs()
    assert bool((err <= 1e-12 * mass[..., :NN]).all()), float(err.max())
    assert not bool(got[..., NN].any())


@pytest.mark.cuda
def test_row_passes_of_one_depth8_stage(cuda_device):
    """One depth-8 stage of the HIGGS configuration's widths on the card:
    8 node launches of 8 row passes in all (levels 1-7 partitioned: 7
    ``node_partition`` launches), one leaf-sum launch of 32, the same in
    ``torch_kernel_row_passes_total`` and ``torch_kernel_launches_total``."""
    X, y = _higgs(200_000, 2**31 + 21, cuda_device)
    torchmon.install()
    before = torchmon.totals()
    cuda_histogram.reset_launch_counts()
    gbdt.fit(X, y, _cfg(1), device=cuda_device)
    torch.cuda.synchronize()
    assert cuda_histogram.LAUNCHES["node_histograms"] == DEPTH
    assert cuda_histogram.ROW_PASSES["node_histograms"] == 8
    assert cuda_histogram.LAUNCHES["node_partition"] == DEPTH - 1
    assert cuda_histogram.LAUNCHES["leaf_sums"] == 1
    assert cuda_histogram.ROW_PASSES["leaf_sums"] == 32
    after = torchmon.totals()
    for kernel, want in (("node_histograms", 8), ("leaf_sums", 32)):
        passes = after["torch_kernel_row_passes_total"]
        assert passes.get(kernel, 0) - before["torch_kernel_row_passes_total"].get(kernel, 0) \
            == want
    launched = after["torch_kernel_launches_total"]
    assert launched.get("node_partition", 0) - before["torch_kernel_launches_total"].get(
        "node_partition", 0) == DEPTH - 1


def _level_inputs(seed, n, F, K, dev, folds=None, fold_bins=False):
    """Bins, node ids (a twentieth parked, node 1 empty), g and h of one
    level on the card."""
    rng = np.random.default_rng(seed)
    lead = () if folds is None else (folds,)
    binned = rng.integers(0, B, size=lead * fold_bins + (n, F)).astype(np.uint8)
    node = rng.integers(0, K, size=lead + (n,)).astype(np.int32)
    node[node == 1] = 0
    node[rng.random(size=lead + (n,)) < 0.05] = -1
    g = rng.uniform(-1, 1, size=lead + (n,)).astype(np.float32)
    h = rng.uniform(0, 0.25, size=lead + (n,)).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (binned, node, g, h)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,folds", [(28, 2 ** level, None) for level in range(1, DEPTH)]
                         + [(17, 4, None), (17, 4, 5), (28, 128, 3)])
def test_partitioned_node_kernel_matches_plain(cuda_device, monkeypatch, F, K, folds):
    """The partitioned walk at every HIGGS level (K = 2-128, F = 28, where
    ``node_plan`` takes it), and, taken by force, at depth 3's last level
    (K = 4, F = 17) and with fold axes (shared and per-fold bins), at a
    ragged n with parked rows and an empty node: counts exactly equal, the
    float32 sums within 1e-5 of each cell's absolute mass (plus 1e-4)."""
    n = 100_003
    fold_bins = folds == 3
    binned, node, g, h = _level_inputs(K * F + (folds or 0), n, F, K, cuda_device, folds,
                                       fold_bins)
    budget = cuda_histogram.smem_budget(cuda_device)
    assert cuda_histogram.node_plan(F, K, B, 4, budget, 1, folds or 1).partitioned == (
        F == 28 and folds is None)
    monkeypatch.setattr(cuda_histogram, "node_plan", lambda F, K, B, item, budget, bin_item,
                        folds=1: cuda_histogram.partitioned_plan(F, K, B, item, budget, bin_item))
    partitions = cuda_histogram.LAUNCHES["node_partition"]
    got = cuda_histogram.node_histograms_cuda(binned, node, g, h, K, B)
    torch.cuda.synchronize()
    assert cuda_histogram.LAUNCHES["node_partition"] == partitions + 1
    want = histogram.node_histograms(binned, node, g.double(), h.double(), K, B)
    mass = histogram.node_histograms(binned, node, g.double().abs(), h.double(), K, B)
    assert torch.equal(got.count.double(), want.count)
    assert not bool(got.count[..., 1, :, :].any())
    for stat, m in (("grad", mass.grad), ("hess", mass.hess), ("grad2", mass.grad2)):
        err = (getattr(got, stat).double() - getattr(want, stat)).abs()
        assert bool((err <= 1e-5 * m + 1e-4).all()), (stat, float(err.max()))
    node.fill_(-1)  # every row parked: exactly zero
    assert not any(bool(a.any()) for a in cuda_histogram.node_histograms_cuda(
        binned, node, g, h, K, B))


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,folds,fold_bins", [
    (100_003, 128, None, False), (40_000, 4, 5, False), (33_333, 16, 3, True), (31, 2, 2, False),
])
def test_partition_kernels_equal_the_plain_partition(cuda_device, n, K, folds, fold_bins):
    """The count, scan and scatter kernels' sorted copies and offsets equal
    ``histogram.node_partition``'s exactly: node order, row order within a
    node, parked rows (−1 and ids outside ``[0, K)``) dropped, an empty node,
    a fit with every row parked; float64 values and int32 bins too."""
    binned, node, g, h = _level_inputs(n + K, n, 28, K, cuda_device, folds, fold_bins)
    node[..., ::11] = K + 2
    if folds:
        node[1] = -1
    cases = [(binned, g, h), (binned.int(), g.double(), h.double())]
    for bins, gg, hh in cases:
        got = cuda_histogram.node_partition_cuda(bins, node, gg, hh, K)
        want = histogram.node_partition(bins.cpu(), node.cpu(), gg.cpu(), hh.cpu(), K)
        torch.cuda.synchronize()
        assert torch.equal(got.offsets.cpu(), want.offsets)
        for f in range(want.offsets.shape[0]):
            total = int(want.offsets[f, -1])
            for name in ("bins", "grad", "hess"):
                assert torch.equal(getattr(got, name)[f, :total].cpu(),
                                   getattr(want, name)[f, :total]), (name, f)
    if folds:
        assert int(want.offsets[1, -1]) == 0

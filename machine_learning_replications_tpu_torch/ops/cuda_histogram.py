"""The hand-written Hopper histogram kernel: build, binding and wrappers.

Counterpart of the JAX package's ``ops/pallas_histogram.py``. One kernel
body (``csrc/histogram.cu``, design notes at its top) computes the general
``_stats_histograms`` contract with an optional leading fold axis, in three
entry modes that differ only in how a row's statistics are formed:

  * ``stats_histograms_cuda``: the general entry, ``[n, S]`` values and
    per-row segment offsets as given;
  * ``stump_histograms_cuda``: K=1, S=2, the depth-1 fits' pass (u8 bins
    on the fused fit; int32 bins with up to n + 1 bins per feature on the
    exact fit, where ``tile_plan`` cuts a feature's cells into ranges); the
    kernel reads ``grad`` and ``hess`` as two columns;
  * ``node_histograms_cuda``: S=4 per (node, feature, bin), the level-wise
    grower's pass; the kernel reads ``node_local``, ``grad`` and ``hess``,
    forms (g·a, h·a, g²·a, a) with a = [0 ≤ node < K] and the node's cell
    offset itself, and writes the ``[K, F, B]`` statistics directly.

Beside it, ``leaf_sums_cuda`` launches the grower's leaf-sum reduction
(the same source, design notes at its ``leaf sums`` section): per fit and
final node, the float64 sums of g and h, with no atomic, the same bits on
every call.

A warp takes 32 rows and steps over a tile's features; lanes whose cell is
equal sum their statistics by shuffles and one lane adds them with one
shared atomic per statistic. Row blocks are staged into shared memory by
``cp.async.bulk`` in a two-stage ring. The bound is one read of the inputs
and one write of the output (at depth 8's last level on the HIGGS
configuration's 10.5M x 28 rows, 435 MB: 0.13 ms on an H100).

Two walks (``csrc/histogram.cu`` notes 4 and 5). The tiled walk cuts the
``[F, K·B]`` cells into tiles that fit one CTA's shared memory beside the
ring (``tile_plan``, plain Python tested on the CPU), and every tile reads
every row again: one node's cells of one feature are 4 KB in float32, so at
K nodes a feature is 4·K KB, and at F = 28 the levels of a depth-8 tree
took 1, 1, 2, 4, 10, 28, 56 and 84 passes over the rows where one is work,
levels 1-3 in 32-row blocks. The partitioned walk first counting-sorts the
level's rows by node on the card (count, scan and scatter kernels into a
scratch copy of the rows' bins, g and h: about 80 bytes a row read and
written, 0.25 ms a level at 10.5M x 28 by the bytes, 0.8-1.1 ms measured on
an H100) and then walks
each node's rows once, a CTA holding all of one node's features (114.7 KB
at F = 28) beside a ring of 1024-row blocks: one pass whatever K is.
``node_plan`` picks the walk from the launch's shape: the partitioned walk
for one fit where K ≥ 2 and the tiled plan takes more than two passes or
stages fewer rows a block; the tiled walk for a level of one node, fold
launches, the stump and stats entries, and plans of at most two passes of
full blocks (depth 3's levels at 17 features).

Build: on first use ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``build/torch_ext/`` of the
checkout (git-ignored), named by the source's hash, and ``ctypes`` loads
it. No PyTorch header is included, so the build takes seconds.

Dispatch: a wrapper given CPU tensors computes the plain PyTorch version
(``ops.histogram.*_reference``, ``ops.histogram.node_histograms``,
``ops.histogram.leaf_sums``); given
CUDA tensors it launches the kernel or raises. A failed build or launch
propagates, never falls back. ``LAUNCHES`` counts, per wrapper, the kernel
launches it made (nothing else; a node call is one launch whichever walk it
takes), so a run can show that its main path went through the kernel;
``LAUNCHES["node_partition"]`` counts the node calls that partitioned.
``ROW_PASSES`` counts, per wrapper, how often those launches walked their
rows: a histogram launch walks them once per tile of its plan
(``node_row_passes``: a partitioned launch once per feature tile of one
node), a partition once, a leaf-sum launch once per tile of ``LEAF_TILE``
segments (``leaf_row_passes``). Each launch and each build also counts in
``obs.torchmon``'s ``torch_kernel_launches_total{kernel}``,
``torch_kernel_row_passes_total{kernel}`` and ``torch_kernel_builds_total``
/ ``torch_kernel_build_seconds_total``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from machine_learning_replications_tpu_torch.obs import torchmon
from machine_learning_replications_tpu_torch.ops import histogram

SOURCE = Path(__file__).resolve().parent / "csrc" / "histogram.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# The kernel's staging ring (csrc/histogram.cu: kStages, kBarrierBytes) and
# the row counts a staged block may take, largest first.
STAGES = 2
BARRIER_BYTES = 16
BLOCK_ROWS = (1024, 512, 256, 128, 64, 32)
# The leaf-sum kernel's threads a block and segments a block holds
# (csrc/histogram.cu: kLeafThreads, kLeafTile).
LEAF_THREADS = 256
LEAF_TILE = 16
# The partition's rows a count or scatter block, the most nodes a scatter
# block scans, its warps, and the rows a scatter sub-block may stage, largest
# first (csrc/histogram.cu: kPartRows, kPartMaxNodes, kPartWarps,
# kMaxStageChunks).
PARTITION_ROWS = 16384
PARTITION_MAX_NODES = 1024
PARTITION_WARPS = 32
STAGE_ROWS = (2048, 1024)
# The most passes of full blocks for which the node entry keeps the tiled walk
# (node_plan; measured at depth 3's last level, PERF.md §6).
TILED_PASSES_KEPT = 2

LAUNCHES = {"stump_histograms": 0, "node_histograms": 0, "stats_histograms": 0,
            "leaf_sums": 0, "node_partition": 0}
ROW_PASSES = dict.fromkeys(LAUNCHES, 0)
build_log: list[str] = []  # nvcc's output (ptxas register/smem report)

_MODES = {"stats": 0, "stump": 1, "node": 2}
_BIN_CODES = {torch.uint8: 0, torch.int32: 1}
_VAL_CODES = {torch.float32: 0, torch.float64: 1}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        ROW_PASSES[k] = 0


def _count(counter: str, passes: int) -> None:
    LAUNCHES[counter] += 1
    ROW_PASSES[counter] += passes
    torchmon.record_launch(counter)
    torchmon.record_row_passes(counter, passes)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build the histogram kernel")
    return found


def build() -> Path:
    """Compile ``csrc/histogram.cu`` (once per source hash) → library path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"histogram_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    torchmon.record_kernel_build(time.perf_counter() - t0)
    build_log.append(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    with _lock:
        lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.histogram_launch.argtypes = [
        i, p, i, ll,          # mode, bins, bin dtype, bins fold stride
        p, ll,                # key (int32), key fold stride
        p, p, i, ll, ll,      # a, b, value dtype, their fold strides
        p, ll, i, i, i, i, i,  # out, n, F, S, KB, B, folds
        i, i, i, i, p,        # tile features, tile cells, block rows, device, stream
    ]
    lib.histogram_launch.restype = i
    lib.leaf_sums_launch.argtypes = [
        p, p, p, i,           # node (int32), g, h, value dtype
        p, ll, p,             # scratch, its float64 elements, out
        ll, i, i, i, p,       # n, folds, segs, device, stream
    ]
    lib.leaf_sums_launch.restype = i
    lib.node_sorted_launch.argtypes = [
        p, i, ll, p, ll,      # bins, bin dtype, fold stride; node ids, fold stride
        p, p, i, ll, ll,      # g, h, value dtype, their fold strides
        p, p, p, ll, p, p,    # sorted bins, g, h, their padded rows, counts, offsets
        p, ll, i, i, i, i,    # out (None: the partition alone), n, F, K, B, folds
        i, i, i, i, p,        # stage rows, tile features, block rows, device, stream
    ]
    lib.node_sorted_launch.restype = i
    lib.histogram_smem_budget.argtypes = [i]
    lib.histogram_smem_budget.restype = i
    lib.histogram_error_string.argtypes = [i]
    lib.histogram_error_string.restype = ctypes.c_char_p
    return lib


def smem_budget(dev: torch.device) -> int:
    """Shared memory one CTA may opt in to on ``dev`` (bytes)."""
    budget = _library().histogram_smem_budget(dev.index)
    if budget <= 0:
        raise RuntimeError(f"cannot read the shared-memory budget of {dev}")
    return budget


def stage_bytes(block_rows: int, row_bytes: tuple[int, ...]) -> int:
    """Bytes of one stage of the kernel's ring: each staged per-row input's
    ``block_rows`` rows, rounded up to 16 bytes (the bulk copy's unit)."""
    return sum(-(-block_rows * b // 16) * 16 for b in row_bytes)


def _cell_tiles(F: int, S: int, kb: int, itemsize: int, room: int) -> tuple[int, int]:
    """Whole features first, in as few tiles as fit ``room`` and balanced
    among them; only where one feature's ``S·kb`` cells alone are over it,
    single features cut into balanced cell ranges."""
    per_feature = S * kb * itemsize
    if per_feature <= room:
        tiles = -(-F // (room // per_feature))
        return -(-F // tiles), kb
    tiles = -(-kb // (room // (S * itemsize)))
    return 1, -(-kb // tiles)


@functools.lru_cache(maxsize=1024)
def tile_plan(F: int, S: int, kb: int, itemsize: int, budget: int,
              row_bytes: tuple[int, ...]) -> tuple[int, int, int]:
    """``(tile_features, tile_cells, block_rows)`` for one launch.

    A CTA holds ``S·tile_features·tile_cells·itemsize`` bytes of histogram
    beside the staging ring: ``STAGES`` stages of ``block_rows`` rows of each
    staged per-row input (``row_bytes``: the bins' ``F·bin itemsize``, then
    the segment or node id's, the statistics') and the ring's barriers, all
    within ``budget``. Of the row counts in ``BLOCK_ROWS``, the plan takes
    the one that leaves the fewest tiles (each tile re-walks every row), and
    of those the largest (fewer ring turns). Plans are kept per shape: a
    fit asks for the same few on every launch."""
    best = None
    for rows in BLOCK_ROWS:
        room = budget - BARRIER_BYTES - STAGES * stage_bytes(rows, row_bytes)
        if room < S * itemsize:
            continue
        tf, tc = _cell_tiles(F, S, kb, itemsize, room)
        tiles = -(-F // tf) * -(-kb // tc)
        if best is None or tiles < best[0]:
            best = (tiles, tf, tc, rows)
    if best is None:
        raise ValueError(f"{S} statistics of {itemsize} bytes do not fit {budget} bytes "
                         f"beside the staging ring")
    return best[1:]


class NodePlan(NamedTuple):
    """One node launch's walk: ``partitioned`` (rows sorted by node, each CTA
    holding ``tile_features`` whole features of one node, ``tile_cells`` =
    B; the scatter staging ``stage_rows`` rows a sub-block) or tiled
    (``tile_plan``'s tiles of the ``[F, K·B]`` cells), and its staged
    block's rows."""
    partitioned: bool
    tile_features: int
    tile_cells: int
    block_rows: int
    stage_rows: int = 0


def scatter_smem(K: int, stage_rows: int, bin_row_bytes: int, val_bytes: int) -> int:
    """Shared memory of a scatter block (``csrc/histogram.cu``'s
    ``scatter_smem_bytes`` and its static warp totals): per-warp ranks, four
    per-node arrays, the slots' nodes and the staged rows."""
    staged_bins = -(-stage_rows * bin_row_bytes // 16) * 16
    return (4 * (PARTITION_WARPS * K + 3 * K + 1 + stage_rows) + staged_bins
            + 2 * stage_rows * val_bytes + 4 * PARTITION_WARPS)


def partitioned_plan(F: int, K: int, B: int, itemsize: int, budget: int,
                     bin_itemsize: int) -> "NodePlan | None":
    """The partitioned walk's plan: the walk's, ``tile_plan``'s at one node
    (cells of B bins) without the node-id stream, and the most rows of
    ``STAGE_ROWS`` a scatter block stages within ``budget``; None where one
    node's cells of a single feature or the scatter's least sub-block are
    over a CTA."""
    try:
        tf, tc, rows = tile_plan(F, 4, B, itemsize, budget, (F * bin_itemsize, itemsize, itemsize))
    except ValueError:
        return None
    stage = [r for r in STAGE_ROWS if scatter_smem(K, r, F * bin_itemsize, itemsize) <= budget]
    return NodePlan(True, tf, tc, rows, stage[0]) if tc == B and stage else None


@functools.lru_cache(maxsize=1024)
def node_plan(F: int, K: int, B: int, itemsize: int, budget: int, bin_itemsize: int,
              folds: int = 1) -> NodePlan:
    """The node entry's walk for ``folds`` fits of K nodes of B bins over F
    features.

    The tiled walk re-reads every row once per tile, and where its tiles fit
    they may leave the ring little room; the partitioned walk sorts the rows
    by node first (count, scan and scatter kernels: 0.8-1.1 ms at 10.5M x 28
    on an H100) and then holds one node's cells at a time. It is taken for
    one fit (a fold launch's rows are few: at 5 x 50,000 rows the partition
    alone takes twice the tiled walk), where there are nodes to sort (2 ≤ K ≤
    ``PARTITION_MAX_NODES``), a node's whole feature fits one CTA, and the
    tiled plan takes more than ``TILED_PASSES_KEPT`` passes or stages fewer
    rows a block. Everything else keeps the tiled walk: a level of one node,
    fold launches, and depth 3's levels at 17 features, where two tiled
    passes of 10M rows (1.87 ms) beat the partition and one pass (2.52 ms)."""
    tiled = NodePlan(False, *tile_plan(F, 4, K * B, itemsize, budget,
                                       (F * bin_itemsize, 4, itemsize, itemsize)))
    if folds != 1 or not 2 <= K <= PARTITION_MAX_NODES:
        return tiled
    part = partitioned_plan(F, K, B, itemsize, budget, bin_itemsize)
    passes = row_passes(F, K * B, tiled.tile_features, tiled.tile_cells)
    if part and (passes > TILED_PASSES_KEPT or tiled.block_rows < part.block_rows):
        return part
    return tiled


def node_row_passes(F: int, K: int, B: int, plan: NodePlan) -> int:
    """Passes over its rows of a node launch: a partitioned launch walks its
    sorted rows once per feature tile of one node, a tiled one once per
    tile of its ``[F, K·B]`` cells."""
    return row_passes(F, B if plan.partitioned else K * B, plan.tile_features, plan.tile_cells)


def row_passes(F: int, kb: int, tile_features: int, tile_cells: int) -> int:
    """Passes over its rows of a launch that ``tile_plan`` cut into tiles of
    ``tile_features`` x ``tile_cells``: one per tile of its ``[F, kb]`` cells."""
    return -(-F // tile_features) * -(-kb // tile_cells)


def leaf_row_passes(segs: int) -> int:
    """Passes over its rows of a leaf-sum launch of ``segs`` segments: one per
    tile of ``LEAF_TILE`` segments (``csrc/histogram.cu``'s leaf sums)."""
    return -(-segs // LEAF_TILE)


def _fold_stride(t: torch.Tensor, name: str, inner: int, k: "int | None") -> int:
    """The stride (elements) between folds of ``t``, whose last ``inner``
    dimensions must be contiguous: 0 where ``t`` has no fold axis (one array
    shared by every fold), else ``t.stride(0)`` (0 for an ``expand``)."""
    body = t if t.dim() == inner else t[0]
    if t.dim() not in (inner, inner + 1) or (t.dim() == inner + 1 and t.shape[0] != k):
        raise ValueError(f"{name} has shape {tuple(t.shape)}; expected {inner} dimensions"
                         f"{'' if k is None else f' or a leading fold axis of {k}'}")
    if not body.is_contiguous():
        raise ValueError(f"{name} must be contiguous (apart from a fold axis)")
    return t.stride(0) if t.dim() == inner + 1 else 0


def _checked(mode: str, bins: torch.Tensor, key: "torch.Tensor | None", a: torch.Tensor,
             b: "torch.Tensor | None", S: int, kb: int) -> tuple:
    """The kernel's checks of one launch's inputs → ``(k, n, F, strides,
    row_bytes)``: k the fold count (None without a fold axis), each input's
    fold stride in elements and the staged per-row inputs' bytes."""
    row_dims = 2 if mode == "stats" else 1
    k = a.shape[0] if a.dim() == row_dims + 1 else None
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"the histogram kernel runs on a CUDA device, not {dev}")
    if bins.dtype not in _BIN_CODES:
        raise TypeError(f"bins must be uint8 or int32, got {bins.dtype}")
    if a.dtype not in _VAL_CODES or (b is not None and b.dtype != a.dtype):
        raise TypeError(f"statistics must be float32 or float64, one dtype; got {a.dtype}"
                        f"{'' if b is None else f', {b.dtype}'}")
    if key is not None and key.dtype != torch.int32:
        raise TypeError(f"{'node ids' if mode == 'node' else 'seg'} must be int32, "
                        f"got {key.dtype}")
    if kb < 1 or bins.dim() not in (2, 3):
        raise ValueError(f"expected bins [n, F] or [k, n, F] and kb >= 1; got "
                         f"{tuple(bins.shape)}, {kb}")
    n, F = bins.shape[-2:]
    rows_shape = a.shape[:a.dim() - row_dims + 1]            # [(k,) n]
    if rows_shape[-1] != n or any(t is not None and t.shape != rows_shape for t in (key, b)):
        raise ValueError(f"row counts differ: bins {tuple(bins.shape)}, values "
                         f"{tuple(a.shape)}, {None if key is None else tuple(key.shape)}, "
                         f"{None if b is None else tuple(b.shape)}")
    strides = {}
    for name, t, inner in (("bins", bins, 2), ("key", key, 1), ("a", a, row_dims), ("b", b, 1)):
        if t is None:
            strides[name] = 0
            continue
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, bins on {dev}")
        strides[name] = _fold_stride(t, name, inner, k)
    row_bytes = tuple(x for x in (
        F * bins.element_size(),
        0 if key is None else key.element_size(),
        a.element_size() * (S if mode == "stats" else 1),
        0 if b is None else b.element_size(),
    ) if x)
    return k, n, F, strides, row_bytes


def _sorted(lib, bins: torch.Tensor, node: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
            strides: dict, out: "torch.Tensor | None", k: int, n: int, F: int, K: int, B: int,
            plan: NodePlan) -> tuple:
    """One call of the partitioned walk's C entry (the partition alone where
    ``out`` is None) through fresh scratch → ``(code, sorted bins, sorted g,
    sorted h, offsets)``; the sorted copies are ``[k, n_pad, ...]``."""
    dev = bins.device
    n_pad = -(-n // 32) * 32
    sbins = torch.empty((k, n_pad, F), dtype=bins.dtype, device=dev)
    sg = torch.empty((k, n_pad), dtype=g.dtype, device=dev)
    sh = torch.empty((k, n_pad), dtype=g.dtype, device=dev)
    counts = torch.empty((k, K, -(-n // PARTITION_ROWS)), dtype=torch.int32, device=dev)
    offsets = torch.zeros((k, K + 1), dtype=torch.int32, device=dev)
    code = lib.node_sorted_launch(
        bins.data_ptr(), _BIN_CODES[bins.dtype], strides["bins"],
        node.data_ptr(), strides["key"],
        g.data_ptr(), h.data_ptr(), _VAL_CODES[g.dtype], strides["a"], strides["b"],
        sbins.data_ptr(), sg.data_ptr(), sh.data_ptr(), n_pad, counts.data_ptr(),
        offsets.data_ptr(), None if out is None else out.data_ptr(),
        n, F, K, B, k, plan.stage_rows, plan.tile_features, plan.block_rows,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return code, sbins, sg, sh, offsets


def _raise_on(lib, code: int) -> None:
    if code != 0:
        msg = lib.histogram_error_string(code).decode()
        raise RuntimeError(f"histogram kernel launch failed ({code}): {msg}")


def _launch(mode: str, bins: torch.Tensor, key: "torch.Tensor | None", a: torch.Tensor,
            b: "torch.Tensor | None", S: int, kb: int, B: int, counter: str) -> torch.Tensor:
    """Checks, allocates the zeroed output, launches once and adds one to
    ``LAUNCHES[counter]`` and the plan's passes to ``ROW_PASSES[counter]``;
    a node launch that ``node_plan`` partitions also adds one to
    ``LAUNCHES["node_partition"]``. Returns ``[k, S, F, kb]`` (``[k, 4, K,
    F, B]`` in node mode) with k = 1 where ``a`` has no fold axis.

    ``bins [n, F]`` (shared by every fold) or ``[k, n, F]``; ``key``: the
    int32 segment offsets ``[(k,) n]`` (stats mode), the int32 node ids
    (node mode) or None (stump mode); ``a``: the values
    ``[(k,) n, S]`` (stats mode) or ``grad [(k,) n]``; ``b``: ``hess`` like
    ``grad`` (stump and node modes)."""
    k, n, F, strides, row_bytes = _checked(mode, bins, key, a, b, S, kb)
    dev = bins.device
    K = kb // B
    lib = _library()
    with torch.cuda.device(dev):
        budget = smem_budget(dev)
        if mode == "node":
            plan = node_plan(F, K, B, a.element_size(), budget, bins.element_size(), k or 1)
        else:
            plan = NodePlan(False, *tile_plan(F, S, kb, a.element_size(), budget, row_bytes))
        shape = (k or 1, 4, K, F, B) if mode == "node" else (k or 1, S, F, kb)
        out = torch.zeros(shape, dtype=a.dtype, device=dev)
        if plan.partitioned:
            code = _sorted(lib, bins, key, a, b, strides, out, k or 1, n, F, K, B, plan)[0]
        else:
            code = lib.histogram_launch(
                _MODES[mode], bins.data_ptr(), _BIN_CODES[bins.dtype], strides["bins"],
                None if key is None else key.data_ptr(), strides["key"],
                a.data_ptr(), None if b is None else b.data_ptr(), _VAL_CODES[a.dtype],
                strides["a"], strides["b"],
                out.data_ptr(), n, F, S, kb, B, k or 1, plan.tile_features, plan.tile_cells,
                plan.block_rows, dev.index, torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(lib, code)
    _count(counter, node_row_passes(F, K, B, plan) if mode == "node"
           else row_passes(F, kb, plan.tile_features, plan.tile_cells))
    if plan.partitioned:
        _count("node_partition", 1)
    return out


def stats_histograms_cuda(bins: torch.Tensor, seg: torch.Tensor, vals: torch.Tensor,
                          kb: int) -> torch.Tensor:
    """``out[s, f, seg[r] + bins[r, f]] += vals[r, s]`` → ``[S, F, kb]``.
    On the card also with a fold axis (vals ``[k, n, S]``, seg ``[k, n]``,
    bins ``[n, F]`` or ``[k, n, F]``) → ``[k, S, F, kb]``."""
    if bins.device.type == "cpu":
        return histogram.stats_histograms_reference(bins, seg, vals, kb)
    if vals.dim() not in (2, 3) or seg is None:
        raise ValueError(f"expected vals [n, S] or [k, n, S] and seg; got {tuple(vals.shape)}")
    out = _launch("stats", bins, seg, vals, None, vals.shape[-1], kb, kb, "stats_histograms")
    return out if vals.dim() == 3 else out[0]


def stump_histograms_cuda(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                          max_bins: int) -> torch.Tensor:
    """K=1, S=2 (grad, hess), seg ≡ 0 → ``[2, F, max_bins]``."""
    if binned.device.type == "cpu":
        return histogram.stump_histograms_reference(binned, grad, hess, max_bins)
    if binned.dim() != 2 or grad.shape != (binned.shape[0],) or hess.shape != grad.shape:
        raise ValueError(f"expected binned [n, F], grad [n], hess [n]; got "
                         f"{tuple(binned.shape)}, {tuple(grad.shape)}, {tuple(hess.shape)}")
    dtype = torch.promote_types(grad.dtype, torch.float32)
    return _launch("stump", binned, None, grad.to(dtype), hess.to(dtype), 2, max_bins,
                   max_bins, "stump_histograms")[0]


def node_histograms_cuda(binned: torch.Tensor, node_local: torch.Tensor, grad: torch.Tensor,
                         hess: torch.Tensor, n_nodes: int,
                         max_bins: int) -> histogram.NodeHistograms:
    """K = ``n_nodes`` nodes, S=4 (g·a, h·a, g²·a, a) with a = [node_local ≥ 0]
    at cell max(node_local, 0)·B + bin → ``NodeHistograms`` of ``[K, F, B]``
    (``node_histograms_pallas``' contract). With a leading fold axis
    (node_local, grad, hess ``[k, n]``; binned ``[n, F]`` or ``[k, n, F]``)
    all k fits go in one launch → ``[k, K, F, B]`` each. On the card
    ``node_local`` is int32 (the TPU kernel's and the grower's node ids)."""
    if binned.device.type == "cpu":
        return histogram.node_histograms(binned, node_local, grad, hess, n_nodes, max_bins)
    if node_local.dim() not in (1, 2) or grad.shape != node_local.shape or (
            hess.shape != grad.shape or binned.shape[-2] != grad.shape[-1]):
        raise ValueError(f"expected node_local, grad, hess [n] or [k, n] over binned rows; got "
                         f"{tuple(binned.shape)}, {tuple(node_local.shape)}, "
                         f"{tuple(grad.shape)}, {tuple(hess.shape)}")
    K, B = n_nodes, max_bins
    dtype = torch.promote_types(grad.dtype, torch.float32)
    out = _launch("node", binned, node_local, grad.to(dtype), hess.to(dtype), 4, K * B, B,
                  "node_histograms")                          # [k, 4, K, F, B]
    return histogram.NodeHistograms(*(out if node_local.dim() == 2 else out[0]).unbind(-4))


def node_partition_cuda(binned: torch.Tensor, node_local: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, n_nodes: int) -> histogram.Partition:
    """The partitioned walk's first step alone (its count, scan and scatter
    kernels) → ``histogram.Partition``: ``[k, n, ...]`` copies of the active
    rows sorted by node and the ``[k, n_nodes + 1]`` offsets, k = 1 without a
    fold axis; on CPU tensors the plain ``histogram.node_partition``. Past a
    fit's ``offsets[:, -1]`` rows the copies hold what the scratch held. One
    call adds one to ``LAUNCHES["node_partition"]``."""
    if binned.device.type == "cpu":
        return histogram.node_partition(binned, node_local, grad, hess, n_nodes)
    k, n, F, strides, _ = _checked("node", binned, node_local, grad, hess, 4, n_nodes)
    lib = _library()
    with torch.cuda.device(binned.device):
        plan = partitioned_plan(F, n_nodes, 1, grad.element_size(), smem_budget(binned.device),
                                binned.element_size())
        if plan is None:
            raise ValueError(f"a scatter block of {n_nodes} nodes and {F} features does not "
                             f"fit the shared memory")
        code, sbins, sg, sh, offsets = _sorted(lib, binned, node_local, grad, hess, strides,
                                               None, k or 1, n, F, n_nodes, 1, plan)
        _raise_on(lib, code)
    _count("node_partition", 1)
    return histogram.Partition(sbins[:, :n], sg[:, :n], sh[:, :n], offsets)


def leaf_scratch(k: int, segs: int, dev: torch.device) -> int:
    """Float64 elements of scratch that suffice for one leaf-sum launch of
    ``k`` fits of ``segs`` segments on ``dev``, whatever the row count: a
    ``[2, tile]`` partial for each block of one wave (every block the card's
    SMs can hold at ``LEAF_THREADS`` threads) or, where there are more
    (fit, tile) pairs than that, one per pair."""
    tile = min(segs, LEAF_TILE)
    props = torch.cuda.get_device_properties(dev)
    slots = props.multi_processor_count * (props.max_threads_per_multi_processor // LEAF_THREADS)
    return max(slots, k * -(-segs // tile)) * 2 * tile


def leaf_sums_cuda(node: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor, k: int,
                   n_nodes: int) -> torch.Tensor:
    """Per-(fit, final node) float64 sums of ``grad`` and ``hess`` → ``[2, k,
    n_nodes + 1]`` (``histogram.leaf_sums``' contract). ``node`` is the
    grower's contiguous int32 ``[k, n]``, ``grad`` and ``hess`` contiguous
    ``[k, n]`` float32 or float64, read as they are. On the card a parked
    row (node −1) adds nothing, so the dump segment ``n_nodes`` holds 0
    there (the plain version's holds the parked rows' sums); the caller
    drops it. One call is one launch of the C entry (a partial and a merge
    kernel)."""
    if node.device.type == "cpu":
        return histogram.leaf_sums(node, grad, hess, k, n_nodes)
    dev = node.device
    if node.dtype != torch.int32:
        raise TypeError(f"node ids must be int32, got {node.dtype}")
    if grad.dtype not in _VAL_CODES or hess.dtype != grad.dtype:
        raise TypeError(f"statistics must be float32 or float64, one dtype; got {grad.dtype}, "
                        f"{hess.dtype}")
    if node.dim() != 2 or node.shape[0] != k or grad.shape != node.shape or (
            hess.shape != node.shape):
        raise ValueError(f"expected node, grad, hess [{k}, n]; got {tuple(node.shape)}, "
                         f"{tuple(grad.shape)}, {tuple(hess.shape)}")
    for name, t in (("node", node), ("grad", grad), ("hess", hess)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, node on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, segs, code = node.shape[1], n_nodes + 1, _VAL_CODES[grad.dtype]
    lib = _library()
    with torch.cuda.device(dev):
        need = leaf_scratch(k, segs, dev)
        partial = torch.empty(need, dtype=torch.float64, device=dev)
        out = torch.empty((2, k, segs), dtype=torch.float64, device=dev)
        err = lib.leaf_sums_launch(
            node.data_ptr(), grad.data_ptr(), hess.data_ptr(), code,
            partial.data_ptr(), need, out.data_ptr(),
            n, k, segs, dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"leaf-sum kernel launch failed ({err}): "
                               f"{lib.histogram_error_string(err).decode()}")
    _count("leaf_sums", leaf_row_passes(segs))
    return out

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
    forms (g·a, h·a, g²·a, a) with a = [node ≥ 0] and the node's cell offset
    itself, and writes the ``[K, F, B]`` statistics directly.

A warp takes 32 rows and steps over a tile's features; lanes whose cell is
equal sum their statistics by shuffles and one lane adds them with one
shared atomic per statistic. Row blocks are staged into shared memory by
``cp.async.bulk`` in a two-stage ring. ``tile_plan`` (plain Python, tested
on the CPU) cuts the ``[F, K·B]`` cells into tiles that fit one CTA's shared
memory beside that ring, and picks the block's row count.

Build: on first use ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``build/torch_ext/`` of the
checkout (git-ignored), named by the source's hash, and ``ctypes`` loads
it. No PyTorch header is included, so the build takes seconds.

Dispatch: a wrapper given CPU tensors computes the plain PyTorch version
(``ops.histogram.*_reference``, ``ops.histogram.node_histograms``); given
CUDA tensors it launches the kernel or raises. A failed build or launch
propagates, never falls back. ``LAUNCHES`` counts, per wrapper, the kernel
launches it made (nothing else), so a run can show that its main path went
through the kernel; each launch and each build also counts in
``obs.torchmon``'s ``torch_kernel_launches_total{kernel}`` and
``torch_kernel_builds_total`` / ``torch_kernel_build_seconds_total``.
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

LAUNCHES = {"stump_histograms": 0, "node_histograms": 0, "stats_histograms": 0}
build_log: list[str] = []  # nvcc's output (ptxas register/smem report)

_MODES = {"stats": 0, "stump": 1, "node": 2}
_BIN_CODES = {torch.uint8: 0, torch.int32: 1}
_VAL_CODES = {torch.float32: 0, torch.float64: 1}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def tile_plan(F: int, S: int, kb: int, itemsize: int, budget: int,
              row_bytes: tuple[int, ...]) -> tuple[int, int, int]:
    """``(tile_features, tile_cells, block_rows)`` for one launch.

    A CTA holds ``S·tile_features·tile_cells·itemsize`` bytes of histogram
    beside the staging ring: ``STAGES`` stages of ``block_rows`` rows of each
    staged per-row input (``row_bytes``: the bins' ``F·bin itemsize``, then
    the segment or node id's, the statistics') and the ring's barriers, all
    within ``budget``. Of the row counts in ``BLOCK_ROWS``, the plan takes
    the one that leaves the fewest tiles (each tile re-walks every row), and
    of those the largest (fewer ring turns)."""
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


def _launch(mode: str, bins: torch.Tensor, key: "torch.Tensor | None", a: torch.Tensor,
            b: "torch.Tensor | None", S: int, kb: int, B: int, counter: str) -> torch.Tensor:
    """Checks, allocates the zeroed output, launches once and adds one to
    ``LAUNCHES[counter]``. Returns ``[k, S, F, kb]`` (``[k, 4, K, F, B]`` in
    node mode) with k = 1 where ``a`` has no fold axis.

    ``bins [n, F]`` (shared by every fold) or ``[k, n, F]``; ``key``: the
    int32 segment offsets ``[(k,) n]`` (stats mode), the int32 node ids
    (node mode) or None (stump mode); ``a``: the values
    ``[(k,) n, S]`` (stats mode) or ``grad [(k,) n]``; ``b``: ``hess`` like
    ``grad`` (stump and node modes)."""
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
    lib = _library()
    with torch.cuda.device(dev):
        tile_f, tile_c, rows = tile_plan(F, S, kb, a.element_size(), smem_budget(dev), row_bytes)
        shape = (k or 1, 4, kb // B, F, B) if mode == "node" else (k or 1, S, F, kb)
        out = torch.zeros(shape, dtype=a.dtype, device=dev)
        code = lib.histogram_launch(
            _MODES[mode], bins.data_ptr(), _BIN_CODES[bins.dtype], strides["bins"],
            None if key is None else key.data_ptr(), strides["key"],
            a.data_ptr(), None if b is None else b.data_ptr(), _VAL_CODES[a.dtype],
            strides["a"], strides["b"],
            out.data_ptr(), n, F, S, kb, B, k or 1, tile_f, tile_c, rows,
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        if code != 0:
            msg = lib.histogram_error_string(code).decode()
            raise RuntimeError(f"histogram kernel launch failed ({code}): {msg}")
    LAUNCHES[counter] += 1
    torchmon.record_launch(counter)
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

"""The hand-written Hopper histogram kernel: build, binding and wrappers.

Counterpart of the JAX package's ``ops/pallas_histogram.py``. The kernel
(``csrc/histogram.cu``, design notes at its top) computes the general
``_stats_histograms`` contract at any ``S·F·KB``, tiling the ``[F, KB]``
cell space to fit shared memory (``tile_plan``), with an optional leading
fold axis. ``stump_histograms_cuda`` is its K=1, S=2 use by the fused
depth-1 GBDT fit, ``node_histograms_cuda`` its S=4 use by the level-wise
tree grower, ``stats_histograms_cuda`` the general entry.

Build: on first use ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``build/torch_ext/`` of the
checkout (git-ignored), named by the source's hash, and ``ctypes`` loads
it. No PyTorch header is included, so the build takes seconds.

Dispatch: a wrapper given CPU tensors computes the plain PyTorch version
(``ops.histogram.*_reference``); given CUDA tensors it launches the kernel
or raises. A failed build or launch propagates, never falls back.
``LAUNCHES`` counts, per wrapper, the kernel launches it made (nothing
else), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from machine_learning_replications_tpu_torch.ops import histogram

SOURCE = Path(__file__).resolve().parent / "csrc" / "histogram.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {"stump_histograms": 0, "node_histograms": 0, "stats_histograms": 0}
build_log: list[str] = []  # nvcc's output (ptxas register/smem report)

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
    proc = subprocess.run(cmd, capture_output=True, text=True)
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
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.stats_histograms_launch.argtypes = [p, i, p, p, i, p, ll, i, i, i, i, ll, i, i, i, p]
    lib.stats_histograms_launch.restype = i
    lib.stats_histograms_smem_budget.argtypes = [i]
    lib.stats_histograms_smem_budget.restype = i
    lib.stats_histograms_error_string.argtypes = [i]
    lib.stats_histograms_error_string.restype = ctypes.c_char_p
    return lib


def smem_budget(dev: torch.device) -> int:
    """Shared memory one CTA may opt in to on ``dev`` (bytes)."""
    budget = _library().stats_histograms_smem_budget(dev.index)
    if budget <= 0:
        raise RuntimeError(f"cannot read the shared-memory budget of {dev}")
    return budget


def tile_plan(F: int, S: int, kb: int, itemsize: int, budget: int) -> tuple[int, int]:
    """``(tile_features, tile_cells)``: one CTA's share of the ``[F, kb]``
    cell space, whose ``S·tile_features·tile_cells·itemsize`` bytes fit
    ``budget``. Whole features first, in as few tiles as fit and balanced
    among them; only where one feature's ``S·kb`` cells alone are over the
    budget, single features cut into balanced cell ranges."""
    per_feature = S * kb * itemsize
    if per_feature <= budget:
        tiles = -(-F // (budget // per_feature))
        return -(-F // tiles), kb
    per_cell = S * itemsize
    if per_cell > budget:
        raise ValueError(f"{S} statistics of {itemsize} bytes do not fit {budget} bytes")
    tiles = -(-kb // (budget // per_cell))
    return 1, -(-kb // tiles)


def _launch(bins: torch.Tensor, seg: "torch.Tensor | None", vals: torch.Tensor,
            kb: int, counter: str) -> torch.Tensor:
    """Checks, allocates the zeroed output, launches once and adds one to
    ``LAUNCHES[counter]``.

    One fit: bins ``[n, F]``, seg ``[n]``, vals ``[n, S]`` → ``[S, F, kb]``.
    ``k`` fits at once (a fold axis): vals ``[k, n, S]``, seg ``[k, n]``,
    bins ``[n, F]`` shared or ``[k, n, F]`` → ``[k, S, F, kb]``."""
    folds = vals.shape[0] if vals.dim() == 3 else None
    k = folds or 1
    if bins.dim() not in (2, 3) or vals.dim() not in (2, 3) or kb < 1 or (
            bins.dim() == 3 and bins.shape[0] != k):
        raise ValueError(f"expected bins [n, F] or [k, n, F], vals [n, S] or [k, n, S] and "
                         f"kb >= 1; got {tuple(bins.shape)}, {tuple(vals.shape)}, {kb}")
    n, F = bins.shape[-2:]
    S = vals.shape[-1]
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"the histogram kernel runs on a CUDA device, not {dev}")
    if bins.dtype not in _BIN_CODES:
        raise TypeError(f"bins must be uint8 or int32, got {bins.dtype}")
    if vals.dtype not in _VAL_CODES:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if vals.shape[-2] != n or (seg is not None and seg.shape != vals.shape[:-1]):
        raise ValueError(f"row counts differ: bins {tuple(bins.shape)}, vals "
                         f"{tuple(vals.shape)}, seg {None if seg is None else tuple(seg.shape)}")
    for name, t in (("bins", bins), ("vals", vals), ("seg", seg)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, bins on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg is not None and seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32, got {seg.dtype}")
    lib = _library()
    with torch.cuda.device(dev):
        tile_f, tile_c = tile_plan(F, S, kb, vals.element_size(), smem_budget(dev))
        out = torch.zeros((k, S, F, kb), dtype=vals.dtype, device=dev)
        code = lib.stats_histograms_launch(
            bins.data_ptr(), _BIN_CODES[bins.dtype],
            None if seg is None else seg.data_ptr(),
            vals.data_ptr(), _VAL_CODES[vals.dtype], out.data_ptr(),
            n, F, S, kb, k, n * F if bins.dim() == 3 else 0, tile_f, tile_c,
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        if code != 0:
            msg = lib.stats_histograms_error_string(code).decode()
            raise RuntimeError(f"stats_histograms kernel launch failed ({code}): {msg}")
    LAUNCHES[counter] += 1
    return out if folds else out[0]


def stats_histograms_cuda(bins: torch.Tensor, seg: torch.Tensor, vals: torch.Tensor,
                          kb: int) -> torch.Tensor:
    """``out[s, f, seg[r] + bins[r, f]] += vals[r, s]`` → ``[S, F, kb]``."""
    if bins.device.type == "cpu":
        return histogram.stats_histograms_reference(bins, seg, vals, kb)
    return _launch(bins, seg, vals, kb, "stats_histograms")


def stump_histograms_cuda(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                          max_bins: int) -> torch.Tensor:
    """K=1, S=2 (grad, hess), seg ≡ 0 → ``[2, F, max_bins]``."""
    if binned.device.type == "cpu":
        return histogram.stump_histograms_reference(binned, grad, hess, max_bins)
    if binned.dim() != 2 or grad.shape != (binned.shape[0],) or hess.shape != grad.shape:
        raise ValueError(f"expected binned [n, F], grad [n], hess [n]; got "
                         f"{tuple(binned.shape)}, {tuple(grad.shape)}, {tuple(hess.shape)}")
    dtype = torch.promote_types(grad.dtype, torch.float32)
    vals = torch.stack([grad.to(dtype), hess.to(dtype)], dim=1)  # [n, 2]
    return _launch(binned, None, vals, max_bins, "stump_histograms")


def node_histograms_cuda(binned: torch.Tensor, node_local: torch.Tensor, grad: torch.Tensor,
                         hess: torch.Tensor, n_nodes: int,
                         max_bins: int) -> histogram.NodeHistograms:
    """K = ``n_nodes`` nodes, S=4 (g·a, h·a, g²·a, a) with a = [node_local ≥ 0]
    and seg = max(node_local, 0)·B → ``NodeHistograms`` of ``[K, F, B]``
    (``node_histograms_pallas``' contract). With a leading fold axis
    (node_local, grad, hess ``[k, n]``; binned ``[n, F]`` or ``[k, n, F]``)
    all k fits go in one launch → ``[k, K, F, B]`` each."""
    if binned.device.type == "cpu":
        return histogram.node_histograms(binned, node_local, grad, hess, n_nodes, max_bins)
    if node_local.dim() not in (1, 2) or grad.shape != node_local.shape or (
            hess.shape != grad.shape or binned.shape[-2] != grad.shape[-1]):
        raise ValueError(f"expected node_local, grad, hess [n] or [k, n] over binned rows; got "
                         f"{tuple(binned.shape)}, {tuple(node_local.shape)}, "
                         f"{tuple(grad.shape)}, {tuple(hess.shape)}")
    K, B = n_nodes, max_bins
    F = binned.shape[-1]
    dtype = torch.promote_types(grad.dtype, torch.float32)
    active = (node_local >= 0).to(dtype)
    g = grad.to(dtype) * active
    h = hess.to(dtype) * active
    vals = torch.stack([g, h, g * g, active], dim=-1)            # [..., n, 4]
    seg = (torch.clamp_min(node_local, 0) * B).to(torch.int32)
    out = _launch(binned, seg, vals, K * B, "node_histograms")   # [..., 4, F, K·B]
    lead = out.shape[:-3]
    stats = out.reshape(*lead, 4, F, K, B).transpose(-3, -2)     # [..., 4, K, F, B]
    return histogram.NodeHistograms(*stats.unbind(-4))

#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds, is right and runs on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--rows N] [--seed S]

It drives the port's main path (``machine_learning_replications_tpu_torch``,
never JAX) through the entry points a user calls, and prints one JSON line
per phase:

  device   the card (``nvidia-smi`` name and power limit), torch and CUDA;
  build    ``nvcc`` builds the hand-written histogram kernel from the
           sources in the checkout;
  kernels  each entry of the kernel (the fused fit's stump histograms, the
           grower's node histograms, the general entry) against its plain
           PyTorch version on the same inputs at the fits' shapes and at
           edge shapes (tiled shared memory, fold axes with aligned and
           unaligned strides, the warp aggregation's best and worst bin
           patterns, ragged row counts, int32 bins, float64, all rows
           inactive), node counts exactly; with its time on the cohort's
           bins and on uniform bins (the contention probe), the plain
           version's, one ``index_add_`` call's, and the bound;
  train    ``gbdt.fit`` of the reference GBDT member (100 depth-1 stumps,
           256 hist bins) on ``--rows`` x 17 synthetic-cohort rows through
           the kernel, against the same fit through the plain version
           (deviance paths at rtol 1e-4, train AUC within 0.005), plus a
           profiler breakdown of one warm fit;
  train_depth  the same fit at ``max_depth=3`` (device binning, then the
           level-wise grower, then the node kernel: one launch per level),
           held to its plain-version fit the same way, with a profile;
  sweep    ``sweep.cv_sweep`` at ``bench.py`` config 4's shape (5-fold CV
           over n_estimators (25, 50, 100) x max_depth (1, 2, 3) on
           ``--sweep-rows`` cohort rows), through the kernel and through the
           plain version, mean-AUC grids within 0.005;
  serve    ``stacking.predict_proba`` with the depth-1 forest as the GBDT
           member and seeded scaler/SVC/LR/meta parameters, on the card and
           on the CPU, at (1e-5, 1e-8).

Launch counts are set to 0 just before each of train, train_depth, sweep
and serve and read just after; each kernel entry must have launched on
that path.

Then the kernel table ``{"kernels": [...]}``, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result; without CUDA it stops at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.config import GBDTConfig, SweepConfig
from machine_learning_replications_tpu_torch.data import make_cohort, selected_indices
from machine_learning_replications_tpu_torch.models import (
    gbdt, linear, scaler, stacking, svm, sweep, tree,
)
from machine_learning_replications_tpu_torch.ops import binning, cuda_histogram, histogram

# Published peaks by H100 part (NVIDIA data sheets, dense, at the full power
# limit): HBM bytes/s, float32 and float64 FLOP/s outside the tensor cores.
PEAKS = {
    "SXM": {"bytes": 3.35e12, "float32": 67e12, "float64": 34e12},
    "PCIe": {"bytes": 2.0e12, "float32": 51e12, "float64": 26e12},
    "NVL": {"bytes": 3.9e12, "float32": 60e12, "float64": 30e12},
}
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-9, 1e-9)}  # (rtol, atol)
KERNEL_SOURCE = "machine_learning_replications_tpu_torch/ops/csrc/histogram.cu"
TPU_KERNELS = {
    "stump_histograms": "machine_learning_replications_tpu/ops/pallas_histogram.py:160",
    "node_histograms": "machine_learning_replications_tpu/ops/pallas_histogram.py:127",
}
STATS = ("grad", "hess", "grad2", "count")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def part_of(name: str) -> str:
    for part in ("PCIe", "NVL"):
        if part.lower() in name.lower():
            return part
    return "SXM"


def timed_ms(fn, flush: torch.Tensor, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call.

    Before each call the L2 cache is flushed (the fit's stage finds the bin
    matrix evicted by its own elementwise passes) and the stream is put to
    sleep, so the host has queued the whole call before the start event
    fires and no enqueue gap is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got: torch.Tensor, want: torch.Tensor, mass: torch.Tensor,
            dtype: torch.dtype) -> dict:
    """Holds ``got`` to ``want`` cell by cell at ``atol + rtol * mass``.

    ``mass`` is the cell's sum of absolute terms: a float sum taken in
    another order errs in proportion to it, not to the (possibly cancelled)
    result. Gradients y - p carry both signs, so a cell's sum can be far
    smaller than its mass; measured on an H100 at the fit's shape, the
    kernel's worst cell was 9.5e-6 off relative to its own result but far
    less relative to its mass."""
    rtol, atol = TOL[dtype]
    got, want, mass = got.double(), want.double(), mass.double()
    diff = (got - want).abs()
    nz = want != 0
    rel = (diff[nz] / want[nz].abs()).max().item() if bool(nz.any()) else 0.0
    nzm = mass != 0
    rel_mass = (diff[nzm] / mass[nzm]).max().item() if bool(nzm.any()) else 0.0
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * mass).all())
    return {"max_abs_err": diff.max().item(), "max_rel_err": rel,
            "max_err_over_mass": rel_mass, "rtol": rtol, "atol": atol, "ok": ok}


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Mann-Whitney AUC with average ranks for ties."""
    _, inv, counts = np.unique(score, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y > 0.5
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    info = {"phase": "device", "nvidia_smi": smi, "kind": kind,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "peaks": part_of(kind)}
    emit(info)
    return info


def phase_build() -> None:
    cached = any(cuda_histogram.BUILD_DIR.glob("histogram_*.so"))
    t0 = time.perf_counter()
    lib = cuda_histogram.build()
    cuda_histogram._library()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log in cuda_histogram.build_log for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": seconds, "cached": cached, "library": lib.name,
          "ptxas": ptxas})


def stage_inputs(X17: np.ndarray, y: np.ndarray, seed: int, dev: torch.device):
    """The fit's histogram inputs: the u8 bin matrix of the cohort and a
    mid-fit (g, h) = (y - p, p(1 - p)) in float32."""
    Xd = torch.as_tensor(X17, device=dev)
    binned, _, nan_flag = binning.device_binning_core(Xd, 256)
    check(not bool(nan_flag), "cohort has no NaN")
    binned = binned.to(torch.uint8)
    rng = np.random.default_rng(seed)
    raw = np.log(y.mean() / (1 - y.mean())) + rng.normal(0.0, 0.7, size=y.shape[0])
    p = 1.0 / (1.0 + np.exp(-raw))
    g = torch.as_tensor((y - p).astype(np.float32), device=dev)
    h = torch.as_tensor((p * (1 - p)).astype(np.float32), device=dev)
    return binned, g, h


def pattern_bins(kind: str, rng, n: int, F: int, B: int, dev) -> torch.Tensor:
    """u8 bin matrices that stress the kernel's warp aggregation:
    ``uniform`` (the contention probe's), ``dominant`` (95% of rows in one
    bin, like the cohort's two-valued columns), ``one_cell`` (every row in
    one bin: one peer group per warp step), ``distinct`` (32 consecutive
    rows in 32 bins: no peers)."""
    if kind == "uniform":
        b = rng.integers(0, B, size=(n, F))
    elif kind == "dominant":
        b = np.where(rng.random((n, F)) < 0.95, 7, rng.integers(0, B, size=(n, F)))
    elif kind == "one_cell":
        b = np.full((n, F), 3)
    else:
        b = (np.arange(n)[:, None] + 5 * np.arange(F)[None, :]) % B
    return torch.as_tensor(b.astype(np.uint8), device=dev)


def bound(nbytes: int, ops: int, peaks: dict, dtype: str) -> dict:
    """The least time for the work: bytes over HBM's rate, operations over
    the float rate of their type; the larger of the two."""
    bytes_ms = nbytes / peaks["bytes"] * 1e3
    ops_ms = ops / peaks[dtype] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def phase_kernels(binned, g, h, peaks: dict, seed: int, dev: torch.device) -> dict:
    """``stump_histograms_cuda`` against the plain
    ``histogram.stump_histograms_reference``: the fit's shape (also in
    float64), the aggregation's best and worst bin patterns at a ragged row
    count, int32 bins, n < 32, binary bins, zero statistics and the general
    entry; then times at the fit's shape, on the cohort's bins and on
    uniform bins (the contention probe)."""
    n, F = binned.shape
    B = 256
    rng = np.random.default_rng(seed + 1)
    checks = []

    def run(name, bins, gg, hh, nb):
        got = cuda_histogram.stump_histograms_cuda(bins, gg, hh, nb)
        want = histogram.stump_histograms_reference(bins, gg, hh, nb)
        mass = histogram.stump_histograms_reference(bins, gg.abs(), hh.abs(), nb)
        torch.cuda.synchronize()
        res = {"shape": name, "n": bins.shape[0], "F": bins.shape[1], "B": nb,
               "bins": str(bins.dtype).replace("torch.", ""),
               "vals": str(gg.dtype).replace("torch.", ""),
               **compare(got, want, mass, gg.dtype)}
        checks.append(res)
        check(res["ok"], f"kernel vs plain at {name}: {res}")
        return got

    run("fit", binned, g, h, B)
    run("fit_f64", binned, g.double(), h.double(), B)
    m = 200_003  # no multiple of 16: the last staged block loads by ordinary loads
    for kind in ("dominant", "one_cell", "distinct"):
        run(f"{kind}_bins", pattern_bins(kind, rng, m, F, B, dev), g[:m], h[:m], B)
    # Non-aligned shape, int32 bins, float64 statistics; n < 32.
    b2 = torch.as_tensor(rng.integers(0, 33, size=(257, 3)).astype(np.int32), device=dev)
    v2 = torch.as_tensor(rng.normal(size=(2, 257)), device=dev)
    run("non_aligned", b2, v2[0], v2[1].abs(), 33)
    run("n20", binned[:20], g[:20], h[:20], B)
    # All-binary bins at the fit's size.
    b3 = torch.as_tensor(rng.integers(0, 2, size=(n, F)).astype(np.uint8), device=dev)
    run("binary", b3, g, h, 2)
    del b3
    # All-zero statistics: the histogram must come out exactly zero.
    z = run("zero_vals", binned, torch.zeros_like(g), torch.zeros_like(h), B)
    check(not bool(z.any()), "zero statistics give a zero histogram")
    # The general entry: node segments, four statistics, a cell past kb; and
    # six statistics (two passes of four) over three folds.
    K, Bn = 8, 33
    bins4 = torch.as_tensor(rng.integers(0, Bn + 1, size=(3001, 6)).astype(np.int32), device=dev)
    seg4 = torch.as_tensor((rng.integers(0, K, size=3001) * Bn).astype(np.int32), device=dev)
    vals4 = torch.as_tensor(rng.normal(size=(3001, 4)), device=dev)
    plain = lambda v: histogram.stats_histograms_reference(bins4, seg4, v, K * Bn)  # noqa: E731
    res = {"shape": "general_nodes", "n": 3001, "F": 6, "K": K, "B": Bn, "bins": "int32",
           "vals": "float64",
           **compare(cuda_histogram.stats_histograms_cuda(bins4, seg4, vals4, K * Bn),
                     plain(vals4), plain(vals4.abs()), torch.float64)}
    checks.append(res)
    check(res["ok"], f"general kernel vs plain: {res}")
    seg6 = torch.as_tensor(rng.integers(0, 5 * Bn, size=(3, 3001)).astype(np.int32), device=dev)
    vals6 = torch.as_tensor(rng.normal(size=(3, 3001, 6)).astype(np.float32), device=dev)
    got6 = cuda_histogram.stats_histograms_cuda(bins4, seg6, vals6, K * Bn)
    for i in range(3):
        want6 = histogram.stats_histograms_reference(bins4, seg6[i], vals6[i], K * Bn)
        mass6 = histogram.stats_histograms_reference(bins4, seg6[i], vals6[i].abs(), K * Bn)
        res = {"shape": f"general_s6_fold{i}", "n": 3001, "F": 6, "S": 6, "bins": "int32",
               "vals": "float32", **compare(got6[i], want6, mass6, torch.float32)}
        checks.append(res)
        check(res["ok"], f"general kernel vs plain: {res}")

    # Times at the fit's shape, cold L2; the same call on uniform bins.
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    uniform = pattern_bins("uniform", rng, n, F, B, dev)
    vals = torch.stack([g, h], dim=1)
    ids = (torch.arange(F, device=dev)[None, :] * B + binned.long()).reshape(-1)
    src = vals[:, None, :].expand(n, F, 2).reshape(n * F, 2).contiguous()
    lib_out = torch.zeros(F * B, 2, dtype=torch.float32, device=dev)
    ms = timed_ms(lambda: cuda_histogram.stump_histograms_cuda(binned, g, h, B), flush)
    uniform_ms = timed_ms(lambda: cuda_histogram.stump_histograms_cuda(uniform, g, h, B), flush)
    plain_ms = timed_ms(lambda: histogram.stump_histograms_reference(binned, g, h, B), flush)
    library_ms = timed_ms(lambda: lib_out.index_add_(0, ids, src), flush)
    del flush, src, ids, uniform
    # The bound: each input read once and the output written once, over HBM;
    # n*F*2 float32 additions over the float32 rate.
    timing = {"ms": ms, "uniform_bins_ms": uniform_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              **bound(n * F * binned.element_size() + 2 * n * g.element_size() + 2 * F * B * 4,
                      2 * n * F, peaks, "float32"),
              "reps": 30, "l2": "flushed before each call"}
    emit({"phase": "kernels", "kernel": "stump_histograms", "checks": checks, **timing})
    return {"max_abs_err": checks[0]["max_abs_err"], **timing}


def phase_node_kernels(binned, g, h, peaks: dict, seed: int, dev: torch.device) -> dict:
    """``node_histograms_cuda`` against the plain ``histogram.node_histograms``:
    the depth-3 fit's levels (K = 1, 2, 4 on the 1M-row bin matrix with
    int32 node ids, as the grower hands them; K = 4 in two shared-memory
    feature tiles, three at float64), K = 64 (cell-range tiles), a five-fold
    batch over expanded statistics, three folds whose strides break the bulk
    copy's alignment, the aggregation's bin patterns, a small int32 bins /
    float64 shape, n < 32 and all rows inactive. Counts must be equal exactly; the
    other statistics are held per cell to their absolute mass
    (``compare``). Then times at depth 3's last level, on the cohort's bins
    and on uniform bins (the contention probe)."""
    n, F = binned.shape
    B = 256
    rng = np.random.default_rng(seed + 3)
    checks = []

    def run(name, bins, node, gg, hh, K, nb):
        got = cuda_histogram.node_histograms_cuda(bins, node, gg, hh, K, nb)
        want = histogram.node_histograms(bins, node, gg, hh, K, nb)
        mass = histogram.node_histograms(bins, node, gg.abs(), hh.abs(), K, nb)
        torch.cuda.synchronize()
        stats = {st: compare(getattr(got, st), getattr(want, st), getattr(mass, st), gg.dtype)
                 for st in STATS}
        counts_exact = bool(torch.equal(got.count, want.count))
        row_bytes = (bins.shape[-1] * bins.element_size(), node.element_size(),
                     gg.element_size(), hh.element_size())
        res = {"shape": name, "n": bins.shape[-2], "F": bins.shape[-1],
               "K": K, "B": nb, "folds": node.shape[0] if node.dim() == 2 else None,
               "bins": str(bins.dtype).replace("torch.", ""),
               "nodes": str(node.dtype).replace("torch.", ""),
               "vals": str(gg.dtype).replace("torch.", ""),
               "plan": cuda_histogram.tile_plan(bins.shape[-1], 4, K * nb, gg.element_size(),
                                                cuda_histogram.smem_budget(dev), row_bytes),
               "counts_exact": counts_exact,
               "max_abs_err": max(v["max_abs_err"] for v in stats.values()),
               "max_err_over_mass": max(v["max_err_over_mass"] for v in stats.values()),
               "ok": counts_exact and all(v["ok"] for v in stats.values())}
        checks.append(res)
        check(res["ok"], f"node kernel vs plain at {name}: {res} {stats}")
        return got

    def nodes(K, rows, lead=()):
        return torch.as_tensor(rng.integers(-1, K, size=lead + (rows,)).astype(np.int32),
                               device=dev)

    for K in (1, 2, 4):
        run(f"fit_level_K{K}", binned, nodes(K, n), g, h, K, B)
    node4 = nodes(4, n)
    run("fit_level_K4_f64", binned, node4, g.double(), h.double(), 4, B)
    m = 100_000
    run("cells_K64", binned[:m], nodes(64, m), g[:m], h[:m], 64, B)
    run("folds5_K4", binned[:50_000], nodes(4, 50_000, (5,)), g[:50_000].expand(5, -1),
        h[:50_000].expand(5, -1), 4, B)
    m = 100_001  # fold strides of 1,700,017 bin bytes and 400,004 / 800,008 value bytes
    fold_bins = torch.stack([binned[:m], binned[1:m + 1], binned[2:m + 2]])
    run("folds3_unaligned", fold_bins, nodes(4, m, (3,)), torch.stack([g[:m]] * 3),
        torch.stack([h[:m]] * 3), 4, B)
    del fold_bins
    m = 200_003
    for kind in ("dominant", "one_cell", "distinct"):
        run(f"{kind}_bins_K4", pattern_bins(kind, rng, m, F, B, dev), nodes(4, m), g[:m],
            h[:m], 4, B)
    b2 = torch.as_tensor(rng.integers(0, 33, size=(257, 3)).astype(np.int32), device=dev)
    v2 = torch.as_tensor(rng.normal(size=(2, 257)), device=dev)
    run("non_aligned", b2, nodes(8, 257), v2[0], v2[1].abs(), 8, 33)
    run("n20", binned[:20], nodes(2, 20), g[:20], h[:20], 2, B)
    z = run("all_inactive", binned, torch.full((n,), -1, dtype=torch.int32, device=dev), g, h,
            4, B)
    check(not any(bool(a.any()) for a in z), "all rows inactive give zero histograms")

    # Times at depth 3's last level (K = 4, int32 node ids as the grower's),
    # cold L2; the same call on uniform bins.
    K = 4
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    uniform = pattern_bins("uniform", rng, n, F, B, dev)
    active = (node4 >= 0).float()
    vals = torch.stack([g * active, h * active, g * g * active, active], dim=1)
    ids = ((node4.clamp_min(0)[:, None] * F + torch.arange(F, device=dev)[None, :]) * B
           + binned.long()).reshape(-1)
    src = vals[:, None, :].expand(n, F, 4).reshape(n * F, 4).contiguous()
    lib_out = torch.zeros(K * F * B, 4, dtype=torch.float32, device=dev)
    ms = timed_ms(lambda: cuda_histogram.node_histograms_cuda(binned, node4, g, h, K, B), flush)
    uniform_ms = timed_ms(lambda: cuda_histogram.node_histograms_cuda(uniform, node4, g, h, K, B),
                          flush)
    plain_ms = timed_ms(lambda: histogram.node_histograms(binned, node4, g, h, K, B), flush,
                        reps=20)
    library_ms = timed_ms(lambda: lib_out.index_add_(0, ids, src), flush)
    del flush, src, ids, uniform
    # The bound: the wrapper's inputs (u8 bins, int32 nodes, float32 g and h)
    # read once and its four [K, F, B] float32 outputs written once, over HBM;
    # 4 additions per active (row, feature) over the float32 rate.
    timing = {"ms": ms, "uniform_bins_ms": uniform_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              **bound(n * F * binned.element_size() + n * node4.element_size() + 2 * n * 4
                      + 4 * K * F * B * 4, 4 * F * int((node4 >= 0).sum()), peaks, "float32"),
              "reps": 30, "l2": "flushed before each call",
              "timed_shape": {"n": n, "F": F, "K": K, "B": B, "nodes": "int32",
                              "inactive_share": float((node4 < 0).float().mean())}}
    emit({"phase": "kernels", "kernel": "node_histograms", "checks": checks, **timing})
    worst = max(checks, key=lambda c: c["max_err_over_mass"])
    main = next(c for c in checks if c["shape"] == "fit_level_K4")
    return {"max_abs_err": main["max_abs_err"], "worst_err_over_mass": worst, **timing}


def fit_timed(Xd, yd, cfg, dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, aux = gbdt.fit(Xd, yd, cfg, device=dev)
    torch.cuda.synchronize()
    return params, aux, time.perf_counter() - t0


def profile_call(fn) -> dict:
    """Device time by kernel over one warm call of ``fn`` (which ends in a
    synchronize and returns its host-clock seconds), and the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = fn()
    by_name = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / (wall * 1e3)) if busy else None,
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def fit_vs_plain(X17, yf, cfg, dev, counter: str) -> tuple[dict, object, dict]:
    """The main path's fit through the kernel (launch counts from 0, read
    right after), warm refits, then the same fit through the plain version:
    deviance paths at rtol 1e-4, train AUC within 0.005, and a profile of
    one warm fit."""
    Xd = torch.as_tensor(X17, device=dev)
    yd = torch.as_tensor(yf, device=dev)
    cuda_histogram.reset_launch_counts()
    params, aux, cold = fit_timed(Xd, yd, cfg, dev)
    launches = dict(cuda_histogram.LAUNCHES)
    per_fit = cfg.n_estimators * cfg.max_depth
    check(launches[counter] == per_fit, f"one {counter} launch per tree level: {launches}")
    warm = [fit_timed(Xd, yd, cfg, dev)[2] for _ in range(3)]
    p_fit = tree.predict_proba1(params, Xd).cpu().numpy()
    auc = roc_auc(yf, p_fit)
    plain_cfg = dataclasses.replace(cfg, histogram_backend="xla")
    plain, plain_aux, plain_s = fit_timed(Xd, yd, plain_cfg, dev)
    auc_plain = roc_auc(yf, tree.predict_proba1(plain, Xd).cpu().numpy())
    dk = torch.as_tensor(aux["train_deviance"]).double().cpu()
    dp = torch.as_tensor(plain_aux["train_deviance"]).double().cpu()
    dev_rel = ((dk - dp).abs() / dp.abs()).max().item()
    check(bool(torch.isfinite(dk).all()) and dk.shape == (cfg.n_estimators,), "finite deviance path")
    check(float(dk[-1]) < float(dk[0]), "deviance falls over the fit")
    check(dev_rel <= 1e-4, f"deviance paths agree at rtol 1e-4: {dev_rel}")
    check(abs(auc - auc_plain) <= 0.005, f"AUC within 0.005 of the plain fit: {auc} {auc_plain}")
    nn = 2 ** (cfg.max_depth + 1) - 1
    check(params.feature.shape == (cfg.n_estimators, nn) and params.value.dtype == torch.float32,
          "forest shape and dtype")
    prof = profile_call(lambda: fit_timed(Xd, yd, cfg, dev)[2])
    split_agree = float((params.feature == plain.feature).float().mean())
    out = {"rows": int(Xd.shape[0]), "features": int(Xd.shape[1]),
           "n_estimators": cfg.n_estimators, "max_depth": cfg.max_depth, "n_bins": cfg.n_bins,
           "launches": launches, "cold_fit_s": cold, "warm_fit_s": statistics.median(warm),
           "warm_fit_runs_s": warm, "plain_fit_s": plain_s, "auc": auc, "auc_plain": auc_plain,
           "deviance_first_last": [float(dk[0]), float(dk[-1])], "deviance_max_rel_diff": dev_rel,
           "split_feature_agreement": split_agree, "profile_warm_fit": prof}
    return out, params, launches


def phase_train(X17, yf, dev) -> tuple:
    cfg = GBDTConfig(splitter="hist", n_estimators=100)
    check(gbdt.uses_fused_hist1(cfg, X17.shape[0]), "the fit takes the fused path")
    out, params, launches = fit_vs_plain(X17, yf, cfg, dev, "stump_histograms")
    emit({"phase": "train", **out})
    return params, launches


def phase_train_depth(X17, yf, dev) -> dict:
    cfg = GBDTConfig(splitter="hist", max_depth=3, n_estimators=100, n_bins=256)
    check(X17.shape[0] >= gbdt.DEVICE_BINNING_MIN_ROWS, "the fit bins on the device")
    out, _, launches = fit_vs_plain(X17, yf, cfg, dev, "node_histograms")
    emit({"phase": "train_depth", **out})
    return launches


def phase_sweep(rows: int, seed: int, dev) -> dict:
    """``bench.py`` config 4: the 5-fold CV sweep on a ``rows``-row cohort,
    through the node kernel and through its plain version."""
    X, y, _ = make_cohort(n=rows, seed=seed)
    X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
    yf = np.asarray(y, dtype=np.float32)
    scfg = SweepConfig(n_estimators_grid=(25, 50, 100), max_depth_grid=(1, 2, 3), cv_folds=5)
    kernel_base, plain_base = GBDTConfig(), GBDTConfig(histogram_backend="xla")

    def run(base):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.cv_sweep(X17, yf, scfg, base, device=dev)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # The main path's run (counts from 0, read right after), then the plain
    # sweep and a warm kernel sweep in turn, then a profile of one more.
    cuda_histogram.reset_launch_counts()
    rk, sk = run(kernel_base)
    launches = dict(cuda_histogram.LAUNCHES)
    cuda_histogram.reset_launch_counts()
    rp, sp = run(plain_base)
    lp = dict(cuda_histogram.LAUNCHES)
    sk_warm = run(kernel_base)[1]
    prof = profile_call(lambda: run(kernel_base)[1])
    levels = max(scfg.n_estimators_grid) * sum(scfg.max_depth_grid)
    check(launches["node_histograms"] == levels,
          f"one node-kernel launch per tree level of all folds: {launches}")
    check(lp["node_histograms"] == 0, f"the plain sweep launches no kernel: {lp}")
    diff = float(np.abs(rk.mean_auc - rp.mean_auc).max())
    check(bool(np.isfinite(rk.fold_auc).all()) and rk.fold_auc.shape == (3, 3, 5),
          "finite [depth, n_estimators, fold] AUC grid")
    check(diff <= 0.005, f"mean-AUC grids within 0.005: {diff}")
    emit({"phase": "sweep", "rows": rows, "features": 17, "folds": scfg.cv_folds,
          "n_estimators_grid": list(scfg.n_estimators_grid),
          "max_depth_grid": list(scfg.max_depth_grid), "launches": launches,
          "seconds": sk, "warm_seconds": sk_warm, "plain_seconds": sp,
          "mean_auc": rk.mean_auc.tolist(),
          "mean_auc_plain": rp.mean_auc.tolist(), "mean_auc_max_abs_diff": diff,
          "best": [rk.best_max_depth, rk.best_n_estimators, rk.best_mean_auc],
          "best_plain": [rp.best_max_depth, rp.best_n_estimators, rp.best_mean_auc],
          "profile_warm_sweep": prof})
    return launches


def serving_params(gbdt_params, X17: np.ndarray, seed: int) -> stacking.StackingParams:
    """Seeded members at the reference's shapes around the fitted forest:
    713 support vectors drawn from scaled cohort rows, gamma = 1/(17 var)
    (sklearn's 'scale'), coefficients of the cohort's order of magnitude."""
    rng = np.random.default_rng(seed)
    dev = gbdt_params.value.device
    mean, std = X17.mean(axis=0), X17.std(axis=0)
    std = np.where(std > 0, std, 1.0)
    sv = (X17[rng.choice(X17.shape[0], 713, replace=False)] - mean) / std
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return stacking.StackingParams(
        scaler=scaler.ScalerParams(mean=f32(mean), scale=f32(std)),
        svc=svm.SVCParams(
            support_vectors=f32(sv),
            dual_coef=f32(rng.choice([-1.0, 1.0], 713) * rng.uniform(0.05, 1.0, 713)),
            intercept=f32(rng.normal(0.0, 0.5)), gamma=f32(1.0 / (17 * sv.var())),
            prob_a=f32(-1.7), prob_b=f32(0.1)),
        gbdt=gbdt_params,
        logreg=linear.LinearParams(coef=f32(rng.normal(0.0, 0.3, 17)), intercept=f32(-1.4)),
        meta=linear.LinearParams(coef=f32([2.0, 3.0, 1.5]), intercept=f32(-3.2)),
    )


def phase_serve(gbdt_params, X17, seed, dev) -> dict:
    params = serving_params(gbdt_params, X17, seed)
    params_cpu = convert.params_to(params, "cpu")
    rng = np.random.default_rng(seed + 2)
    out = {"phase": "serve", "batches": []}
    cuda_histogram.reset_launch_counts()
    for rows, reps in ((64, 50), (100_000, 10)):
        Xb = np.ascontiguousarray(X17[rng.choice(X17.shape[0], rows, replace=False)])
        lat = []
        for _ in range(reps + 3):
            t0 = time.perf_counter()
            p = stacking.predict_proba(params, Xb, device=dev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        p_cpu = stacking.predict_proba(params_cpu, Xb, device="cpu")
        p = p.cpu()
        check(p.shape == (rows, 2) and bool(torch.isfinite(p).all()), "finite [n, 2] output")
        check(bool(torch.allclose(p.sum(dim=1), torch.ones(rows), atol=1e-6)), "rows sum to 1")
        err = (p.double() - p_cpu.double()).abs()
        ok = bool((err <= 1e-8 + 1e-5 * p_cpu.double().abs()).all())
        check(ok, f"GPU equals CPU at (1e-5, 1e-8) for {rows} rows: max abs err {err.max()}")
        out["batches"].append({"rows": rows, "latency_ms_median": statistics.median(lat[3:]) * 1e3,
                               "latency_ms_runs": [t * 1e3 for t in lat[3:]],
                               "max_abs_err_vs_cpu": err.max().item(),
                               "p1_mean": float(p[:, 1].mean())})
    out["launches"] = dict(cuda_histogram.LAUNCHES)
    emit(out)
    return out["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000, help="cohort rows for the fits")
    ap.add_argument("--sweep-rows", type=int, default=50_000,
                    help="cohort rows for the CV sweep (bench.py config 4's default)")
    ap.add_argument("--seed", type=int, default=2020, help="seed of the cohort and parameters")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    info = phase_device()
    peaks = PEAKS[info["peaks"]]
    phase_build()

    X, y, _ = make_cohort(n=args.rows, seed=args.seed)
    X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
    yf = np.asarray(y, dtype=np.float32)
    del X, y
    binned, g, h = stage_inputs(X17, yf, args.seed, dev)
    kern = {"stump_histograms": phase_kernels(binned, g, h, peaks, args.seed, dev),
            "node_histograms": phase_node_kernels(binned, g, h, peaks, args.seed, dev)}
    del binned, g, h
    torch.cuda.empty_cache()

    # The main path, one phase at a time: counts from 0 before, read after.
    gbdt_params, train_launches = phase_train(X17, yf, dev)
    depth_launches = phase_train_depth(X17, yf, dev)
    torch.cuda.empty_cache()
    sweep_launches = phase_sweep(args.sweep_rows, args.seed, dev)
    serve_launches = phase_serve(gbdt_params, X17, args.seed, dev)
    launches = {name: sum(run[name] for run in (train_launches, depth_launches,
                                                 sweep_launches, serve_launches))
                for name in kern}
    for name, count in launches.items():
        check(count > 0, f"the main path launched the {name} kernel")

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNELS[name], "launches": launches[name],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for name, k in kern.items()]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

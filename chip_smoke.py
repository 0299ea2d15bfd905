#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds, is right and runs on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--rows N] [--seed S] [--node-levels]

It drives the port's main path (``machine_learning_replications_tpu_torch``,
never JAX) through the entry points a user calls, and prints one JSON line
per phase:

  device   the card (``nvidia-smi`` name and power limit), torch and CUDA;
  build    ``nvcc`` builds the hand-written histogram kernel from the
           sources in the checkout;
  kernels  each entry of the kernel (the fused fit's stump histograms, the
           grower's node histograms and leaf sums, the general entry)
           against its plain PyTorch version on the same inputs at the
           fits' shapes and at edge shapes (tiled shared memory, fold axes with aligned and
           unaligned strides, the warp aggregation's best and worst bin
           patterns, ragged row counts, int32 bins, float64, all rows
           inactive), node counts exactly; with its time on the cohort's
           bins and on uniform bins (the contention probe), the plain
           version's, one ``index_add_`` call's, and the bound;
  node_levels  the node entry at each level of one depth-8 tree on the
           HIGGS configuration's 10.5M x 28 rows, of one depth-3 tree on
           10M x 17 cohort rows and of the 5-fold fits (K = 2, 4; 50,000
           rows in float32, 713 in float64), through the walk ``node_plan``
           takes and through the tiled walk, against the plain version, timed
           beside the partition alone, the plain version and the bound
           (``--node-levels`` runs this phase alone, after device and build);
  train    ``gbdt.fit`` of the reference GBDT member (100 depth-1 stumps,
           256 hist bins) on ``--rows`` x 17 synthetic-cohort rows through
           the kernel, against the same fit through the plain version
           (deviance paths at rtol 1e-4, train AUC within 0.005), plus a
           profiler breakdown of one warm fit;
  train_depth  the same fit at ``max_depth=3`` (device binning, then the
           level-wise grower, then the node kernel: one launch per level),
           held to its plain-version fit the same way, with a profile;
  fit_exact  ``gbdt.fit(X17, y, GBDTConfig())``: the default 'exact'
           splitter at depth 1, 100 stumps, on the reference cohort (1427
           rows) and on config 4's 50,000 rows, every unique-value midpoint a
           candidate, so the stump kernel takes int32 bins with B up to
           n (and, at 50,000 rows, cuts each feature's cells into ranges); held to the plain-version fit (forests equal but for a
           tie, deviance at rtol 1e-4, AUC within 0.005), with a profile;
  sweep    ``sweep.cv_sweep`` at ``bench.py`` config 4's shape (5-fold CV
           over n_estimators (25, 50, 100) x max_depth (1, 2, 3) on
           ``--sweep-rows`` cohort rows), through the kernel and through the
           plain version, mean-AUC grids within 0.005;
  serve    ``stacking.predict_proba`` with the depth-1 forest as the GBDT
           member and seeded scaler/SVC/LR/meta parameters, on the card and
           on the CPU, at (1e-5, 1e-8);
  predict  the reference's ``predict`` route: a full-pipeline model (the
           1-NN imputer over all 64 variables, the serve phase's ensemble)
           saved and loaded as a port checkpoint, ``cli predict --model`` in
           a subprocess on the card against the CPU port's line, and
           ``pipeline_predict_proba1_contract`` on [1, 17] and [100000, 17]
           contract rows, card against CPU, donors included;
  serve_http  serving on the card (``serve/``): the bucketed engine of the
           serve phase's ensemble and of the predict phase's full pipeline,
           one CUDA graph per bucket of ``DEFAULT_BUCKETS`` (warmup seconds,
           exactly one capture per bucket by ``trace_counts`` and
           ``torch_graph_captures_total``, every lane of every bucket equal
           to the eager oracle on the card and to the CPU port, latency per
           bucket beside the eager routes); then ``make_server(...,
           device=dev)`` on a free port: 200 sequential requests pinned to
           the device path, 200 on the host path, a closed-loop burst of 32
           keep-alive clients x 50 (every reply equal to its version's
           oracle, none but 200, the breaker closed), ``/admin/deploy`` of
           the pipeline checkpoint during a second burst (the version flips,
           the new engine captures while the old one replays), a fault drill
           (``engine.compute:raise@count=3`` through ``/debug/faults``: three
           500s, 503 + Retry-After, recovery on 7 fresh captures with the
           same answer) and ``cli serve --model`` in a subprocess (ready,
           one reply equal to ``cli predict``'s line, SIGTERM, exit 0);
  score    bulk scoring with the predict phase's full-pipeline checkpoint:
           ``cli score`` in a subprocess on a 250,000-row contract JSONL
           cohort with 10 malformed lines (2048-row chunks, prefetch 4, 2
           parse threads: rows/s, wall and stage seconds, 10 quarantined,
           ``score_done`` journaled); in-process on the first 50,000 lines:
           sequential = overlapped bytes, a run killed after 10 chunks
           resumes to the same bytes, every chunk's ``p1`` bit-equal to the
           eager ``pipeline_predict_proba1_contract`` on its padded chunk,
           the run equal to the eager whole-cohort call at
           ``parity_tolerance`` and to the CPU port at (1e-5, 1e-8), a second
           run captures no graph and builds no kernel, one run profiled
           (card busy, idle share, H2D bytes); ``cli score --mesh 2
           --distributed`` as two gloo ranks sharing the card on the first
           20,000 lines (512-row chunks: ``p1`` within ``parity_tolerance``
           of one process's run, the same quarantine, a pair SIGKILLed after
           3 committed chunks resuming to the uninterrupted pair's bytes,
           rank 1's ``--out`` untouched); then 20,000 ``.mat`` rows, read by
           the native MAT-v5 reader (equal to scipy's matrix) and through
           ``cli score`` against the eager call, and the bare ensemble
           quarantining the same rows' NaN contract values;
  learn    continual learning's offline half from the same live checkpoint:
           1427 captured rows (another seed, Max_Wall_Thick + 4) through
           ``cli learn retrain`` (journal start then done, a PipelineParams
           candidate at version >= 1) and ``cli learn shadow --out`` (a
           strict-JSON verdict with JAX's fields), the candidate's replay on
           the card against the CPU port at (1e-5, 1e-8), and an in-process
           ``warm_refit`` timed with its stage seconds;
  fleet    the fleet on the card, every process a subprocess of the port's
           CLI: ``fleet router --capture`` (owning no CUDA context),
           ``fleet autoscale --min 2 --max 3`` spawning two replicas on the
           card (seconds to ready; the ready deadline set from the
           serve_http phase's measured ``cli serve`` cold start), one
           ``serve --workers 2 --register`` replica (each worker owns a CUDA
           context, the parent none); a 32-client x 50 burst of shifted
           patients through the router (0 non-200, every reply equal to its
           version's oracle on the card and the CPU port, every replica
           serving; requests/s, p50, p99 with three, one and two replicas in
           rotation and straight at one replica; card memory); SIGKILL of an
           autoscaled replica under a burst (0 non-200, respawned, back in
           rotation); ``learn run`` on the router's capture with stated
           gates rolling v2 out under a 16-client burst (promoted with its
           AOT bundle, every replica at v2 restored from it with 0
           fallbacks, replies equal to v2's oracles, both kernel entries
           launched, per-replica deploy seconds); ``fleet status`` and
           ``learn status`` as strict JSON; SIGTERM to everything (exit 0,
           every replica deregistered, peak card memory per process);
  aot      AOT executable bundles (``persist/aot.py``) on the fleet's v2, the
           script's one publish (``learn run``'s promotion, from an empty
           Inductor cache: export seconds per backend, package bytes): ``cli
           serve --model`` restores all 7 device and 2 host buckets (every
           ``serve_aot_fallback_total`` series 0, no capture, every reply on
           both paths equal to the card's eager oracle at
           ``parity_tolerance``, to the CPU port at (1e-5, 1e-8) and to ``cli
           predict``'s line); the same with ``--no-aot`` and with
           ``--inject persist.aot_restore:corrupt`` (all 9 buckets fall back
           with ``deserialize_error``, journaled and counted, and capture);
           each cold start to ``/readyz``; ``engine.predict`` ms and one
           call's card time per bucket, restored against captured;
  train_pipeline  the reference's ``train`` route: ``fit_pipeline`` (1-NN
           impute, LassoCV top-17, the stacking fit with its 5-fold CV, the
           quality profile) on the CLI's 713 + 713 cohort halves, float64,
           cold and warm with stage seconds (one warm fit under a span
           tracer: its ``stage:*`` spans against ``stage_seconds``) and the
           SVC solves' steps, held to the CPU port's fit;
           ``cli train --trace-dir --journal`` then ``cli predict`` in
           subprocesses on the card (the journal: manifest first with the
           card's name, at least 6 ``stage_start``, ``run_done`` last with
           graph captures and the in-process fit's kernel launches; the
           trace: every ``stage:*`` span inside ``train``); and the scaled
           fit on 50,000 develop rows, float32 (the SVC subsample regime at
           2,048 rows, the exact member at B ≈ n, the fold fits over every
           row);
  cli      ``cli sweep --synthetic 50000 --save DIR`` in-process on the
           default grid, (25, 50, 100, 200) x (1, 2, 3) x 5 folds, on the
           imputed develop half of ``make_cohort(100000, missing_rate=0.03)``
           (float64, as the CLI hands it over): its printed grid within 0.005
           of ``cv_sweep`` through the plain version on the same imputed
           rows, its ``best:`` cell within 0.005 of the best; ``cli predict
           --model DIR`` in a subprocess against the saved forest's line;
           then ``cli import-sklearn`` of the committed sklearn-layout
           fixture, ``cli predict --model`` on the import and ``cli predict
           --pkl`` on the fixture, each a subprocess on the card, all three
           lines equal to the CPU port's, and the imported ensemble's
           ``[64, 17]`` probabilities card against CPU at (1e-5, 1e-8);
  distributed  the data-parallel paths (``parallel/``): a one-rank NCCL world
           in this process, ``fit_gbdt_sharded`` on the train phase's rows
           (100 stumps through the stump trainer, 100 depth-3 trees through
           the level-wise trainer; cold, warm, the all-reduces per fit and
           their seconds by CUDA events) against the single-device fits
           (forests equal but for a tie at depth 1, deviance at rtol 1e-4,
           AUC within 0.005); then two ranks sharing the card on gloo as CLI
           subprocesses with torch's launcher variables: ``train --synthetic
           1426 --mesh 2 --distributed`` (AUC line equal to one process's
           ``cli train``, each rank holding the card, rank 1 writing
           nothing into its ``--save``), the same with a depth-2 member
           on one shared ``--resume-dir`` (every stage written once, by
           rank 0; each rank's two ``run_done`` with its peak memory and, between
           them, both kernels' launches: under a mesh a depth-1 member's
           fold fits take the stump trainer, as in JAX) and ``sweep
           --synthetic 50000 --mesh 2 --distributed`` on the default grid's
           first two stage counts and depths (grid within 0.005 of the same
           cells of the cli phase's in-process grid);
  dryrun   the dry run and the flagship entry (``graft_entry``):
           ``dryrun_multichip(4)``, four ranks sharing the card as a (2, 2)
           mesh on gloo running JAX's ten dry-run phases in float32 (sharded
           stump and level-wise fits, the row-sharded eval, the replicated member fits, the sharded
           imputer and CV folds, LassoCV, the sweep, ``fit_pipeline``), each
           rank's results held to rank 0's and rank 0's to the single-device
           fits on the plain histograms: ten timed phase lines per rank,
           every rank declaring gloo, holding the card and launching both
           kernel entries; both entries at the ranks' shapes against their
           plain versions; then
           ``entry()``'s forward on the card against the CPU port's.

The kernel phase also checks and times the stump entry at the exact
splitter's shapes: int32 bins, B = the cohort's unique values per column
(1427 at 1427 rows, 49,861 at 50,000), and both entries at the shapes the
``train`` route gives them (the member's at 713 rows; the 5 fold fits' root
level at 713 and 50,000 rows), and both entries at a rank's shape in a
two-rank world (500,000 rows of the cohort's u8 bins; the node entry at
depth 3's last level).

Launch counts are set to 0 just before each of train, train_depth,
fit_exact, sweep, serve, predict, serve_http, score, learn (its in-process
``warm_refit``), fleet, aot, cli (its in-process ``cli sweep``), distributed (each
one-rank fit), dryrun (each rank, and ``entry()``'s fit) and
train_pipeline (its reference-size fit and its scaled fit) and read just
after; each kernel entry must have launched on that
path, and none on the predict, serve_http, aot and score paths. The fleet
phase's launches are those its ``learn run`` subprocess journals in
``run_done`` (its replicas journal none, and the script's own process
launches nothing there); the distributed phase adds those its two
``train`` ranks journal, the dryrun phase those its four ranks report
(and its flagship fit's in this process).

Then the kernel table ``{"kernels": [...]}``, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result; without CUDA it stops at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from machine_learning_replications_tpu_torch import convert
from machine_learning_replications_tpu_torch.config import GBDTConfig, SweepConfig
from machine_learning_replications_tpu_torch.data import make_cohort, save_data, selected_indices
from machine_learning_replications_tpu_torch.device import holds_card
from machine_learning_replications_tpu_torch.envsafe import clean_env, free_port, rank_env
from machine_learning_replications_tpu_torch.models import (
    gbdt, knn_impute, linear, pipeline, scaler, stacking, svm, sweep, tree,
)
from machine_learning_replications_tpu_torch.obs import spans
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
# Develop rows of the scaled fit_pipeline: bench.py config 4's 50,000; its
# SVC subsample (the member's and the stacking CV's), cut from the default
# 8,192 to keep the script inside its time limit (the float32 dual runs its
# 20,000 steps at either size).
SCALED_ROWS = 50_000
SCALED_SVC_ROWS = 2_048
# The predict phase holds the card's 100,000-row batch to the CPU port on
# its first rows only (the CPU's imputer over 100,000 rows, twice, cost half
# the phase).
PREDICT_CPU_ROWS = 20_000
# Bulk scoring: the headline cohort (half the JAX package's own score bench
# size of 1,000,000, to keep the script well inside its time limit on a slow
# host), the prefix the in-process gates run on, the .mat route's rows, and
# the captured rows of the learn phase (the reference cohort's size).
SCORE_ROWS = 250_000
SCORE_GATE_ROWS = 50_000
SCORE_MAT_ROWS = 20_000
SCORE_BAD_LINES = 10
CAPTURE_ROWS = 1427
# The fleet phase: one burst's patients (32 clients x 50), the stated shadow
# gates its `learn run` promotes under (the defaults' mean divergence 0.15
# and score PSI 2 refuse the seeded refit, which moves the scores far from
# the live model's; p95 0.35 sits at its edge; the other gates stay at their
# defaults), and a debounce that
# holds the autoscaler's load decisions off (its spawn, ready deadline and
# crash respawn are what the phase drives; the policy is held on the CPU).
FLEET_PATIENTS = 1600
FLEET_GATES = ["--max-divergence-mean", "0.5", "--max-divergence-p95", "0.6",
               "--max-score-psi", "50"]
HOLD_POLLS = 1_000_000
SHAPE_KEYS = ("shape", "n", "F", "K", "folds", "B", "bins", "vals", "launches_per_fit_pipeline",
              "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "row_passes", "tiled_ms", "partition_ms")


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
    """The fused fit's histogram inputs: the u8 device-quantile bin matrix of
    the cohort and a mid-fit (g, h)."""
    Xd = torch.as_tensor(X17, device=dev)
    binned, _, nan_flag = binning.device_binning_core(Xd, 256)
    check(not bool(nan_flag), "cohort has no NaN")
    return binned.to(torch.uint8), *mid_fit_stats(y, seed, dev)


def mid_fit_stats(y: np.ndarray, seed: int, dev: torch.device):
    """A mid-fit (g, h) = (y - p, p(1 - p)) in float32, from prior log-odds
    scores spread by seeded noise."""
    rng = np.random.default_rng(seed)
    raw = np.log(y.mean() / (1 - y.mean())) + rng.normal(0.0, 0.7, size=y.shape[0])
    p = 1.0 / (1.0 + np.exp(-raw))
    return (torch.as_tensor((y - p).astype(np.float32), device=dev),
            torch.as_tensor((p * (1 - p)).astype(np.float32), device=dev))


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
    timing = {**time_stump(binned, g, h, B, flush, peaks),
              "uniform_bins_ms": timed_ms(
                  lambda: cuda_histogram.stump_histograms_cuda(uniform, g, h, B), flush)}
    del flush, uniform
    emit({"phase": "kernels", "kernel": "stump_histograms", "checks": checks, **timing})
    return {"max_abs_err": checks[0]["max_abs_err"], **timing}


def time_stump(binned, g, h, B: int, flush, peaks: dict) -> dict:
    """The stump kernel's time per call on these inputs (cold L2), its plain
    version's, one ``index_add_`` computing the same sums, and the bound:
    each input read once and the ``[2, F, B]`` output written once over HBM,
    n*F*2 additions over the statistics' float rate."""
    n, F = binned.shape
    ids = (torch.arange(F, device=binned.device)[None, :] * B + binned.long()).reshape(-1)
    src = torch.stack([g, h], dim=1)[:, None, :].expand(n, F, 2).reshape(n * F, 2).contiguous()
    lib_out = torch.zeros(F * B, 2, dtype=g.dtype, device=binned.device)
    out = {"ms": timed_ms(lambda: cuda_histogram.stump_histograms_cuda(binned, g, h, B), flush),
           "plain_ms": timed_ms(lambda: histogram.stump_histograms_reference(binned, g, h, B),
                                flush),
           "library_ms": timed_ms(lambda: lib_out.index_add_(0, ids, src), flush),
           **bound(n * F * binned.element_size() + 2 * n * g.element_size()
                   + 2 * F * B * g.element_size(), 2 * n * F, peaks,
                   str(g.dtype).replace("torch.", "")),
           "reps": 30, "l2": "flushed before each call"}
    return out


def exact_inputs(rows: int, seed: int, dev: torch.device):
    """The exact splitter's histogram inputs at ``rows`` cohort rows: the
    int32 bins of every unique-value midpoint of the 17 selected variables
    (``binning.bin_features(X, None)``, as ``gbdt.fit`` bins them), a mid-fit
    (g, h) and the bin count B."""
    X, y, _ = make_cohort(n=rows, seed=seed)
    X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
    bins = binning.bin_features(X17, None)
    return (torch.as_tensor(bins.binned, device=dev), *mid_fit_stats(y, seed + 5, dev),
            bins.max_bins)


def phase_exact_kernels(peaks: dict, seed: int, dev: torch.device) -> list:
    """``stump_histograms_cuda`` at the exact splitter's shapes: int32 bins
    with B = the unique-value midpoints + 1 of the reference cohort (1427
    rows, one tile) and of config 4's 50,000 rows (one feature's cells cut
    into ranges), float32 and float64, against the plain version with
    ``compare``'s mass-scaled tolerance; then timed (float32)."""
    shapes = []
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    for rows in (1427, 50_000):
        binned, g, h, B = exact_inputs(rows, seed, dev)
        n, F = binned.shape
        check(binned.dtype == torch.int32 and B > 256, f"exact bins are int32 past 256: {B}")
        checks = []
        for gg, hh in ((g, h), (g.double(), h.double())):
            got = cuda_histogram.stump_histograms_cuda(binned, gg, hh, B)
            want = histogram.stump_histograms_reference(binned, gg, hh, B)
            mass = histogram.stump_histograms_reference(binned, gg.abs(), hh.abs(), B)
            torch.cuda.synchronize()
            res = {"vals": str(gg.dtype).replace("torch.", ""), **compare(got, want, mass, gg.dtype)}
            checks.append(res)
            check(res["ok"], f"stump kernel vs plain at exact bins n={n} B={B}: {res}")
        plan = cuda_histogram.tile_plan(F, 2, B, 4, cuda_histogram.smem_budget(dev),
                                        (F * 4, 4, 4))
        shapes.append({"n": n, "F": F, "B": B, "bins": "int32", "plan": plan,
                       "tiles": -(-F // plan[0]) * -(-B // plan[1]), "checks": checks,
                       "max_abs_err": checks[0]["max_abs_err"],
                       **time_stump(binned, g, h, B, flush, peaks)})
    del flush
    emit({"phase": "kernels", "kernel": "stump_histograms", "shapes": "exact", "exact": shapes})
    return shapes


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
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    uniform = pattern_bins("uniform", rng, n, F, B, dev)
    timing = {**time_node(binned, node4, g, h, 4, B, flush, peaks),
              "uniform_bins_ms": timed_ms(
                  lambda: cuda_histogram.node_histograms_cuda(uniform, node4, g, h, 4, B), flush)}
    del flush, uniform
    emit({"phase": "kernels", "kernel": "node_histograms", "checks": checks, **timing})
    worst = max(checks, key=lambda c: c["max_err_over_mass"])
    main = next(c for c in checks if c["shape"] == "fit_level_K4")
    return {"max_abs_err": main["max_abs_err"], "worst_err_over_mass": worst, **timing}


def time_node(binned, node, g, h, K: int, B: int, flush, peaks: dict) -> dict:
    """The node kernel's time per call on these inputs (cold L2), its plain
    version's, one ``index_add_`` computing the same sums, and the bound:
    the wrapper's inputs (u8 bins, int32 nodes, float32 g and h) read once
    and its four ``[K, F, B]`` float32 outputs written once over HBM, 4
    additions per active (row, feature) over the float32 rate."""
    n, F = binned.shape
    dev = binned.device
    active = (node >= 0).float()
    vals = torch.stack([g * active, h * active, g * g * active, active], dim=1)
    ids = ((node.clamp_min(0)[:, None] * F + torch.arange(F, device=dev)[None, :]) * B
           + binned.long()).reshape(-1)
    src = vals[:, None, :].expand(n, F, 4).reshape(n * F, 4).contiguous()
    lib_out = torch.zeros(K * F * B, 4, dtype=torch.float32, device=dev)
    out = {"ms": timed_ms(lambda: cuda_histogram.node_histograms_cuda(binned, node, g, h, K, B),
                          flush),
           "plain_ms": timed_ms(lambda: histogram.node_histograms(binned, node, g, h, K, B), flush,
                                reps=20),
           "library_ms": timed_ms(lambda: lib_out.index_add_(0, ids, src), flush),
           **bound(n * F * binned.element_size() + n * node.element_size() + 2 * n * 4
                   + 4 * K * F * B * 4, 4 * F * int((node >= 0).sum()), peaks, "float32"),
           "reps": 30, "l2": "flushed before each call",
           "timed_shape": {"n": n, "F": F, "K": K, "B": B, "nodes": "int32",
                           "inactive_share": float((node < 0).float().mean())}}
    del src, ids, lib_out
    return out


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

    # The card's activity alone: only its events are read, and a fit whose
    # solver blocks replay as CUDA graphs traces millions of kernels.
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = fn()
    t_stop = time.perf_counter()
    # Summed from the raw trace events: key_averages() would build them into
    # Python event trees for minutes. That reader is not a public torch API,
    # so a run whose trace shows no card event fails here rather than report
    # an idle card.
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    read_s = time.perf_counter() - t_stop
    busy = sum(by_name.values())
    check(busy > 0, f"the profile saw the card's kernels: {len(by_name)} CUDA event names")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "top_kernels_ms": [[k[:80], v] for k, v in top],
            "trace_stop_s": t_stop - t0 - wall, "trace_read_s": read_s}


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
    grown = cfg.n_estimators if cfg.max_depth > 1 else 0
    check(launches["leaf_sums"] == grown, f"one leaf_sums launch per grown tree: {launches}")
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


def stump_gains(binned, thresholds, ys, raw) -> torch.Tensor:
    """The friedman proxy of every (feature, boundary) split at raw scores
    ``raw``, from the plain histograms in float64 (``select_splits``'
    arithmetic, -inf where a side is empty or the boundary is padding)."""
    p = torch.sigmoid(raw.double())
    g = ys.double() - p
    B = thresholds.shape[1] + 1
    hist = histogram.stump_histograms_reference(binned, g, p * (1 - p), B)
    cnt = histogram.stump_histograms_reference(binned, torch.ones_like(g), torch.ones_like(g), B)
    GL = torch.cumsum(hist[0], dim=1)[:, :-1]
    CL = torch.cumsum(cnt[0], dim=1)[:, :-1]
    n = float(binned.shape[0])
    GR, CR = g.sum() - GL, n - CL
    diff = GL / CL.clamp_min(1) - GR / CR.clamp_min(1)
    ok = (CL >= 1) & (CR >= 1) & torch.isfinite(thresholds)
    return torch.where(ok, diff * diff * CL * CR, -torch.inf)


def forests_agree(kernel, plain, X17, yf, dev) -> dict:
    """Kernel and plain depth-1 forests hold the same (feature, threshold)
    at every stage, except where the plain fit shows a tie: at the first
    stage where they differ, both splits' gains under the plain fit's own
    scores must agree within 1e-5 relative (float32 sums regroup). Later
    stages follow different scores and are held by the deviance and AUC
    gates only."""
    fk, fp = kernel.feature[:, 0], plain.feature[:, 0]
    tk, tp = kernel.threshold[:, 0], plain.threshold[:, 0]
    same = (fk == fp) & (tk == tp)
    out = {"stages_equal": int(same.sum()), "stages": int(same.numel()),
           "first_divergent_stage": None}
    if bool(same.all()):
        return out
    t = int(torch.nonzero(~same)[0, 0])
    bins = binning.bin_features(X17, None)
    binned = torch.as_tensor(bins.binned, device=dev)
    thresholds = torch.as_tensor(bins.thresholds, dtype=plain.threshold.dtype, device=dev)
    head = dataclasses.replace(plain, **{k: getattr(plain, k)[:t] for k in
                                         ("feature", "threshold", "left", "right", "value")})
    raw = tree.raw_score(head, torch.as_tensor(X17, device=dev))
    gains = stump_gains(binned, thresholds, torch.as_tensor(yf, device=dev), raw)

    def gain(f, thr):
        b = int(torch.searchsorted(thresholds[f].double(), float(thr)))
        return float(gains[f, b])

    gk, gp = gain(int(fk[t]), tk[t]), gain(int(fp[t]), tp[t])
    rel = abs(gk - gp) / max(abs(gp), 1e-300)
    check(rel <= 1e-5, f"kernel and plain forests differ at stage {t} without a tie: "
                       f"gains {gk} vs {gp}")
    out.update(first_divergent_stage=t, tie_gain_rel_gap=rel)
    return out


def phase_fit_exact(seed: int, dev) -> dict:
    """``gbdt.fit(X17, y, GBDTConfig())`` — the reference member as the
    repo defaults it: 'exact', depth 1, 100 stumps — on the reference cohort
    (``make_cohort(1427)``, the reference's width and depth) and on config
    4's 50,000 rows, float32, through the stump kernel at int32 bins (one
    launch per stage), against the same fit through the plain version:
    forests equal but for a tie the plain fit shows, deviance paths at rtol
    1e-4, train AUC within 0.005; with a profile of one warm fit."""
    cfg = GBDTConfig()
    runs = []
    launches = {}
    for rows in (1427, 50_000):
        X, y, _ = make_cohort(n=rows, seed=seed)
        X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
        yf = np.asarray(y, dtype=np.float32)
        check(not gbdt.uses_fused_hist1(cfg, rows), "the exact fit bins on the host")
        cuda_histogram.reset_launch_counts()
        params, aux, cold = fit_timed(X17, yf, cfg, dev)
        run_launches = dict(cuda_histogram.LAUNCHES)
        check(run_launches["stump_histograms"] == cfg.n_estimators,
              f"one stump launch per stage: {run_launches}")
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
        warm = [fit_timed(X17, yf, cfg, dev)[2] for _ in range(3)]
        plain, plain_aux, plain_s = fit_timed(X17, yf, dataclasses.replace(
            cfg, histogram_backend="xla"), dev)
        Xd = torch.as_tensor(X17, device=dev)
        auc = roc_auc(yf, tree.predict_proba1(params, Xd).cpu().numpy())
        auc_plain = roc_auc(yf, tree.predict_proba1(plain, Xd).cpu().numpy())
        dk = torch.as_tensor(aux["train_deviance"]).double()
        dp = torch.as_tensor(plain_aux["train_deviance"]).double()
        dev_rel = ((dk - dp).abs() / dp.abs()).max().item()
        check(isinstance(aux["train_deviance"], np.ndarray) and dk.shape == (cfg.n_estimators,)
              and bool(torch.isfinite(dk).all()), "a finite host deviance path")
        check(float(dk[-1]) < float(dk[0]), "deviance falls over the fit")
        check(dev_rel <= 1e-4, f"deviance paths agree at rtol 1e-4: {dev_rel}")
        check(abs(auc - auc_plain) <= 0.005, f"AUC within 0.005 of the plain fit: {auc} {auc_plain}")
        agree = forests_agree(params, plain, X17, yf, dev)
        prof = profile_call(lambda: fit_timed(X17, yf, cfg, dev)[2])
        runs.append({"rows": rows, "features": 17, "n_estimators": cfg.n_estimators,
                     "splitter": cfg.splitter, "max_bins": binning.bin_features(X17, None).max_bins,
                     "launches": run_launches, "cold_fit_s": cold,
                     "warm_fit_s": statistics.median(warm), "warm_fit_runs_s": warm,
                     "plain_fit_s": plain_s, "auc": auc, "auc_plain": auc_plain,
                     "deviance_first_last": [float(dk[0]), float(dk[-1])],
                     "deviance_max_rel_diff": dev_rel, **agree, "profile_warm_fit": prof})
    emit({"phase": "fit_exact", "runs": runs})
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
        # Each member's share, so that a disagreement names where it arose.
        m_err = (stacking.predict_proba1_with_members(params, Xb, device=dev)[1].cpu().double()
                 - stacking.predict_proba1_with_members(params_cpu, Xb, device="cpu")[1].double()
                 ).abs().amax(dim=0).tolist()
        ok = bool((err <= 1e-8 + 1e-5 * p_cpu.double().abs()).all())
        check(ok, f"GPU equals CPU at (1e-5, 1e-8) for {rows} rows: max abs err {err.max()} "
                  f"(members svc, gbc, lg: {m_err})")
        out["batches"].append({"rows": rows, "latency_ms_median": statistics.median(lat[3:]) * 1e3,
                               "latency_ms_runs": [t * 1e3 for t in lat[3:]],
                               "max_abs_err_vs_cpu": err.max().item(),
                               "member_max_abs_err_vs_cpu": m_err,
                               "p1_mean": float(p[:, 1].mean())})
    out["launches"] = dict(cuda_histogram.LAUNCHES)
    emit(out)
    return out["launches"]


def predict_params(gbdt_params, X17: np.ndarray, seed: int, dev) -> pipeline.PipelineParams:
    """A full-pipeline model at the reference's shapes: the 1-NN imputer
    fitted on ``make_cohort(1427, missing_rate=0.03)`` (all 64 variables,
    donors with NaN, float64), the contract's 17 columns as the support mask,
    and the serve phase's stacked ensemble (float32)."""
    X64, _, _ = make_cohort(n=1427, seed=seed, missing_rate=0.03)
    mask = torch.zeros(64, dtype=torch.bool, device=dev)
    mask[selected_indices()] = True
    return pipeline.PipelineParams(imputer=knn_impute.fit(X64, device=dev), support_mask=mask,
                                   ensemble=serving_params(gbdt_params, X17, seed))


def same_params(a, b) -> bool:
    """Two parameter trees hold equal tensors (on any devices, NaN equal to
    NaN) and statics."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(same_params(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, torch.Tensor):
        a, b = a.cpu(), b.cpu()
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            ((a == b) | ((a != a) & (b != b))).all())   # NaN donors equal NaN
    return a == b


def phase_predict(gbdt_params, X17: np.ndarray, seed: int, dev) -> dict:
    """The reference's ``predict`` route through a full-pipeline checkpoint:
    save and load it (``persist/checkpoint.py``), ``cli predict --model`` on
    the example patient in a subprocess on the card against the CPU port's
    line, ``pipeline_predict_proba1_contract`` on ``[1, 17]`` and
    ``[100000, 17]`` contract rows on the card against the CPU port at
    (1e-5, 1e-8) (the large batch on its first ``PREDICT_CPU_ROWS``), and the
    imputer's donors card vs CPU on the same rows (equal, or tied within
    1e-12 relative). No hand kernel lies on this path: the launch
    counts must stay 0."""
    import tempfile

    from machine_learning_replications_tpu_torch.persist import checkpoint

    cuda_histogram.reset_launch_counts()
    params = predict_params(gbdt_params, X17, seed, dev)
    out = {"phase": "predict", "hand_kernels": "none on this path (imputer distances and the "
           "RBF kernel are torch.matmul; the rest are torch ops)"}
    scratch = cuda_histogram.BUILD_DIR.parent     # git-ignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = f"{tmp}/model"
        t0 = time.perf_counter()
        version = checkpoint.save_model(path, params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = checkpoint.load_model(path, device=dev)
        load_s = time.perf_counter() - t0
        check(same_params(params, loaded), "the checkpoint loads back equal tensors")
        proc, cli_s = run_cli(["predict", "--model", path], timeout=300)
    params_cpu = convert.params_to(params, "cpu")
    cpu_line = cli_line(params_cpu, torch.device("cpu"))
    card_line = proc.stdout.strip().splitlines()[-1]
    check(card_line == cpu_line, f"cli predict on the card {card_line!r} vs the CPU port {cpu_line!r}")
    out.update(checkpoint_version=version, save_s=save_s, load_s=load_s, cli_subprocess_s=cli_s,
               cli_line=card_line, cli_line_cpu=cpu_line)

    rng = np.random.default_rng(seed + 6)
    block = pipeline.resolve_contract_block_fn(params)
    out["batches"] = []
    for rows, reps in ((1, 30), (100_000, 5)):
        Xc = np.asarray(X17[rng.choice(X17.shape[0], rows, replace=False)], np.float64)
        lat = []
        for _ in range(reps + 2):
            t0 = time.perf_counter()
            p = pipeline.pipeline_predict_proba1_contract(params, Xc, device=dev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        held = min(rows, PREDICT_CPU_ROWS)
        t0 = time.perf_counter()
        p_cpu = pipeline.pipeline_predict_proba1_contract(params_cpu, Xc[:held],
                                                          device="cpu").double()
        cpu_s = time.perf_counter() - t0
        p = p.cpu().double()
        check(p.shape == (rows,) and bool(torch.isfinite(p).all()), "finite [n] probabilities")
        err = (p[:held] - p_cpu).abs()
        check(bool((err <= 1e-8 + 1e-5 * p_cpu.abs()).all()),
              f"card equals CPU at (1e-5, 1e-8) for {held} rows: max abs err {err.max()}")
        # The donors: equal, or equally near under the CPU's distances.
        x64 = pipeline.contract_rows_to_x64(params, Xc[:held])
        differ, worst = 0, 0.0
        for s0 in range(0, held, 8192):
            xq = torch.as_tensor(x64[s0:s0 + 8192])
            idx, ok = block.donors(params.imputer, xq.to(dev))
            idx_c, ok_c = block.donors(params_cpu.imputer, xq)
            idx, ok = idx.cpu(), ok.cpu()
            check(torch.equal(ok, ok_c), "the same rows find a donor on the card and the CPU")
            bad = (idx != idx_c) & ok_c
            if bool(bad.any()):
                D = block.distances(params_cpu.imputer, xq)
                r = torch.nonzero(bad)[:, 0]
                dk, dc = D[r, idx[bad]], D[r, idx_c[bad]]
                gap = ((dk - dc).abs() / dc.abs().clamp_min(1e-300)).max().item()
                check(gap <= 1e-12, f"donors differ without a tie: relative gap {gap}")
                worst = max(worst, gap)
                differ += int(bad.any(dim=1).sum())
        out["batches"].append({"rows": rows, "latency_ms_median": statistics.median(lat[2:]) * 1e3,
                               "latency_ms_runs": [t * 1e3 for t in lat[2:]],
                               "cpu_port_s": cpu_s, "cpu_held_rows": held,
                               "max_abs_err_vs_cpu": err.max().item(),
                               "rows_with_other_donor": differ, "donor_tie_rel_gap": worst,
                               "p1_mean": float(p.mean())})
    out["launches"] = dict(cuda_histogram.LAUNCHES)
    check(not any(out["launches"].values()), f"no hand kernel on the predict path: {out['launches']}")
    emit(out)
    return out["launches"]


def median_ms(fn, reps: int = 20, warm: int = 3) -> tuple:
    """``(median ms, all ms)`` of ``reps`` calls of ``fn`` (host clock, each
    call ending in a card synchronize), after ``warm`` untimed calls."""
    runs = []
    for i in range(warm + reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs), runs


def replay_ms(eng, b: int, reps: int = 20) -> float:
    """Median card time of one replay of bucket ``b``'s graph, by CUDA events
    on the engine's stream (its copies and the host excluded). Reaches into
    the engine's captures: a measurement, not a serving path."""
    g, times = eng._graphs[b], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with eng._lock, torch.cuda.stream(eng._stream):
            start.record()
            g.graph.replay()
            end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def quantile(xs: list, q: float) -> float:
    return float(np.quantile(np.asarray(xs, np.float64), q))


class Client:
    """One keep-alive HTTP/1.1 connection (``http.client``)."""

    def __init__(self, port: int, timeout: float = 60) -> None:
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def call(self, method: str, path: str, body=None, headers=None) -> tuple:
        """``(status, parsed JSON, headers, seconds)``."""
        data = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": "application/json", **(headers or {})})
        resp = self.conn.getresponse()
        raw = resp.read()
        seconds = time.perf_counter() - t0
        if resp.getheader("Connection", "").lower() == "close":
            self.conn.close()
        return resp.status, json.loads(raw or b"{}"), dict(resp.getheaders()), seconds

    def close(self) -> None:
        self.conn.close()


def burst(port: int, patients: list, clients: int, per_client: int, headers=None,
          during=None) -> dict:
    """A closed loop of ``clients`` keep-alive clients, each sending
    ``per_client`` ``/predict`` requests back to back (patient ``i`` of the
    pool in turn). ``during`` runs on the main thread once the clients
    started; with it, each client keeps sending until ``during`` returned
    and then ``per_client // 4`` more, so the traffic spans it. Returns every
    reply ``(patient index, status, body, headers, seconds)``, the wall
    seconds and what ``during`` returned."""
    import threading

    replies, lock, done = [], threading.Lock(), threading.Event()
    if during is None:
        done.set()

    def run(c):
        cl = Client(port)
        k, after = 0, 0 if during is not None else per_client
        try:
            while k < per_client or not done.is_set() or after < per_client // 4:
                i = (c * per_client + k) % len(patients)
                st, body, hdrs, sec = cl.call("POST", "/predict", patients[i], headers)
                with lock:
                    replies.append((i, st, body, hdrs, sec))
                k += 1
                after += done.is_set()
        finally:
            cl.close()

    threads = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        extra = during() if during is not None else None
    finally:
        done.set()
    for t in threads:
        t.join()
    return {"replies": replies, "seconds": time.perf_counter() - t0, "during": extra}


def check_replies(replies: list, oracles: dict, what: str) -> dict:
    """Every reply 200, and its probability equal to the eager oracle of the
    version that computed it (``X-Model-Version``) on the card at
    ``parity_tolerance`` and to the CPU port's at (1e-5, 1e-8)."""
    bad = [r for r in replies if r[1] != 200]
    check(not bad, f"{what}: {len(bad)} non-200 replies, e.g. {bad[:2]}")
    worst = 0.0
    for i, _, body, hdrs, _ in replies:
        card, cpu, (rtol, atol) = oracles[hdrs.get("X-Model-Version")]
        p = body["probability"]
        for want, tol in ((card[i], (rtol, atol)), (cpu[i], (1e-5, 1e-8))):
            check(abs(p - want) <= tol[1] + tol[0] * abs(want),
                  f"{what}: reply {p} vs oracle {want} (patient {i})")
        worst = max(worst, abs(p - card[i]))
    return {"non_200": len(bad), "max_abs_err_vs_card_oracle": worst}


def path_split(port: int) -> dict:
    cl = Client(port)
    try:
        _, snap, _, _ = cl.call("GET", "/metrics?format=json")
    finally:
        cl.close()
    fam = snap["runtime"]["serve_path_total"]
    return {"snapshot": snap, "paths": {k.split("=")[-1].strip('"{}'): v for k, v in fam.items()}
            if isinstance(fam, dict) else fam}


def phase_serve_http(gbdt_params, X17: np.ndarray, seed: int, dev) -> dict:
    """Serving on the card (``serve/``): the bucketed engine's one CUDA graph
    per bucket (warmup seconds, captures, every lane of every bucket held to
    the eager oracle, latency per bucket beside the eager routes), then
    ``make_server(..., device=dev)`` on a free port: 200 sequential requests
    pinned to the device path and 200 on the host path, a closed-loop burst
    of 32 keep-alive clients x 50 requests, ``/admin/deploy`` of the full
    pipeline checkpoint during a second burst, a fault drill through
    ``/debug/faults`` (breaker open, 503 + Retry-After, recovery on freshly
    captured graphs), and ``cli serve --model`` in a subprocess. No hand
    kernel lies on this path: the launch counts must stay 0."""
    import signal
    import tempfile

    from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT
    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17
    from machine_learning_replications_tpu_torch.obs import torchmon
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.serve import engine, make_server

    torchmon.install()
    cuda_histogram.reset_launch_counts()
    out = {"phase": "serve_http", "buckets": list(engine.DEFAULT_BUCKETS)}
    params = serving_params(gbdt_params, X17, seed)
    pipe = predict_params(gbdt_params, X17, seed, dev)
    rng = np.random.default_rng(seed + 7)
    pool = np.asarray(X17[rng.choice(X17.shape[0], 512, replace=False)], np.float64)

    # -- the engine: one capture per bucket, every lane held to the oracle --
    warm = {}
    for name, p in (("stacking", params), ("pipeline", pipe)):
        eng = engine.BucketedPredictEngine(p, device=dev)
        c0 = torchmon.totals()["torch_graph_captures_total"]
        t0 = time.perf_counter()
        secs = eng.warmup()
        total = time.perf_counter() - t0
        captures = torchmon.totals()["torch_graph_captures_total"] - c0
        check(eng.trace_counts == {b: 1 for b in engine.DEFAULT_BUCKETS},
              f"{name}: one capture per bucket: {eng.trace_counts}")
        check(captures == len(engine.DEFAULT_BUCKETS), f"{name}: {captures} graph captures")
        rtol, atol = engine.parity_tolerance(p)
        p_cpu = convert.params_to(p, "cpu")
        lanes, lat, replay = {}, {}, {}
        for b in engine.DEFAULT_BUCKETS:
            Xb = pool[:b]
            got = eng.predict(Xb)
            want = engine.oracle_proba1(p, Xb)
            want_cpu = engine.oracle_proba1(p_cpu, Xb)
            check(got.shape == (b,) and bool(np.isfinite(got).all()), f"{name} b{b}: finite")
            check(bool(np.allclose(got, want, rtol=rtol, atol=atol)),
                  f"{name} b{b}: every lane equals the card oracle")
            check(bool(np.allclose(got, want_cpu, rtol=1e-5, atol=1e-8)),
                  f"{name} b{b}: every lane equals the CPU port")
            lanes[b] = float(np.abs(got - want).max())
            lat[b], _ = median_ms(lambda: eng.predict(Xb))
            replay[b] = replay_ms(eng, b)

        def one_predict():
            t0 = time.perf_counter()
            eng.predict(pool[:64])
            return time.perf_counter() - t0

        warm[name] = {"warmup_s_per_bucket": secs, "warmup_s": total, "captures": captures,
                      "trace_counts": eng.trace_counts, "parity_tolerance": [rtol, atol],
                      "max_abs_err_per_bucket": lanes, "predict_ms_median_per_bucket": lat,
                      "replay_device_ms_median_per_bucket": replay,
                      "profile_predict_64": profile_call(one_predict)}
        del eng
    out["engine"] = warm
    X64 = pool[:64].astype(np.float32)
    out["eager_stacking_64_ms"], _ = median_ms(
        lambda: stacking.predict_proba(params, X64, device=dev))
    out["eager_pipeline_1_ms"], _ = median_ms(
        lambda: pipeline.pipeline_predict_proba1_contract(pipe, pool[:1], device=dev))

    # -- the server ----------------------------------------------------------
    patients = [{k: float(v) for k, v in zip(SELECTED_17, r)} for r in pool]
    oracle = {}
    scratch = cuda_histogram.BUILD_DIR.parent
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = f"{tmp}/model"
        check(checkpoint.save_model(path, params) == 1, "stacking checkpoint is version 1")
        loaded, info = checkpoint.load_model_versioned(path, device=dev)
        for p, version in ((loaded, "1"), (pipe, "2")):
            oracle[version] = (engine.oracle_proba1(p, pool),
                               engine.oracle_proba1(convert.params_to(p, "cpu"), pool),
                               engine.parity_tolerance(p))
        port = free_port()
        t0 = time.perf_counter()
        handle = make_server(loaded, port=port, device=dev, host_path=True, fault_endpoint=True,
                             admin_endpoint=True, model_version=info["version"],
                             profile_dir=f"{tmp}/profiles").start_background()
        out["make_server_s"] = time.perf_counter() - t0
        try:
            cl = Client(port)
            seq = {}
            for label, hdr in (("device", {"X-Serve-Path": "device"}), ("host", None)):
                rep = []
                for k in range(200):
                    st, body, hdrs, sec = cl.call("POST", "/predict", patients[k], hdr)
                    rep.append((k, st, body, hdrs, sec))
                check(all(r[3]["X-Serve-Path"] == label for r in rep), f"every reply on {label}")
                lat = [r[4] * 1e3 for r in rep]
                seq[label] = {"requests": len(rep), "p50_ms": quantile(lat, 0.5),
                              "p99_ms": quantile(lat, 0.99),
                              **check_replies(rep, oracle, f"sequential {label}")}
            cl.close()
            out["sequential"] = seq
            b1 = burst(port, patients, 32, 50)
            lat = [r[4] * 1e3 for r in b1["replies"]]
            snap = path_split(port)
            out["burst"] = {"clients": 32, "per_client": 50, "requests": len(b1["replies"]),
                            "seconds": b1["seconds"], "rps": len(b1["replies"]) / b1["seconds"],
                            "p50_ms": quantile(lat, 0.5), "p99_ms": quantile(lat, 0.99),
                            "paths": {h: sum(r[3]["X-Serve-Path"] == h for r in b1["replies"])
                                      for h in ("host", "device")},
                            "serve_path_total": snap["paths"],
                            "batch_size": snap["snapshot"].get("batch_size"),
                            "padding_waste": snap["snapshot"].get("padding_waste"),
                            **check_replies(b1["replies"], oracle, "burst")}
            cl = Client(port)
            _, health, _, _ = cl.call("GET", "/healthz")
            check(health["breaker"]["state"] == "closed" and health["ready"],
                  f"breaker closed after the burst: {health['breaker']}")

            # -- deploy the full pipeline during a second burst --------------
            old_engine = handle.engine._engine
            check(checkpoint.save_model(path, pipe) == 2, "pipeline checkpoint is version 2")

            def deploy():
                time.sleep(0.5)
                # A deploy under this burst took 35-60 s on an H100 host and
                # longer on a slower one: the reply may take minutes.
                dc = Client(port, timeout=600)
                try:
                    return dc.call("POST", "/admin/deploy", {"model": path})
                finally:
                    dc.close()

            b2 = burst(port, patients, 16, 80, during=deploy)
            st, body, _, dep_s = b2["during"]
            check(st == 200 and body["deploy"]["result"] == "ok" and body["deploy"]["version"] == 2,
                  f"deploy under load: {st} {body}")
            versions = [r[3].get("X-Model-Version") for r in b2["replies"]]
            check({"1", "2"} <= set(versions), f"the version flips in the replies: {set(versions)}")
            new_engine = handle.engine._engine
            check(new_engine is not old_engine and new_engine.trace_counts == {
                b: 1 for b in engine.DEFAULT_BUCKETS}, "the deployed engine captured every bucket")
            out["deploy"] = {"seconds": dep_s, "deploy_status": body["deploy"],
                             "requests": len(b2["replies"]),
                             "replies_by_version": {v: versions.count(v) for v in ("1", "2")},
                             **check_replies(b2["replies"], oracle, "deploy burst")}

            # -- fault drill ---------------------------------------------------
            cl.close()                   # idle through the burst: the server reaped it
            cl = Client(port)
            pin = {"X-Serve-Path": "device"}
            st, golden, _, _ = cl.call("POST", "/predict", patients[0], pin)
            check(st == 200, "a reply before the drill")
            cap0 = torchmon.totals()["torch_graph_captures_total"]
            st, _, _, _ = cl.call("POST", "/debug/faults", {"arm": "engine.compute:raise@count=3"})
            check(st == 200, "faults armed over HTTP")
            codes, retry_after, t0 = [], None, time.perf_counter()
            while time.perf_counter() - t0 < 60:
                st, body, hdrs, _ = cl.call("POST", "/predict", patients[0], pin)
                codes.append(st)
                if st == 503:
                    retry_after = hdrs.get("Retry-After")
                if st == 200 and 503 in codes:
                    break
                time.sleep(0.01)
            check(codes[:3] == [500, 500, 500] and retry_after is not None and int(retry_after) >= 1,
                  f"breaker opens with 503 + Retry-After: {codes[:8]} {retry_after}")
            check(codes[-1] == 200 and body["probability"] == golden["probability"],
                  f"recovery with the same answer: {codes[-3:]}")
            restarted = handle.engine._engine
            check(restarted is not new_engine and restarted.trace_counts == {
                b: 1 for b in engine.DEFAULT_BUCKETS}, "the restart captured fresh graphs")
            recaptures = torchmon.totals()["torch_graph_captures_total"] - cap0
            check(recaptures == len(engine.DEFAULT_BUCKETS), f"{recaptures} recaptures")
            out["fault_drill"] = {"codes": {c: codes.count(c) for c in set(codes)},
                                  "retry_after": retry_after,
                                  "recovery_s": time.perf_counter() - t0,
                                  "recaptures": recaptures}
            # the same deploy with no traffic: what the burst's clients cost it
            st, body, _, idle_s = cl.call("POST", "/admin/deploy", {"model": path})
            check(st == 200 and body["deploy"]["result"] == "ok", f"idle deploy: {st} {body}")
            out["deploy"]["idle_seconds"] = idle_s
            cl.close()
        finally:
            handle.shutdown()

        # -- cli serve in a subprocess ------------------------------------------
        port = free_port()
        env = {**os.environ, "MLR_TPU_PROGRESS": "0"}
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "machine_learning_replications_tpu_torch", "serve",
             "--model", path, "--port", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=Path(__file__).resolve().parent)
        try:
            while True:
                check(proc.poll() is None, "cli serve exited early")
                check(time.perf_counter() - t0 < 300, "cli serve ready within 300 s")
                try:
                    cl = Client(port)
                    st, _, _, _ = cl.call("GET", "/readyz")
                    cl.close()
                    if st == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.25)
            ready_s = time.perf_counter() - t0
            cl = Client(port)
            st, body, hdrs, _ = cl.call("POST", "/predict", dict(EXAMPLE_PATIENT))
            cl.close()
            check(st == 200, f"cli serve /predict: {st} {body}")
            line, _ = run_cli(["predict", "--model", path], timeout=300)
            line = line.stdout.strip().splitlines()[-1]
            check(body["text"] == line, f"cli serve {body['text']!r} vs cli predict {line!r}")
        finally:
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=120)
        check(proc.returncode == 0, f"cli serve drains on SIGTERM with exit 0: {err[-2000:]}")
        out["cli_serve"] = {"ready_s": ready_s, "probability": body["probability"],
                            "model_version": hdrs.get("X-Model-Version"), "cli_predict": line}
    out["launches"] = dict(cuda_histogram.LAUNCHES)
    check(not any(out["launches"].values()), f"no hand kernel on the serve path: {out['launches']}")
    emit(out)
    return out["launches"], ready_s


def scrape(port: int) -> dict:
    """``{series: value}`` of a server's ``/metrics`` page."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        page = resp.read().decode()
    out = {}
    for line in page.splitlines():
        if line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            out[series] = float(value)
    return out


def restored_ms(eng, b: int, reps: int = 20) -> float:
    """Median card time of one call of bucket ``b``'s restored program, by
    CUDA events on the engine's stream (its copies and the host excluded):
    ``replay_ms``'s counterpart for an AOT-restored bucket."""
    from machine_learning_replications_tpu_torch.data.examples import patient_row

    fn = eng._aot_execs[b]
    X = torch.as_tensor(np.repeat(eng._host_rows(patient_row()), b, axis=0),
                        device=eng.device).to(eng._in_dtype)
    times = []
    for i in range(reps + 3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with eng._lock, torch.cuda.stream(eng._stream):
            start.record()
            fn(X)
            end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_aot(model: str, publish: dict, seed: int, dev) -> dict:
    """AOT executable bundles (``persist/aot.py``) on the fleet phase's v2:
    the full-pipeline model that ``learn run``'s promotion published with
    its bundle (``publish``: the export seconds per backend from its
    journal's ``aot_export``, from an empty Inductor cache, and its refit's
    launches; one export per run, to stay inside the time limit). Here: the
    package bytes and fingerprints; ``cli serve --model`` to ``/readyz`` 200
    restoring all 7 device and 2 host buckets (every
    ``serve_aot_fallback_total`` series 0, no graph captured, every reply on
    either path equal to the eager oracle on the card at ``parity_tolerance``
    and to the CPU port at (1e-5, 1e-8), the example patient's text equal to
    ``cli predict --model``'s line); the same with ``--no-aot`` (7
    captures) and with ``--inject persist.aot_restore:corrupt`` (all 9
    buckets fall back with ``deserialize_error``, journaled and counted, the
    7 device buckets captured, the replies still right); each cold start to
    ``/readyz``; in this process, ``engine.predict`` ms per bucket and one
    call's card time (CUDA events) restored against captured. No hand kernel
    runs here."""
    import signal
    import tempfile

    from machine_learning_replications_tpu_torch.data.examples import EXAMPLE_PATIENT, patient_row
    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17
    from machine_learning_replications_tpu_torch.persist import aot, checkpoint
    from machine_learning_replications_tpu_torch.serve import engine
    from machine_learning_replications_tpu_torch.serve.hostpath import DEFAULT_HOST_BUCKETS

    cuda_histogram.reset_launch_counts()
    device_b, host_b = list(engine.DEFAULT_BUCKETS), list(DEFAULT_HOST_BUCKETS)
    out = {"phase": "aot", "model": "the fleet phase's v2 (learn run's refit of the predict "
           "cell's pipeline)", "device_buckets": device_b, "host_buckets": host_b}
    root = Path(__file__).resolve().parent
    scratch = cuda_histogram.BUILD_DIR.parent     # git-ignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        def journal(path: str) -> list:
            with open(path) as f:
                return [json.loads(line) for line in f]

        bundle = aot.load_bundle(model)
        check(bundle is not None, "the checkpoint ships an aot bundle")
        blobs = bundle.manifest["blobs"]
        cover = {be: sorted(b["bucket"] for b in blobs if b["backend"] == be)
                 for be in ("cuda", "cpu")}
        check(cover == {"cuda": device_b, "cpu": host_b}, f"the bundle's buckets: {cover}")
        checkpoint.verify_checkpoint(model, deep=True)
        out["publish"] = {
            **publish, "package_bytes": {b["file"]: b["bytes"] for b in blobs},
            "fingerprints": {be: {k: v for k, v in fp.items() if k != "structure"}
                             for be, fp in bundle.manifest["fingerprints"].items()}}

        params = checkpoint.load_model(model, device=dev)
        X, _, _ = make_cohort(n=32, seed=seed + 12, missing_rate=0.0)
        rows = np.ascontiguousarray(X[:, selected_indices()], np.float64)
        rows[0] = patient_row()[0]
        patients = [dict(zip(SELECTED_17, map(float, r))) for r in rows]
        check(list(EXAMPLE_PATIENT) == list(SELECTED_17) and patients[0] == {
            k: float(v) for k, v in EXAMPLE_PATIENT.items()}, "row 0 is the example patient")
        want = engine.oracle_proba1(params, rows)
        want_cpu = engine.oracle_proba1(convert.params_to(params, "cpu"), rows)
        tol = engine.parity_tolerance(params)
        predict_line = run_cli(["predict", "--model", model], timeout=300)[0]
        predict_line = predict_line.stdout.strip().splitlines()[-1]

        def drive(name: str, *extra) -> dict:
            """One ``cli serve`` cold start: ready seconds, replies on both
            paths held to the oracles, ``/metrics``, the journal, SIGTERM."""
            port = free_port()
            log = open(f"{tmp}/{name}.log", "w")
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "machine_learning_replications_tpu_torch", "serve",
                 "--model", model, "--port", str(port), "--journal", f"{tmp}/{name}.jsonl",
                 *extra], stdout=log, stderr=subprocess.STDOUT, text=True,
                env={**os.environ, "MLR_TPU_PROGRESS": "0"}, cwd=root)
            try:
                while True:
                    check(proc.poll() is None, f"cli serve ({name}) exited early: "
                                               f"{Path(f'{tmp}/{name}.log').read_text()[-2000:]}")
                    check(time.perf_counter() - t0 < 600, f"cli serve ({name}) ready within 600 s")
                    try:
                        cl = Client(port)
                        st, _, _, _ = cl.call("GET", "/readyz")
                        cl.close()
                        if st == 200:
                            break
                    except OSError:
                        pass
                    time.sleep(0.1)
                ready_s = time.perf_counter() - t0
                cl = Client(port)
                got = {}
                for path, hdr in (("device", {"X-Serve-Path": "device"}), ("host", None)):
                    probs = []
                    for patient in patients:
                        st, body, hdrs, _ = cl.call("POST", "/predict", patient, hdr)
                        check(st == 200, f"{name} /predict: {st} {body}")
                        probs.append(body["probability"])
                        if patient is patients[0]:
                            check(body["text"] == predict_line,
                                  f"{name}: {body['text']!r} vs cli predict {predict_line!r}")
                    got[path] = np.asarray(probs)
                    np.testing.assert_allclose(got[path], want, rtol=tol[0], atol=tol[1],
                                               err_msg=f"{name} {path} vs the card's oracle")
                    np.testing.assert_allclose(got[path], want_cpu, rtol=1e-5, atol=1e-8,
                                               err_msg=f"{name} {path} vs the CPU port")
                cl.close()
                metrics = scrape(port)
            finally:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=120)
                log.close()
            check(proc.returncode == 0, f"cli serve ({name}) exits 0 on SIGTERM")
            events = journal(f"{tmp}/{name}.jsonl")
            fallback = {k[len('serve_aot_fallback_total{reason="'):-2]: v
                        for k, v in metrics.items() if k.startswith("serve_aot_fallback_total{")}
            check(len(fallback) == 8, f"eight fallback reasons on /metrics: {fallback}")
            return {
                "ready_s": ready_s,
                "restored": sorted((e["role"], e["bucket"]) for e in events
                                   if e["kind"] == "aot_restore"),
                "fallbacks": sorted((e["role"], e["bucket"], e["reason"]) for e in events
                                    if e["kind"] == "aot_fallback"),
                "fallback_total": fallback,
                # an unlabeled counter renders no sample until it first counts
                "captures": metrics.get("torch_graph_captures_total", 0.0),
                "max_abs_err_vs_oracle": float(max(np.abs(g - want).max() for g in got.values())),
                "restore_s": {k: v for k, v in metrics.items()
                              if k.startswith("serve_aot_restore_seconds{")},
            }

        every = sorted([("device", b) for b in device_b] + [("host", b) for b in host_b])
        # -- restore ----------------------------------------------------------
        restored = drive("aot")
        check(restored["restored"] == every, f"all 9 buckets restored: {restored['restored']}")
        check(not restored["fallbacks"] and not any(restored["fallback_total"].values()),
              f"no fallback: {restored['fallbacks']} {restored['fallback_total']}")
        check(restored["captures"] == 0, f"no graph captured: {restored['captures']}")
        # -- compare: the same without the bundle -----------------------------
        captured = drive("no_aot", "--no-aot")
        check(not captured["restored"] and not captured["fallbacks"],
              "--no-aot restores nothing and falls back nowhere")
        check(captured["captures"] == len(device_b), f"--no-aot captures: {captured['captures']}")
        # -- corrupt: every bucket falls back, and still answers --------------
        torn = drive("corrupt", "--inject", "persist.aot_restore:corrupt")
        check(not torn["restored"] and torn["fallbacks"] == [
            (role, b, "deserialize_error") for role, b in every],
              f"every bucket fell back with deserialize_error: {torn['fallbacks']}")
        check(torn["fallback_total"]["deserialize_error"] == len(every) and sum(
            torn["fallback_total"].values()) == len(every), f"counted: {torn['fallback_total']}")
        check(torn["captures"] == len(device_b), f"the torn run captured: {torn['captures']}")
        out.update(restore=restored, no_aot=captured, corrupt=torn)

        # -- in this process: predict per bucket, card time per call ---------
        eng = engine.BucketedPredictEngine(params, device=dev, aot=bundle.for_backend("cuda"))
        t0 = time.perf_counter()
        eng.warmup()
        warm_aot = time.perf_counter() - t0
        check(sorted(eng._aot_execs) == device_b and eng.compile_count() == 0,
              f"in-process restore: {sorted(eng._aot_execs)} {eng.trace_counts}")
        cap = engine.BucketedPredictEngine(params, device=dev)
        t0 = time.perf_counter()
        cap.warmup()
        warm_cap = time.perf_counter() - t0
        big = np.repeat(rows, 16, axis=0)
        np.testing.assert_allclose(eng.predict(big), engine.oracle_proba1(params, big),
                                   rtol=tol[0], atol=tol[1])
        per_bucket = {}
        for b in device_b:
            Xb = big[:b]
            per_bucket[b] = {
                "predict_ms_restored": median_ms(lambda: eng.predict(Xb))[0],
                "predict_ms_captured": median_ms(lambda: cap.predict(Xb))[0],
                "card_ms_restored": restored_ms(eng, b),
                "card_ms_captured": replay_ms(cap, b)}
        out.update(engine_warmup_s={"restored": warm_aot, "captured": warm_cap},
                   per_bucket=per_bucket, cli_predict_line=predict_line)
    out["launches"] = dict(cuda_histogram.LAUNCHES)
    check(not any(out["launches"].values()), f"no hand kernel on the restore path: "
                                             f"{out['launches']}")
    emit(out)
    return out["launches"]


def write_cohort_jsonl(path: str, X17: np.ndarray, bad_before: list) -> np.ndarray:
    """Contract-order rows as patient-dict JSONL (17 digits per value, so
    the parse gives back the same float64s), one malformed line before each
    row index of ``bad_before``; returns ``line_row[line - 1]``, the row of
    each 1-based input line (-1 on a malformed one)."""
    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17

    fmt = "{" + ", ".join(f'"{k}": %.17g' for k in SELECTED_17) + "}"
    bad = sorted(bad_before)
    line_row = np.empty(len(X17) + len(bad), np.int64)
    with open(path, "w") as f:
        start, line = 0, 0
        for i in bad + [len(X17)]:
            np.savetxt(f, X17[start:i], fmt=fmt)
            line_row[line:line + i - start] = np.arange(start, i)
            line += i - start
            if i < len(X17):
                f.write('{"Gender": 1, "truncated export line\n')
                line_row[line] = -1
                line += 1
            start = i
    return line_row


def read_scores(out_dir: str) -> tuple:
    """``(rows, lines, p1)`` of every committed score record, in order."""
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("scores-"):
            with open(os.path.join(out_dir, name)) as f:
                recs += [json.loads(line) for line in f]
    return (np.array([r["row"] for r in recs]), np.array([r["line"] for r in recs]),
            np.array([r["p1"] for r in recs], np.float64))


def output_bytes(out_dir: str) -> bytes:
    """Every score shard and the quarantine sidecar, concatenated."""
    return b"".join(name.encode() + Path(out_dir, name).read_bytes()
                    for name in sorted(os.listdir(out_dir))
                    if name.startswith("scores-") or name == "quarantine.jsonl")


def journal_kinds(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["kind"] for line in f]


SCORE_MESH_ROWS = 20_000
SCORE_MESH_CHUNK = 512


def score_mesh(params, model: str, cohort: str, tmp: str, digest: str, tol: tuple,
               dev) -> dict:
    """``cli score --mesh 2 --distributed`` as two gloo ranks sharing the card
    on the first ``SCORE_MESH_ROWS`` lines (``SCORE_MESH_CHUNK``-row chunks),
    beside one process's run on the same lines: ``p1`` within ``tol``, the
    same quarantine; a second pair SIGKILLed once rank 0 has committed 3
    chunks, then rerun, resumes to bytes equal to the uninterrupted pair's;
    rank 1's ``--out`` stays untouched."""
    from machine_learning_replications_tpu_torch.score import ScorePipeline, open_cohort

    t0 = time.perf_counter()
    single = ScorePipeline(params, open_cohort(cohort, SCORE_MESH_CHUNK, limit=SCORE_MESH_ROWS),
                           f"{tmp}/single_mesh_ref", model_digest=digest, device=dev).run()
    single_s = time.perf_counter() - t0
    root = Path(__file__).resolve().parent

    def pair(name: str) -> list:
        port = free_port()
        return [subprocess.Popen(
            [sys.executable, "-m", "machine_learning_replications_tpu_torch", "score", "--model",
             model, "--cohort", cohort, "--out", f"{tmp}/{name}_r{r}", "--limit",
             str(SCORE_MESH_ROWS), "--chunk-rows", str(SCORE_MESH_CHUNK), "--mesh", "2",
             "--distributed", "--journal", f"{tmp}/{name}.jsonl"],
            env=rank_env(r, 2, port, cpu=False), cwd=root,
            stdout=open(f"{tmp}/{name}_r{r}.out", "w"), stderr=open(f"{tmp}/{name}_r{r}.err", "w"))
            for r in range(2)]

    def wait(procs, name, ok=(0,)):
        for r, p in enumerate(procs):
            rc = p.wait(timeout=600)
            check(rc in ok, f"{name} rank {r} exits {ok}: "
                  f"{Path(f'{tmp}/{name}_r{r}.err').read_text()[-2000:]}")

    t0 = time.perf_counter()
    full, killed = pair("mesh"), pair("mesh_killed")
    progress = Path(f"{tmp}/mesh_killed_r0/progress.json")
    chunks_at_kill = 0
    try:
        while chunks_at_kill < 3:
            check(all(p.poll() is None for p in killed), "the pair to kill is still running")
            try:
                chunks_at_kill = json.loads(progress.read_text())["chunks"]
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.01)
    finally:
        for p in killed:
            p.kill()
            p.wait()
    wait(full, "mesh")
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wait(pair("mesh_killed"), "mesh_killed")
    resume_s = time.perf_counter() - t0
    with open(f"{tmp}/mesh_r0/summary.json") as f:
        mesh = json.load(f)
    with open(f"{tmp}/mesh_killed_r0/summary.json") as f:
        resumed = json.load(f)
    _, _, p1_single = read_scores(f"{tmp}/single_mesh_ref")
    rows, lines, p1 = read_scores(f"{tmp}/mesh_r0")
    rtol, atol = tol
    check(mesh["mesh"] and mesh["rows"] == single["rows"] and p1.shape == p1_single.shape
          and bool(np.allclose(p1, p1_single, rtol=rtol, atol=atol)),
          f"two-rank p1 within {tol} of one process's: {np.abs(p1 - p1_single).max()}")
    check(mesh["bad_rows"] == single["bad_rows"]
          and Path(f"{tmp}/mesh_r0/quarantine.jsonl").read_bytes()
          == Path(f"{tmp}/single_mesh_ref/quarantine.jsonl").read_bytes(),
          "the two-rank run quarantines what one process does")
    check(resumed["resumed"] and 3 <= resumed["resumed_chunks"] < mesh["chunks"]
          and output_bytes(f"{tmp}/mesh_killed_r0") == output_bytes(f"{tmp}/mesh_r0")
          and resumed["output_sha256"] == mesh["output_sha256"],
          f"the killed pair resumes to the uninterrupted pair's bytes: {resumed['resumed_chunks']}")
    check(not any(Path(f"{tmp}/{n}_r1").exists() for n in ("mesh", "mesh_killed")),
          "rank 1 wrote nothing into its --out")
    for r in range(2):
        check("distributed runtime up (gloo: 2 ranks share 1 card"
              in Path(f"{tmp}/mesh_r{r}.err").read_text(), f"score rank {r} declares gloo")
    return {"rows": SCORE_MESH_ROWS, "chunk_rows": SCORE_MESH_CHUNK, "chunks": mesh["chunks"],
            "bad_rows": mesh["bad_rows"], "single_process_s": single_s,
            "single_wall_seconds": single["wall_seconds"], "pair_s": pair_s,
            "mesh_wall_seconds": mesh["wall_seconds"],
            "mesh_rows_per_second": mesh["rows_per_second"], "resume_pair_s": resume_s,
            "chunks_at_kill": chunks_at_kill, "resumed_chunks": resumed["resumed_chunks"],
            "max_abs_err_vs_single": float(np.abs(p1 - p1_single).max())}


def phase_score(gbdt_params, X17: np.ndarray, seed: int, dev) -> dict:
    """Bulk scoring on the card (``score/``) with the predict phase's
    full-pipeline checkpoint. ``cli score`` in a subprocess on a
    ``SCORE_ROWS``-row contract JSONL cohort with ``SCORE_BAD_LINES``
    malformed lines at fixed positions, at the CLI's defaults (2048-row
    chunks, prefetch 4, 2 parse workers): rows/s, wall and stage seconds, the
    quarantine count, ``score_done`` in its journal. In-process on the first
    ``SCORE_GATE_ROWS`` lines: sequential and overlapped output bytes equal;
    a run killed after 10 chunks resumes to the same bytes; every chunk's
    ``p1`` bit-equal to the eager ``pipeline_predict_proba1_contract`` on its
    padded chunk; the run's ``p1`` equal to the eager whole-cohort call on the
    card at ``parity_tolerance`` and to the CPU port at (1e-5, 1e-8); a second
    run captures no graph and builds no kernel; one run profiled. Then the
    ``.mat`` route: ``SCORE_MAT_ROWS`` rows of ``make_cohort(missing_rate=
    0.03)`` in the reference layout through ``cli score``, and the bare
    ensemble on the same rows' 17 contract columns, which quarantines the rows
    holding a NaN. No hand kernel lies on this path: the launch counts must
    stay 0."""
    import tempfile

    from machine_learning_replications_tpu_torch.data import matloader
    from machine_learning_replications_tpu_torch.data.sharding import pad_rows_to
    from machine_learning_replications_tpu_torch.obs import torchmon
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.score import ScorePipeline, open_cohort
    from machine_learning_replications_tpu_torch.score.pipeline import ScoreInterrupted
    from machine_learning_replications_tpu_torch.score.progress import params_digest
    from machine_learning_replications_tpu_torch.serve import engine

    torchmon.install()
    cuda_histogram.reset_launch_counts()
    params = predict_params(gbdt_params, X17, seed, dev)
    out = {"phase": "score", "rows": SCORE_ROWS, "bad_lines": SCORE_BAD_LINES,
           "gate_rows": SCORE_GATE_ROWS, "model": "PipelineParams (predict phase)"}
    Xc, _, _ = make_cohort(n=SCORE_ROWS, seed=seed + 8)
    Xc = np.ascontiguousarray(Xc[:, selected_indices()])
    bad_before = [int(i) for i in np.linspace(5_000, SCORE_ROWS - 5_000, SCORE_BAD_LINES)]
    scratch = cuda_histogram.BUILD_DIR.parent     # git-ignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        model, cohort = f"{tmp}/model", f"{tmp}/cohort.jsonl"
        checkpoint.save_model(model, params)
        t0 = time.perf_counter()
        line_row = write_cohort_jsonl(cohort, Xc, bad_before)
        out["write_cohort_s"] = time.perf_counter() - t0

        # -- the headline: cli score on the whole cohort ---------------------
        proc, cli_s = run_cli(["score", "--model", model, "--cohort", cohort, "--out",
                               f"{tmp}/cli", "--journal", f"{tmp}/cli.jsonl"], timeout=900)
        with open(f"{tmp}/cli/summary.json") as f:
            head = json.load(f)
        kinds = journal_kinds(f"{tmp}/cli.jsonl")
        check(head["rows"] == SCORE_ROWS and head["bad_rows"] == SCORE_BAD_LINES,
              f"cli score: {head['rows']} rows, {head['bad_rows']} quarantined")
        check("score_done" in kinds and kinds[-1] == "run_done",
              f"score_done in the journal: {kinds[-3:]}")
        check(head["chunks"] == -(-len(line_row) // 2048), f"{head['chunks']} chunks")
        out["cli"] = {k: head[k] for k in (
            "rows", "bad_rows", "chunks", "wall_seconds", "rows_per_second", "stage_seconds",
            "chunk_rows", "prefetch", "parse_workers", "output_sha256", "torch_graph_captures",
            "torch_kernel_builds")}
        out["cli"].update(subprocess_s=cli_s, stdout=proc.stdout.strip().splitlines()[-1])
        _, lines, p1_cli = read_scores(f"{tmp}/cli")
        check(bool(np.isfinite(p1_cli).all()) and p1_cli.shape == (SCORE_ROWS,),
              "finite p1 for every row")

        # -- in-process gates on the first SCORE_GATE_ROWS lines -------------
        digest = params_digest(model=model)

        def run(name, **kw):
            src = open_cohort(cohort, 2048, limit=SCORE_GATE_ROWS)
            return ScorePipeline(params, src, f"{tmp}/{name}", model_digest=digest,
                                 device=dev, **kw).run()

        seq = run("seq", overlap=False)
        ovl = run("ovl")
        check(seq["output_sha256"] == ovl["output_sha256"]
              and output_bytes(f"{tmp}/seq") == output_bytes(f"{tmp}/ovl"),
              "sequential and overlapped outputs are the same bytes")
        try:
            run("resumed", _interrupt_after_chunks=10)
            check(False, "the interrupted run stops after 10 chunks")
        except ScoreInterrupted:
            pass
        resumed = run("resumed")
        check(resumed["resumed"] and resumed["resumed_chunks"] == 10
              and resumed["output_sha256"] == ovl["output_sha256"]
              and output_bytes(f"{tmp}/resumed") == output_bytes(f"{tmp}/ovl"),
              "a run killed after 10 chunks resumes to the same bytes")
        before = torchmon.totals()
        again = run("again")
        after = torchmon.totals()
        new_work = {k: after[k] - before[k] for k in ("torch_graph_captures_total",
                                                      "torch_kernel_builds_total")}
        check(not any(new_work.values()), f"a second run adds no capture or build: {new_work}")
        h2d0 = after["torch_transfer_bytes_total"].get("h2d", 0)
        prof = profile_call(lambda: run("profiled")["wall_seconds"])
        h2d = torchmon.totals()["torch_transfer_bytes_total"].get("h2d", 0) - h2d0

        rows, lines, p1 = read_scores(f"{tmp}/ovl")
        src_rows = line_row[lines - 1]
        check(bool((src_rows >= 0).all()) and rows.tolist() == list(range(len(rows))),
              "row ids in order, each on a valid line")
        check(bool(np.array_equal(p1, p1_cli[:len(p1)])), "the CLI run's prefix is the same p1")
        Xg = Xc[src_rows]
        chunk_of = (lines - 1) // 2048
        for c in np.unique(chunk_of):
            sel = chunk_of == c
            padded, n = pad_rows_to(Xg[sel], 2048, mode="edge")
            want = pipeline.pipeline_predict_proba1_contract(params, padded, device=dev)
            check(bool(np.array_equal(p1[sel], want.cpu().numpy().astype(np.float64)[:n])),
                  f"chunk {c}: p1 bit-equal to the eager route on its padded chunk")
        whole = pipeline.pipeline_predict_proba1_contract(params, Xg, device=dev)
        whole = whole.cpu().numpy().astype(np.float64)
        rtol, atol = engine.parity_tolerance(params)
        check(bool(np.allclose(p1, whole, rtol=rtol, atol=atol)),
              f"p1 equals the eager whole-cohort call at {(rtol, atol)}")
        t0 = time.perf_counter()
        cpu = pipeline.pipeline_predict_proba1_contract(convert.params_to(params, "cpu"), Xg,
                                                        device="cpu").numpy().astype(np.float64)
        cpu_s = time.perf_counter() - t0
        err = np.abs(p1 - cpu)
        check(bool((err <= 1e-8 + 1e-5 * np.abs(cpu)).all()),
              f"p1 equals the CPU port at (1e-5, 1e-8): max abs err {err.max()}")
        out["gates"] = {
            "chunks": int(len(np.unique(chunk_of))), "rows": int(len(p1)),
            "sequential": {k: seq[k] for k in ("wall_seconds", "rows_per_second",
                                               "stage_seconds")},
            "overlapped": {k: ovl[k] for k in ("wall_seconds", "rows_per_second",
                                               "stage_seconds")},
            "second_run": {k: again[k] for k in ("wall_seconds", "rows_per_second")},
            "resumed_chunks": resumed["resumed_chunks"], "new_work_second_run": new_work,
            "max_abs_err_whole_cohort": float(np.abs(p1 - whole).max()),
            "parity_tolerance": [rtol, atol], "max_abs_err_vs_cpu": float(err.max()),
            "cpu_port_s": cpu_s, "profile_overlapped": {**prof, "h2d_bytes": h2d},
            "p1_mean": float(p1.mean())}

        out["mesh"] = score_mesh(params, model, cohort, tmp, digest, (rtol, atol), dev)

        # -- the .mat route ---------------------------------------------------
        Xm, ym, names = make_cohort(n=SCORE_MAT_ROWS, seed=seed + 9, missing_rate=0.03)
        save_data(f"{tmp}/cohort.mat", Xm, ym, names)
        t0 = time.perf_counter()
        X_native = matloader.load_feature_matrix(f"{tmp}/cohort.mat", backend="native")
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        X_scipy = matloader.load_feature_matrix(f"{tmp}/cohort.mat", backend="scipy")
        scipy_s = time.perf_counter() - t0
        check(X_native.shape == (SCORE_MAT_ROWS, 64)
              and np.array_equal(X_native, X_scipy, equal_nan=True),
              "the native MAT-v5 reader's matrix equals scipy's")
        X17m = Xm[:, selected_indices()]
        save_data(f"{tmp}/cohort17.mat", X17m, ym, np.empty((1, 0), object))
        _, mat_s = run_cli(["score", "--model", model, "--cohort", f"{tmp}/cohort.mat",
                            "--out", f"{tmp}/mat"])
        with open(f"{tmp}/mat/summary.json") as f:
            mat = json.load(f)
        _, _, p1m = read_scores(f"{tmp}/mat")
        check(mat["route"] == "x64" and mat["rows"] == SCORE_MAT_ROWS and mat["bad_rows"] == 0,
              f".mat route: {mat['route']}, {mat['rows']} rows")
        want = pipeline.pipeline_predict_proba1(params, Xm, device=dev)
        want = want.cpu().numpy().astype(np.float64)
        check(bool(np.allclose(p1m, want, rtol=rtol, atol=atol)),
              f".mat p1 equals the eager pipeline_predict_proba1 at {(rtol, atol)}")
        nan_rows = int(np.isnan(X17m).any(axis=1).sum())
        bare = ScorePipeline(params.ensemble, open_cohort(f"{tmp}/cohort17.mat", 2048),
                             f"{tmp}/mat17", model_digest="ensemble", device=dev,
                             max_bad_rows=SCORE_MAT_ROWS).run()
        check(nan_rows > 0 and bare["bad_rows"] == nan_rows
              and bare["rows"] == SCORE_MAT_ROWS - nan_rows,
              f"the bare ensemble quarantines the {nan_rows} NaN rows: {bare['bad_rows']}")
        out["mat"] = {"rows": SCORE_MAT_ROWS, "missing_rate": 0.03, "cli_subprocess_s": mat_s,
                      "native_read_s": native_s, "scipy_read_s": scipy_s,
                      "wall_seconds": mat["wall_seconds"],
                      "rows_per_second": mat["rows_per_second"],
                      "max_abs_err_vs_eager": float(np.abs(p1m - want).max()),
                      "bare_ensemble_quarantined": bare["bad_rows"]}
    out["launches"] = dict(cuda_histogram.LAUNCHES)
    check(not any(out["launches"].values()), f"no hand kernel on the score path: {out['launches']}")
    emit(out)
    return out["launches"]


def phase_learn(gbdt_params, X17: np.ndarray, seed: int, dev) -> dict:
    """Continual learning's offline half on the card, from the predict
    phase's full-pipeline checkpoint (the live model): ``CAPTURE_ROWS``
    captured rows (``CohortCapture``) from another ``make_cohort`` seed, one
    selected variable shifted; ``cli learn retrain`` in a subprocess (journal:
    ``learn_retrain_start`` then ``learn_retrain_done``; the candidate a
    ``PipelineParams`` checkpoint at version >= 1), ``cli learn shadow
    --out`` (a strict-JSON verdict with every field of JAX's); the
    candidate's ``replay_scores`` on the card against the CPU port at (1e-5,
    1e-8); and an in-process ``warm_refit`` timed, with its stage seconds,
    launch counts from 0: both kernel entries must launch."""
    import tempfile

    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17
    from machine_learning_replications_tpu_torch.learn import retrain, shadow
    from machine_learning_replications_tpu_torch.learn.capture import CohortCapture
    from machine_learning_replications_tpu_torch.persist import checkpoint

    params = predict_params(gbdt_params, X17, seed, dev)
    Xc, _, _ = make_cohort(n=CAPTURE_ROWS, seed=seed + 10)
    captured = np.ascontiguousarray(Xc[:, selected_indices()])
    shift = "Max_Wall_Thick"
    captured[:, SELECTED_17.index(shift)] += 4.0
    out = {"phase": "learn", "captured_rows": CAPTURE_ROWS, "shifted": f"{shift} + 4",
           "config": "ExperimentConfig()"}
    scratch = cuda_histogram.BUILD_DIR.parent
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        model, cap, cand = f"{tmp}/live", f"{tmp}/capture", f"{tmp}/candidate"
        checkpoint.save_model(model, params)
        capture = CohortCapture(cap, rows_per_shard=512)
        for row in captured:
            capture.append_line({k: float(v) for k, v in zip(SELECTED_17, row)})
        capture.close()
        y = retrain.pseudo_labels(params, captured, device=dev)
        out["distilled_positive_share"] = float(y.mean())

        proc, retrain_s = run_cli(["learn", "retrain", "--model", model, "--capture", cap,
                                   "--candidate", cand, "--journal", f"{tmp}/retrain.jsonl"],
                                  timeout=900)
        info = json.loads(proc.stdout)
        kinds = journal_kinds(f"{tmp}/retrain.jsonl")
        check("learn_retrain_start" in kinds and "learn_retrain_done" in kinds
              and kinds.index("learn_retrain_start") < kinds.index("learn_retrain_done"),
              f"learn_retrain_start then learn_retrain_done: {kinds}")
        version = checkpoint.checkpoint_version(cand)
        cand_card = checkpoint.load_model(cand, device=dev)
        check(isinstance(cand_card, pipeline.PipelineParams) and version is not None
              and version >= 1 and info["version"] == version,
              f"the candidate is a PipelineParams checkpoint at version {version}")

        shadow_proc, shadow_s = run_cli(["learn", "shadow", "--model", model, "--capture", cap,
                                         "--candidate", cand, "--out", f"{tmp}/verdict.json"],
                                        ok=(0, 1))

        def no_nan(token):
            raise ValueError(f"non-strict JSON token {token}")

        with open(f"{tmp}/verdict.json") as f:
            verdict = json.load(f, parse_constant=no_nan)
        check(shadow_proc.returncode == (0 if verdict["pass"] else 1),
              f"cli learn shadow exits by its verdict: {shadow_proc.stderr[-2000:]}")
        check(set(verdict) == {"pass", "reasons", "stats", "thresholds", "candidate_version"}
              and set(verdict["stats"]) == {
                  "rows", "divergence_mean", "divergence_p95", "divergence_max", "flip_rate",
                  "score_psi", "disagreement_live", "disagreement_candidate",
                  "disagreement_delta", "candidate_quality"}
              and set(verdict["thresholds"]) == set(shadow.ShadowThresholds().as_dict())
              and verdict["candidate_version"] == version
              and verdict["stats"]["rows"] == CAPTURE_ROWS, f"the verdict's fields: {verdict}")

        p1, members, rows = shadow.replay_scores(cand_card, captured, device=dev)
        cpu = convert.params_to(cand_card, "cpu")
        p1c, membersc, rowsc = shadow.replay_scores(cpu, captured, device="cpu")
        errs = {k: float(np.abs(a - b).max()) for k, a, b in (
            ("p1", p1, p1c), ("members", members, membersc), ("rows", rows, rowsc))}
        check(all(bool(np.allclose(a, b, rtol=1e-5, atol=1e-8))
                  for a, b in ((p1, p1c), (members, membersc), (rows, rowsc))),
              f"the candidate's replay on the card equals the CPU port at (1e-5, 1e-8): {errs}")

        # The main path's run: counts from 0, read right after.
        torch.cuda.synchronize()
        cuda_histogram.reset_launch_counts()
        t0 = time.perf_counter()
        _, refit = retrain.warm_refit(params, captured, f"{tmp}/refit", device=dev)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        launches = dict(cuda_histogram.LAUNCHES)
        check(launches["stump_histograms"] > 0 and launches["node_histograms"] > 0,
              f"warm_refit launched both kernel entries: {launches}")
        out.update(retrain_cli_s=retrain_s, retrain_cli_info=info, journal=kinds,
                   shadow_cli_s=shadow_s, verdict_pass=verdict["pass"],
                   verdict_reasons=verdict["reasons"], verdict_stats=verdict["stats"],
                   replay_max_abs_err_vs_cpu=errs, warm_refit_s=refit_s,
                   warm_refit_stage_seconds=refit["stage_seconds"], launches=launches)
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# fleet: the router, the autoscaler, a multi-worker replica, learn run
# ---------------------------------------------------------------------------


def card_apps() -> dict:
    """``{pid: used MiB}`` of the processes ``nvidia-smi`` lists on the card
    (a container may list none of its own)."""
    rows = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    return {int(r.split(",")[0]): float(r.split(",")[1]) for r in rows if r.strip()}


def card_memory() -> str:
    """The card's used and total memory, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=memory.used,memory.total",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def http_json(url: str, body=None, timeout: float = 30) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_for(pred, timeout: float, what: str, poll: float = 0.25):
    """Poll ``pred`` until it returns a true value (returned) or fail."""
    deadline = time.perf_counter() + timeout
    while True:
        try:
            got = pred()
        except OSError:
            got = None
        if got:
            return got
        check(time.perf_counter() < deadline, f"{what} within {timeout:.0f} s")
        time.sleep(poll)


def burst_stats(res: dict) -> dict:
    secs = [r[4] for r in res["replies"]]
    by = {}
    for r in res["replies"]:
        by[r[3].get("X-Replica")] = by.get(r[3].get("X-Replica"), 0) + 1
    return {"requests": len(secs), "requests_per_s": len(secs) / res["seconds"],
            "p50_ms": 1e3 * quantile(secs, 0.5), "p99_ms": 1e3 * quantile(secs, 0.99),
            "by_replica": by}


def phase_fleet(gbdt_params, X17: np.ndarray, seed: int, ready_s: float, keep_dir: str,
                dev) -> tuple:
    """The fleet on the card, every process a subprocess of the port's CLI:
    ``fleet router --capture`` (it must hold no CUDA context); ``fleet
    autoscale --min 2 --max 3`` spawning two replicas on the card; a
    ``serve --workers 2 --register`` replica (two processes, one port); a
    32-client burst through the router (every reply 200 and equal to its
    version's oracle, every replica serving), through the router with one
    and two replicas in rotation, and straight at one replica; SIGKILL of an
    autoscaled replica during a burst (0 non-200; respawned, back in
    rotation); ``learn run`` retraining on the router's capture and rolling
    v2 out through it under a 16-client burst (promoted with its AOT bundle,
    compiled from an empty Inductor cache; every replica at v2, restored
    from the bundle with 0 fallbacks; both kernel entries launched, read
    from its journal); ``fleet status`` and ``learn status`` as strict JSON;
    SIGTERM to everything (exit 0, every replica deregistered). v2's
    checkpoint is copied to ``keep_dir`` for the aot phase. Returns the ``learn
    run`` subprocess's kernel launches (no other process of the fleet
    launches a hand kernel) and its publish's record."""
    import shutil
    import signal
    import tempfile

    from machine_learning_replications_tpu_torch.data.schema import SELECTED_17
    from machine_learning_replications_tpu_torch.fleet.lifecycle import RouterClient
    from machine_learning_replications_tpu_torch.persist import aot as aot_mod
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.serve import engine

    cuda_histogram.reset_launch_counts()
    v1 = predict_params(gbdt_params, X17, seed, dev)
    Xc, _, _ = make_cohort(n=FLEET_PATIENTS, seed=seed + 20)
    rows = np.ascontiguousarray(Xc[:, selected_indices()], np.float64)
    rows[:, SELECTED_17.index("Max_Wall_Thick")] += 4.0
    patients = [{k: float(v) for k, v in zip(SELECTED_17, r)} for r in rows]
    oracles = {"1": (engine.oracle_proba1(v1, rows), engine.oracle_proba1(
        convert.params_to(v1, "cpu"), rows), engine.parity_tolerance(v1))}
    # Measured, not JAX's default: the serve_http phase's `cli serve` cold
    # start on this card, with room for four processes starting together.
    ready_deadline = max(60.0, 5.0 * ready_s)
    out = {"phase": "fleet", "patients": FLEET_PATIENTS, "shifted": "Max_Wall_Thick + 4",
           "ready_deadline_s": ready_deadline, "cli_serve_ready_s": ready_s,
           "learn_thresholds": dict(zip(FLEET_GATES[::2], FLEET_GATES[1::2]))}
    root = Path(__file__).resolve().parent
    env = {**os.environ, "MLR_TPU_PROGRESS": "0"}
    procs: dict = {}
    scratch = cuda_histogram.BUILD_DIR.parent
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        model, cap = f"{tmp}/live", f"{tmp}/capture"
        check(checkpoint.save_model(model, v1) == 1, "the live checkpoint is version 1")

        def spawn(name: str, argv: list, extra_env=None):
            log = open(f"{tmp}/{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "machine_learning_replications_tpu_torch", *argv],
                stdout=log, stderr=subprocess.STDOUT, text=True, env={**env, **(extra_env or {})},
                cwd=root), log)
            return procs[name][0]

        def tail(name: str) -> str:
            procs[name][1].flush()
            return Path(f"{tmp}/{name}.log").read_text()[-3000:]

        def alive(name: str) -> bool:
            check(procs[name][0].poll() is None, f"{name} exited early: {tail(name)}")
            return True

        def replicas() -> list:
            return http_json(f"{rurl}/fleet/replicas")["replicas"]

        def journal(path: str) -> list:
            with open(path) as f:
                return [json.loads(line) for line in f]

        try:
            # 1. the router --------------------------------------------------
            rport = free_port()
            rurl = f"http://127.0.0.1:{rport}"
            t0 = time.perf_counter()
            router = spawn("router", ["fleet", "router", "--port", str(rport), "--capture", cap,
                                      "--journal", f"{tmp}/router.jsonl"])
            wait_for(lambda: alive("router") and http_json(f"{rurl}/healthz"), 60, "the router")
            out["router_start_s"] = time.perf_counter() - t0

            # 2. two autoscaled replicas and one two-worker replica ---------
            t0 = time.perf_counter()
            spawn("autoscale", [
                "fleet", "autoscale", "--router", rurl, "--model", model, "--min", "2",
                "--max", "3", "--serve-arg=--device", f"--serve-arg={dev.type}",
                "--serve-arg=--admin-endpoint", "--replica-journal-dir", f"{tmp}/replicas",
                "--ready-deadline", f"{ready_deadline:.0f}", "--poll-interval", "1",
                "--breach-polls", str(HOLD_POLLS), "--idle-polls", str(HOLD_POLLS),
                "--journal", f"{tmp}/autoscale.jsonl"])
            wport = free_port()
            wurl = f"http://127.0.0.1:{wport}"
            workers = spawn("workers", ["serve", "--model", model, "--device", dev.type,
                                        "--workers", "2", "--port", str(wport), "--register", rurl,
                                        "--journal", f"{tmp}/workers.jsonl"])
            worker_ready, seen = None, {}
            while len(seen) < 2 or len([r for r in replicas() if r["in_rotation"]]) < 3:
                for name in ("workers", "autoscale", "router"):
                    alive(name)
                check(time.perf_counter() - t0 < ready_deadline + 60,
                      f"three replicas in rotation: {replicas()}")
                try:
                    h = http_json(f"{wurl}/healthz", timeout=5)
                    if h["ready"]:
                        worker_ready = worker_ready or time.perf_counter() - t0
                        seen.setdefault(h["worker"], time.perf_counter() - t0)
                except OSError:
                    pass
                time.sleep(0.25)
            out["all_in_rotation_s"] = time.perf_counter() - t0
            ajournal = journal(f"{tmp}/autoscale.jsonl")
            spawned = {e["replica"]: e for e in ajournal if e["kind"] == "lifecycle_spawn"}
            out["ready_s"] = {
                **{e["replica"]: e["seconds"] for e in ajournal if e["kind"] == "lifecycle_ready"},
                "workers (first 200)": worker_ready,
                **{f"workers w{k}": s for k, s in sorted(seen.items())}}
            line = next(ln for ln in tail("workers").splitlines() if "(pids " in ln)
            worker_pids = json.loads(line.split("(pids ")[1].rstrip(")"))
            apps = card_apps()
            smi_used = card_memory()
            serving = {**{rid: e["pid"] for rid, e in spawned.items()},
                       **{f"workers w{k}": pid for k, pid in enumerate(worker_pids)}}
            for name, pid in serving.items():
                check(holds_card(pid) == (dev.type == "cuda"),
                      f"serving process {name} (pid {pid}) owns a CUDA context")
            for name, pid in (("router", router.pid), ("autoscale", procs["autoscale"][0].pid),
                              ("workers parent", workers.pid)):
                check(not holds_card(pid) and pid not in apps,
                      f"the {name} (pid {pid}) owns no CUDA context: nvidia-smi lists {apps}")
            out["card"] = {"memory_used_total": smi_used, "nvidia_smi_apps_mib": apps,
                           "serving_pids": serving, "router_pid": router.pid,
                           "workers_parent_pid": workers.pid,
                           "nvidia_smi_lists_serving": sorted(set(serving.values()) & set(apps))}

            # 3. bursts: through the router (3, 1 and 2 replicas), direct ----
            def paths() -> dict:
                """Each autoscaled replica's ``serve_path_total`` (one process
                each; a scrape of the two-worker port reaches one worker)."""
                return {r["id"]: path_split(int(r["url"].rsplit(":", 1)[1]))["paths"]
                        for r in replicas() if r["id"] in spawned}

            def router_burst(clients, per_client, what, during=None):
                before = paths()
                res = burst(rport, patients, clients, per_client, during=during)
                out.setdefault("checks", {})[what] = check_replies(res["replies"], oracles, what)
                after = paths()
                res["paths"] = {rid: {p: n - before.get(rid, {}).get(p, 0) for p, n in c.items()}
                                for rid, c in after.items()}
                return res

            res = router_burst(32, 50, "burst")
            stats = {**burst_stats(res), "paths": res["paths"]}
            ids = [r["id"] for r in replicas()]
            check(set(stats["by_replica"]) == set(ids) and all(stats["by_replica"].values()),
                  f"every replica served the burst: {stats['by_replica']} of {ids}")
            out["burst"] = {"replicas_3_first": stats}
            rc = RouterClient(rurl)
            first = sorted(spawned)[0]
            # then warm: one replica in rotation, two, all three again
            for keep in ((first,), tuple(sorted(spawned)), tuple(ids)):
                held = [i for i in ids if i not in keep]
                for i in held:
                    check(rc.hold(i), f"hold {i}")
                try:
                    res = router_burst(32, 50, f"burst, {len(keep)} in rotation")
                    out["burst"][f"replicas_{len(keep)}"] = {**burst_stats(res),
                                                             "paths": res["paths"]}
                finally:
                    for i in held:
                        check(rc.release(i), f"release {i}")
            direct = next(r["url"] for r in replicas() if r["id"] == first)
            res = burst(int(direct.rsplit(":", 1)[1]), patients, 32, 50)
            out["checks"]["direct"] = check_replies(res["replies"], oracles, "direct burst")
            out["burst"]["direct_one_replica"] = burst_stats(res)

            # 4. SIGKILL an autoscaled replica under a burst ----------------
            victim = sorted(spawned)[-1]

            def kill_and_recover():
                pid = spawned[victim]["pid"]
                t_kill = time.perf_counter()
                os.kill(pid, signal.SIGKILL)

                def back():
                    evs = journal(f"{tmp}/autoscale.jsonl")
                    again = [e for e in evs if e["kind"] == "lifecycle_ready"
                             and e["replica"] == victim and e.get("respawn")]
                    rep = [r for r in replicas() if r["id"] == victim]
                    return again and rep and rep[0]["in_rotation"] and rep[0]["state"] == "ready"

                wait_for(back, ready_deadline + 60, f"{victim} respawned and back in rotation")
                evs = journal(f"{tmp}/autoscale.jsonl")
                return {"replica": victim, "killed_pid": pid,
                        "recovery_s": time.perf_counter() - t_kill,
                        "arc": [e["kind"] for e in evs if e.get("replica") == victim]}

            res = router_burst(32, 50, "kill drill", during=kill_and_recover)
            out["kill_drill"] = {**res["during"], **burst_stats(res)}

            # the two-worker replica leaves: SIGTERM, drained, deregistered
            # (it cannot take a rolling deploy: no --admin-endpoint with N
            # workers, as in JAX)
            workers.send_signal(signal.SIGTERM)
            check(workers.wait(timeout=120) == 0, f"the workers drain, exit 0: {tail('workers')}")
            wid = f"127.0.0.1:{wport}"
            wait_for(lambda: wid not in [r["id"] for r in replicas()], 30,
                     "the two-worker replica deregistered")
            check(not any(Path(f"/proc/{p}").exists() for p in worker_pids),
                  "both workers exited")
            wdone = [journal(f"{tmp}/workers.jsonl.w{k}")[-1] for k in (0, 1)]
            check(all(d["kind"] == "run_done" for d in wdone), f"workers' run_done: {wdone}")
            out["workers_memory"] = {f"w{k}": d.get("cuda_max_memory_allocated_bytes")
                                     for k, d in enumerate(wdone)}

            # 5. learn run: refit on the capture, roll v2 out under a burst -
            health = http_json(f"{rurl}/healthz")
            check(health["capture"]["rows_retained"] >= CAPTURE_ROWS,
                  f"the router captured >= {CAPTURE_ROWS} rows: {health['capture']}")
            learn_argv = ["learn", "run", "--device", dev.type, "--model", model, "--capture", cap,
                          "--router", rurl,
                          "--schedule", "1", "--max-cycles", "1", "--rows", str(CAPTURE_ROWS),
                          "--settle-timeout", "0", "--recovery-timeout", "5",
                          "--poll-interval", "0.5", "--journal", f"{tmp}/learn.jsonl",
                          *FLEET_GATES]

            def learn_run():
                t0 = time.perf_counter()
                # an empty Inductor cache: the compile a first publish pays
                proc = spawn("learn", learn_argv,
                             {"TORCHINDUCTOR_CACHE_DIR": f"{tmp}/inductor"})
                proc.wait(timeout=900)
                return {"rc": proc.returncode, "seconds": time.perf_counter() - t0}

            res = burst(rport, patients, 16, 50, during=learn_run)
            check(res["during"]["rc"] == 0, f"learn run exits 0: {tail('learn')}")
            v2 = checkpoint.load_model(model, device=dev)
            check(checkpoint.checkpoint_version(model) == 2, "the live path holds version 2")
            oracles["2"] = (engine.oracle_proba1(v2, rows),
                            engine.oracle_proba1(convert.params_to(v2, "cpu"), rows),
                            engine.parity_tolerance(v2))
            out["checks"]["deploy burst"] = check_replies(res["replies"], oracles, "deploy burst")
            versions = {}
            for r in res["replies"]:
                versions[r[3].get("X-Model-Version")] = versions.get(
                    r[3].get("X-Model-Version"), 0) + 1
            ljournal = journal(f"{tmp}/learn.jsonl")
            cycle = next(e for e in ljournal if e["kind"] == "learn_cycle_done")
            check(cycle["outcome"] == "promoted", f"learn_cycle_done promoted: {cycle}")
            promo = next(e for e in ljournal if e["kind"] == "learn_promotion")
            verdict = next(e for e in ljournal if e["kind"] == "learn_shadow_verdict")
            wait_for(lambda: all(r["version"] == 2 and r["in_rotation"] for r in replicas()),
                     30, "every replica at version 2 in rotation")
            for r in replicas():
                check(http_json(f"{r['url']}/healthz")["model_version"] == 2,
                      f"{r['id']} reports version 2")
            after = router_burst(16, 20, "after the deploy")
            check(all(r[3].get("X-Model-Version") == "2" for r in after["replies"]),
                  "every reply after the deploy is version 2")
            done = ljournal[-1]
            check(done["kind"] == "run_done", f"learn run's run_done last: {done}")
            launches = {k: done["torch_kernel_launches_total"].get(k, 0)
                        for k in cuda_histogram.LAUNCHES}
            check(launches["stump_histograms"] > 0 and launches["node_histograms"] > 0,
                  f"learn run launched both kernel entries: {launches}")
            # promotion published v2 with its bundle: every replica's deploy
            # restored all 7 device and 2 host buckets from it, 0 fallbacks
            check(aot_mod.load_bundle(model) is not None, "v2 ships an aot bundle")
            restored = {}
            for rid in sorted(spawned):
                recs = journal(f"{tmp}/replicas/replica_{rid}.jsonl")
                start = max(i for i, e in enumerate(recs) if e["kind"] == "deploy_start")
                after = recs[start:]
                restored[rid] = sorted((e["role"], e["bucket"]) for e in after
                                       if e["kind"] == "aot_restore")
                check(not any(e["kind"] == "aot_fallback" for e in recs),
                      f"{rid}: no aot fallback")
                check(len(restored[rid]) == len(engine.DEFAULT_BUCKETS) + 2,
                      f"{rid}'s deploy restored every bucket: {restored[rid]}")
            # v2 and its bundle outlive the phase: the aot phase serves them
            shutil.copytree(model, f"{keep_dir}/model")
            export = next(e for e in ljournal if e["kind"] == "aot_export")
            publish = {"by": "learn run's promotion", "learn_run_s": res["during"]["seconds"],
                       "export_s": export["seconds"],
                       "export_backend_s": export["backend_seconds"],
                       "refit_launches": launches}
            rjournal = journal(f"{tmp}/router.jsonl")
            steps = next(e for e in rjournal if e["kind"] == "fleet_deploy_done")
            out["learn"] = {
                "learn_run_s": res["during"]["seconds"], "cycle": cycle,
                "verdict": {k: verdict.get(k) for k in (
                    "passed", "reasons", "rows", "divergence_mean", "divergence_p95",
                    "flip_rate", "score_psi", "disagreement_delta", "candidate_quality")},
                "deploy": promo.get("replicas"), "deploy_result": promo.get("deploy_result"),
                "deploy_done": steps,
                "deploy_replica_s": {e["replica"]: e.get("seconds") for e in rjournal
                                     if e["kind"] == "fleet_deploy_replica"},
                "burst_versions": versions, **burst_stats(res), "launches": launches,
                "deploy_restored": restored, "publish": publish,
                "retrain": {k: next(e for e in ljournal if e["kind"] == "learn_retrain_done"
                                    ).get(k) for k in ("rows", "seconds", "version")}}

            # 6. status, strict JSON -----------------------------------------
            def no_nan(token):
                raise ValueError(f"non-strict JSON token {token}")

            for argv in (["fleet", "status", "--router", rurl],
                         ["learn", "status", "--router", rurl]):
                proc, secs = run_cli(argv, timeout=120)
                status = json.loads(proc.stdout, parse_constant=no_nan)
                out[f"{argv[0]}_status"] = {"seconds": secs, "keys": sorted(status)}

            # 7. SIGTERM everything ------------------------------------------
            t0 = time.perf_counter()
            procs["autoscale"][0].send_signal(signal.SIGTERM)
            check(procs["autoscale"][0].wait(timeout=180) == 0,
                  f"the autoscaler exits 0: {tail('autoscale')}")
            check(replicas() == [], f"every replica deregistered: {replicas()}")
            last_pid = {e["replica"]: e["pid"] for e in journal(f"{tmp}/autoscale.jsonl")
                        if e["kind"] == "lifecycle_spawn"}
            check(not any(Path(f"/proc/{p}").exists() for p in last_pid.values()),
                  f"every autoscaled replica exited: {last_pid}")
            mem = {}
            for rid in sorted(spawned):
                recs = journal(f"{tmp}/replicas/replica_{rid}.jsonl")
                # run_done is journaled only on the clean way out (drained, exit 0)
                check(recs[-1]["kind"] == "run_done", f"{rid} drained: {recs[-1]}")
                mem[rid] = recs[-1].get("cuda_max_memory_allocated_bytes")
                check(sum(recs[-1]["torch_kernel_launches_total"].values()) == 0,
                      f"{rid} launched no hand kernel")
            out["replica_memory"] = {**mem, **out.pop("workers_memory")}
            router.send_signal(signal.SIGTERM)
            check(router.wait(timeout=60) == 0, f"the router exits 0: {tail('router')}")
            out["teardown_s"] = time.perf_counter() - t0
        finally:
            for name, (proc, log) in procs.items():
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
                    try:
                        proc.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                log.close()
    out["launches"] = {k: launches.get(k, 0) for k in cuda_histogram.LAUNCHES}
    check(not any(cuda_histogram.LAUNCHES.values()), "the script's process launched nothing here")
    emit(out)
    return out["launches"], publish


def fold_fit_inputs(rows: int, seed: int, dtype: torch.dtype, dev: torch.device):
    """The stacking CV's GBDT fold fits at ``rows`` develop rows, at their
    first tree level: the host bins of the 17 selected variables (256-bin
    budget, u8 ids), the 5 folds' node ids (0 on a fold's train rows, -1 on
    its test rows: K = 1) and its masked mid-fit (g, h), in ``dtype``."""
    from machine_learning_replications_tpu_torch.utils.cv import stratified_kfold_test_masks

    X, y, _ = make_cohort(n=rows, seed=seed)
    X17 = np.ascontiguousarray(X[:, selected_indices()])
    bins = binning.bin_features(X17, 256)
    train = 1.0 - stratified_kfold_test_masks(y, 5)
    node = torch.as_tensor(np.where(train > 0, 0, -1).astype(np.int32), device=dev)
    g, h = mid_fit_stats(y, seed + 7, dev)
    w = torch.as_tensor(train, dtype=dtype, device=dev)
    return (torch.as_tensor(bins.binned.astype(np.uint8), device=dev), node,
            g.to(dtype)[None] * w, h.to(dtype)[None] * w, bins.max_bins)


def phase_train_kernels(peaks: dict, seed: int, dev: torch.device) -> dict:
    """Both kernels at the shapes the ``train`` route gives them, against
    their plain versions (``compare``'s tolerance, node counts exactly), then
    timed (CUDA events, L2 flushed): the stump kernel at the reference
    member's shape (713 develop rows, every unique-value midpoint: int32
    bins, float64 statistics as the reference-size fit runs) and the node
    kernel at the fold fits' shape (5 folds in one launch, K = 1, u8 bins,
    B <= 256) at 713 rows in float64 and 50,000 rows in float32."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    binned, g, h, B = exact_inputs(713, seed, dev)
    g, h = g.double(), h.double()
    got = cuda_histogram.stump_histograms_cuda(binned, g, h, B)
    want = histogram.stump_histograms_reference(binned, g, h, B)
    mass = histogram.stump_histograms_reference(binned, g.abs(), h.abs(), B)
    torch.cuda.synchronize()
    res = compare(got, want, mass, torch.float64)
    check(res["ok"], f"stump kernel vs plain at the member's shape: {res}")
    stump = {"n": binned.shape[0], "F": binned.shape[1], "B": B, "bins": "int32",
             "vals": "float64", **res,
             **time_stump(binned, g, h, B, flush, peaks)}
    nodes = []
    for rows, dtype in ((713, torch.float64), (50_000, torch.float32)):
        bins, node, gg, hh, nb = fold_fit_inputs(rows, seed, dtype, dev)
        got = cuda_histogram.node_histograms_cuda(bins, node, gg, hh, 1, nb)
        want = histogram.node_histograms(bins, node, gg, hh, 1, nb)
        mass = histogram.node_histograms(bins, node, gg.abs(), hh.abs(), 1, nb)
        torch.cuda.synchronize()
        stats = {st: compare(getattr(got, st), getattr(want, st), getattr(mass, st), dtype)
                 for st in STATS}
        exact = bool(torch.equal(got.count, want.count))
        check(exact and all(v["ok"] for v in stats.values()),
              f"node kernel vs plain at the fold fits' shape, {rows} rows: {stats}")
        k, n = node.shape
        F = bins.shape[1]
        ids = ((torch.arange(k, device=dev)[:, None, None] * F
                + torch.arange(F, device=dev)[None, None, :]) * nb + bins.long()[None]).reshape(-1)
        active = (node >= 0).to(dtype)
        vals = torch.stack([gg, hh, gg * gg, active], dim=-1)            # [k, n, 4]
        src = vals[:, :, None, :].expand(k, n, F, 4).reshape(-1, 4).contiguous()
        lib_out = torch.zeros(k * F * nb, 4, dtype=dtype, device=dev)
        item = gg.element_size()
        nodes.append({
            "n": n, "F": F, "K": 1, "folds": k, "B": nb, "bins": "uint8",
            "vals": str(dtype).replace("torch.", ""), "counts_exact": exact,
            "max_abs_err": max(v["max_abs_err"] for v in stats.values()),
            "max_err_over_mass": max(v["max_err_over_mass"] for v in stats.values()),
            "ms": timed_ms(lambda: cuda_histogram.node_histograms_cuda(bins, node, gg, hh, 1, nb),
                           flush),
            "plain_ms": timed_ms(lambda: histogram.node_histograms(bins, node, gg, hh, 1, nb),
                                 flush, reps=20),
            "library_ms": timed_ms(lambda: lib_out.index_add_(0, ids, src), flush),
            # inputs read once (the bins once for all folds), the four [k, 1, F, B]
            # outputs written once; 4 additions per active (fold, row, feature)
            **bound(n * F + k * n * 4 + 2 * k * n * item + 4 * k * F * nb * item,
                    4 * F * int((node >= 0).sum()), peaks, str(dtype).replace("torch.", "")),
            "reps": 30, "l2": "flushed before each call"})
        del src, ids, lib_out
    del flush
    emit({"phase": "kernels", "shapes": "train", "stump_histograms": stump,
          "node_histograms": nodes})
    return {"stump_histograms": [stump], "node_histograms": nodes}


def run_cli(argv: list, timeout: int = 600, ok: tuple = (0,), env=None) -> tuple:
    """``python -m machine_learning_replications_tpu_torch *argv`` in a
    fresh process on the card from the checkout's root: ``(completed
    process, wall seconds)``; an exit code outside ``ok`` fails the script."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "machine_learning_replications_tpu_torch", *argv],
                          capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    check(proc.returncode in ok, f"cli {argv[0]} on the card: {proc.stderr[-2000:]}")
    return proc, seconds


def x_events(trace: dict) -> list:
    """The complete (``ph: "X"``) events of a Chrome trace: the spans."""
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def check_observed_train(records: list, events: list, launches: dict) -> dict:
    """``cli train --trace-dir --journal``'s journal and trace: the manifest
    first, naming the card; at least 6 ``stage_start``; ``run_done`` last,
    with graph captures and the kernel launches of the in-process fit of the
    same cohort (``launches``); every ``stage:*`` span inside ``train``. The
    git sha is not checked: a copy of the repo without ``.git`` has none."""
    man, kinds = records[0], [r["kind"] for r in records[1:]]
    check(man["kind"] == "manifest" and man["command"] == "train", f"manifest first: {man}")
    check(man.get("device") == torch.cuda.get_device_name(0), f"the card in the manifest: {man}")
    check(kinds.count("stage_start") >= 6, f"at least 6 stage_start: {kinds}")
    check(kinds[-1] == "run_done", f"run_done last: {kinds[-3:]}")
    done = records[-1]
    journaled = done["torch_kernel_launches_total"]
    check(done["torch_graph_captures_total"] > 0, f"graph captures in run_done: {done}")
    check(all(journaled.get(k, 0) == launches[k] for k in cuda_histogram.LAUNCHES),
          f"run_done's launches {journaled} equal the in-process fit's {launches}")
    root = next(e for e in events if e["name"] == "train")
    stages = [e for e in events if e["name"].startswith("stage:")]
    check(stages and all(root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
                         for e in stages), "every stage:* span inside the train span")
    return {"stage_starts": kinds.count("stage_start"), "run_done": done,
            "manifest_device": man.get("device"), "manifest_versions": man["versions"],
            "train_span_s": root["dur"] / 1e6,
            "stage_spans_s": {e["name"]: e["dur"] / 1e6 for e in stages},
            "stage_done_s": {r["stage"]: r["seconds"] for r in records
                             if r["kind"] == "stage_done"}}


def cli_line(params, dev) -> str:
    """The line ``cli predict`` prints for the example patient under ``params``."""
    from machine_learning_replications_tpu_torch import cli
    from machine_learning_replications_tpu_torch.data.examples import patient_row

    prob = cli.predict_proba1(params, patient_row(), dev)
    return f"Probability of progressive HF is: {100.0 * prob:.2f} %"


def phase_cli(rows: int, seed: int, dev) -> dict:
    """The rest of the reference CLI on the card. ``cli sweep --synthetic
    rows --save DIR`` in-process on the default grid (launch counts from 0,
    read right after) against ``cv_sweep`` through the plain version on the
    same imputed rows; ``cli predict --model DIR`` in a subprocess against
    the saved forest's line. Then ``cli import-sklearn`` of the committed
    fixture, ``predict --model`` on the import and ``predict --pkl`` on the
    fixture (subprocesses on the card), each line equal to the CPU port's,
    and the imported ensemble card against CPU on a ``[64, 17]`` batch."""
    import contextlib
    import io
    import tempfile

    from machine_learning_replications_tpu_torch import cli
    from machine_learning_replications_tpu_torch.persist import checkpoint, sklearn_import

    out = {"phase": "cli", "rows": rows}
    scratch = cuda_histogram.BUILD_DIR.parent     # git-ignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    scfg = SweepConfig()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        saved = f"{tmp}/sweep_model"
        buf = io.StringIO()
        torch.cuda.synchronize()
        cuda_histogram.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["sweep", "--synthetic", str(rows), "--seed", str(seed), "--save", saved])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = dict(cuda_histogram.LAUNCHES)
        check(rc == 0, "cli sweep exits 0")
        check(launches["node_histograms"] > 0, f"cli sweep launched the node kernel: {launches}")
        lines = buf.getvalue().strip().splitlines()
        header = [int(t) for t in lines[0].replace("m=", " ").split()[1:]]
        check(header == list(scfg.n_estimators_grid) and len(lines) == 2 + len(scfg.max_depth_grid),
              f"the default grid printed: {lines}")
        grid = np.array([[float(t) for t in ln.split()[1:]] for ln in lines[1:-1]])
        depths = [int(ln.split()[0]) for ln in lines[1:-1]]
        best = lines[-1].split()
        best_m, best_d = int(best[1].split("=")[1]), int(best[2].split("=")[1])

        # The plain version on the same imputed develop rows.
        X, y, _ = make_cohort(n=2 * rows, seed=seed, missing_rate=0.03)
        Xd, yd = X[:rows], y[:rows]
        del X, y
        _, Ximp = knn_impute.fit_transform(Xd, device=dev)
        X17 = np.ascontiguousarray(Ximp.cpu().numpy()[:, selected_indices()])
        del Ximp
        t0 = time.perf_counter()
        plain = sweep.cv_sweep(X17, yd, scfg, GBDTConfig(histogram_backend="xla"), device=dev)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(depths == list(scfg.max_depth_grid), f"depth rows {depths}")
        diff = float(np.abs(grid - plain.mean_auc).max())
        check(bool(np.isfinite(plain.fold_auc).all()) and grid.shape == plain.mean_auc.shape,
              "finite mean-AUC grids of one shape")
        check(diff <= 0.005, f"cli sweep's grid within 0.005 of the plain sweep's: {diff}")
        di, ei = scfg.max_depth_grid.index(best_d), scfg.n_estimators_grid.index(best_m)
        best_gap = plain.best_mean_auc - float(plain.mean_auc[di, ei])
        check(best_gap <= 0.005, f"the best: cell within 0.005 of the plain best: {best_gap}")

        params = checkpoint.load_model(saved, device="cpu")
        check(isinstance(params, tree.TreeEnsembleParams) and params.max_depth == best_d
              and params.feature.shape[0] == best_m, "the saved model is the best cell's forest")
        proc, predict_s = run_cli(["predict", "--model", saved])
        want = cli_line(params, torch.device("cpu"))
        got = proc.stdout.strip().splitlines()[-1]
        check(got == want, f"cli predict on the sweep's save {got!r} vs {want!r}")
        out.update(sweep_s=sweep_s, plain_sweep_s=plain_s, launches=launches,
                   grid=grid.tolist(), grid_plain=plain.mean_auc.tolist(),
                   grid_max_abs_diff=diff, best=[best_d, best_m, float(best[-1].split("=")[1])],
                   best_plain=[plain.best_max_depth, plain.best_n_estimators,
                               plain.best_mean_auc],
                   predict_saved_s=predict_s, predict_saved_line=got)

        # The committed sklearn-layout pickle: import, then both predict routes.
        fixture = str(Path(sklearn_import.__file__).resolve().parent / "testdata"
                      / "stacking_small.pkl")
        imported = f"{tmp}/imported"
        _, import_s = run_cli(["import-sklearn", "--pkl", fixture, "--out", imported])
        by_model, model_s = run_cli(["predict", "--model", imported])
        by_pkl, pkl_s = run_cli(["predict", "--pkl", fixture])
    cpu = sklearn_import.import_stacking(sklearn_import.decode_pickle(fixture), device="cpu")
    want = cli_line(cpu, torch.device("cpu"))
    lines = [p.stdout.strip().splitlines()[-1] for p in (by_model, by_pkl)]
    check(lines == [want, want], f"predict --model / --pkl on the card {lines} vs the CPU {want!r}")
    card = sklearn_import.import_stacking(sklearn_import.decode_pickle(fixture), device=dev)
    rng = np.random.default_rng(seed + 8)
    Xb = rng.normal(size=(64, 17))
    Xb[:, :10] = (Xb[:, :10] > 0.3).astype(float)
    p = stacking.predict_proba(card, Xb, device=dev).cpu()
    p_cpu = stacking.predict_proba(cpu, Xb, device="cpu")
    err = (p - p_cpu).abs()
    check(bool((err <= 1e-8 + 1e-5 * p_cpu.abs()).all()),
          f"imported ensemble card vs CPU at (1e-5, 1e-8): max abs err {err.max()}")
    out.update(import_s=import_s, predict_model_s=model_s, predict_pkl_s=pkl_s,
               import_lines=lines, import_max_abs_err_vs_cpu=err.max().item())
    emit(out)
    return launches, grid


RANK_ROWS = 500_000   # one rank's rows of the 1M-row cohort in a two-rank world
DIST_TRAIN_ROWS = 1426
# ``fit_pipeline``'s stage checkpoints, each under its own name.
PIPELINE_STAGES = ("impute", "select", "member_svc", "member_gbdt", "member_lg", "meta_svc_oof",
                   "meta_gbdt_oof", "meta_lg_oof", "meta", "quality_profile")


def phase_rank_kernels(binned, g, h, peaks: dict, seed: int, dev: torch.device) -> dict:
    """Both kernel entries at a rank's shape in a two-rank world: the stump
    entry on the first 500,000 rows of the cohort's u8 bins (float32) and the
    node entry at depth 3's last level (K = 4, int32 node ids) on the same
    rows, held to their plain versions (``compare``, node counts exactly) and
    timed as ``time_stump`` / ``time_node`` time them."""
    n, B = RANK_ROWS, 256
    bins, gg, hh = binned[:n], g[:n], h[:n]
    rng = np.random.default_rng(seed + 11)
    node = torch.as_tensor(rng.integers(-1, 4, size=n).astype(np.int32), device=dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    got = cuda_histogram.stump_histograms_cuda(bins, gg, hh, B)
    want = histogram.stump_histograms_reference(bins, gg, hh, B)
    mass = histogram.stump_histograms_reference(bins, gg.abs(), hh.abs(), B)
    torch.cuda.synchronize()
    res = compare(got, want, mass, torch.float32)
    check(res["ok"], f"stump kernel vs plain at a rank's shape: {res}")
    stump = {"n": n, "F": bins.shape[1], "B": B, "bins": "uint8", "vals": "float32", **res,
             **time_stump(bins, gg, hh, B, flush, peaks)}
    got = cuda_histogram.node_histograms_cuda(bins, node, gg, hh, 4, B)
    want = histogram.node_histograms(bins, node, gg, hh, 4, B)
    mass = histogram.node_histograms(bins, node, gg.abs(), hh.abs(), 4, B)
    torch.cuda.synchronize()
    stats = {st: compare(getattr(got, st), getattr(want, st), getattr(mass, st), torch.float32)
             for st in STATS}
    exact = bool(torch.equal(got.count, want.count))
    check(exact and all(v["ok"] for v in stats.values()),
          f"node kernel vs plain at a rank's shape: {stats}")
    nodes = {"n": n, "F": bins.shape[1], "K": 4, "B": B, "bins": "uint8", "vals": "float32",
             "counts_exact": exact,
             "max_abs_err": max(v["max_abs_err"] for v in stats.values()),
             "max_err_over_mass": max(v["max_err_over_mass"] for v in stats.values()),
             **time_node(bins, node, gg, hh, 4, B, flush, peaks)}
    del flush
    emit({"phase": "kernels", "shapes": "rank", "stump_histograms": stump,
          "node_histograms": nodes})
    return {"stump_histograms": [stump], "node_histograms": [nodes]}


def phase_leaf_kernels(peaks: dict, seed: int, dev: torch.device) -> list:
    """``leaf_sums_cuda`` (the grower's per-leaf float64 sums of g and h)
    against its plain version, the float64 ``index_add_`` pair, within 1e-12
    of each segment's sum of absolute terms, the same bits on a second
    call, then timed (CUDA events, L2 flushed) beside that pair and the
    bound: at a depth-3 fit's shape (n = 10M, k = 1, S = 16, float32, rows
    on the 8 leaves) and the ``train`` route's fold fits' (713 rows, k = 5,
    float64, depth 3, a fold's test rows parked)."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    depth = 3
    NN = 2 ** (depth + 1) - 1
    leaves = 2 ** depth
    out = []
    for n, k, dtype in ((10_000_000, 1, torch.float32), (713, 5, torch.float64)):
        node = (leaves - 1 + torch.randint(0, leaves, (k, n), generator=gen, device=dev)).int()
        if k > 1:
            test = torch.rand((k, n), generator=gen, device=dev) < 1 / k
            node = torch.where(test, -1, node)
        g = (2 * torch.rand((k, n), generator=gen, device=dev) - 1).to(dtype)
        h = (0.25 * torch.rand((k, n), generator=gen, device=dev)).to(dtype)
        got = cuda_histogram.leaf_sums_cuda(node, g, h, k, NN)
        again = cuda_histogram.leaf_sums_cuda(node, g, h, k, NN)
        want = histogram.leaf_sums(node, g, h, k, NN)
        mass = histogram.leaf_sums(node, g.abs(), h.abs(), k, NN)
        torch.cuda.synchronize()
        err = (got - want)[..., :NN].abs()
        worst = float((err / mass[..., :NN].clamp_min(1e-300)).max())
        check(worst <= 1e-12 and bool(torch.equal(got, again)),
              f"leaf-sum kernel vs the index_add_ pair at n={n}, k={k}: {worst}")
        item = g.element_size()
        out.append({
            "n": n, "k": k, "segs": k * (NN + 1), "vals": str(dtype).replace("torch.", ""),
            "max_err_over_mass": worst,
            "ms": timed_ms(lambda: cuda_histogram.leaf_sums_cuda(node, g, h, k, NN), flush),
            "plain_ms": timed_ms(lambda: histogram.leaf_sums(node, g, h, k, NN), flush),
            # node, g and h read once, the [2, k, NN + 1] float64 sums written once
            **bound(k * n * (4 + 2 * item) + 2 * k * (NN + 1) * 8, 2 * int((node >= 0).sum()),
                    peaks, "float64"),
            "reps": 30, "l2": "flushed before each call"})
        del node, g, h, got, again, want, mass
    del flush
    emit({"phase": "kernels", "shapes": "leaf_sums", "leaf_sums": out})
    return out


def record_levels(X: torch.Tensor, y: torch.Tensor, depth: int, dev) -> list:
    """One stage of a depth-``depth`` ``gbdt.fit`` of (X, y) on the card, each
    level's node-kernel inputs kept: ``[(binned, node_local, g, h, K)]``."""
    levels = []
    real = cuda_histogram.node_histograms_cuda

    def keep(binned, node_local, g, h, n_nodes, max_bins):
        levels.append((binned, node_local.clone(), g.clone(), h.clone(), n_nodes))
        return real(binned, node_local, g, h, n_nodes, max_bins)

    cuda_histogram.node_histograms_cuda = keep      # gbdt resolves it at each fit
    try:
        gbdt.fit(X, y, GBDTConfig(n_estimators=1, max_depth=depth, splitter="hist", n_bins=256),
                 device=dev)
    finally:
        cuda_histogram.node_histograms_cuda = real
    return levels


@contextlib.contextmanager
def tiled_walk():
    """The node entry's tiled walk at every K, for timing it beside the
    partitioned walk that ``node_plan`` would take."""
    real = cuda_histogram.node_plan

    def tiled(F, K, B, itemsize, budget, bin_itemsize, folds=1):
        return cuda_histogram.NodePlan(False, *cuda_histogram.tile_plan(
            F, 4, K * B, itemsize, budget, (F * bin_itemsize, 4, itemsize, itemsize)))

    cuda_histogram.node_plan = tiled        # _launch looks it up at each call
    try:
        yield
    finally:
        cuda_histogram.node_plan = real


def time_node_level(name: str, binned, node, g, h, K: int, flush, peaks: dict,
                    plain_reps: int = 3) -> dict:
    """One node launch's shape: the entry (the walk ``node_plan`` takes) and
    the tiled walk against the plain version, counts exactly; the
    partitioned walk's sums held to ``compare``'s tolerance, the tiled
    walk's largest error reported (its float32 cells sum every row a CTA
    walks, which at 10M rows passes 1e-5 of the mass: PERF.md §7).
    Then both walks timed (CUDA events, L2 flushed) beside the partition
    alone, the plain version and the bound: bins (once, shared by folds),
    node ids, g and h read once, the four ``[k, K, F, B]`` outputs written
    once, 4 additions per active (row, feature)."""
    B = 256
    n, F = binned.shape[-2:]
    k = node.shape[0] if node.dim() == 2 else 1
    dtype = g.dtype
    plan = cuda_histogram.node_plan(F, K, B, g.element_size(), cuda_histogram.smem_budget(
        binned.device), binned.element_size(), k)
    want = histogram.node_histograms(binned, node, g.double(), h.double(), K, B)
    mass = histogram.node_histograms(binned, node, g.double().abs(), h.double().abs(), K, B)
    worst = {}
    for walk in ("entry", "tiled"):
        with tiled_walk() if walk == "tiled" else contextlib.nullcontext():
            got = cuda_histogram.node_histograms_cuda(binned, node, g, h, K, B)
        torch.cuda.synchronize()
        stats = {st: compare(getattr(got, st), getattr(want, st), getattr(mass, st), dtype)
                 for st in STATS}
        check(bool(torch.equal(got.count.double(), want.count)),
              f"node counts ({walk} walk) vs plain at {name}")
        worst[walk] = max(v["max_err_over_mass"] for v in stats.values())
        if walk == "entry" and plan.partitioned:
            check(all(v["ok"] for v in stats.values()),
                  f"partitioned node walk vs plain at {name}: {stats}")
    del got, want, mass

    def entry():
        return cuda_histogram.node_histograms_cuda(binned, node, g, h, K, B)

    with tiled_walk():
        tiled_ms = timed_ms(entry, flush, reps=10)
    item = g.element_size()
    return {
        "shape": name, "n": n, "F": F, "K": K, "folds": k if node.dim() == 2 else None,
        "B": B, "bins": str(binned.dtype).replace("torch.", ""),
        "vals": str(dtype).replace("torch.", ""), "plan": plan._asdict(),
        "row_passes": cuda_histogram.node_row_passes(F, K, B, plan),
        "tiled_row_passes": cuda_histogram.row_passes(F, K * B, *cuda_histogram.tile_plan(
            F, 4, K * B, item, cuda_histogram.smem_budget(binned.device),
            (F * binned.element_size(), 4, item, item))[:2]),
        "active_share": float((node >= 0).float().mean()),
        "max_err_over_mass": worst["entry"], "tiled_max_err_over_mass": worst["tiled"],
        "ms": timed_ms(entry, flush), "tiled_ms": tiled_ms,
        "partition_ms": timed_ms(lambda: cuda_histogram.node_partition_cuda(
            binned, node, g, h, K), flush) if K >= 2 else None,
        "plain_ms": timed_ms(lambda: histogram.node_histograms(binned, node, g, h, K, B), flush,
                             reps=plain_reps, warmup=1),
        **bound(binned.numel() * binned.element_size() + k * n * (4 + 2 * item)
                + 4 * k * K * F * B * item, 4 * F * int((node >= 0).sum()), peaks,
                str(dtype).replace("torch.", "")),
        "reps": 30, "l2": "flushed before each call"}


def phase_node_levels(peaks: dict, seed: int, dev: torch.device) -> list:
    """The node entry at the shapes its walks are chosen for: the 8 levels of
    a depth-8 tree on the HIGGS configuration's 10.5M x 28 rows and the 3 of a
    depth-3 tree on the 10M x 17 cohort (each level's node ids and (g, h)
    from one stage of ``gbdt.fit`` on the card), and the 5-fold depth-3 fold
    fits' levels (K = 2, 4) at 50,000 rows in float32 and 713 in float64
    (each fold's train rows spread over the nodes at random). Each shape
    through the walk ``node_plan`` takes and through the tiled walk
    (``time_node_level``)."""
    from hfbench.gen import cohort

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    out = []
    for spec, rows, depth in (("higgs", 10_500_000, 8), ("table_s1", 10_000_000, 3)):
        X, y = cohort.gbdt_cohort(rows, seed, dev, spec_name=spec)
        levels = record_levels(X, y, depth, dev)
        del X, y
        for level, (binned, node, g, h, K) in enumerate(levels):
            out.append(time_node_level(f"{spec}_depth{depth}_level{level}", binned, node, g, h,
                                       K, flush, peaks))
            emit({"phase": "node_levels", **out[-1]})
        del levels, binned, node, g, h
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed)
    for rows, dtype in ((50_000, torch.float32), (713, torch.float64)):
        bins, node1, gg, hh, nb = fold_fit_inputs(rows, seed, dtype, dev)
        check(nb == 256, f"the fold fits' bins: {nb}")
        for K in (2, 4):
            spread = torch.randint(0, K, node1.shape, generator=gen, device=dev, dtype=torch.int32)
            node = torch.where(node1 >= 0, spread, -1)
            out.append(time_node_level(f"folds5_{rows}_K{K}", bins, node, gg, hh, K, flush,
                                       peaks, plain_reps=10))
            emit({"phase": "node_levels", **out[-1]})
    del flush
    return out


def sharded_fit_timed(mesh, Xd, yd, cfg):
    from machine_learning_replications_tpu_torch.parallel import fit_gbdt_sharded

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, aux = fit_gbdt_sharded(mesh, Xd, yd, cfg)
    torch.cuda.synchronize()
    return params, aux, time.perf_counter() - t0


# The two-rank ``cli sweep``'s grid: the first two stage counts and depths of
# the default grid, so that its fold fits run at both depths (both kernel
# entries) in a third of the default grid's time.
RANK_SWEEP_STAGES, RANK_SWEEP_DEPTHS = (25, 50), (1, 2)


def grid_of(stdout: str) -> np.ndarray:
    """The mean-AUC grid ``cli sweep`` printed (a row per depth, between the
    header and the ``best:`` line)."""
    lines = stdout.strip().splitlines()
    head = max(i for i, ln in enumerate(lines) if ln.split()[:1] == ["depth"])
    return np.array([[float(t) for t in ln.split()[1:]] for ln in lines[head + 1:-1]])


def phase_distributed(X17: np.ndarray, yf: np.ndarray, seed: int, cli_grid: np.ndarray,
                      dev) -> dict:
    """The port's data-parallel paths on the card (``parallel/``).

    A one-rank NCCL world in this process: ``fit_gbdt_sharded`` on the train
    phase's 1M x 17 float32 rows, 100 stumps (the stump trainer, u8 bins) and
    100 depth-3 trees (the level-wise trainer), cold, warm and once with
    every all-reduce timed by CUDA events; held to the single-device fits
    (forests equal but for a tie the single fit shows at depth 1, deviance
    at rtol 1e-4, AUC within 0.005); the group destroyed after. Then two
    ranks sharing the card (gloo, the launcher's variables set here) as CLI
    subprocesses, beside ``cli train`` in one process: ``train --synthetic
    1426 --mesh 2 --distributed`` (each rank's AUC line equal to the
    single-process line; each rank holds the card; rank 1, given its own
    ``--save``, writes nothing there) and the same with a depth-2 member
    on one ``--resume-dir`` both ranks share (rank 0 writes every stage)
    (under a mesh the depth-1 member's fold fits take the stump trainer, as
    in JAX; the depth-2 member and its folds the level-wise one): each
    rank's two ``run_done`` carry its peak memory and, between them, both
    kernel entries' launches, and ``sweep --synthetic 50000 --mesh 2
    --distributed`` on ``RANK_SWEEP_STAGES`` x ``RANK_SWEEP_DEPTHS`` (its grid
    within 0.005 of the same cells of the cli phase's in-process grid).
    Returns the launches: this process's and the ranks' journals'."""
    import tempfile

    from machine_learning_replications_tpu_torch.parallel import distributed, make_mesh
    from machine_learning_replications_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    out = {"phase": "distributed"}
    Xd = torch.as_tensor(X17, device=dev)
    yd = torch.as_tensor(yf, device=dev)
    check(torch.distributed.is_nccl_available(), "this torch build has NCCL")
    check(distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev),
          "a one-rank world is up")
    out["bringup"] = dict(distributed.BRINGUP)
    check(out["bringup"]["backend"] == "nccl", f"one rank, one card: NCCL {out['bringup']}")
    launches = {k: 0 for k in cuda_histogram.LAUNCHES}
    try:
        mesh = make_mesh(1, 1, device=dev)
        for name, cfg, counter in (
                ("stump", GBDTConfig(splitter="hist", n_estimators=100), "stump_histograms"),
                ("depth3", GBDTConfig(splitter="hist", max_depth=3, n_estimators=100,
                                      n_bins=256), "node_histograms")):
            cuda_histogram.reset_launch_counts()
            params, aux, cold = sharded_fit_timed(mesh, Xd, yd, cfg)
            run = dict(cuda_histogram.LAUNCHES)
            grown = cfg.n_estimators if cfg.max_depth > 1 else 0
            check(run[counter] == cfg.n_estimators * cfg.max_depth
                  and run["leaf_sums"] == grown
                  and sum(run.values()) == run[counter] + run["leaf_sums"],
                  f"one {counter} launch per tree level, one leaf_sums per grown tree: {run}")
            for k in launches:
                launches[k] += run[k]
            warm = [sharded_fit_timed(mesh, Xd, yd, cfg)[2] for _ in range(3)]
            pmesh.COLLECTIVES["all_reduce"] = 0
            with pmesh.timed() as ar_seconds:
                timed_s = sharded_fit_timed(mesh, Xd, yd, cfg)[2]
            n_ar = pmesh.COLLECTIVES["all_reduce"]
            single, single_aux, single_s = fit_timed(Xd, yd, cfg, dev)
            auc = roc_auc(yf, tree.predict_proba1(params, Xd).cpu().numpy())
            auc_single = roc_auc(yf, tree.predict_proba1(single, Xd).cpu().numpy())
            dk = torch.as_tensor(aux["train_deviance"]).double().cpu()
            ds = torch.as_tensor(single_aux["train_deviance"]).double().cpu()
            dev_rel = ((dk - ds).abs() / ds.abs()).max().item()
            check(bool(torch.isfinite(dk).all()) and dk.shape == (cfg.n_estimators,),
                  "finite deviance path")
            check(dev_rel <= 1e-4, f"sharded vs single deviance at rtol 1e-4: {dev_rel}")
            check(abs(auc - auc_single) <= 0.005, f"AUC within 0.005: {auc} {auc_single}")
            res = {"rows": int(Xd.shape[0]), "n_estimators": cfg.n_estimators,
                   "max_depth": cfg.max_depth, "launches": run, "cold_fit_s": cold,
                   "warm_fit_s": statistics.median(warm), "warm_fit_runs_s": warm,
                   "single_device_warm_fit_s": single_s, "all_reduces_per_fit": n_ar,
                   "all_reduce_s": sum(ar_seconds), "timed_fit_s": timed_s,
                   "auc": auc, "auc_single": auc_single, "deviance_max_rel_diff": dev_rel,
                   "split_feature_agreement": float((params.feature == single.feature)
                                                    .float().mean())}
            if cfg.max_depth == 1:
                res.update(forests_agree(params, single, X17, yf, dev))
            out[name] = res
    finally:
        distributed.shutdown()

    # Two ranks sharing the card, as CLI subprocesses, beside one process.
    root = Path(__file__).resolve().parent
    scratch = cuda_histogram.BUILD_DIR.parent
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        train_port, sweep_port = free_port(), free_port()
        jobs = {}
        single_env = clean_env(cpu=False)
        cmds = {"train_single": (["train", "--synthetic", str(DIST_TRAIN_ROWS), "--seed",
                                  str(seed)], single_env)}
        # Under a mesh the depth-1 member's fold fits run on the stump trainer,
        # as in JAX, so the default config launches only the stump entry; a
        # depth-2 member (its fold fits too) runs the level-wise trainer.
        Path(f"{tmp}/depth2.json").write_text(json.dumps({"gbdt": {"max_depth": 2}}))
        depth2_port = free_port()
        for r in range(2):
            cmds[f"train_r{r}"] = (["train", "--synthetic", str(DIST_TRAIN_ROWS), "--seed",
                                    str(seed), "--mesh", "2", "--distributed",
                                    "--save", f"{tmp}/save{r}", "--journal", f"{tmp}/j.jsonl"],
                                   rank_env(r, 2, train_port, cpu=False))
            cmds[f"train2_r{r}"] = (["train", "--synthetic", str(DIST_TRAIN_ROWS), "--seed",
                                     str(seed), "--config", f"{tmp}/depth2.json", "--mesh", "2",
                                     "--distributed", "--journal", f"{tmp}/j2.jsonl",
                                     "--resume-dir", f"{tmp}/stages2"],
                                    rank_env(r, 2, depth2_port, cpu=False))
            cmds[f"sweep_r{r}"] = (["sweep", "--synthetic", "50000", "--seed", str(seed),
                                    "--n-estimators", *map(str, RANK_SWEEP_STAGES),
                                    "--max-depth", *map(str, RANK_SWEEP_DEPTHS),
                                    "--mesh", "2", "--distributed"],
                                   rank_env(r, 2, sweep_port, cpu=False))
        t0 = time.perf_counter()
        for name, (argv, env) in cmds.items():
            jobs[name] = subprocess.Popen(
                [sys.executable, "-m", "machine_learning_replications_tpu_torch", *argv],
                env=env, cwd=root, stdout=open(f"{tmp}/{name}.out", "w"),
                stderr=open(f"{tmp}/{name}.err", "w"))
        held, seconds = {}, {}
        rank_jobs = {name for name in jobs if "_r" in name}
        try:  # each rank's first sight holding the card, each process's end
            while len(seconds) < len(jobs) and time.perf_counter() - t0 < 900:
                for name, p in jobs.items():
                    if name in seconds:
                        continue
                    if p.poll() is not None:
                        seconds[name] = time.perf_counter() - t0
                    elif name in rank_jobs and name not in held and holds_card(p.pid):
                        held[name] = time.perf_counter() - t0
                time.sleep(0.25)
        finally:
            for p in jobs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = {name: (Path(f"{tmp}/{name}.out").read_text(), Path(f"{tmp}/{name}.err").read_text())
                for name in jobs}
        for name, p in jobs.items():
            check(p.returncode == 0, f"{name} exits 0: {logs[name][1][-2000:]}")
        check(set(held) == rank_jobs, f"every rank held the card: {held}")
        want_line = logs["train_single"][0].strip().splitlines()[-1]
        lines = [logs[f"train_r{r}"][0].strip().splitlines()[-1] for r in range(2)]
        check(want_line.startswith("AUC-ROC") and lines == [want_line, want_line],
              f"two-rank cli train's AUC lines {lines} vs one process's {want_line!r}")
        for r in range(2):
            check("distributed runtime up (gloo: 2 ranks share 1 card" in logs[f"train_r{r}"][1],
                  f"rank {r} declares gloo for two ranks on one card")
        check(Path(f"{tmp}/save0/model.json").exists() and not Path(f"{tmp}/save1").exists(),
              "rank 0 saved; rank 1 wrote nothing into its --save")
        stages2 = sorted(os.listdir(f"{tmp}/stages2"))
        check(stages2 == sorted(["fingerprint.json", *PIPELINE_STAGES]),
              f"the depth-2 pair's shared --resume-dir holds every stage once: {stages2}")
        ranks = []
        for r in range(2):
            rank = {"rank": r}
            for run, journal in (("default", "j.jsonl"), ("depth2", "j2.jsonl")):
                with open(f"{tmp}/{journal}" + (f".rank{r}" if r else "")) as f:
                    records = [json.loads(line) for line in f]
                man, done = records[0], records[-1]
                check(man.get("rank") == r and man["distributed"]["backend"] == "gloo"
                      and done["kind"] == "run_done"
                      and done.get("cuda_max_memory_allocated_bytes", 0) > 0,
                      f"rank {r}'s {run} journal: {man} {done}")
                rl = done.get("torch_kernel_launches_total", {})
                for k in launches:
                    launches[k] += rl.get(k, 0)
                rank[run] = {"launches": rl, "manifest_distributed": man["distributed"],
                             "cuda_max_memory_allocated_bytes":
                                 done.get("cuda_max_memory_allocated_bytes")}
            check(rank["default"]["launches"].get("stump_histograms", 0) > 0
                  and rank["depth2"]["launches"].get("node_histograms", 0) > 0,
                  f"rank {r} launched both kernel entries: {rank}")
            ranks.append(rank)
        grids = [grid_of(logs[f"sweep_r{r}"][0]) for r in range(2)]
        check(np.array_equal(grids[0], grids[1]), "both sweep ranks print one grid")
        full = SweepConfig()   # the cli phase's grid: rows are depths, columns stages
        check(full.max_depth_grid[:2] == RANK_SWEEP_DEPTHS
              and full.n_estimators_grid[:2] == RANK_SWEEP_STAGES,
              "the two-rank sweep's grid is the head of the cli phase's")
        sub = cli_grid[:len(RANK_SWEEP_DEPTHS), :len(RANK_SWEEP_STAGES)]
        diff = float(np.abs(grids[0] - sub).max())
        check(grids[0].shape == sub.shape and diff <= 0.005,
              f"two-rank sweep grid within 0.005 of the in-process grid: {diff}")
    out.update(train_two_ranks={"rows": DIST_TRAIN_ROWS, "seconds": seconds,
                                "held_card_after_s": held, "auc_line": want_line, "ranks": ranks,
                                "depth2_resume_dir": stages2},
               sweep_two_ranks={"rows": 50_000, "n_estimators": RANK_SWEEP_STAGES,
                                "max_depth": RANK_SWEEP_DEPTHS, "grid": grids[0].tolist(),
                                "grid_max_abs_diff_vs_in_process": diff,
                                "best_line": logs["sweep_r0"][0].strip().splitlines()[-1]},
               launches=launches, seconds=time.perf_counter() - t_phase)
    emit(out)
    return launches


DRYRUN_RANKS = 4
DRYRUN_TIMEOUT_S = 300
# The dry run's per-rank kernel shapes (n, F, B): phases 2, 3, 6 and 9 give a
# rank 48 of the 96-row cohort's rows at 256 or 16 bins, phase 8 64 of the
# 128-row sweep cohort's 6 columns.
DRYRUN_SHAPES = ((48, 17, 256), (48, 17, 16), (64, 6, 256), (64, 6, 16))


def hold_dryrun_shapes(dev, seed: int) -> list:
    """Both kernel entries at ``DRYRUN_SHAPES`` (K = 4 nodes, int32 ids with
    inactive rows), held to their plain versions (``compare``, node counts
    exactly): the ranks hold their sharded fits to plain single-device fits,
    and these hold the kernel itself at the rows a rank gives it."""
    rng = np.random.default_rng(seed + 17)
    out = []
    for n, F, B in DRYRUN_SHAPES:
        bins = torch.as_tensor(rng.integers(0, B, size=(n, F)).astype(np.uint8), device=dev)
        gg, hh = mid_fit_stats((rng.random(n) < 0.3).astype(np.float64), seed + n + B, dev)
        node = torch.as_tensor(rng.integers(-1, 4, size=n).astype(np.int32), device=dev)
        got = cuda_histogram.stump_histograms_cuda(bins, gg, hh, B)
        want = histogram.stump_histograms_reference(bins, gg, hh, B)
        mass = histogram.stump_histograms_reference(bins, gg.abs(), hh.abs(), B)
        gn = cuda_histogram.node_histograms_cuda(bins, node, gg, hh, 4, B)
        wn = histogram.node_histograms(bins, node, gg, hh, 4, B)
        mn = histogram.node_histograms(bins, node, gg.abs(), hh.abs(), 4, B)
        torch.cuda.synchronize()
        stump = compare(got, want, mass, torch.float32)
        stats = [compare(getattr(gn, st), getattr(wn, st), getattr(mn, st), torch.float32)
                 for st in STATS]
        exact = bool(torch.equal(gn.count, wn.count))
        check(stump["ok"] and exact and all(v["ok"] for v in stats),
              f"both kernel entries vs plain at the dry run's shape {(n, F, B)}: "
              f"{stump} {stats} counts exact {exact}")
        out.append({"n": n, "F": F, "B": B, "stump_max_abs_err": stump["max_abs_err"],
                    "node_max_abs_err": max(v["max_abs_err"] for v in stats)})
    return out


def phase_dryrun(dev) -> dict:
    """The dry run and the flagship entry on the card (``graft_entry``).
    ``dryrun_multichip(4)``: four ranks sharing the card as a ``(2, 2)`` mesh on gloo (the bring-up's
    rule: NCCL refuses two ranks on one device), JAX's ten phases in float32,
    each rank holding its results to rank 0's and rank 0 to the single-device
    fits, whose histograms run the plain version. Gates: exit 0; each rank's ten timed phase lines; every rank declares
    gloo, holds the card and launched both kernel entries; the phases' seconds
    and the total; both kernel entries at the ranks' shapes against their plain
    versions (``hold_dryrun_shapes``). Then ``entry()``'s forward on the card against the CPU
    port's (``entry(device="cpu")``) at (1e-5, 1e-8), rows summing to 1.
    Returns the launches: this process's (the flagship fit) and the ranks'."""
    import re

    from machine_learning_replications_tpu_torch import graft_entry

    t_phase = time.perf_counter()
    out = {"phase": "dryrun", "ranks": DRYRUN_RANKS}
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(DRYRUN_RANKS, timeout_s=DRYRUN_TIMEOUT_S,
                                         stream=sys.stderr)
    out["dryrun_multichip_s"] = time.perf_counter() - t0
    launches = {k: 0 for k in cuda_histogram.LAUNCHES}
    ranks = []
    for r in range(DRYRUN_RANKS):
        done = [ln for ln in lines if f" rank {r}] phase " in ln and " done: " in ln]
        phases = {int(m.group(1)): float(m.group(2)) for m in (
            re.search(r"phase (\d+) done: .*\((\d+\.\d+)s\)$", ln) for ln in done) if m}
        check(sorted(phases) == list(range(10)), f"rank {r} printed ten timed phase lines: {done}")
        reports = [json.loads(ln.split(" report ", 1)[1]) for ln in lines
                   if f" rank {r}] report " in ln]
        check(len(reports) == 1, f"rank {r} reported once: {reports}")
        rep = reports[0]
        check(rep["backend"] == "gloo" and "share 1 card" in rep["reason"]
              and rep["device"].startswith("cuda") and rep["holds_card"],
              f"rank {r} declares gloo and holds the card: {rep}")
        check(all(rep["launches"].get(k, 0) > 0 for k in ("stump_histograms", "node_histograms")),
              f"rank {r} launched both kernel entries: {rep['launches']}")
        for k in launches:
            launches[k] += rep["launches"].get(k, 0)
        ranks.append({**rep, "phase_seconds": phases})
    total = [float(m.group(1)) for m in (re.search(r"dryrun_multichip OK in (\d+\.\d+)s", ln)
                                         for ln in lines) if m]
    world = [float(m.group(1)) for m in (re.search(r"all \d+ ranks exited 0 in (\d+\.\d+)s", ln)
                                         for ln in lines) if m]
    check(len(total) == 1 and len(world) == 1, "the total and the world's seconds are printed")
    out.update(rank_reports=ranks, rank0_total_s=total[0], world_s=world[0],
               phase8=[ln.split("phase 8 done: ", 1)[1] for ln in lines
                       if " rank 0] phase 8 done: " in ln][0])

    out["kernel_holds"] = hold_dryrun_shapes(dev, 2020)

    # The flagship forward step, card against CPU.
    cuda_histogram.reset_launch_counts()
    t0 = time.perf_counter()
    fn, (params, X) = graft_entry.entry()
    got = fn(params, X)
    torch.cuda.synchronize()
    out["entry_s"] = time.perf_counter() - t0
    here = dict(cuda_histogram.LAUNCHES)
    fn_c, (params_c, X_c) = graft_entry.entry(device="cpu")
    want = fn_c(params_c, X_c)
    got = got.cpu()
    err = (got.double() - want.double()).abs()
    check(got.shape == (64, 2) and bool(torch.isfinite(got).all())
          and bool((err <= 1e-8 + 1e-5 * want.double().abs()).all()),
          f"entry()'s forward on the card equals the CPU port's at (1e-5, 1e-8): {err.max()}")
    check(bool(((got.double().sum(dim=1) - 1).abs() <= 1e-5).all()), "entry() rows sum to 1")
    out["entry"] = {"max_abs_err_vs_cpu": float(err.max()), "launches": here}
    for k in launches:
        launches[k] += here.get(k, 0)
    out.update(launches=launches, seconds=time.perf_counter() - t_phase)
    emit(out)
    return launches


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over the tensor's scale (its largest |want|)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def fit_pipeline_timed(X, y, cfg, dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, info = pipeline.fit_pipeline(X, y, cfg, device=dev)
    torch.cuda.synchronize()
    return params, info, time.perf_counter() - t0


def svc_solves(info: dict) -> dict:
    """Per SVC stage: each batched dual solve's lanes and its most steps."""
    return {k: [{"lanes": len(v), "max_steps": max(v), "min_steps": min(v)} for v in runs]
            for k, runs in info["svc_iterations"].items()}


def phase_train_pipeline(seed: int, scaled_rows: int, dev) -> dict:
    """The reference's ``train`` route: ``fit_pipeline`` (1-NN impute →
    LassoCV top-17 → stacking fit with 5-fold CV → quality profile) on the
    CLI's cohort halves (``make_cohort(1426, missing_rate=0.03)``: 713
    develop rows, 713 select rows, all 64 variables, ``ExperimentConfig()``,
    float64) on the card, cold then one traced warm fit with stage seconds and
    the SVC solves' steps; held to the same fit
    by the CPU port (masks, donors, forests but for a tie, every member and
    the meta-LR within 1e-6 relative, select-half p1 within 1e-6, AUC within
    0.005); ``cli train --trace-dir --journal`` then ``cli predict`` in
    subprocesses on the card (``check_observed_train``); then the scaled fit on ``scaled_rows`` develop rows of
    ``make_cohort(2 · scaled_rows)``, float32, once. Returns each fit's
    launch counts by its develop rows."""
    import tempfile

    from machine_learning_replications_tpu_torch.config import ExperimentConfig
    from machine_learning_replications_tpu_torch.persist import checkpoint
    from machine_learning_replications_tpu_torch.utils import metrics

    cfg = ExperimentConfig()
    n = 713
    X, y, _ = make_cohort(n=2 * n, seed=seed, missing_rate=0.03)
    Xd, yd, Xs, ys = X[:n], y[:n], X[n:], y[n:]
    out = {"phase": "train_pipeline", "rows": n, "select_rows": n, "variables": 64,
           "dtype": "float64", "config": "ExperimentConfig()"}

    # The main path's run: counts from 0, read right after.
    cuda_histogram.reset_launch_counts()
    params, info, cold = fit_pipeline_timed(Xd, yd, cfg, dev)
    launches = dict(cuda_histogram.LAUNCHES)
    check(launches["stump_histograms"] == cfg.gbdt.n_estimators,
          f"one stump launch per stage of the GBDT member: {launches}")
    check(launches["node_histograms"] == cfg.gbdt.n_estimators * cfg.gbdt.max_depth,
          f"one node launch per level of the 5 fold fits together: {launches}")
    # A warm fit under a span tracer: each stage:* span against the fit's
    # own stage_seconds. The stages are timed by their
    # spans, so this holds only that the trace and stage_seconds are one
    # interval; that span exit waits for the card is checked by the card
    # test test_span_waits_for_a_graph_replayed_solver_block.
    warm = []
    tracer = spans.Tracer(process_name="chip_smoke fit_pipeline")
    spans.set_tracer(tracer)
    try:
        warm.append(fit_pipeline_timed(Xd, yd, cfg, dev))
    finally:
        spans.set_tracer(None)
    stage_spans = {e["name"][len("stage:"):]: e["dur"] / 1e6 for e in x_events(tracer.export())
                   if e["name"].startswith("stage:")}
    stage_secs = warm[-1][1]["stage_seconds"]
    check(set(stage_spans) == set(stage_secs), f"a span per stage: {stage_spans} {stage_secs}")
    span_gap = max(abs(stage_spans[k] - stage_secs[k]) for k in stage_secs)
    check(span_gap <= 1e-3, f"stage spans within 1e-3 s of stage_seconds: {span_gap}")
    t0 = time.perf_counter()
    cpu, cpu_info = pipeline.fit_pipeline(Xd, yd, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0

    check(torch.equal(params.support_mask.cpu(), cpu.support_mask), "support masks equal")
    check(same_params(params.imputer, cpu.imputer), "imputer donors and means equal")
    agree = forests_agree(params.ensemble.gbdt, convert.params_to(cpu.ensemble.gbdt, dev),
                          np.ascontiguousarray(
                              pipeline.impute_select(cpu, Xd).numpy()), yd, dev)
    errs = {f"svc.{f}": rel_err(getattr(params.ensemble.svc, f), getattr(cpu.ensemble.svc, f))
            for f in ("dual_coef", "intercept", "prob_a", "prob_b")}
    for m in ("logreg", "meta"):
        for f in ("coef", "intercept"):
            errs[f"{m}.{f}"] = rel_err(getattr(getattr(params.ensemble, m), f),
                                       getattr(getattr(cpu.ensemble, m), f))
    check(all(v <= 1e-6 for v in errs.values()), f"card members within 1e-6 relative: {errs}")
    p1 = pipeline.pipeline_predict_proba1(params, Xs, device=dev).cpu().double()
    p1_cpu = pipeline.pipeline_predict_proba1(cpu, Xs, device="cpu").double()
    p1_err = float((p1 - p1_cpu).abs().max())
    check(p1.shape == (n,) and bool(torch.isfinite(p1).all()), "finite [713] probabilities")
    check(p1_err <= 1e-6, f"select-half p1 within 1e-6 of the CPU port: {p1_err}")
    auc, auc_cpu = roc_auc(ys, p1.numpy()), roc_auc(ys, p1_cpu.numpy())
    check(abs(auc - auc_cpu) <= 0.005, f"AUC within 0.005: {auc} {auc_cpu}")
    auc_line = (f"AUC-ROC {float(metrics.roc_auc(ys, p1.numpy())):.4f}   average precision "
                f"{float(metrics.average_precision(ys, p1.numpy())):.4f}")
    out.update(launches=launches, cold_s=cold, warm_s=statistics.median(w[2] for w in warm),
               warm_runs_s=[w[2] for w in warm], stage_seconds_cold=info["stage_seconds"],
               stage_seconds_warm=[w[1]["stage_seconds"] for w in warm],
               traced_warm_stage_spans_s=stage_spans, traced_stage_span_max_gap_s=span_gap,
               svc_solves=svc_solves(info), cpu_port_s=cpu_s,
               cpu_stage_seconds=cpu_info["stage_seconds"], member_rel_err=errs,
               p1_max_abs_err=p1_err, auc=auc, auc_cpu=auc_cpu, auc_line=auc_line,
               n_selected=info["n_selected"], alpha_=info["selection"]["alpha_"], **agree)

    # cli train on the card (its own process, traced and journaled), then cli
    # predict on what it saved.
    scratch = cuda_histogram.BUILD_DIR.parent     # git-ignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        model = f"{tmp}/model"
        runs = {}
        for name, argv in (("train", ["train", "--synthetic", str(n), "--seed", str(seed),
                                      "--save", model, "--trace-dir", f"{tmp}/trace",
                                      "--journal", f"{tmp}/journal.jsonl"]),
                           ("predict", ["predict", "--model", model])):
            runs[name] = run_cli(argv)
        saved = checkpoint.load_model(model, device="cpu")
        with open(f"{tmp}/journal.jsonl") as f:
            records = [json.loads(line) for line in f]
        with open(f"{tmp}/trace/trace.json") as f:
            trace_events = x_events(json.load(f))
    out["cli_train_observed"] = check_observed_train(records, trace_events, launches)
    train_lines = runs["train"][0].stdout.strip().splitlines()
    check(train_lines[-1] == auc_line,
          f"cli train's line {train_lines[-1]!r} vs the in-process card fit's {auc_line!r}")
    cpu_line = cli_line(saved, torch.device("cpu"))
    card_line = runs["predict"][0].stdout.strip().splitlines()[-1]
    check(card_line == cpu_line, f"cli predict on the card {card_line!r} vs the CPU port "
                                 f"{cpu_line!r}")
    out.update(cli_train_s=runs["train"][1], cli_predict_s=runs["predict"][1],
               cli_report=train_lines[-8:], cli_predict_line=card_line)

    # The scaled fit: the SVC subsample regime, the member at B ≈ n, the fold
    # fits over every row; float32, once.
    X, y, _ = make_cohort(n=2 * scaled_rows, seed=seed)
    X32 = np.ascontiguousarray(X, dtype=np.float32)
    del X
    Xd, yd, Xs, ys = X32[:scaled_rows], y[:scaled_rows], X32[scaled_rows:], y[scaled_rows:]
    cfg = dataclasses.replace(cfg, svc=dataclasses.replace(cfg.svc, max_rows=SCALED_SVC_ROWS))
    cuda_histogram.reset_launch_counts()
    big, big_info, big_s = fit_pipeline_timed(Xd, yd, cfg, dev)
    big_launches = dict(cuda_histogram.LAUNCHES)
    check(big_launches["stump_histograms"] == cfg.gbdt.n_estimators
          and big_launches["node_histograms"] == cfg.gbdt.n_estimators,
          f"the scaled fit's launches: {big_launches}")
    check(all(bool(torch.isfinite(t).all()) for t in (
        big.ensemble.svc.dual_coef, big.ensemble.svc.intercept, big.ensemble.svc.prob_a,
        big.ensemble.svc.prob_b, big.ensemble.gbdt.value, big.ensemble.logreg.coef,
        big.ensemble.meta.coef, big.ensemble.meta.intercept)), "finite scaled-fit parameters")
    X17 = pipeline.impute_select(big, Xd)
    gcfg = gbdt.scaled_member_cfg(cfg.gbdt, *X17.shape)
    plain, _ = gbdt.fit(X17.cpu().numpy(), yd, dataclasses.replace(gcfg, histogram_backend="xla"),
                        device=dev)
    big_agree = forests_agree(big.ensemble.gbdt, plain, X17.cpu().numpy(), yd, dev)
    p1_big = pipeline.pipeline_predict_proba1(big, Xs, device=dev).cpu().double()
    check(bool(torch.isfinite(p1_big).all()), "finite scaled-fit probabilities")
    out["scaled"] = {
        "rows": scaled_rows, "select_rows": scaled_rows, "dtype": "float32",
        "member_splitter": gcfg.splitter, "svc_max_rows": cfg.svc.max_rows,
        "launches": big_launches, "seconds": big_s, "stage_seconds": big_info["stage_seconds"],
        "svc_solves": svc_solves(big_info), "auc": roc_auc(ys, p1_big.numpy()),
        "member_vs_plain": big_agree}
    emit(out)
    return {n: launches, scaled_rows: big_launches}


def main(argv=None) -> int:
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000, help="cohort rows for the fits")
    ap.add_argument("--sweep-rows", type=int, default=50_000,
                    help="cohort rows for the CV sweep (bench.py config 4's default)")
    ap.add_argument("--seed", type=int, default=2020, help="seed of the cohort and parameters")
    ap.add_argument("--node-levels", action="store_true",
                    help="run only the device, build and node_levels phases")
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
    if args.node_levels:
        phase_node_levels(peaks, args.seed, dev)
        print(info["nvidia_smi"], flush=True)
        emit({"ok": True, "phase_seconds": time.perf_counter() - t_start})
        return 0

    X, y, _ = make_cohort(n=args.rows, seed=args.seed)
    X17 = np.ascontiguousarray(X[:, selected_indices()], dtype=np.float32)
    yf = np.asarray(y, dtype=np.float32)
    del X, y
    binned, g, h = stage_inputs(X17, yf, args.seed, dev)
    kern = {"stump_histograms": phase_kernels(binned, g, h, peaks, args.seed, dev),
            "node_histograms": phase_node_kernels(binned, g, h, peaks, args.seed, dev)}
    del binned, g, h
    kern["stump_histograms"]["exact_shapes"] = phase_exact_kernels(peaks, args.seed, dev)
    for name, shapes in phase_train_kernels(peaks, args.seed, dev).items():
        kern[name]["train_shapes"] = shapes
    binned, g, h = stage_inputs(X17, yf, args.seed, dev)
    for name, shapes in phase_rank_kernels(binned, g, h, peaks, args.seed, dev).items():
        kern[name]["rank_shapes"] = shapes
    del binned, g, h
    leaf = phase_leaf_kernels(peaks, args.seed, dev)
    kern["node_histograms"]["level_shapes"] = phase_node_levels(peaks, args.seed, dev)
    torch.cuda.empty_cache()

    # The main path, one phase at a time: counts from 0 before, read after.
    phase_s = {"kernels": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t0
        return out

    gbdt_params, train_launches = timed("train", phase_train, X17, yf, dev)
    runs = [train_launches, timed("train_depth", phase_train_depth, X17, yf, dev)]
    runs.append(timed("fit_exact", phase_fit_exact, args.seed, dev))
    runs.append(timed("sweep", phase_sweep, args.sweep_rows, args.seed, dev))
    runs.append(timed("serve", phase_serve, gbdt_params, X17, args.seed, dev))
    runs.append(timed("predict", phase_predict, gbdt_params, X17, args.seed, dev))
    serve_launches, ready_s = timed("serve_http", phase_serve_http, gbdt_params, X17,
                                    args.seed, dev)
    runs.append(serve_launches)
    runs.append(timed("score", phase_score, gbdt_params, X17, args.seed, dev))
    runs.append(timed("learn", phase_learn, gbdt_params, X17, args.seed, dev))
    scratch = cuda_histogram.BUILD_DIR.parent     # git-ignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as keep:
        fleet_launches, publish = timed("fleet", phase_fleet, gbdt_params, X17, args.seed,
                                        ready_s, keep, dev)
        runs.append(fleet_launches)
        runs.append(timed("aot", phase_aot, f"{keep}/model", publish, args.seed, dev))
    cli_launches, cli_grid = timed("cli", phase_cli, args.sweep_rows, args.seed, dev)
    runs.append(cli_launches)
    runs.append(timed("distributed", phase_distributed, X17, yf, args.seed, cli_grid, dev))
    runs.append(timed("dryrun", phase_dryrun, dev))
    per_fit = timed("train_pipeline", phase_train_pipeline, args.seed, SCALED_ROWS, dev)
    runs.extend(per_fit.values())
    launches = {name: sum(run.get(name, 0) for run in runs) for name in (*kern, "leaf_sums")}
    # Each kernel shape a fit_pipeline reaches carries the launches that fit
    # (of that many develop rows) was read to make above.
    for name, k in kern.items():
        for e in k.get("exact_shapes", []) + k.get("train_shapes", []):
            if e["n"] in per_fit:
                e["launches_per_fit_pipeline"] = per_fit[e["n"]][name]
    for name, count in launches.items():
        check(count > 0, f"the main path launched the {name} kernel")

    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "phase_seconds": phase_s})
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNELS[name], "launches": launches[name],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        **{group: [{key: e[key] for key in SHAPE_KEYS if key in e} for e in k[group]]
           for group in ("exact_shapes", "train_shapes", "rank_shapes", "level_shapes")
           if group in k},
    } for name, k in kern.items()] + [{
        "name": "leaf_sums", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "none (the grower's float64 index_add_ pair)",
        "launches": launches["leaf_sums"], "shapes": leaf}]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fixed-shape blocks of solver steps on the card.

The iterative solvers (FISTA in ``models/solvers``, the SVC dual in
``models/svm``) advance every lane through blocks of a fixed number of
steps, and the host asks whether any lane still runs once a block.
``run_blocks`` replays such a block as one CUDA graph; ``momentum_table``
holds FISTA's extrapolation weights, which every running lane shares.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from machine_learning_replications_tpu_torch.obs import torchmon


def _host_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@functools.lru_cache(maxsize=8)
def _momentum_host(n_steps: int, dt) -> np.ndarray:
    """FISTA's extrapolation weights ``β_k = (t_k − 1) / t_{k+1}`` with
    ``t_0 = 1``, ``t_{k+1} = (1 + sqrt(1 + 4 t_k²)) / 2``, for k < n_steps,
    in numpy type ``dt`` (IEEE arithmetic, rounded as the device rounds)."""
    out = np.empty(n_steps, dt)
    tk = dt(1.0)
    for k in range(n_steps):
        t_new = dt(dt(0.5) * (dt(1.0) + np.sqrt(dt(1.0) + dt(4.0) * tk * tk)))
        out[k] = dt((tk - dt(1.0)) / t_new)
        tk = t_new
    out.setflags(write=False)
    return out


def momentum_table(n_steps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``_momentum_host`` as a tensor. ``t_k`` depends only on the step
    count, and every lane still running has taken the same number of steps
    (a stopped lane never resumes), so all running lanes share ``β_k``."""
    return torch.tensor(_momentum_host(n_steps, _host_dtype(dtype)), device=device)


def run_blocks(block, n_blocks: int, running, device: torch.device) -> None:
    """Run ``block()`` — one fixed-shape block of steps that advances its
    state tensors in place — up to ``n_blocks`` times, while ``running()``
    (one host sync) says some lane still runs.

    On a CUDA device the first block runs eagerly on a side stream (which
    also warms cuBLAS there), the block is then captured once into a CUDA
    graph and replayed: one launch per block where eager PyTorch pays one
    per operation (a dual step's projection alone is 64 bisection steps).
    The replayed kernels are the eager ones, so the numbers are too. Each
    capture counts in ``torch_graph_captures_total`` (``obs.torchmon``)."""
    replay = block
    first = 0
    if device.type == "cuda" and n_blocks > 1 and running():
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            block()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                block()
            finally:
                graph.capture_end()
        torchmon.record_graph_capture()
        torch.cuda.current_stream(device).wait_stream(side)
        replay, first = graph.replay, 1
    for _ in range(first, n_blocks):
        if not running():
            break
        replay()

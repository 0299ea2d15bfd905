"""Runtime accounting of the port's device work, into the metrics registry.

The counterpart of the JAX package's ``obs/jaxmon.py``. JAX reports its
compiles through ``jax.monitoring``; the port's equivalents of a compile are
a CUDA-graph capture and an ``nvcc`` build of a hand-written kernel, and its
kernel launches are counted where they happen. ``install`` declares the
families, and the instrumented call sites feed them:

  ``torch_graph_captures_total``        counter — CUDA graphs captured
                                        (``ops.steps.run_blocks``, the
                                        serving engine's buckets)
  ``torch_kernel_builds_total``         counter — ``nvcc`` builds of a hand
                                        kernel (``ops.cuda_histogram.build``)
  ``torch_kernel_build_seconds_total``  counter — seconds inside those builds
  ``torch_kernel_launches_total{kernel=...}``
                                        counter — hand-kernel launches by
                                        wrapper (``ops.cuda_histogram``)
  ``torch_transfer_bytes_total{direction=...}``
                                        counter — host/device bytes moved
                                        through ``device_put`` / ``device_get``
                                        (checkpoint loads h2d, ``device.to_host``
                                        d2h) and the bulk scorer's pinned
                                        copies (``score.pipeline.ChunkScorer``)
                                        only. The models' own
                                        ``torch.as_tensor(..., device=)``
                                        uploads are NOT counted, so this is
                                        a subset of the traffic, not a total

Before ``install`` every hook is a no-op, so call sites stay unconditional;
``install`` is idempotent, and no hook ever raises (an accounting hook that
can fail a fit is worse than none). ``totals`` is what a CLI run journals in
its ``run_done`` record.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from machine_learning_replications_tpu_torch.obs.registry import REGISTRY, MetricsRegistry

_installed = False
_families: dict[str, Any] = {}
_bound_registry: MetricsRegistry | None = None


def _declare(registry: MetricsRegistry) -> dict[str, Any]:
    return {
        "graph_captures": registry.counter(
            "torch_graph_captures_total",
            "CUDA graphs captured (ops.steps.run_blocks).",
        ),
        "kernel_builds": registry.counter(
            "torch_kernel_builds_total",
            "nvcc builds of a hand-written kernel.",
        ),
        "kernel_build_seconds": registry.counter(
            "torch_kernel_build_seconds_total",
            "Seconds spent in nvcc builds of hand-written kernels.",
        ),
        "kernel_launches": registry.counter(
            "torch_kernel_launches_total",
            "Hand-written kernel launches by wrapper.",
            labels=("kernel",),
        ),
        "transfer_bytes": registry.counter(
            "torch_transfer_bytes_total",
            "Host/device bytes through obs.torchmon.device_put / device_get "
            "(checkpoint loads h2d, device.to_host d2h) and the bulk scorer's "
            "pinned copies only; the models' own uploads are not counted.",
            labels=("direction",),
        ),
    }


def install(registry: MetricsRegistry | None = None) -> dict[str, Any]:
    """Declare the families (once per process) and return them. The hooks
    write through one registry for the process lifetime (the one the first
    ``install`` names; default the global ``REGISTRY``); a later call naming
    a different registry is an error, as in ``obs.jaxmon``."""
    global _installed, _families, _bound_registry
    reg = registry or REGISTRY
    if _installed:
        if reg is not _bound_registry:
            raise ValueError(
                "obs.torchmon is already installed against a different registry; "
                "its hooks bind once per process"
            )
        return _families
    _families = _declare(reg)
    _bound_registry = reg
    _installed = True
    return _families


def _inc(key: str, n: int | float = 1, **labels: str) -> None:
    fam = _families.get(key)
    if fam is None or not n:
        return
    try:
        fam.labels(**labels).inc(n)
    except Exception:  # noqa: BLE001 — never fail device work from a hook
        pass


def record_graph_capture() -> None:
    _inc("graph_captures")


def record_kernel_build(seconds: float) -> None:
    _inc("kernel_builds")
    _inc("kernel_build_seconds", float(seconds))


def record_launch(kernel: str) -> None:
    _inc("kernel_launches", kernel=kernel)


def record_transfer(direction: str, nbytes: int) -> None:
    """Account ``nbytes`` of host↔device traffic (direction 'h2d'/'d2h')."""
    _inc("transfer_bytes", int(nbytes), direction=direction)


def device_put(x: Any, device: torch.device) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)``, accounting the bytes as h2d
    when a host value lands on a CUDA device."""
    t = torch.as_tensor(x, device=device)
    if t.device.type == "cuda" and not (isinstance(x, torch.Tensor) and x.device.type == "cuda"):
        record_transfer("h2d", t.numel() * t.element_size())
    return t


def device_get(x: Any) -> np.ndarray:
    """A tensor on any device as a host numpy array, accounting the bytes
    as d2h when it came from a CUDA device."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    out = x.detach().cpu().numpy()
    if x.device.type == "cuda":
        record_transfer("d2h", out.nbytes)
    return out


def _value(key: str):
    fam = _families.get(key)
    if fam is None:
        return 0
    return fam.get().value


def compile_count() -> int:
    """CUDA graphs captured so far in the process (0 before ``install``) —
    the port's counterpart of the JAX compile count the batcher samples
    around a flush when its engine keeps no count of its own."""
    return int(_value("graph_captures"))


def _by_label(key: str) -> dict:
    fam = _families.get(key)
    if fam is None:
        return {}
    return {values[0]: child.value for values, child in fam.collect()}


def totals() -> dict:
    """The process-lifetime counts (zeros before ``install``), keyed by
    family name; labeled families as ``{label value: count}``."""
    return {
        "torch_graph_captures_total": _value("graph_captures"),
        "torch_kernel_builds_total": _value("kernel_builds"),
        "torch_kernel_build_seconds_total": round(float(_value("kernel_build_seconds")), 3),
        "torch_kernel_launches_total": _by_label("kernel_launches"),
        "torch_transfer_bytes_total": _by_label("transfer_bytes"),
    }

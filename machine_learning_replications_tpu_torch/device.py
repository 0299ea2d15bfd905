"""Device resolution and the float32 matmul-precision pin.

Every entry point of the port takes ``device=``. ``None`` means the card:
when CUDA is absent that raises instead of quietly running on the CPU, so a
measurement can never be taken on the wrong device. Callers that want the
CPU (the tests) say so with ``device="cpu"``.

The JAX package runs its matrix products at ``Precision.HIGHEST``. On the
card PyTorch may route float32 products through TF32 (about three decimal
digits), which would break GPU-vs-CPU parity of the SVC member's RBF kernel
and the linear members; ``pin_matmul_precision`` turns that off for both
cuBLAS and cuDNN, and ``resolve_device`` applies it whenever it hands out a
CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch


def pin_matmul_precision() -> None:
    """Full-precision float32 products everywhere (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """``None`` → the current CUDA device, or ``RuntimeError`` without one.

    A CUDA device comes back with its index filled in, so it compares equal
    to ``tensor.device`` of the tensors placed on it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        pin_matmul_precision()
    return dev


def float_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The floating dtype JAX's promotion gives these operands (at least
    float32; float64 as soon as any operand is float64)."""
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def to_host(a) -> np.ndarray:
    """A tensor on any device, or anything array-like, as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)

"""Stage progress lines and the NaN guard.

Port of the JAX package's ``utils/trace.py`` (its phase timer and profiler
capture have no counterpart here: ``obs.spans`` times phases, and
``obs.profiler`` captures the device):

  * ``stage_say`` — the stage runner's timestamped stderr progress line;
  * ``nan_guard`` — the counterpart of ``jax_debug_nans``: raise
    ``FloatingPointError`` at the first operation whose floating output
    holds a NaN (a transfer between host and card is not checked, as JAX
    does not check ``device_put``).

PyTorch has no switch of that kind (``torch.autograd.detect_anomaly``
covers backward passes only), so ``nan_guard`` is a
``TorchDispatchMode`` that checks every operation's output as it runs.
Each check reads one flag back from the device, so a guarded region runs
op by op, as XLA re-runs a computation de-optimised under
``jax_debug_nans``. A CUDA graph would replay its kernels unchecked, so
nothing captures one under the guard: ``ops.steps.run_blocks`` steps its
blocks eagerly, and any other capture raises (``refuse_capture``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Iterator


def stage_say(msg: str) -> None:
    """One timestamped stderr progress line of the stage runner
    (``obs.journal.stage_scope``), flushed, in the JAX package's format:
    ``[pipeline <ISO-8601 UTC>] <msg>``. Opt out with ``MLR_TPU_PROGRESS=0``
    (the JAX package's switch, so one setting quiets both)."""
    if os.environ.get("MLR_TPU_PROGRESS", "1") == "0":
        return
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    print(f"[pipeline {stamp}] {msg}", file=sys.stderr, flush=True)


_guards = threading.local()  # .depth: the guards entered on this thread


def nan_guard_active() -> bool:
    """Whether a ``nan_guard`` is in force on this thread (the dispatch
    mode stack, like the guard, is per thread)."""
    return getattr(_guards, "depth", 0) > 0


def refuse_capture(what: str) -> None:
    """Raise where ``what`` would capture a CUDA graph under ``nan_guard``:
    a replayed graph's kernels would escape the guard's checks."""
    if nan_guard_active():
        raise RuntimeError(
            f"{what} would capture a CUDA graph inside nan_guard, whose checks a graph "
            "replay skips; leave the guard first")


def _nan_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    aten = torch.ops.aten
    lifts = (aten.lift_fresh.default, aten.lift_fresh_copy.default)

    def transfer(func, args, kwargs) -> bool:
        """A host array taken in, or a copy from one device to another:
        ``jax_debug_nans`` leaves ``device_put`` unchecked, so a host array
        with NaN by design (a calibration bin without rows) may go to the
        card. A cast on one device is checked, as JAX checks ``astype``."""
        if func in lifts:
            return True
        if func is aten._to_copy.default:
            dev = kwargs.get("device")
            return dev is not None and torch.device(dev) != args[0].device
        if func is aten.copy_.default:
            return args[0].device != args[1].device
        return False

    class _NanCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if transfer(func, args, kwargs):
                return out
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func} (nan_guard)")
            return out

    return _NanCheck()


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError``, naming the operation, at the first
    operation inside the scope whose floating output holds a NaN
    (``jax_debug_nans``). ``enable=False`` is inert. Guards nest; each
    exit, raising or not, restores the state it found."""
    if not enable:
        yield
        return
    _guards.depth = getattr(_guards, "depth", 0) + 1
    try:
        with _nan_mode():
            yield
    finally:
        _guards.depth -= 1

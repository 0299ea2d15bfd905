"""Multi-process bring-up on ``torch.distributed``.

Port of the JAX package's ``parallel/distributed.py``. JAX connects hosts
with ``jax.distributed.initialize``; here each rank is one process and
``initialize_distributed`` joins it to the default process group, whose
address, world size and rank come from the arguments or from the variables
torch's launcher sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``; ``LOCAL_WORLD_SIZE`` where present). Nothing on a
machine tells a program of a cluster, so with neither arguments nor
variables this is JAX's single-host no-op: it returns False.

The backend is a declared choice, printed on stderr and kept in
``BRINGUP`` for the run journal's manifest: NCCL when every rank on the host
has a card of its own, gloo on the CPU or when ranks share a card (NCCL
refuses two ranks on one device). Either way a rank that asked for the card
computes on the card; gloo all-reduces its CUDA tensors. A failed
connection raises; nothing falls back.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from machine_learning_replications_tpu_torch.device import resolve_device
from machine_learning_replications_tpu_torch.parallel import mesh as _mesh
from machine_learning_replications_tpu_torch.parallel.mesh import make_mesh

# What the bring-up chose and why (empty before it); the CLI journals it.
BRINGUP: dict = {}


def _env_int(name: str) -> "int | None":
    v = os.environ.get(name)
    return int(v) if v else None  # a malformed value raises ValueError


def choose_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """``(backend, reason)`` for ``local_world`` ranks on this host whose
    tensors live on ``device``'s type."""
    if device.type != "cuda":
        return "gloo", f"{local_world} rank(s) on the CPU"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s), a card each of {cards}"
    return "gloo", f"{local_world} ranks share {cards} card{'s' if cards > 1 else ''}"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    auto: bool = True,
    device=None,
) -> bool:
    """Join this process to the default process group.

    ``coordinator_address`` is ``host:port`` (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``),
    ``process_id`` this rank (``RANK``). ``device`` is where this rank
    computes (default: the card, raising without one); a CUDA rank takes
    card ``LOCAL_RANK`` modulo the cards present. With no address and no
    world size this is the single-host no-op (False; ``auto`` is kept for
    JAX's signature: torch has no cluster discovery to attempt). Returns
    True once a process group is up; safe to call twice."""
    del auto
    if dist.is_initialized():
        return True
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = _env_int("MASTER_PORT")
        if port is None:
            raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed bring-up needs an address, a world size and a rank; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} outside a world of {num_processes}")
    dev = resolve_device(device)
    local_rank = process_id if local_rank is None else local_rank
    local_world = num_processes if local_world is None else local_world
    backend, reason = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    BRINGUP.clear()
    BRINGUP.update(backend=backend, reason=reason, world_size=num_processes,
                   rank=process_id, local_rank=local_rank,
                   device=str(resolve_device(device)))
    print(f"distributed runtime up ({backend}: {reason}; rank {process_id} of "
          f"{num_processes})", file=sys.stderr)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh._GROUPS.clear()
    BRINGUP.clear()


def global_mesh(data: int | None = None, model: int = 1, *, device=None):
    """A mesh over every rank of the process group (this process alone
    before ``initialize_distributed``)."""
    return make_mesh(data=data, model=model, device=device)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1

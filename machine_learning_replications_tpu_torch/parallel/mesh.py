"""The ``(data, model)`` mesh over the ranks of the default process group,
and the few collectives the sharded trainers need.

Port of the JAX package's ``parallel/mesh.py``. JAX lays a mesh over the
devices one process sees; here every rank is a process with one device,
and the mesh lays the ranks of ``torch.distributed``'s default group out as
a ``[data, model]`` grid with the model axis innermost (rank ``r`` sits at
``(r // model, r % model)``), as JAX keeps model-axis neighbours adjacent.
Each axis's process group is ``mesh.get_group(axis)``: the ranks that share
this rank's other coordinate.

A mesh of one rank with no process group (``single_device_mesh``, or
``make_mesh`` before any bring-up) is the same code path with every
reduction an identity, so the sharded trainers run in one process on the
CPU. Once a process group exists, every collective is a real call, on axes
of size one too: a one-rank world still goes through its backend.

Every collective is an ``all_reduce`` (SUM, or MAX for the split gains):
gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only, and two
ranks sharing one card run on gloo. JAX's ``all_gather`` of each model
shard's best split becomes two reductions of an ``[M]`` vector in which a
rank fills only its own slot (``best_over_model``). A collective's failure
is never caught.

``COLLECTIVES`` counts the all-reduces made (and, inside ``timed()``, keeps
CUDA events around each, so their device time is read after the fact
without a host sync in the loop).
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from machine_learning_replications_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

COLLECTIVES = {"all_reduce": 0}
_timing: "list | None" = None


class Mesh:
    """A ``[data, model]`` grid of ranks and this rank's place in it.

    ``shape`` maps axis name → size (as ``jax.sharding.Mesh.shape``);
    ``device`` is this rank's device; ``groups`` maps ``DATA_AXIS``,
    ``MODEL_AXIS`` and ``None`` (both axes) to process groups, or is None
    for a one-rank mesh without a process group."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, data: int, model: int, device: torch.device, rank: int = 0,
                 groups: "dict | None" = None) -> None:
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.device = device
        self.rank = rank
        self.groups = groups

    @property
    def size(self) -> int:
        """The number of ranks (``jax.sharding.Mesh.size``)."""
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        model = self.shape[MODEL_AXIS]
        return self.rank // model if axis == DATA_AXIS else self.rank % model

    def get_group(self, axis: "str | None" = None):
        """The process group of ``axis`` (``None``: both axes)."""
        return None if self.groups is None else self.groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


_GROUPS: dict = {}


def _axis_groups(data: int, model: int) -> dict:
    """This rank's data, model and world groups of a ``[data, model]``
    grid. Every rank creates every group, in one order (``new_group`` is
    collective); groups are made once per grid and process group."""
    key = (data, model, id(dist.group.WORLD))
    if key not in _GROUPS:
        rank = dist.get_rank()
        mine = {None: dist.group.WORLD}
        for m in range(model):  # the data axis: ranks of one model column
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                mine[DATA_AXIS] = g
        for d in range(data):   # the model axis: ranks of one data row
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                mine[MODEL_AXIS] = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def make_mesh(data: int | None = None, model: int = 1, *, device=None) -> Mesh:
    """Build a ``(data, model)`` mesh over the default process group's ranks
    with this rank's tensors on ``device`` (default: the card).

    ``data=None`` puts every rank not on the model axis on the data axis.
    Without a process group the world is this one process, so only a
    ``(1, 1)`` mesh can be built. The mesh must span the whole world: every
    rank runs the same program."""
    dev = resolve_device(device)
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    n = data * model
    if n > world:
        raise ValueError(f"mesh {data}x{model} needs {n} ranks, have {world}")
    if n != world:
        raise ValueError(f"mesh {data}x{model} must span all {world} ranks")
    if not up:
        return Mesh(data, model, dev)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL process group reduces CUDA tensors; this rank asked for {dev}")
    return Mesh(data, model, dev, dist.get_rank(), _axis_groups(data, model))


def single_device_mesh(*, device=None) -> Mesh:
    """A ``(1, 1)`` mesh of this process alone (no process group)."""
    return Mesh(1, 1, resolve_device(device))


def check_device(mesh: "Mesh | None", device: torch.device) -> None:
    """Refuse a call whose ``device`` is not where ``mesh``'s ranks compute."""
    if mesh is not None and mesh.device != device:
        raise ValueError(f"the mesh's ranks compute on {mesh.device}, requested device is {device}")


def agree(mesh: "Mesh | None", fn):
    """``fn()`` on this rank, with every rank of ``mesh`` held to one
    outcome: where it raised on any rank it raises on every rank (the
    exception itself where it was raised, RuntimeError elsewhere), so no rank
    goes on to a collective its peers have left. For host work on one rank,
    such as rank 0 publishing files. One all-reduce; without a process group
    just ``fn()``."""
    if mesh is None or mesh.groups is None:
        return fn()
    try:
        out, err = fn(), None
    except Exception as exc:
        out, err = None, exc
    failed = int(psum(torch.tensor([float(err is not None)], device=mesh.device), mesh, None).item())
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"{failed} other rank(s) of the mesh failed; see their errors")
    return out


def _all_reduce(t: torch.Tensor, mesh: Mesh, axis: "str | None", op) -> torch.Tensor:
    if mesh.groups is None:
        return t
    t = t.contiguous()
    COLLECTIVES["all_reduce"] += 1
    if _timing is None:
        dist.all_reduce(t, op=op, group=mesh.get_group(axis))
        return t
    if t.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(t, op=op, group=mesh.get_group(axis))
        end.record()
        _timing.append((start, end))
    else:
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=mesh.get_group(axis))
        _timing.append(time.perf_counter() - t0)
    return t


def psum(t: torch.Tensor, mesh: Mesh, axis: "str | None" = DATA_AXIS) -> torch.Tensor:
    """Sum of ``t`` over one mesh axis (``None``: both), replicated on every
    rank of it (``jax.lax.psum``). Reduces in place where ``t`` is
    contiguous, so callers hand over tensors they no longer read."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.SUM)


def pmax(t: torch.Tensor, mesh: Mesh, axis: "str | None" = DATA_AXIS) -> torch.Tensor:
    """Elementwise maximum of ``t`` over one mesh axis (in place, as ``psum``)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MAX)


def best_over_model(gain: torch.Tensor, loc: torch.Tensor, mesh: Mesh):
    """Every model shard's best (gain, local location) → ``(winner, gains,
    locs)``: the winning shard (the lower one on a tie, as ``argmax`` picks
    the first maximum) and both ``[M]`` vectors, on every rank.

    JAX's ``all_gather`` of the M bests as two all-reduces: the gains
    vector holds this rank's gain in its own slot and −inf elsewhere (MAX),
    the locations vector its location and 0 elsewhere (SUM). No host sync."""
    M = mesh.shape[MODEL_AXIS]
    mine = torch.arange(M, device=gain.device) == mesh.axis_index(MODEL_AXIS)
    gains = pmax(torch.where(mine, gain, torch.full_like(gain, -torch.inf)), mesh, MODEL_AXIS)
    locs = psum(torch.where(mine, loc, torch.zeros_like(loc)), mesh, MODEL_AXIS)
    return torch.argmax(gains), gains, locs


@contextlib.contextmanager
def timed():
    """Record the device time of every all-reduce made inside the block;
    yields a list that, once the block ends, holds their seconds (a CUDA
    tensor's from events around the call, read after one synchronize; a CPU
    tensor's from the host clock)."""
    global _timing
    outer, _timing = _timing, []
    seconds: list = []
    try:
        yield seconds
    finally:
        marks, _timing = _timing, outer
        if any(not isinstance(m, float) for m in marks):
            torch.cuda.synchronize()
        seconds.extend(m if isinstance(m, float) else m[0].elapsed_time(m[1]) / 1e3
                       for m in marks)

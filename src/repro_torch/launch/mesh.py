"""Process groups and the ("part", "view") trainer mesh over torch.distributed.

Counterpart of ``repro.launch.mesh`` for the distributed GS trainer.  JAX
builds one SPMD program over a device mesh; here every rank is one process
driving one device, and the mesh is the set of sub-groups the trainer's
collectives run over:

    init_distributed(device)   join (or create) the default process group:
        under ``torchrun`` (RANK / WORLD_SIZE / LOCAL_RANK set) through
        ``env://``; otherwise a world of one, in-process.  Backend ``nccl``
        on ``cuda`` (device ``cuda:LOCAL_RANK``), ``gloo`` on ``cpu``.
    make_mesh((p, v), ("part", "view"))   the rank grid, row-major as
        ``jax.make_mesh`` lays devices out: rank r sits at part r // v,
        view r % v.  Each axis has one sub-group per coordinate of the
        other axis; ``Mesh.group(axis)`` is the one this rank belongs to.

No fallback: a failed NCCL init raises, and a backend that does not match
the device raises.  Every group gets a ``timeout``, so a rank that takes
another branch than its peers fails instead of hanging.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import check_device

#: collective timeout when the caller gives none
DEFAULT_TIMEOUT_S = 600.0

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    return datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if seconds is None else float(seconds))


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    dev = torch.device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"no process-group backend for device {dev}")
    return _BACKEND[dev.type]


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: Optional[float] = None):
    """Join the default process group -> (rank, world_size, device).

    ``rank``/``world_size``/``init_method`` default to what ``torchrun``
    set in the environment; with none of it set the world is this one
    process (an in-process store, no port).  The device is
    ``cuda:LOCAL_RANK`` on ``cuda``.  If the default group already exists
    its backend must match the device."""
    dev = check_device(device)
    backend = backend_for(dev)
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"the default process group runs {have!r}, but device {dev} "
                f"needs {backend!r}")
        return dist.get_rank(), dist.get_world_size(), dev
    kw = dict(backend=backend, timeout=_timeout(timeout_s))
    if dev.type == "cuda":
        kw["device_id"] = dev
    if init_method is None and rank is None and world_size is None:
        # a world of one: an in-process store, no rendezvous
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                                **kw)
    else:
        dist.init_process_group(
            init_method=init_method or "env://",
            rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size, **kw)
    return dist.get_rank(), dist.get_world_size(), dev


def destroy_distributed():
    """Tear the default group down (every sub-group with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """The rank grid of a ``(p, v)`` ("part", "view") mesh.

    ``axis_names``/``shape`` as ``jax.sharding.Mesh`` gives them; ``index``
    is this rank's coordinate on an axis, ``group`` the sub-group of the
    ranks that share every other coordinate (the group a collective over
    that axis runs in)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int, coords: Sequence[int], device: torch.device,
                 groups: dict):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.rank = int(rank)
        self.coords = tuple(int(c) for c in coords)
        self.device = device
        self._groups = groups

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def axis_size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self._groups[axis]

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank} at {self.coords}, {self.device})")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              timeout_s: Optional[float] = None) -> Mesh:
    """The mesh of the default process group, which must have
    ``prod(shape)`` ranks.  Every rank creates every sub-group, in the same
    order (``torch.distributed.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed(...) before make_mesh")
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    world = dist.get_world_size()
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has {world}")
    rank = dist.get_rank()
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    coords = [(rank // strides[i]) % shape[i] for i in range(len(shape))]
    groups = {}
    for a, axis in enumerate(axes):
        # every line of ranks along ``axis``: fix the other coordinates
        others = [range(s) if i != a else range(1)
                  for i, s in enumerate(shape)]
        for base in itertools.product(*others):
            line = [sum(c * st for c, st in zip(base, strides))
                    + j * strides[a] for j in range(shape[a])]
            grp = dist.group.WORLD if len(line) == world else \
                dist.new_group(line, timeout=_timeout(timeout_s))
            if rank in line:
                groups[axis] = grp
    return Mesh(shape, axes, rank=rank, coords=coords,
                device=_default_device(), groups=groups)


def _default_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")

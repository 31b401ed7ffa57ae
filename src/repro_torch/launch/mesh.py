"""Process groups and the trainer's rank meshes over torch.distributed.

Counterpart of ``repro.launch.mesh`` for the distributed GS trainer.  JAX
builds one SPMD program over a device mesh; here every rank is one process
driving one device, and the mesh is the set of sub-groups the trainer's
collectives run over:

    init_distributed(device)   join (or create) the default process group:
        under ``torchrun`` (RANK / WORLD_SIZE / LOCAL_RANK set) through
        ``env://``; otherwise a world of one, in-process.  Backend ``nccl``
        on ``cuda`` (device ``cuda:LOCAL_RANK``), ``gloo`` on ``cpu``.
    make_mesh(shape, axes)   the rank grid over any of the axes
        ("pod", "part" | "data", "model", "view"), row-major as
        ``jax.make_mesh`` lays devices out: on a (p, v) ("part", "view")
        mesh rank r sits at part r // v, view r % v.  A collective over a
        set of axes runs among the ranks that share every other
        coordinate; ``Mesh.group(*axes)`` is this rank's such group.
    make_production_mesh(multi_pod=)   the reference's production shapes,
        (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model");
        ``single_device_mesh()`` its (1, 1) ("data", "model").

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
    """A rank grid.

    ``axis_names``/``shape`` as ``jax.sharding.Mesh`` gives them; ``index``
    is this rank's coordinate on an axis, ``group(*axes)`` the sub-group of
    the ranks that share every coordinate outside ``axes`` (the group a
    collective over those axes runs in).  Axes given as None are skipped;
    a group of one rank is None (a collective over it is the identity)."""

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

    def group(self, *axes: Optional[str]):
        names = [a for a in axes if a is not None]
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not on mesh "
                             f"{self.axis_names}")
        return self._groups.get(_group_key(self.shape, self.axis_names,
                                           names))

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank} at {self.coords}, {self.device})")


def _group_key(shape, axis_names, axes) -> tuple:
    """The axes of ``axes`` that have more than one rank, in mesh order:
    subsets with the same key have the same groups."""
    return tuple(a for a, s in zip(axis_names, shape) if a in axes and s > 1)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              timeout_s: Optional[float] = None) -> Mesh:
    """The mesh of the default process group, which must have
    ``prod(shape)`` ranks.  Every rank creates the groups of every subset of
    the axes with more than one rank, eagerly and in one fixed order
    (``torch.distributed.new_group`` is collective: a group made later on
    some ranks only would hang the next collective)."""
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
    if len(set(axes)) != len(axes):
        raise ValueError(f"repeated mesh axes {axes}")
    rank = dist.get_rank()
    # row-major: every rank's coordinates
    grid = list(itertools.product(*(range(s) for s in shape)))
    wide = [a for a, s in zip(axes, shape) if s > 1]
    groups = {}
    for size in range(1, len(wide) + 1):
        # in mesh order: each subset is its own ``_group_key``
        for subset in itertools.combinations(wide, size):
            inside = [i for i, a in enumerate(axes) if a in subset]
            # the ranks that share every coordinate outside ``subset``
            lines = {}
            for r, c in enumerate(grid):
                outside = tuple(x for i, x in enumerate(c) if i not in inside)
                lines.setdefault(outside, []).append(r)
            for outside in sorted(lines):
                line = lines[outside]
                grp = dist.group.WORLD if len(line) == world else \
                    dist.new_group(line, timeout=_timeout(timeout_s))
                if rank in line:
                    groups[subset] = grp
    return Mesh(shape, axes, rank=rank, coords=grid[rank],
                device=_default_device(), groups=groups)


def make_production_mesh(*, multi_pod: bool = False,
                         timeout_s: Optional[float] = None) -> Mesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``; the process
    group must have 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, timeout_s=timeout_s)


def single_device_mesh(*, timeout_s: Optional[float] = None) -> Mesh:
    """The reference's (1, 1) ("data", "model") mesh of a world of one."""
    return make_mesh((1, 1), ("data", "model"), timeout_s=timeout_s)


def _default_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")

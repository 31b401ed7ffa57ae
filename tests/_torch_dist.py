"""Run a function on gloo ranks of a mesh (default ("part", "view"); any
axes with ``axes=``), each rank its own spawned process (torch only: the
ranks never import JAX); with ``device="cuda"`` the ranks run NCCL, rank r
on card r.

``run_ranks(fn, shape, tmp_path, *args)`` starts ``prod(shape)`` processes
(``Ranks`` starts them without waiting);
each joins a gloo process group through a ``file://`` rendezvous under
``tmp_path`` (no TCP port to clash between test workers), builds the mesh
and calls ``fn(mesh, *args)``.  ``fn`` must be importable by name (a
module-level function) and reports through files.  The parent joins every
rank within ``timeout`` seconds, kills them all past it, and raises if any
rank failed.  Each process group has a short collective timeout, so a rank
that takes another branch than its peers fails instead of hanging.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
import traceback

import torch.multiprocessing as mp

#: collective timeout inside the ranks
PG_TIMEOUT_S = 60.0


def _entry(rank, world, shape, axes, init_file, module, name, args, err_dir,
           device):
    try:
        import torch

        torch.set_num_threads(1)
        from repro_torch.launch import mesh as mesh_mod

        dev = torch.device("cuda", rank) if device == "cuda" else "cpu"
        mesh_mod.init_distributed(
            dev, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout_s=PG_TIMEOUT_S)
        try:
            mesh = mesh_mod.make_mesh(shape, axes, timeout_s=PG_TIMEOUT_S)
            fn = getattr(importlib.import_module(module), name)
            fn(mesh, *args)
        finally:
            mesh_mod.destroy_distributed()
    except BaseException:
        with open(os.path.join(err_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """Spawned ranks running ``fn(mesh, *args)`` on a ``shape`` mesh over
    ``axes`` (gloo, or NCCL with ``device="cuda"``); ``join()`` waits for
    them (killing all past the deadline) and raises if any rank failed."""

    def __init__(self, fn, shape, tmp_path, *args, timeout: float = 120.0,
                 device: str = "cpu", axes=("part", "view")):
        self.shape = tuple(shape)
        self.world = 1
        for s in self.shape:
            self.world *= s
        tag = "x".join(map(str, self.shape)) + f"_{time.monotonic_ns()}"
        axes = tuple(axes)
        init_file = os.path.join(str(tmp_path), f"pg_{tag}")
        self.err_dir = os.path.join(str(tmp_path), f"err_{tag}")
        os.makedirs(self.err_dir, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(
            r, self.world, self.shape, axes, init_file, fn.__module__,
            fn.__name__, args, self.err_dir, device), daemon=True)
            for r in range(self.world)]
        old = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        try:
            for p in self.procs:
                p.start()
        finally:
            if old is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = old
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def join(self):
        try:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
        finally:
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join(5)
        errs = []
        for r in range(self.world):
            path = os.path.join(self.err_dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
        if alive:
            raise TimeoutError(
                f"{len(alive)} of {self.world} ranks still running after "
                f"{self.timeout} s (killed)\n" + "\n".join(errs))
        bad = [(r, p.exitcode) for r, p in enumerate(self.procs)
               if p.exitcode != 0]
        if bad or errs:
            raise RuntimeError(f"ranks failed {bad}\n" + "\n".join(errs))


def run_ranks(fn, shape, tmp_path, *args, timeout: float = 120.0,
              device: str = "cpu", axes=("part", "view")):
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh over
    ``axes`` and wait for them."""
    Ranks(fn, shape, tmp_path, *args, timeout=timeout, device=device,
          axes=axes).join()

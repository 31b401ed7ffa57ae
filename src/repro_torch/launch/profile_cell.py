"""Per-op attribution of one dry-run cell's step, or its device time by
kernel on the card.

Counterpart of ``repro.launch.profile_cell``, which attributes a compiled
cell's HLO bytes or FLOPs to its instructions (the reference had no wall
clock).  ``--by hbm`` / ``--by flops`` print the top ``per_op`` rows of
``launch.cost_analysis.analyze`` over one run of the step (on ``meta``
tensors for an LM or ``--gs`` cell, so no card is needed); ``--by time``
runs one step on ``--device`` under ``torch.profiler`` after one warm-up
step and prints device ms per kernel and the device's busy share of the
window (``device_profile``).

    python -m repro_torch.launch.profile_cell --arch minicpm-2b \
        --shape train_4k [--gs gs-kingsnake] [--top 20] [--by flops]
    python -m repro_torch.launch.profile_cell --arch minicpm-2b \
        --shape train_4k --batch 8 --seq 512 --by time --device cuda

``--gs-train DATASET`` profiles the PRODUCTION trainer instead of the
dense dry-run cell: the tiered ``make_gs_train_step`` that
``fit_partitions`` dispatches, on a ("part", "view") mesh of the default
process group (a world of one in-process, or ``torchrun``'s ranks), on
real tensors of ``--device``:

    python -m repro_torch.launch.profile_cell --gs-train sphere_shell \
        --gs-res 32 --top 10 --device cpu
"""

from __future__ import annotations

import argparse
import math
import time

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke, get_spec
from repro_torch.core.cameras import orbital_rig
from repro_torch.core.gaussians import from_points
from repro_torch.core.tiling import TileGrid
from repro_torch.core.train import GSTrainCfg, init_opt
from repro_torch.core.train import make_train_step as gs_train_step
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import destroy_distributed, init_distributed
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import SHAPES, init_opt_state, init_params


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_profile(fn, steps, dev):
    """``fn()`` run ``steps`` times under ``torch.profiler`` (device activity
    only) -> (rows [(kernel name, (calls, us))] by device time, the share of
    the window's wall time in which the device ran anything, the window's
    wall us, the device event count)."""
    dev = torch.device(dev)
    sync(dev)
    act = torch.profiler.ProfilerActivity
    on_card = dev.type == "cuda"
    with torch.profiler.profile(
            activities=[act.CUDA if on_card else act.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kind = torch.autograd.DeviceType.CUDA if on_card \
        else torch.autograd.DeviceType.CPU
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == kind
    )
    by_name, busy, reach = {}, 0.0, -math.inf
    for start, end, name in spans:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + end - start)
        busy += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return rows, busy / wall_us, wall_us, len(spans)


def _fill(tree, vocab: int, gen: torch.Generator, device):
    """Real tensors for a ``meta`` tree: integer leaves uniform in [0,
    vocab), floating leaves N(0, 0.02^2), in the leaf's dtype."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            x = torch.randn(tuple(t.shape), generator=gen, device=device)
            return (x * 0.02).to(t.dtype)
        return torch.randint(0, vocab, tuple(t.shape), generator=gen,
                             device=device, dtype=t.dtype)
    return pytree.tree_map(leaf, tree)


def lm_device_args(spec, kind: str, args, device):
    """The cell's arguments on ``device``: ``init_params`` and
    ``init_opt_state`` from seed 0, tokens, frames, patches and caches
    drawn from it (``_fill``); decode's position stays an int."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(spec, gen, device=device)
    if kind == "train":
        return (params, init_opt_state(spec, params),
                _fill(args[2], spec.vocab, gen, device))
    return (params,) + tuple(_fill(a, spec.vocab, gen, device)
                             for a in args[1:])


def gs_device_args(cell: str, device):
    """The dense ``--gs`` cell's step and its arguments on ``device``:
    random splats from seed 0 in every slot, one view of an orbital
    rig."""
    meta = dryrun.gs_meta(cell)
    res, N = meta["resolution"], meta["gaussians_per_part"]
    cfg = GSTrainCfg(K=meta["K"], tile_h=8, tile_w=128)
    gen = torch.Generator(device=device).manual_seed(0)
    g = from_points(torch.rand((N, 3), generator=gen, device=device) - 0.5,
                    device=device)
    cam = orbital_rig(1, (0.0, 0.0, 0.0), 2.5, width=res, height=res,
                      device=device)
    gt = torch.rand((1, res, res, 3), generator=gen, device=device)
    step = gs_train_step(cfg, TileGrid(res, res, 8, 128), 1.0, k_tiers=None,
                         assign_impl="dense")
    return step, (g, init_opt(g), cam, gt, None)


def _print_attribution(name, mesh, hlo, by, top):
    per_op = hlo["per_op"]
    key = "bytes" if by == "hbm" else "flops"
    total = sum(r[key] for r in per_op.values())
    unit = "GB" if by == "hbm" else "GFLOP"
    print(f"{name} [{mesh}]  total {total/1e9:.1f} {unit} per device")
    rows = sorted(per_op.items(), key=lambda kv: -kv[1][key])[:top]
    for op, r in rows:
        print(f"{r[key]/1e9:10.2f} {unit}  {100*r[key]/max(total, 1):5.1f}%"
              f"  {op:28s} x{r['count']}")


def _print_time(name, mesh, fn, device, top):
    fn()                                    # warm-up (builds, caches)
    rows, share, wall_us, n = device_profile(fn, 1, device)
    print(f"{name} [{mesh}]  {wall_us / 1e3:.3f} ms per step, device busy "
          f"{100 * share:.1f}% of the window, {n} device events")
    busy = sum(us for _, (_, us) in rows)
    for kname, (calls, us) in rows[:top]:
        print(f"{us / 1e3:10.3f} ms  {100 * us / max(busy, 1):5.1f}%"
              f"  x{calls:<5d} {kname[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config in place of its SPEC")
    ap.add_argument("--batch", type=int, default=0,
                    help="replace the shape's batch")
    ap.add_argument("--seq", type=int, default=0,
                    help="replace the shape's sequence length")
    ap.add_argument("--gs", default="")
    ap.add_argument("--gs-train", default="",
                    help="profile the production tiered GS train step for "
                         "this dataset (sphere_shell/kingsnake/...) on a "
                         "('part','view') mesh")
    ap.add_argument("--gs-res", type=int, default=64)
    ap.add_argument("--gs-parts", type=int, default=2)
    ap.add_argument("--gs-view-batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where --by time and --gs-train run")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--by", default="hbm", choices=["hbm", "flops", "time"])
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if args.gs_train:
        owned = not dist.is_initialized()
        _, n, device = init_distributed(args.device)
        try:
            v = math.gcd(max(1, args.gs_view_batch), n)
            mesh = make_mesh((n // v, v), ("part", "view"))
            step, step_args, meta = dryrun.gs_train_cell(
                args.gs_train, mesh, res=args.gs_res,
                n_parts=args.gs_parts, view_batch=args.gs_view_batch)
            name = (f"gs-train-{args.gs_train} res={meta['resolution']} "
                    f"parts={meta['n_parts']} N/part="
                    f"{meta['gaussians_per_part']} "
                    f"k_tiers={meta['k_tiers']}")
            mesh_name = f"{n // v}x{v} part,view"
            if args.by == "time":
                _print_time(name, mesh_name, lambda: step(*step_args),
                            device, args.top)
            else:
                _print_attribution(name, mesh_name, analyze(step, *step_args),
                                   args.by, args.top)
        finally:
            if owned:
                destroy_distributed()
        return 0

    if args.gs:
        name = args.gs
        if args.by == "time":
            step, step_args = gs_device_args(args.gs, device)
            _print_time(name, "card", lambda: step(*step_args), device,
                        args.top)
        else:
            hlo, _, _ = dryrun.gs_cell(args.gs)
            _print_attribution(name, "card", hlo, args.by, args.top)
        return 0

    spec = (get_smoke if args.smoke else get_spec)(args.arch)
    step, step_args = dryrun.lm_step(spec, args.shape,
                                     batch=args.batch or None,
                                     seq=args.seq or None)
    name = f"{args.arch}__{args.shape}"
    if args.by == "time":
        kind = SHAPES[args.shape]["kind"]
        real = lm_device_args(spec, kind, step_args, device)
        _print_time(name, "card", lambda: step(*real), device, args.top)
    else:
        _print_attribution(name, "card", analyze(step, *step_args), args.by,
                           args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

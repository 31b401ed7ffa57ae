"""Training driver (CLI), port of ``repro.launch.train``: the GS mode.

    # one process (a world of one): the card, or --device cpu
    python -m repro_torch.launch.train --gs --dataset kingsnake --parts 2 \
        --steps 200 --resolution 64
    # N processes, one card each (NCCL), or N CPU ranks (gloo)
    torchrun --nproc-per-node N -m repro_torch.launch.train --gs ... \
        --device cuda

The paper's end-to-end workflow on the distributed tier-schedule driver
(``core/distributed.fit_partitions``): partition (+ ghost cells) ->
per-partition GT renders + coverage masks -> tiered distributed training of
every partition in one step on the ("part", "view") rank mesh (probe ->
train -> densify -> re-probe; the TierSchedule state checkpointed beside
the parameters, so a restart resumes without re-probing) -> per-partition
checkpoints -> merge -> global render + PSNR/SSIM -> the merged checkpoint
``<ckpt>/merged`` (float32, or ``--ckpt-quantize int8``) with the scene
frame that ``launch/serve_gs.py`` serves, and ``render_final.npy``.

``--device`` (default ``cuda``) and ``torchrun`` replace the reference's
``--host-devices``; ``--mesh PxV`` picks the mesh.  ``--dtype-policy
bf16`` halves the all-gathered splat tables; ``--grad-compress bf16|int8``
compresses the gradients (int8 with an error-feedback residual that rides
the checkpoints); a resume under another setting of either exits naming
both.  ``--exchange`` swaps the "part" all-gather for the sparse-overlap
exchange (its budget probed, or pinned by ``--exchange-budget``, and
restored by a resume); ``--rebalance-every N`` deals live splats evenly
over the "part" ranks every N steps.  The LM mode and the timeseries
driver are not ported: their flags exit with an error naming the ROADMAP
item.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import types

import numpy as np
import torch

from repro_torch.configs.gs_datasets import get_gs_dataset
from repro_torch.core import distributed as dist_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import metrics
from repro_torch.core.cameras import orbital_rig
from repro_torch.core.partition import partition_points
from repro_torch.core.pipeline import (build_scene, coverage_masks,
                                       gt_gaussians,
                                       init_partition_gaussians,
                                       render_views)
from repro_torch.core.tiling import TileGrid
from repro_torch.core.train import GSTrainCfg, _check_resume_policy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime.checkpoint import CheckpointManager, quantize_cold

#: flags of parts not ported yet -> the ROADMAP queue 1 item that owns them
_MISSING_FLAGS = {
    "timeseries": "item 15 (prepare_timestep, TimestepPrefetcher, "
                  "--timeseries)",
}


def _stack(parts):
    """Per-partition Gaussians -> one batched (P, N) Gaussians."""
    return type(parts[0])(*(torch.stack(fs) for fs in zip(*parts)))


def run_gs(args):
    """The GS workflow on this rank -> 0.  Rank 0 prints and writes."""
    rank, world, dev = mesh_mod.init_distributed(args.device)
    rank0 = rank == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    if args.smoke:
        # tiny full-lifecycle config: 2 partitions, small scene, densify
        # mid-run so the probe -> train -> densify -> re-probe loop (and a
        # checkpointed schedule) runs end to end; --steps / --ckpt-dir stay
        # the caller's, so a second invocation exercises the resume
        args.dataset = "sphere_shell"
        args.parts = 2
        args.resolution = min(args.resolution, 32)
        args.views = args.views or 4
        args.view_batch = args.view_batch or 2
        if args.densify_every == 0:
            args.densify_every, args.densify_from = 2, 1
        if args.ckpt_every == 0:
            args.ckpt_every = 2

    cfg = GSTrainCfg(view_batch=args.view_batch or 1,
                     exchange=args.exchange,
                     exchange_budget=args.exchange_budget,
                     dtype_policy=args.dtype_policy,
                     grad_compress=args.grad_compress)
    n_views = args.views or get_gs_dataset(
        args.dataset, "full" if args.full else "cpu").n_views
    if args.mesh:
        p, v = (int(x) for x in args.mesh.lower().split("x"))
        if p * v != world:
            raise SystemExit(f"--mesh {args.mesh} needs {p * v} ranks, have "
                             f"{world} (run with torchrun --nproc-per-node "
                             f"{p * v})")
    else:
        # the widest "view" axis the effective minibatch supports; the
        # rest go to "part"
        v = math.gcd(max(1, min(cfg.view_batch, n_views)), world)
        p = world // v
    mesh = mesh_mod.make_mesh((p, v), ("part", "view"))
    sc = gs_scene(args, cfg, p, dev)
    parts, points, colors, extent = sc.parts, sc.points, sc.colors, sc.extent
    center, radius, grid, cams = sc.center, sc.radius, sc.grid, sc.cams
    g, gts, masks = sc.g, sc.gts, sc.masks
    del sc

    kt = cfg.resolved_k_tiers()
    table = "exchange" if cfg.exchange else "all-gather"
    if cfg.exchange and cfg.exchange_budget:
        table += f"(budget={cfg.exchange_budget})"
    say(f"[train-gs] dataset={args.dataset} parts={args.parts} "
        f"res={args.resolution} views={n_views} mesh={p}x{v} "
        f"({world} ranks, {mesh_mod.backend_for(dev)} on {dev.type}) "
        f"ghost={not args.no_ghost} mask={not args.no_mask} "
        f"table={table} raster="
        f"{'tiered ' + str(kt) if kt else 'dense K=' + str(cfg.assign_K)} "
        f"dtype={cfg.dtype_policy} grad-compress={cfg.grad_compress}")

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    latest = ckpt.latest_restorable_step()
    if latest is not None:
        try:
            _check_resume_policy(ckpt.manifest_extra(latest), cfg)
        except ValueError as e:
            print(f"[train-gs] {e}", file=sys.stderr, flush=True)
            return 2
        say(f"[train-gs] resuming from checkpoint step {latest} "
            "(schedule restored, no re-probe)")
    sched = cfg.tier_schedule()
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    g1, o1, losses = dist_mod.fit_partitions(
        g, cams, gts, masks, cfg, mesh=mesh, steps=args.steps,
        extent=extent, generator=generator,
        densify_every=args.densify_every, densify_from=args.densify_from,
        grid=grid, schedule=sched, ckpt=ckpt, ckpt_every=args.ckpt_every,
        rebalance_every=args.rebalance_every, log_every=args.log_every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    del gts, masks
    done = max(args.steps, latest or 0)
    if losses:
        say(f"[train-gs] trained steps {latest or 0}->{done} "
            f"({len(losses)} ran, {train_s:.1f}s)  "
            f"final loss {losses[-1]:.4f}")
    else:
        say(f"[train-gs] checkpoint already at step {done}; "
            "skipping to merge")
    if sched is not None:
        say(f"[train-gs] schedule: {sched}")

    g_all = dist_mod.gather_partitions(g1, mesh)
    del g1, o1
    if rank0:
        _write_outputs(args, g_all, parts, points, colors, cams, grid, cfg,
                       center, radius, extent, n_views, done, dev)
    torch.distributed.barrier()
    return 0


def gs_scene(args, cfg: GSTrainCfg, n_part: int, dev):
    """The CLI's training inputs from its flags (``--dataset``, ``--full``,
    ``--seed``, ``--parts``, ``--resolution``, ``--views``,
    ``--no-ghost``, ``--no-mask``, ``--densify-every``): the isosurface
    scene, its partitions with ghost cells, the orbital rig, the batched
    (P, N) initial gaussians (capacity x the dataset's factor when
    densifying, a multiple of ``n_part``) and each partition's GT renders
    and coverage masks at bg = 0 (the distributed tile loss compares raw
    premultiplied color tiles) -> a namespace of them."""
    ds = get_gs_dataset(args.dataset, "full" if args.full else "cpu")
    n_views = args.views or ds.n_views
    points, colors, extent = build_scene(ds, args.seed)
    center = 0.5 * (points.max(0) + points.min(0))
    radius = 1.6 * extent / 2 + 1e-3
    W = H = args.resolution
    grid = TileGrid(W, H, cfg.tile_h, cfg.tile_w)
    cams = orbital_rig(n_views, center, radius, width=W, height=H,
                       device=dev)
    ghost_w = ds.ghost_frac * extent if not args.no_ghost else 0.0
    parts, _ = partition_points(points, colors, args.parts,
                                ghost_width=ghost_w)
    base = max(len(pd.points) for pd in parts)
    cap = int(base * ds.capacity_factor) if args.densify_every else base
    cap = -(-cap // n_part) * n_part          # "part"-shardable capacity
    g = _stack([init_partition_gaussians(pd, capacity=cap, device=dev)
                for pd in parts])
    gts, masks = [], []
    for pd in parts:
        part_gt, part_cov = render_views(
            gt_gaussians(pd.points, pd.colors, device=dev), cams, grid,
            K=cfg.K, bg=0.0)
        gts.append(part_gt)
        if not args.no_mask:
            masks.append(coverage_masks(part_cov))
        del part_cov
    return types.SimpleNamespace(
        parts=parts, points=points, colors=colors, extent=extent,
        center=center, radius=radius, grid=grid, cams=cams, g=g,
        gts=torch.stack(gts),
        masks=None if args.no_mask else torch.stack(masks))


def _write_outputs(args, g_all, parts, points, colors, cams, grid, cfg,
                   center, radius, extent, n_views, done, dev):
    """Rank 0: per-partition checkpoints, merge, render, metrics, the merged
    checkpoint and the final render."""
    part_list = [type(g_all)(*(f[i] for f in g_all))
                 for i in range(args.parts)]
    pckpt = CheckpointManager(os.path.join(args.ckpt_dir, "partitions"),
                              keep=2)
    for pid, gp in enumerate(part_list):
        pckpt.save(done, gp, partition=pid,
                   extra={"dataset": args.dataset})

    merged = merge_mod.merge_partitions(part_list,
                                        [pd.part_id for pd in parts])
    gt_imgs, _ = render_views(gt_gaussians(points, colors, device=dev), cams,
                              grid, K=cfg.K)
    renders, _ = render_views(merged, cams, grid, K=cfg.K)
    ps = float(np.mean([float(metrics.psnr(renders[i], gt_imgs[i]))
                        for i in range(n_views)]))
    ss = float(np.mean([float(metrics.ssim(renders[i], gt_imgs[i]))
                        for i in range(n_views)]))
    print(f"[train-gs] PSNR {ps:.2f}  SSIM {ss:.4f}  "
          f"gaussians {int(merged.active.sum()):,}", flush=True)

    # train->serve handoff: the MERGED model as its own checkpoint with the
    # scene frame serving needs, and the final merged render
    mckpt = CheckpointManager(os.path.join(args.ckpt_dir, "merged"), keep=2)
    merged_extra = {"scene": {
        "dataset": args.dataset, "resolution": args.resolution,
        "center": [float(c) for c in center], "radius": float(radius),
        "extent": float(extent), "n_views": int(n_views), "K": int(cfg.K),
        "tile_h": int(cfg.tile_h), "tile_w": int(cfg.tile_w),
    }}
    merged_save = merged
    if args.ckpt_quantize == "int8":
        merged_save, quant_meta = quantize_cold(merged)
        merged_extra["quant"] = quant_meta
        print("[train-gs] merged checkpoint cold attributes quantized "
              f"(int8, fields={list(quant_meta['fields'])})", flush=True)
    mckpt.save(done, merged_save, extra=merged_extra)
    np.save(os.path.join(args.ckpt_dir, "render_final.npy"),
            renders.cpu().numpy())
    print(f"[train-gs] merged checkpoint (step {done}) + final render "
          f"saved under {args.ckpt_dir}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags (the reference's, with ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--gs", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny full-lifecycle run (2 parts, small scene, "
                         "densify + checkpoint on)")
    ap.add_argument("--dataset", default="sphere_shell")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--views", type=int, default=None)
    ap.add_argument("--view-batch", type=int, default=None,
                    help="views per minibatch step (split over the mesh's "
                         "'view' axis; must divide by its size)")
    ap.add_argument("--mesh", default=None,
                    help="PARTxVIEW rank mesh, e.g. 2x2 (default: the "
                         "widest 'view' axis the view batch supports)")
    ap.add_argument("--densify-every", type=int, default=0)
    ap.add_argument("--densify-from", type=int, default=100)
    ap.add_argument("--densify-cap", type=int, default=None,
                    help="ceiling on LIVE splats per partition, for "
                         "--timeseries (not ported); --gs ignores it, as "
                         "the reference does")
    ap.add_argument("--no-ghost", action="store_true")
    ap.add_argument("--no-mask", action="store_true")
    ap.add_argument("--ckpt-quantize", default="none",
                    choices=["none", "int8"],
                    help="merged-checkpoint cold attributes (SH color, "
                         "opacity logit) as int8 with per-tensor scales")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--dtype-policy", default="f32", choices=["f32", "bf16"],
                    help="storage / wire dtype of the all-gathered splat "
                         "tables (bf16 halves them); compositing, loss and "
                         "optimizer stay f32. A resume across a policy "
                         "change fails loudly.")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"],
                    help="gradient wire compression (optim/compress.py); "
                         "int8 carries an error-feedback residual in step "
                         "state and through checkpoints")
    ap.add_argument("--exchange", action="store_true",
                    help="sparse-overlap splat exchange instead of the "
                         "full-table all-gather (probed edge budgets, "
                         "overflow counters)")
    ap.add_argument("--exchange-budget", type=int, default=None,
                    help="pin the per-(src,dst) edge budget instead of "
                         "probing it")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="check per-shard live-splat skew every N steps "
                         "and permute rows to rebalance (0 = off)")
    # flags of parts not ported yet: accepted so they can be refused by name
    ap.add_argument("--timeseries", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name, item in _MISSING_FLAGS.items():
        if getattr(args, name):
            flag = "--" + name.replace("_", "-")
            print(f"[train] {flag}: not ported yet (ROADMAP queue 1, "
                  f"{item})", file=sys.stderr)
            return 2
    if not args.gs:
        print("[train] only the GS mode (--gs) is ported; the LM mode is "
              "ROADMAP queue 1 item 20", file=sys.stderr)
        return 2
    owns_group = not torch.distributed.is_initialized()
    try:
        return run_gs(args)
    finally:
        if owns_group:
            mesh_mod.destroy_distributed()


if __name__ == "__main__":
    raise SystemExit(main())

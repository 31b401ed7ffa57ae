"""Training driver (CLI), port of ``repro.launch.train``.

Two modes, one runtime:

    # LM: one process on one device
    python -m repro_torch.launch.train --arch minicpm-2b --smoke --steps 20
    # GS, one process (a world of one): the card, or --device cpu
    python -m repro_torch.launch.train --gs --dataset kingsnake --parts 2 \
        --steps 200 --resolution 64
    # GS, N processes, one card each (NCCL), or N CPU ranks (gloo)
    torchrun --nproc-per-node N -m repro_torch.launch.train --gs ... \
        --device cuda

The LM mode (``run_lm``) trains a registered architecture (``--arch``; its
SMOKE config with ``--smoke``) on ``data.tokens.SyntheticTokens``: bf16
parameters from ``init_params`` on a generator on ``--device`` seeded with
``--seed``, ``models.make_train_step`` (remat, the recomputing flash
backward, ``--microbatches``, ``--compression``, AdamW under the arch's LR
schedule), checkpoints every ``--ckpt-every`` steps and at the end (the
parameters and the optimizer state; bf16 leaves in the reference's on-disk
form), resuming from the newest one, with a heartbeat and step retry.  It
runs one process with no process group, as the reference's does.

The GS mode is the paper's end-to-end workflow on the distributed tier-schedule driver
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
over the "part" ranks every N steps.

``--timeseries`` trains timesteps t = 0..T-1 (``--timesteps``) of the
evolving volume, sampled ``--dt`` apart: each timestep warm-starts from
the previous one's committed state (tier and exchange schedules restored,
no init probe) under ``--densify-cap``, commits a delta checkpoint to
``<ckpt>/timeseries``, and has its successor's ingest prepared on a
worker thread (``pipeline.TimestepPrefetcher``) while it trains; a
restart resumes at the last committed timestep.

Under ``torchrun`` every rank joins over ``env://`` (its card
``cuda:LOCAL_RANK``), builds the whole scene, and trains its block of
every partition; rank 0 alone merges, renders, prints and writes.  The
batched capacity is rounded up to a multiple of the "part" size, but
densify fills no slot past the unrounded one, so the run trains the same
splats on any mesh, and a checkpoint or chain written on one mesh resumes
on another (``distributed.fit_slots``).  Rank 0's last line is the run's
record, ``[train-gs] record {...}`` (``[train-gs-ts]`` for
``--timeseries``): one JSON object with the losses, each rank's ingest
seconds, median step ms, device- and host-memory peaks and kernel
launches, rank 0's merge + render + write seconds, PSNR / SSIM and the
checkpoints' bytes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import statistics
import sys
import time
import types

import numpy as np
import torch

from repro_torch import check_device
from repro_torch.configs import get_smoke, get_spec
from repro_torch.configs.gs_datasets import get_gs_dataset
from repro_torch.core import distributed as dist_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import metrics
from repro_torch.core.cameras import orbital_rig
from repro_torch.core.partition import partition_points
from repro_torch.core.pipeline import (TimestepPrefetcher, build_scene,
                                       gt_gaussians, prepare_timestep,
                                       render_views)
from repro_torch.core.tiling import TileGrid
from repro_torch.core.train import (GSTrainCfg, _check_resume_policy,
                                    init_opt)
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.kernels import project as project_kernels
from repro_torch.kernels import rasterize
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import (TrainCfg, init_opt_state, init_params,
                                make_train_step)
from repro_torch.runtime.checkpoint import (CheckpointManager, quantize_cold,
                                            tree_map, unshaped_like)
from repro_torch.runtime.ft import Heartbeat, retry_step


def run_lm(args) -> dict:
    """The LM mode -> a record: the spec, the final parameters and optimizer
    state, each step's loss, grad norm, lr scale and seconds (the device
    synchronised at each step's end), the steps run, and the final save's
    seconds."""
    dev = check_device(args.device)
    spec = get_smoke(args.arch) if args.smoke else get_spec(args.arch)
    cfg = TrainCfg(total_steps=args.steps, compression=args.compression,
                   schedule=spec.lr_schedule, kv_chunk=args.kv_chunk,
                   n_microbatches=args.microbatches)
    print(f"[train] arch={spec.name} params={spec.param_count():,} "
          f"policy={spec.sharding_policy}")
    params = init_params(spec, torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    opt = init_opt_state(spec, params, cfg)
    step_fn = make_train_step(spec, cfg)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    hb = Heartbeat(args.ckpt_dir, "worker0")
    (params, opt), _, latest = ckpt.restore_latest((params, opt), device=dev)
    start = latest or 0
    if latest is not None:
        print(f"[train] resumed from step {start}")

    data = SyntheticTokens(vocab=spec.vocab, seq=args.seq,
                           global_batch=args.batch, seed=args.seed)
    rec = {"spec": spec, "start": start, "loss": [], "grad_norm": [],
           "lr_scale": [], "step_s": []}
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = data.batch(step, device=dev)
        params, opt, metrics = retry_step(step_fn, params, opt, batch)
        for k in ("loss", "grad_norm", "lr_scale"):
            rec[k].append(float(metrics[k]))       # waits for the step
        rec["step_s"].append(time.perf_counter() - t_step)
        hb.beat(step)
        if (step + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t0) / args.log_every
            t0 = time.perf_counter()
            print(f"  step {step+1:5d} loss {rec['loss'][-1]:.4f} "
                  f"gnorm {rec['grad_norm'][-1]:.3f} {dt*1e3:.0f}ms/step")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt), extra={"arch": spec.name})
    t_save = time.perf_counter()
    ckpt.save(args.steps, (params, opt), extra={"arch": spec.name})
    rec["save_s"] = time.perf_counter() - t_save
    print("[train] done")
    rec.update(params=params, opt=opt, steps=args.steps)
    return rec


def _smoke(args):
    """``--smoke``: a tiny full-lifecycle config -- 2 partitions, a small
    scene, densify mid-run so the probe -> train -> densify -> re-probe
    loop (and a checkpointed schedule) runs end to end; ``--steps`` /
    ``--ckpt-dir`` stay the caller's, so a second invocation resumes."""
    args.dataset = "sphere_shell"
    args.parts = 2
    args.resolution = min(args.resolution, 32)
    args.views = args.views or 4
    args.view_batch = args.view_batch or 2
    if args.densify_every == 0:
        args.densify_every, args.densify_from = 2, 1


def _cfg(args) -> GSTrainCfg:
    return GSTrainCfg(view_batch=args.view_batch or 1,
                      exchange=args.exchange,
                      exchange_budget=args.exchange_budget,
                      dtype_policy=args.dtype_policy,
                      grad_compress=args.grad_compress)


def _mesh(args, cfg: GSTrainCfg, n_views: int, world: int):
    """``--mesh PxV``, or the widest "view" axis the effective minibatch
    supports with the rest on "part" -> (mesh, p, v)."""
    if args.mesh:
        p, v = (int(x) for x in args.mesh.lower().split("x"))
        if p * v != world:
            raise SystemExit(f"--mesh {args.mesh} needs {p * v} ranks, have "
                             f"{world} (run with torchrun --nproc-per-node "
                             f"{p * v})")
    else:
        v = math.gcd(max(1, min(cfg.view_batch, n_views)), world)
        p = world // v
    return mesh_mod.make_mesh((p, v), ("part", "view")), p, v


def run_gs(args):
    """The GS workflow on this rank -> 0.  Rank 0 prints and writes."""
    rank, world, dev = mesh_mod.init_distributed(args.device)
    rank0 = rank == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    if args.smoke:
        _smoke(args)
        if args.ckpt_every == 0:
            args.ckpt_every = 2

    cfg = _cfg(args)
    n_views = args.views or get_gs_dataset(
        args.dataset, "full" if args.full else "cpu").n_views
    mesh, p, v = _mesh(args, cfg, n_views, world)
    t0 = time.perf_counter()
    sc = gs_scene(args, cfg, p, dev)
    _sync(dev)
    ingest_s = time.perf_counter() - t0
    parts, points, colors, extent = sc.parts, sc.points, sc.colors, sc.extent
    center, radius, grid, cams = sc.center, sc.radius, sc.grid, sc.cams
    g, gts, masks, live_cap = sc.g, sc.gts, sc.masks, sc.live_cap
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
    step_s = []
    t0 = time.perf_counter()
    g1, o1, losses = dist_mod.fit_partitions(
        g, cams, gts, masks, cfg, mesh=mesh, steps=args.steps,
        extent=extent, generator=generator,
        densify_every=args.densify_every, densify_from=args.densify_from,
        grid=grid, schedule=sched, ckpt=ckpt, ckpt_every=args.ckpt_every,
        rebalance_every=args.rebalance_every, log_every=args.log_every,
        densify_cap=live_cap, step_times=step_s)
    _sync(dev)
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

    ranks = _rank_stats(dev, ingest_s=ingest_s, train_s=train_s,
                        step_ms=_median_ms(step_s), steps=len(step_s))
    g_all = dist_mod.gather_partitions(g1, mesh)
    del g1, o1
    if rank0:
        t0 = time.perf_counter()
        out = _write_outputs(args, g_all, parts, points, colors, cams, grid,
                             cfg, center, radius, extent, n_views, done, dev)
        _sync(dev)
        out.update(write_s=time.perf_counter() - t0, world=world,
                   mesh=[p, v], points=len(points), slots=list(g.active.shape),
                   losses=losses, ranks=ranks,
                   ckpt_bytes=_dir_bytes(os.path.join(
                       args.ckpt_dir, f"step_{done:09d}")))
        _print_record("[train-gs]", out, dev)
    torch.distributed.barrier()
    return 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(seconds):
    return statistics.median(seconds) * 1e3 if seconds else None


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _rank_stats(dev, **stats):
    """This rank's ``stats`` with its device-memory and host-memory (resident
    set) peaks and the compositor's and the projection's kernel launches
    (forward, backward), all-gathered -> every rank's, in rank order."""
    stats["rank"] = torch.distributed.get_rank()
    stats["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None)
    # ru_maxrss is in KiB on Linux
    stats["host_peak_gib"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    stats["launches"] = [rasterize.LAUNCHES, rasterize.BWD_LAUNCHES]
    stats["project_launches"] = [project_kernels.PROJECT_LAUNCHES,
                                 project_kernels.PROJECT_BWD_LAUNCHES]
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, stats)
    return out


def _print_record(tag, rec, dev):
    """Rank 0: the run's record as one JSON line (``<tag> record {...}``),
    rank 0's device-memory peak after its merge included."""
    rec["peak_gib_rank0"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                             if dev.type == "cuda" else None)
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(f"{tag} record {json.dumps(rec)}", flush=True)


def read_record(text: str, tag: str) -> dict:
    """The record ``_print_record`` printed into ``text`` (a run's standard
    output) -> the object; not exactly one record line raises ValueError."""
    head = f"{tag} record "
    lines = [ln for ln in text.splitlines() if ln.startswith(head)]
    if len(lines) != 1:
        raise ValueError(f"{len(lines)} '{head}' lines in the run's output")
    return json.loads(lines[0][len(head):])


def record_lines(rec: dict) -> list:
    """A record's numbers as lines of text: one a per-rank key (every
    rank's value, in rank order), then rank 0's merge and outputs, then the
    losses."""
    ranks = rec["ranks"]
    lines = [f"per rank {k}: {[r[k] for r in ranks]}"
             for k in ranks[0] if k != "rank"]
    ckpt = (f"checkpoint bytes {rec['ckpt_bytes']}" if "ckpt_bytes" in rec
            else f"chain bytes {rec['chain_bytes']}")
    lines.append(
        f"world {rec['world']}, mesh {rec['mesh']}; rank 0 merge + render + "
        f"write {rec['write_s']:.3f} s, peak after it {rec['peak_gib_rank0']}"
        f" GiB; merged PSNR {rec['psnr']:.4f} SSIM {rec['ssim']:.5f}, "
        f"{rec['live']} live splats, {rec['merged_bytes']} bytes; {ckpt}")
    lines.append(f"losses {rec['losses']}")
    return lines


def series_frame(args, cfg: GSTrainCfg, n_part: int, dev):
    """The frame a run keeps fixed, from its flags and the t = 0 scene:
    the dataset, the view count, the t = 0 scene (points, colors, extent),
    its centre and orbit radius, the tile grid, the orbital rig, the
    slots a partition may fill (``live_cap``: the largest partition with
    its ghost cells, x the dataset's ``capacity_factor`` when densifying)
    and the capacity of the batched (P, N) layout (``live_cap`` rounded up
    to a multiple of ``n_part``, so "part" can shard it) -> a namespace of
    them.  Densify is held to ``live_cap``: the padding past it is the
    mesh's, and a run fills the same slots on any number of ranks."""
    ds = get_gs_dataset(args.dataset, "full" if args.full else "cpu")
    n_views = args.views or ds.n_views
    scene = build_scene(ds, args.seed)
    points, colors, extent = scene
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
    live_cap = int(base * ds.capacity_factor) if args.densify_every \
        else base
    cap = -(-live_cap // n_part) * n_part     # "part"-shardable capacity
    return types.SimpleNamespace(ds=ds, n_views=n_views, scene=scene,
                                 center=center, radius=radius, grid=grid,
                                 cams=cams, capacity=cap, live_cap=live_cap)


def _prep(args, cfg: GSTrainCfg, fr, t_idx: int, dev):
    """``prepare_timestep`` of timestep ``t_idx`` (t = t_idx * --dt) in
    the frame ``fr``."""
    return prepare_timestep(
        fr.ds, fr.cams, fr.grid, t=t_idx * args.dt, seed=args.seed,
        n_parts=args.parts, capacity=fr.capacity, K=cfg.K,
        use_ghost=not args.no_ghost,
        use_mask=not args.no_mask, device=dev,
        scene=fr.scene if t_idx == 0 else None)


def gs_scene(args, cfg: GSTrainCfg, n_part: int, dev):
    """The CLI's training inputs from its flags (``--dataset``, ``--full``,
    ``--seed``, ``--parts``, ``--resolution``, ``--views``,
    ``--no-ghost``, ``--no-mask``, ``--densify-every``): ``series_frame``
    and ``prepare_timestep`` at t = 0 -- the isosurface scene, its
    partitions with ghost cells, the orbital rig, the batched (P, N)
    initial gaussians and each partition's GT renders and coverage masks
    at bg = 0 (the distributed tile loss compares raw premultiplied color
    tiles) -> a namespace of them."""
    fr = series_frame(args, cfg, n_part, dev)
    td = _prep(args, cfg, fr, 0, dev)
    return types.SimpleNamespace(
        parts=td.parts, points=td.points, colors=td.colors,
        extent=td.extent, center=fr.center, radius=fr.radius, grid=fr.grid,
        cams=fr.cams, g=td.g0, gts=td.gts, masks=td.masks,
        live_cap=fr.live_cap)


def _write_outputs(args, g_all, parts, points, colors, cams, grid, cfg,
                   center, radius, extent, n_views, done, dev, *,
                   tag="[train-gs]", series=None):
    """Rank 0: per-partition checkpoints, merge, render, metrics, the merged
    checkpoint and the final render -> {"psnr", "ssim", "live",
    "merged_bytes"}.  ``series`` ({"timestep", "t"} of a timeseries run's
    final timestep) labels the metrics and rides the checkpoints' extras:
    the timestep in the partitions', both in the merged one's."""
    part_list = [type(g_all)(*(f[i] for f in g_all))
                 for i in range(args.parts)]
    pckpt = CheckpointManager(os.path.join(args.ckpt_dir, "partitions"),
                              keep=2)
    part_extra = {"dataset": args.dataset}
    if series:
        part_extra["timestep"] = series["timestep"]
    for pid, gp in enumerate(part_list):
        pckpt.save(done, gp, partition=pid, extra=part_extra)

    merged = merge_mod.merge_partitions(part_list,
                                        [pd.part_id for pd in parts])
    gt_imgs, _ = render_views(gt_gaussians(points, colors, device=dev), cams,
                              grid, K=cfg.K)
    renders, _ = render_views(merged, cams, grid, K=cfg.K)
    ps = float(np.mean([float(metrics.psnr(renders[i], gt_imgs[i]))
                        for i in range(n_views)]))
    ss = float(np.mean([float(metrics.ssim(renders[i], gt_imgs[i]))
                        for i in range(n_views)]))
    label = f"timestep {series['timestep']} " if series else ""
    print(f"{tag} {label}PSNR {ps:.2f}  SSIM {ss:.4f}  "
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
    merged_extra.update(series or {})
    merged_save = merged
    if args.ckpt_quantize == "int8":
        merged_save, quant_meta = quantize_cold(merged)
        merged_extra["quant"] = quant_meta
        print(f"{tag} merged checkpoint cold attributes quantized "
              f"(int8, fields={list(quant_meta['fields'])})", flush=True)
    merged_dir = mckpt.save(done, merged_save, extra=merged_extra)
    np.save(os.path.join(args.ckpt_dir, "render_final.npy"),
            renders.cpu().numpy())
    print(f"{tag} merged checkpoint (step {done}) + final render "
          f"saved under {args.ckpt_dir}", flush=True)
    return {"psnr": ps, "ssim": ss, "live": int(merged.active.sum()),
            "merged_bytes": _dir_bytes(merged_dir)}


def run_gs_timeseries(args):
    """``--gs --timeseries``: timesteps t = 0..T-1 of the evolving volume on
    this rank -> 0.  Each timestep warm-starts ``fit_partitions`` from the
    previous one's committed state (restored TierSchedule caps and
    ExchangeSchedule budgets, no init probe), commits a full checkpoint
    (timestep 0) or a delta against the previous timestep to
    ``<ckpt>/timeseries``, and has the next timestep's ingest prefetched on
    a worker thread meanwhile.  A restart resumes at the last committed
    timestep.  Rank 0 prints and writes; every rank restores."""
    rank, world, dev = mesh_mod.init_distributed(args.device)
    rank0 = rank == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    if args.smoke:
        _smoke(args)
        args.timesteps = min(args.timesteps, 2)
        if args.densify_cap is None:
            args.densify_cap = 4096

    cfg = _cfg(args)
    T, S = args.timesteps, args.steps
    n_views = args.views or get_gs_dataset(
        args.dataset, "full" if args.full else "cpu").n_views
    mesh, p, v = _mesh(args, cfg, n_views, world)
    # the series-fixed frame: rig, grid and capacity come from the t = 0
    # scene, so every timestep shares one (P, N) / (P, V, H, W) layout --
    # the warm-started state and the delta diffs both depend on it.  The
    # capacity_factor slack covers densify growth AND the extraction's
    # drift over the series (prepare_timestep raises past it).
    fr = series_frame(args, cfg, p, dev)
    say(f"[train-gs-ts] dataset={args.dataset} timesteps={T} dt={args.dt} "
        f"steps/timestep={S} parts={args.parts} res={args.resolution} "
        f"mesh={p}x{v} ({world} ranks, {mesh_mod.backend_for(dev)} on "
        f"{dev.type}) capacity={fr.capacity} "
        f"densify_cap={args.densify_cap} dtype={cfg.dtype_policy} "
        f"grad-compress={cfg.grad_compress}")

    # the delta chain: one keep=0 manager (a delta needs its whole base
    # chain), a full save at timestep 0, per-field row diffs after it
    tck = CheckpointManager(os.path.join(args.ckpt_dir, "timeseries"),
                            keep=0)
    latest = tck.latest_restorable_step()
    t_start = 0 if latest is None else latest // S
    if t_start:
        say(f"[train-gs-ts] restarting at timestep {t_start} "
            f"(chain committed through step {latest})")

    def restore(step, td, device):
        # the chain's (g, opt) at ``step``, its slots fitted to this mesh's
        like = (td.g0, init_opt(td.g0))
        tree, extra = tck.restore_delta(step, unshaped_like(like),
                                        device=device)
        return dist_mod.fit_slots(tree, like), extra

    densify_cap = fr.live_cap if args.densify_cap is None \
        else min(args.densify_cap, fr.live_cap)
    # per timestep: the ingest's seconds in the worker, the main thread's
    # wait for it, the median step, the losses
    prep_s, wait_s, step_ms, loss_log = {}, [], [], []

    def prep(t_idx):
        t0 = time.perf_counter()
        td = _prep(args, cfg, fr, t_idx, dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        prep_s[t_idx] = time.perf_counter() - t0
        return td

    warm = None           # (host state tree, extra, global step)
    td = g_all = None
    with TimestepPrefetcher(dev) as pf:
        if t_start < T:
            pf.submit(prep, t_start)
        for t in range(t_start, T):
            t0 = time.perf_counter()
            td = pf.get()
            wait_s.append(time.perf_counter() - t0)
            if t + 1 < T:
                # streaming ingest: t + 1's prep overlaps t's training
                pf.submit(prep, t + 1)
            if warm is None and t > 0:
                # the restart: the warm seed from the committed delta chain
                warm = (*restore(t * S, td, "cpu"), t * S)
            if t > 0:
                src = warm[1].get("timestep", t - 1)
                say(f"[train-gs-ts] timestep {t}: warm-start from "
                    f"timestep {src} (step {warm[2]}) — schedule + "
                    "exchange restored, no init probe")
            else:
                say("[train-gs-ts] timestep 0: cold start")

            sched = cfg.tier_schedule()
            ex = dist_mod.ExchangeSchedule(budget=cfg.exchange_budget) \
                if cfg.exchange else None
            # a fresh generator each timestep: fit_partitions fast-forwards
            # it over the densify events before the warm step, so the split
            # noise is a continuous run's
            generator = torch.Generator(device=dev).manual_seed(args.seed)
            _sync(dev)
            step_s = []
            t0 = time.perf_counter()
            g1, o1, losses = dist_mod.fit_partitions(
                td.g0, fr.cams, td.gts, td.masks, cfg, mesh=mesh,
                steps=(t + 1) * S, extent=td.extent, generator=generator,
                densify_every=args.densify_every,
                # series-absolute, so the fast-forward replays exactly the
                # densify events a continuous run would have had
                densify_from=args.densify_from, grid=fr.grid,
                schedule=sched, exchange_schedule=ex,
                rebalance_every=args.rebalance_every,
                log_every=args.log_every, warm_start=warm,
                densify_cap=densify_cap, step_times=step_s)
            _sync(dev)
            dt_s = time.perf_counter() - t0
            step_ms.append(_median_ms(step_s))
            loss_log.append(losses)
            # commit the timestep (every rank gathers; rank 0 writes)
            g_all, o_all = dist_mod.gather_partitions((g1, o1), mesh)
            del g1, o1
            live = int(g_all.active.sum())
            say(f"[train-gs-ts] timestep {t} (t={td.t:.3f}): steps "
                f"{t * S}->{(t + 1) * S} ({dt_s:.1f}s)  final loss "
                f"{losses[-1]:.4f}  live splats {live:,}")
            tree = tree_map(lambda x: x.cpu(), (g_all, o_all))
            del o_all
            extra = {"timestep": t, "t": float(td.t),
                     "schedule": sched.state_dict() if sched else None,
                     "exchange": ex.state_dict() if ex else None,
                     "dtype_policy": cfg.dtype_policy,
                     "grad_compress": cfg.grad_compress}
            if rank0:
                if t == 0:
                    tck.save(S, tree, extra=extra)
                else:
                    tck.save_delta((t + 1) * S, tree, base_step=t * S,
                                   extra=extra)
            torch.distributed.barrier()
            warm = (tree, extra, (t + 1) * S)

    if g_all is None:
        # the chain is complete: the final timestep for the merge below
        td = _prep(args, cfg, fr, T - 1, dev)
        (g_all, _), _ = restore(T * S, td, dev)
        say(f"[train-gs-ts] chain already complete at timestep {T - 1}; "
            "skipping to merge")
    td.gts = td.masks = None          # the merge renders its own
    ranks = _rank_stats(dev, prep_s=[prep_s.get(t) for t in range(T)],
                        wait_s=wait_s, step_ms=step_ms)
    if rank0:
        t0 = time.perf_counter()
        out = _write_outputs(args, g_all, td.parts, td.points, td.colors,
                             fr.cams, fr.grid, cfg, fr.center, fr.radius,
                             td.extent, fr.n_views, T * S, dev,
                             tag="[train-gs-ts]",
                             series={"timestep": T - 1, "t": float(td.t)})
        _sync(dev)
        chain = os.path.join(args.ckpt_dir, "timeseries")
        out.update(write_s=time.perf_counter() - t0, world=world,
                   mesh=[p, v], t_start=t_start, losses=loss_log,
                   ranks=ranks, chain_bytes={
                       s: _dir_bytes(os.path.join(chain, f"step_{s:09d}"))
                       for s in tck.all_steps()})
        _print_record("[train-gs-ts]", out, dev)
    torch.distributed.barrier()
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags (the reference's, with ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--gs", action="store_true")
    # LM
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: reduced same-family config; GS: tiny "
                         "full-lifecycle run (2 parts, small scene, densify "
                         "+ checkpoint on)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--kv-chunk", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    # GS
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
                    help="--timeseries: ceiling on LIVE splats per "
                         "partition (densify stops growing at it, so memory "
                         "stays bounded across timesteps; default "
                         "uncapped); --gs ignores it, as the reference "
                         "does")
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
                    help="cuda or cpu (GS: NCCL, one card per rank, or "
                         "gloo)")
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
    ap.add_argument("--timeseries", action="store_true",
                    help="train timesteps t=0..T-1 of the evolving volume; "
                         "each warm-starts from the previous one's "
                         "committed state (restored schedules, no init "
                         "probe), with delta checkpoints between timesteps "
                         "and the next timestep's ingest prefetched during "
                         "training")
    ap.add_argument("--timesteps", type=int, default=4,
                    help="number of timesteps T for --timeseries")
    ap.add_argument("--dt", type=float, default=0.1,
                    help="time between timesteps (the volume evolves as "
                         "t = index * dt)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.gs:
        run_lm(args)
        return 0
    owns_group = not torch.distributed.is_initialized()
    try:
        return run_gs_timeseries(args) if args.timeseries else run_gs(args)
    finally:
        if owns_group:
            mesh_mod.destroy_distributed()


if __name__ == "__main__":
    raise SystemExit(main())

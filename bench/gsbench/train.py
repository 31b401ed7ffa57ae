"""The ``train`` traffic driver: the distributed trainer's steps back to
back, as the paper's users run them.

Set-up makes the inputs (``scene``), composes the program's ingest as its
training CLI does (partitions with ghost cells, the batched initial
splats, each partition's ground-truth renders and coverage masks), and
builds one training state that ``fit_partitions`` drives through its
first steps: step 1 (which probes the tier schedule), steps 2-3, and the
rest of the rig's first lap (where a view outgrows the probed tier caps,
they grow, so the window runs the grown shapes).  Those calls resume one
from another through an in-memory checkpoint, so that the states after
steps 1 and 3 can be read.  The window is then one ``fit_partitions``
call that warm-starts from a host copy of the lap's state for ``n + 1``
steps, ``n`` from ``--seconds`` over the lap's median step: it opens at
the end of the call's first step (the upload and sharding done) and
closes at the end of its last, marked where the call appends to
``step_times``.  Each step takes one
view a partition, the rig's views in order; nothing densifies.

The output check runs after the window, on rank 0, with the program's
state freed: the plain reference extracts the points again, partitions
them, builds the initial splats, renders the ground truth of the first
three steps' views and takes three steps of its own, and the program's
first three losses, first gradient (from Adam's first moment after step
1) and change after step 3 are held against its.  Then, for the steady
state the window ran (grown tier caps, trained splats, Adam's moments
after the window), the program takes one more step from the state the
window left, and the reference takes the same step from that state: the
loss and the change of that step join the loss and change gaps.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
import types

import torch
import torch.distributed as dist

from gsbench import fields, reference, scene
from gsbench.harness import MemoryCheckpoint, Run, forbidden_loaded, judge
from gsbench.trace import DeviceTrace

FIELDS = reference.FIELDS


def _host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _to_host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _from_rank0(value: int, dev) -> int:
    """Rank 0's ``value`` on every rank."""
    if dist.get_world_size() == 1:
        return value
    t = torch.tensor([value], device=dev)
    dist.broadcast(t, 0)
    return int(t.item())


class _StepTimes(list):
    """``fit_partitions``' ``step_times`` list that calls ``mark(k)`` once
    the call has appended its ``k``-th step (read back, so finished on the
    device)."""

    def __init__(self, mark):
        super().__init__()
        self.mark = mark

    def append(self, x):
        super().append(x)
        self.mark(len(self))


class _Window:
    """The measured window inside one ``fit_partitions`` call of ``n + 1``
    steps: it opens at the end of the call's first step and closes at the
    end of its last, so it holds ``n`` whole steps and none of the call's
    warm start before them."""

    def __init__(self, n: int, dev, trace: bool, rasterize):
        self.n, self.dev, self.rasterize = n, dev, rasterize
        self.tracing = trace
        self.trace = DeviceTrace(trace and dev.type == "cuda")
        self.t0 = self.t1 = None
        self.peak = 0
        self.launches = []
        self.times = _StepTimes(self._mark)

    def _mark(self, k: int):
        if k == 1:
            _sync(self.dev)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.dev)
            self.rasterize.RECORDER = [] if self.tracing else None
            self.trace.__enter__()
            self.t0 = time.time()
        elif k == self.n + 1:
            _sync(self.dev)
            # before the profiler's exit, which reads its events back
            self.t1 = time.time()
            self.trace.__exit__(None, None, None)
            self.launches = self.rasterize.RECORDER or []
            self.rasterize.RECORDER = None
            if self.dev.type == "cuda":
                self.peak = torch.cuda.max_memory_allocated(self.dev)


def run_train(run: Run):
    """One run on this rank -> the result pieces on rank 0, None on the
    others."""
    from repro_torch.configs.gs_datasets import GSDataset
    from repro_torch.core import distributed as D
    from repro_torch.core.cameras import Camera
    from repro_torch.core.partition import partition_points
    from repro_torch.core.pipeline import prepare_timestep
    from repro_torch.core.tiling import TileGrid
    from repro_torch.core.train import GSTrainCfg
    from repro_torch.kernels import rasterize
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime.checkpoint import tree_map

    cfg_d = run.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, dev = mesh_mod.init_distributed(run.device)
    rank0 = rank == 0
    say = run.say if rank0 else (lambda msg: None)
    tc = cfg_d["train"]
    P, V = int(cfg_d["partitions"]), int(cfg_d["views"])
    W = H = int(cfg_d["image"])
    th, tw, K = int(tc["tile_h"]), int(tc["tile_w"]), int(tc["K"])

    with run.spans.span("setup.points"):
        pts, cols, rows, count = scene.source(run.cell).points(
            cfg_d, run.seed, dev)
        points, colors = pts.cpu().numpy(), cols.cpu().numpy()
        prog_points = points.copy() if rank0 else None
        del pts, cols
    center, extent, _ = scene.frame(points)
    views_np = scene.train_views(V, center, extent)
    focal = reference.focal_for(W)
    f32 = dict(dtype=torch.float32, device=dev)
    cams = Camera(torch.from_numpy(views_np).to(dev),
                  torch.full((V,), focal, **f32),
                  torch.full((V,), focal, **f32), W, H)
    grid = TileGrid(W, H, th, tw)
    cfg = GSTrainCfg(K=K, tile_h=th, tile_w=tw, view_batch=1,
                     dtype_policy=tc["dtype_policy"])
    ds = GSDataset(run.cell.spec["config"], cfg_d["field"], len(points),
                   n_views=V, resolutions=(W,),
                   capacity_factor=float(tc["capacity_factor"]),
                   ghost_frac=float(tc["ghost_frac"]))
    with run.spans.span("setup.ingest"):
        parts, _ = partition_points(points, colors, P,
                                    ghost_width=ds.ghost_frac * extent)
        base = max(len(pd.points) for pd in parts)
        del parts
        cap = -(-int(base * ds.capacity_factor) // world) * world
        td = prepare_timestep(ds, cams, grid, t=0.0, seed=run.seed,
                              n_parts=P, capacity=cap, K=K, use_ghost=True,
                              use_mask=bool(tc["masks"]), device=dev,
                              scene=(points, colors, extent))
        _sync(dev)
    live = int(td.g0.active.sum())
    mesh = mesh_mod.make_mesh((world, 1), ("part", "view"))
    sched = cfg.tier_schedule()
    mem = MemoryCheckpoint()
    losses, step_times = [], []
    lap = max(V, 3)

    def keep(to: int, g, opt):
        # every rank resumes from the global tree, which the program's
        # own save leaves on rank 0 alone
        if world > 1:
            tree = D.gather_partitions((g, opt), mesh)
            box = [mem.extra]
            dist.broadcast_object_list(box, 0)
            mem.save(to, tree, box[0])

    def chunk(to: int):
        g, opt, ls = D.fit_partitions(
            td.g0, cams, td.gts, td.masks, cfg, mesh=mesh, steps=to,
            extent=extent, grid=grid, schedule=sched, ckpt=mem,
            step_times=step_times)
        losses.extend(ls)
        keep(to, g, opt)
        del g, opt

    p0 = _host(td.g0.trainable()) if rank0 else None
    with run.spans.span("setup.first_steps"):
        chunk(1)
        m1 = _host(mem.tree[1].m) if rank0 else None
        chunk(3)
        p3 = _host(mem.tree[0].trainable()) if rank0 else None
        caps3 = sched.tier_caps
        # the rest of the first lap of the rig: the tier caps grow where a
        # view outgrows the probe's, and the window starts with them grown
        chunk(lap)
        _sync(dev)
    first_losses = losses[:3]
    say(f"points {len(points)} of {count} crossings (R = "
        f"{cfg_d['resolution']}), {P} partitions of {cap} slots, {live} "
        f"live; mesh ({world}, 1) (\"part\", \"view\"); tiers "
        f"{sched.k_tiers} caps {caps3} after step 3, {sched.tier_caps} "
        f"after the first lap ({len(losses)} steps); first losses "
        f"{first_losses}")
    n = _from_rank0(max(1, math.ceil(
        run.seconds / statistics.median(step_times[1:] or step_times))), dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    # ---- the window: one fit_partitions call ------------------------------
    # it continues from a host copy of the lap's state (the program's warm
    # start): a resume from ``mem`` would keep the restored global tree and
    # a fresh moment template on the card all through the call
    warm = (tree_map(_to_host, mem.tree), mem.extra, lap)
    mem.tree = None
    win = _Window(n, dev, run.trace, rasterize)
    with run.spans.span("fit_partitions"):
        g, opt, win_all = D.fit_partitions(
            td.g0, cams, td.gts, td.masks, cfg, mesh=mesh,
            steps=lap + 1 + n, extent=extent, grid=grid, schedule=sched,
            warm_start=warm, step_times=win.times)
    setup_s = win.t0 - run.t_start
    window_s = win.t1 - win.t0
    win_losses = win_all[1:]
    steps = len(win_losses)
    trace, launches, peak = win.trace, win.launches, win.peak
    stats = {"peak": peak, "setup_peak": max(setup_peak, peak),
             "busy_s": trace.busy_s() if run.trace else None,
             "forbidden": forbidden_loaded()}
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, stats)
    else:
        every = [stats]
    sched_caps = sched.tier_caps

    # ---- one more step, from the state the window left, for the check ----
    end = lap + 1 + n
    tree = D.gather_partitions((g, opt), mesh)
    del g, opt
    mem.save(end, tree, dict(warm[1], schedule=sched.state_dict()))
    del tree, warm
    late = None
    if rank0:
        g_end, o_end = mem.tree[0], mem.tree[1]
        late = {"params": _host(g_end.trainable()), "m": _host(o_end.m),
                "v": _host(o_end.v), "done": int(o_end.step),
                "active": g_end.active.detach().cpu(), "view": end % V}
        del g_end, o_end
    chunk(end + 1)
    if rank0:
        late["loss"] = losses[-1]
        late["after"] = _host(mem.tree[0].trainable())
        late["caps"] = sched.tier_caps
    del td, mem, cams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if world > 1:
        dist.barrier()
    mesh_mod.destroy_distributed()
    if not rank0:
        return None

    say("set-up spans " + ", ".join(
        f"{name} {(b - a) / 1e9:.2f} s" for name, a, b in run.spans.items
        if name.startswith("setup")) + f"; set-up {setup_s:.2f} s")
    say(f"window {window_s:.3f} s, {steps} steps in one fit_partitions "
        f"call of {n + 1} (its first in set-up; {n} from {run.seconds} s "
        f"over the first lap's median step), tier caps {sched_caps}, "
        f"{late['caps']} after the check's step; step ms median "
        f"{statistics.median(win.times[1:]) * 1e3:.2f}; peaks GiB "
        f"{[round(s['peak'] / 2**30, 3) for s in every]}")

    # ---- the output check --------------------------------------------------
    t_check = time.time()
    with run.spans.span("check"):
        readings = check_train(run, cfg_d, prog_points, rows, count,
                               first_losses, m1, p0, p3, late, extent,
                               views_np, focal, cap, dev)
    say(f"output check {time.time() - t_check:.1f} s")
    correct, checks = judge(readings, run.cell.limits)
    failed = sum(1 for x in win_losses if not math.isfinite(x))
    ctx = types.SimpleNamespace(
        kind="train", trace=trace if run.trace else None, spans=run.spans,
        launches=launches or [], window_s=window_s, steps=steps,
        step_times=list(win.times[1:]), requests=0, telemetry=None,
        shapes={"partitions": P, "slots": cap, "views": 1, "width": W,
                "height": H, "K": K},
        cards=world, busy=[s["busy_s"] for s in every])
    return {
        "correct": correct and failed == 0 and steps > 0,
        "attempted": steps, "failed": failed,
        "e2e": {"train_step_ms": window_s * 1e3 / max(steps, 1),
                "peak_mem_gib": max(s["peak"] for s in every) / 2**30,
                "setup_s": setup_s},
        "device_count": world,
        "memory_peak_bytes": max(s["setup_peak"] for s in every),
        "forbidden": sorted({f for s in every for f in s["forbidden"]}),
        "ctx": ctx, "checks": checks}


def check_train(run, cfg_d, prog_points, rows, count, prog_losses, m1, p0,
                p3, late, extent, views_np, focal, cap, dev):
    """The reference's readings of the program's first three steps, and of
    its step from the state the window left (``late``)."""
    tc = cfg_d["train"]
    P = int(cfg_d["partitions"])
    W = H = int(cfg_d["image"])
    th, tw, K = int(tc["tile_h"]), int(tc["tile_w"]), int(tc["K"])
    prec = reference.Precision("f32")
    out = {}
    shape = dict(width=W, height=H, tile_h=th, tile_w=tw, K=K)
    with prec.backend_flags():
        allpts = scene.source(run.cell).reference_points(cfg_d, dev)
        if allpts.shape[0] != count:
            out["points_gap"] = float("inf")
            return out
        pts = allpts[torch.from_numpy(rows).to(dev)]
        del allpts
        out["points_gap"] = float(
            (pts - torch.from_numpy(prog_points).to(dev)).abs().max())
        cols = fields.height_colors(pts)
        pts_np = pts.cpu().numpy()
        ghost = float(tc["ghost_frac"]) * extent
        blocks = reference.partition(pts_np, P, ghost)
        # the first three steps' views, then the late step's
        order = [0, 1, 2, late["view"]]
        init = []
        gts, masks = [[] for _ in order], [[] for _ in order]
        views = [torch.from_numpy(views_np[i]).to(dev) for i in order]
        for rows_p, _, _ in blocks:
            ix = torch.from_numpy(rows_p).to(dev)
            init.append(reference.init_splats(pts[ix], cols[ix], cap,
                                             float(tc["init_opacity"])))
            gt_s = reference.init_splats(pts[ix], cols[ix], len(rows_p),
                                         float(tc["gt_opacity"]))
            for i, view in enumerate(views):
                rgb, cov = reference.render_image(gt_s, view, focal, bg=0.0,
                                                  prec=prec, **shape)
                gts[i].append(rgb)
                masks[i].append(reference.coverage_mask(cov, prec)
                                if tc["masks"] else torch.ones_like(
                                    cov, dtype=torch.bool))
            del gt_s
        gts = [torch.stack(x) for x in gts]
        masks = [torch.stack(x) for x in masks]
        ref0 = {k: torch.stack([s[k] for s in init]) for k in FIELDS}
        losses, first, params = reference.train_steps(
            init, views[:3], focal, gts[:3], masks[:3], steps=3,
            extent=extent, prec=prec, **shape)
        change_ref = {k: params[k] - ref0[k] for k in FIELDS}
        del init, params, ref0
        # the late step, from the program's state after the window
        start = {k: x.to(dev) for k, x in late["params"].items()}
        active = late["active"].to(dev)
        parts = [{**{k: start[k][p] for k in FIELDS}, "active": active[p]}
                 for p in range(P)]
        opt = ({k: x.to(dev) for k, x in late["m"].items()},
               {k: x.to(dev) for k, x in late["v"].items()}, late["done"])
        late_losses, late_first, late_params = reference.train_steps(
            parts, views[3:], focal, gts[3:], masks[3:], steps=1,
            extent=extent, prec=prec, opt=opt, **shape)
        late_ref = {k: late_params[k] - start[k] for k in FIELDS}
        del parts, opt, late_params
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog_losses, losses)]
    late_loss = abs(late["loss"] - late_losses[0]) / abs(late_losses[0])
    out["loss_gap"] = max(gaps + [late_loss])
    b1 = 0.9
    grad_prog = {k: m1[k].to(dev) / (1 - b1) for k in FIELDS}
    out["grad_gap"], _ = reference.leaf_gaps(grad_prog, first)
    keep = reference.moved_leaves(first)
    change_prog = {k: (p3[k] - p0[k]).to(dev) for k in FIELDS}
    early_change, per_leaf = reference.leaf_gaps(change_prog, change_ref,
                                                 keep)
    late_keep = reference.moved_leaves(late_first)
    late_prog = {k: (late["after"][k] - late["params"][k]).to(dev)
                 for k in FIELDS}
    late_change, late_leaf = reference.leaf_gaps(late_prog, late_ref,
                                                 late_keep)
    out["change_gap"] = max(early_change, late_change)
    run.say(f"reference losses {losses} program {prog_losses}; change gaps "
            f"by leaf {per_leaf}; leaves compared {keep}")
    run.say(f"late step (view {late['view']}, Adam step {late['done'] + 1})"
            f": reference loss {late_losses[0]} program {late['loss']}, gap "
            f"{late_loss}; change gaps by leaf {late_leaf}; leaves compared "
            f"{late_keep}; first three steps: loss gap {max(gaps)}, change "
            f"gap {early_change}")
    return out

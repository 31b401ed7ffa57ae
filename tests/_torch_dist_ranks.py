"""Rank-side functions of the distributed port tests (torch only; run by
``_torch_dist.run_ranks`` in spawned processes).  Inputs arrive as ``.npz``
files written by the test, results leave the same way."""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.cameras import Camera, select
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.tiling import TileGrid
from repro_torch.core.train import GSTrainCfg, init_opt
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime.checkpoint import CheckpointManager

from _torch_dist import PG_TIMEOUT_S

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")


def load_scene(path):
    """-> (g (P, N), cams, gts (P, V, H, W, 3), masks (P, V, H, W) or
    None, grid, meta) from a test's npz."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    g = Gaussians(**{k: torch.from_numpy(z[f"g_{k}"].copy())
                     for k in Gaussians._fields})
    cams = Camera(torch.from_numpy(z["cam_view"].copy()),
                  torch.from_numpy(z["cam_fx"].copy()),
                  torch.from_numpy(z["cam_fy"].copy()),
                  int(meta["width"]), int(meta["height"]))
    masks = torch.from_numpy(z["masks"].copy()) if "masks" in z else None
    grid = TileGrid(*meta["grid"])
    return g, cams, torch.from_numpy(z["gts"].copy()), masks, grid, meta


def save_tree(path, g, opt=None, losses=None, **extra):
    out = {f"g_{k}": v.numpy() for k, v in g._asdict().items()}
    if opt is not None:
        for k in FIELDS:
            out[f"m_{k}"] = opt.m[k].numpy()
            out[f"v_{k}"] = opt.v[k].numpy()
        out["grad_accum"] = opt.grad_accum.numpy()
        out["grad_count"] = opt.grad_count.numpy()
        out["step"] = opt.step.numpy()
    if losses is not None:
        out["losses"] = np.asarray(losses, np.float64)
    out.update(extra)
    np.savez(path, **out)


def step_rank(mesh, scene_path, out_dir, k_tiers, tier_caps, cfg_kw, views):
    """One distributed train step from the scene's state on the batch of
    views ``[0, views)``; rank 0 saves the gathered state, every rank its
    loss."""
    g, cams, gts, masks, grid, meta = load_scene(scene_path)
    cfg = GSTrainCfg(**cfg_kw)
    gt_t, mask_t = D._tile_view_batches(gts, masks, grid)
    vi = torch.arange(views)
    batch = {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
             "cam": Camera(cams.view[vi], cams.fx[vi], cams.fy[vi],
                           cams.width, cams.height)}
    step = D.make_gs_train_step(
        mesh, cfg, grid, meta["extent"], impl="ref", views=views,
        k_tiers=None if k_tiers is None else tuple(k_tiers),
        tier_caps=None if tier_caps is None else tuple(tier_caps),
        return_overflow=True)
    gl, ol = D.gs_shard_state((g, init_opt(g)), mesh)
    g1, o1, loss, ov = step(gl, ol, D.gs_shard_batch(batch, mesh, views))
    g1, o1 = D.gather_partitions((g1, o1), mesh)
    rank = dist.get_rank()
    np.save(os.path.join(out_dir, f"loss{rank}.npy"),
            np.asarray([float(loss), int(ov["tiles"]), int(ov["assign"]),
                        int(ov["exchange"])], np.float64))
    if rank == 0:
        save_tree(os.path.join(out_dir, "state.npz"), g1, o1)


def fit_rank(mesh, scene_path, out_dir, cfg_kw, fit_kw, noise_path=None,
             ckpt_dir=None, tag="fit", seed=None, warm=None):
    """``fit_partitions`` on the scene; rank 0 saves the gathered result,
    every rank its losses.  ``warm=(dir, step[, keep_err])``: warm-start
    from that checkpoint's tree, extra and step instead of a disk resume
    (under int8 the tree holds the residual; ``keep_err`` False hands in
    only (g, opt))."""
    g, cams, gts, masks, grid, meta = load_scene(scene_path)
    cfg = GSTrainCfg(**cfg_kw)
    kw = dict(fit_kw)
    if warm is not None:
        like = (g, init_opt(g))
        if cfg.grad_compress == "int8":
            like += (D.zero_err(g, "int8"),)
        tree, extra = CheckpointManager(warm[0]).restore(
            warm[1], like, device="cpu")
        if len(warm) > 2 and not warm[2]:
            tree = tree[:2]
        kw["warm_start"] = (tuple(tree), extra, warm[1])
    if "grid" in kw:
        kw["grid"] = TileGrid(*kw["grid"])
    if noise_path is not None:
        z = np.load(noise_path)
        kw["densify_noise"] = [z[k] for k in sorted(z.files)]
    if seed is not None:
        kw["generator"] = torch.Generator().manual_seed(seed)
    if ckpt_dir is not None:
        kw["ckpt"] = CheckpointManager(ckpt_dir, keep=0)
    sched = cfg.tier_schedule()
    g1, o1, losses = D.fit_partitions(g, cams, gts, masks, cfg, mesh=mesh,
                                      schedule=sched, **kw)
    g1, o1 = D.gather_partitions((g1, o1), mesh)
    rank = dist.get_rank()
    np.save(os.path.join(out_dir, f"{tag}_losses{rank}.npy"),
            np.asarray(losses, np.float64))
    if rank == 0:
        caps = [] if sched is None or sched.tier_caps is None \
            else list(sched.tier_caps)
        save_tree(os.path.join(out_dir, f"{tag}.npz"), g1, o1, losses,
                  caps=np.asarray(caps, np.int64))


def wire_step_rank(mesh, scene_path, out_dir, tag, cfg_kw, views=2,
                   k_tiers="cfg", shape=None, axes=None):
    """One train step of ``cfg_kw`` (the wire and compression options)
    from the scene's state on the views ``[0, views)``, on the entry mesh
    or on a ``(shape, axes)`` mesh built on this world; ``k_tiers`` "cfg"
    takes the cfg's ladder.  Every rank saves its loss; rank 0 the
    gathered state and the gathered int8 residual (``e_<field>``)."""
    g, cams, gts, masks, grid, meta = load_scene(scene_path)
    m = mesh if shape is None else mesh_mod.make_mesh(
        shape, axes, timeout_s=PG_TIMEOUT_S)
    cfg = GSTrainCfg(**cfg_kw)
    Pn = g.means.shape[0]
    gt_t, mask_t = D._tile_view_batches(gts, masks, grid)
    vi = torch.arange(views)
    batch = {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
             "cam": select(cams, vi)}
    kw = {} if k_tiers == "cfg" else {
        "k_tiers": None if k_tiers is None else tuple(k_tiers)}
    step = D.make_gs_train_step(m, cfg, grid, meta["extent"], impl="ref",
                                views=views, return_overflow=True, **kw)
    gl, ol = D.gs_shard_state((g, init_opt(g)), m)
    b = D.gs_shard_batch(batch, m, views, n_parts=Pn)
    if cfg.grad_compress == "none":
        g1, o1, loss, _ = step(gl, ol, b)
        err = None
    else:
        g1, o1, err, loss, _ = step(
            gl, ol, D.zero_err(gl, cfg.grad_compress), b)
    g1, o1, err = D.gather_partitions((g1, o1, err), m)
    rank = dist.get_rank()
    np.save(os.path.join(out_dir, f"{tag}_loss{rank}.npy"),
            np.asarray([float(loss)], np.float64))
    if rank == 0:
        extra = {} if err is None else {f"e_{k}": v.numpy()
                                        for k, v in err.items()}
        save_tree(os.path.join(out_dir, f"{tag}.npz"), g1, o1, **extra)


def probe_counter_rank(mesh, scene_path, out_dir, cfg_kw, fit_kw, noise_path,
                       ckpt_dir, tag, probe="probe_gs_schedule"):
    """``fit_rank`` with the calls of ``D.<probe>`` counted (the tier
    probe, or ``probe_gs_exchange``: a resume makes none)."""
    calls = []
    real = getattr(D, probe)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    setattr(D, probe, counted)
    try:
        fit_rank(mesh, scene_path, out_dir, cfg_kw, fit_kw,
                 noise_path=noise_path, ckpt_dir=ckpt_dir, tag=tag)
    finally:
        setattr(D, probe, real)
    np.save(os.path.join(out_dir, f"{tag}_probes{dist.get_rank()}.npy"),
            np.asarray(len(calls)))


def cli_rank(mesh, argv, out_path):
    """``repro_torch.launch.train.main(argv)`` on this rank, stdout to
    ``out_path`` (rank-suffixed)."""
    import contextlib

    from repro_torch.launch import train

    path = f"{out_path}.{dist.get_rank()}"
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        rc = train.main(list(argv))
    if rc:
        raise SystemExit(rc)


def cli_rc_rank(mesh, argv, out_path):
    """``launch.train.main(argv)`` on this rank, its stdout and stderr to
    ``out_path`` (rank-suffixed) and its exit code to ``<out_path>.rc<rank>``
    (a refusal returns 2 without raising)."""
    import contextlib

    from repro_torch.launch import train

    r = dist.get_rank()
    with open(f"{out_path}.{r}", "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(f):
        rc = train.main(list(argv))
    with open(f"{out_path}.rc{r}", "w") as f:
        f.write(str(rc))


def card_fit_rank(mesh, out_dir, tag, steps, cfg_kw=None):
    """``fit_partitions`` on this rank's card: two partitions of a 128-splat
    sphere-shell model (192 slots), 4 views of 32x32 with two a step, a
    densify event every 3 steps with injected split noise; ``cfg_kw`` adds
    train-config fields (the wire options).  Every rank saves its losses
    and its kernel launches; rank 0 the gathered state."""
    from repro_torch.core.cameras import orbital_rig
    from repro_torch.core.gaussians import from_points
    from repro_torch.data.isosurface import point_cloud_for
    from repro_torch.kernels import rasterize
    from repro_torch.runtime.checkpoint import tree_map

    dev = mesh.device
    pts, cols = point_cloud_for("sphere_shell", 128)
    g = from_points(pts[:128], cols[:128], capacity=192, opacity=0.7,
                    device=dev)
    g = Gaussians(*(torch.stack([f, f]) for f in g))
    cams = orbital_rig(4, (0.5, 0.5, 0.5), 1.6, width=32, height=32,
                       device=dev)
    gts = torch.stack([torch.full((4, 32, 32, 3), c, device=dev)
                       for c in (0.5, 0.3)])
    cfg = GSTrainCfg(K=8, tile_h=8, tile_w=16, lr_colors=5e-2, max_new=32,
                     densify_grad_thresh=1e-9, **(cfg_kw or {}))
    noise = [np.random.default_rng(e).normal(size=(2, 32, 3)).astype("f4")
             for e in range(steps // 3)]
    fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
    g1, o1, losses = D.fit_partitions(
        g, cams, gts, None, cfg, mesh=mesh, steps=steps, extent=1.0,
        densify_every=3, densify_from=0, grid=TileGrid(32, 32, 8, 16),
        view_batch=2, densify_noise=noise)
    launches = [rasterize.LAUNCHES - fwd, rasterize.BWD_LAUNCHES - bwd]
    g1, o1 = D.gather_partitions((g1, o1), mesh)
    rank = dist.get_rank()
    np.save(os.path.join(out_dir, f"{tag}_losses{rank}.npy"),
            np.asarray(losses, np.float64))
    np.save(os.path.join(out_dir, f"{tag}_launches{rank}.npy"),
            np.asarray(launches))
    if rank == 0:
        g1, o1 = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                          else x, (g1, o1))
        save_tree(os.path.join(out_dir, f"{tag}.npz"), g1, o1, losses)


#: the forward variants ``axes_rank`` runs: (name, views, options); views
#: None is the unbatched step on view 0 (meshes without a "view" axis)
FWD_VARIANTS = (
    ("dense", 2, {}),
    ("strip", 2, dict(strip_budget=127 / 128)),
    ("sorted", 2, dict(strip_budget=127 / 128, k_tiers=(4, 8, 16),
                       assign_impl="sorted")),
    ("single", None, {}),
)


def axes_rank(mesh, scene_path, out_dir, meshes):
    """On each mesh of ``meshes`` [(tag, shape, axes)], built on this
    world: every forward variant of FWD_VARIANTS (K = 16, return_tiles) and
    one train step (the trainer's tiered default, two views) from the
    scene's state.  Every rank saves its coordinates, its groups' ranks,
    its losses, tiles and overflow counters; rank 0 the gathered state."""
    g, cams, gts, masks, grid, meta = load_scene(scene_path)
    Pn = g.means.shape[0]
    gt_t, mask_t = D._tile_view_batches(gts, masks, grid)
    vi = torch.arange(2)
    batches = {2: {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
                   "cam": select(cams, vi)},
               None: {"gt_tiles": gt_t[0], "mask_tiles": mask_t[0],
                      "cam": select(cams, 0)}}
    rank = dist.get_rank()
    for tag, shape, axes in meshes:
        m = mesh_mod.make_mesh(shape, axes, timeout_s=PG_TIMEOUT_S)
        ax = D._axes(m)
        out = {"coords": np.asarray(m.coords)}
        for sub in ((ax.pod, ax.data, ax.model), (ax.pod, ax.model, ax.view),
                    (ax.model, ax.view), (ax.pod,), (ax.data,)):
            grp = m.group(*sub)
            key = "+".join(a for a in sub if a)
            out[f"group_{key}"] = np.asarray(
                [rank] if grp is None else dist.get_process_group_ranks(grp))
        gl = D.gs_shard_state(g, m)
        for name, views, kw in FWD_VARIANTS:
            if views is None and ax.view is not None:
                continue
            b = D.gs_shard_batch(batches[views], m, views, n_parts=Pn)
            fwd = D.make_gs_forward(m, grid, K=16, impl="ref", views=views,
                                    return_tiles=True, return_overflow=True,
                                    **kw)
            loss, tiles, ov = fwd(gl, b["cam"], b["gt_tiles"],
                                  b["mask_tiles"])
            out[f"{name}_loss"] = np.asarray(float(loss), np.float64)
            out[f"{name}_tiles"] = tiles.detach().numpy()
            out[f"{name}_overflow"] = np.asarray([int(ov["tiles"]),
                                                  int(ov["assign"])])
        cfg = GSTrainCfg(K=16, view_batch=2)
        step = D.make_gs_train_step(m, cfg, grid, meta["extent"], impl="ref",
                                    views=2, return_overflow=True)
        gs, opt0 = D.gs_shard_state((g, init_opt(g)), m)
        g1, o1, loss, ov = step(gs, opt0, D.gs_shard_batch(batches[2], m, 2,
                                                          n_parts=Pn))
        out["step_loss"] = np.asarray(float(loss), np.float64)
        out["step_overflow"] = np.asarray([int(ov["tiles"]),
                                           int(ov["assign"])])
        g1, o1 = D.gather_partitions((g1, o1), m)
        np.savez(os.path.join(out_dir, f"{tag}_rank{rank}.npz"), **out)
        if rank == 0:
            save_tree(os.path.join(out_dir, f"{tag}_state.npz"), g1, o1)


def production_mesh_rank(mesh, out_path):
    """The reference's production meshes on this world: each raises unless
    the world has its 256 / 512 ranks; on a world of one
    ``single_device_mesh`` resolves ("data", "model").  Rank 0 writes what
    it saw."""
    seen = {}
    for multi_pod in (False, True):
        try:
            mesh_mod.make_production_mesh(multi_pod=multi_pod)
        except ValueError as e:
            seen[f"multi_pod={multi_pod}"] = str(e)
    if dist.get_world_size() == 1:
        m = mesh_mod.single_device_mesh()
        seen["single"] = [list(m.axis_names), list(m.shape),
                          list(D._axes(m))]
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(seen, f)


def card_scene(path, views, n_part=1):
    """The CLI's full-size inputs on this process's card (``launch.train``'s
    ``gs_scene``: the 4M-point kingsnake scene, 2 partitions with ghost
    cells, 1024x1024, ``views`` orbital views, capacity x 1.3, a multiple
    of ``n_part``), saved to ``path`` on the host -> the scene's extent."""
    from repro_torch.launch import train

    args = train.build_parser().parse_args([
        "--gs", "--dataset", "kingsnake", "--full", "--parts", "2",
        "--resolution", "1024", "--views", str(views), "--densify-every",
        "3"])
    sc = train.gs_scene(args, GSTrainCfg(), n_part, torch.device("cuda", 0))
    cpu = lambda x: x.cpu()  # noqa: E731
    torch.save({"g": {k: cpu(v) for k, v in sc.g._asdict().items()},
                "cam": [cpu(sc.cams.view), cpu(sc.cams.fx), cpu(sc.cams.fy),
                        sc.cams.width, sc.cams.height],
                "gts": cpu(sc.gts), "masks": cpu(sc.masks),
                "grid": list(sc.grid), "extent": float(sc.extent)}, path)
    return float(sc.extent)


def card_pod_rank(mesh, scene_path, out_dir, tag, fit_kw, cfg_kw=None):
    """``fit_partitions`` of a ``card_scene`` on this rank's card with the
    CLI's cfg (and ``cfg_kw``'s fields): every rank saves its losses, each
    step's wall ms, the whole call's wall s (probes, densify and rebalance
    included) and both kernels' launches; rank 0 the gathered trained
    state."""
    import time

    from repro_torch.kernels import rasterize

    dev = mesh.device
    z = torch.load(scene_path, map_location=dev)
    g = Gaussians(**z["g"])
    cams = Camera(*z["cam"])
    times = []
    real = D.make_gs_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def timed(*sa):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = step(*sa)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
    D.make_gs_train_step = make
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        g1, _, losses = D.fit_partitions(
            g, cams, z["gts"], z["masks"], GSTrainCfg(**(cfg_kw or {})),
            mesh=mesh,
            extent=z["extent"], grid=TileGrid(*z["grid"]), **fit_kw)
    finally:
        D.make_gs_train_step = real
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    launches = [rasterize.LAUNCHES - fwd, rasterize.BWD_LAUNCHES - bwd]
    g1 = D.gather_partitions(g1, mesh)
    rank = dist.get_rank()
    np.savez(os.path.join(out_dir, f"{tag}_rank{rank}.npz"),
             losses=np.asarray(losses, np.float64),
             step_ms=np.asarray(times), launches=np.asarray(launches),
             fit_s=np.asarray(fit_s))
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{tag}.npz"),
                 **{k: v.cpu().numpy() for k, v in g1._asdict().items()})


def _event_ms(fn, reps, dev):
    """ms of ``reps`` back-to-back calls of ``fn``: CUDA events on a card,
    the host clock on the CPU."""
    if dev.type != "cuda":
        import time

        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b)


def card_collectives_rank(mesh, scene_path, out_dir, reps=10):
    """The "part" all-gather and its reduce-scatter transpose of each wire
    table layout alone, on this rank's rows of a ``card_scene`` (view 0),
    timed with CUDA events (3 calls to warm up, then ``reps`` back to back
    per event pair; the host clock on the CPU).  Rank 0 saves, per layout, the bytes a splat, the
    rows received and the median ms of each collective (the ranks' max)."""
    from repro_torch.core.dtypes import cast_tables

    dev = mesh.device
    z = torch.load(scene_path, map_location=dev)
    g = D.gs_shard_state(Gaussians(**z["g"]), mesh)
    cams = Camera(*z["cam"])
    group = mesh.group(D._axes(mesh).data)
    n = dist.get_world_size(group)
    with torch.no_grad():
        splats = D._project_rows(g, select(cams, 0), False)
    out = {}
    for mode in ("f32", "split"):
        for pol in ("f32", "bf16"):
            tabs = cast_tables(D.wire_tables(splats, mode), pol)
            tabs = [t.detach().contiguous() for t in tabs]
            full = [D._all_gather(t, group, 1) for t in tabs]

            def gather():
                return [D._all_gather(t, group, 1) for t in tabs]

            def scatter():
                return [D._reduce_scatter(f, group, 1) for f in full]

            ms = []
            for fn in (gather, scatter):
                for _ in range(3):
                    fn()
                t = torch.tensor([_event_ms(fn, reps, dev) / reps],
                                 device=dev)
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                ms.append(float(t))
            rows = full[0].shape[0] * full[0].shape[1]
            out[f"{mode}/{pol}"] = {
                "bytes_per_splat": D.wire_bytes_per_splat(tabs),
                "rows_received": rows * (n - 1) // n,
                "all_gather_ms": ms[0], "reduce_scatter_ms": ms[1]}
            del full
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "collectives.json"), "w") as f:
            json.dump(out, f)


def jobs_rank(mesh, jobs):
    """Run several rank functions in turn on one mesh: ``jobs`` is a list
    of (function name, args) -- one spawn for many checks."""
    for name, args in jobs:
        globals()[name](mesh, *args)


def _banded_state(cams, grid, n_part, Pn, Nl):
    """(Pn, n_part * Nl) small splats (scale 0.003) at random points whose
    bboxes in view 0 each lie in one band -- one tile row of the grid per
    "part" rank -- with "part" shard s holding only splats of band (s + 1)
    % n_part: the exchange's heavy edges on a derangement."""
    from repro_torch.core.gaussians import from_points
    from repro_torch.core.projection import project
    from repro_torch.core.tiling import _bbox_bounds

    gen = torch.Generator().manual_seed(0)
    pts = -0.25 + 1.5 * torch.rand((8192, 3), generator=gen)
    cols = torch.rand((8192, 3), generator=gen)
    g = from_points(pts, cols, opacity=0.8, init_scale=0.003, device="cpu")
    s = project(g, select(cams, 0))
    mx, my = s.mean2d[:, 0], s.mean2d[:, 1]
    _, _, y0, y1 = _bbox_bounds(mx, my, s.radius, grid)
    inside = s.valid & (mx >= 0) & (mx < grid.width) & (my >= 0) \
        & (my < grid.height) & (y0 == y1)
    rows_per_band = grid.ny // n_part
    band = torch.div(y0, rows_per_band, rounding_mode="floor")
    pick = []
    for sh in range(n_part):
        cand = torch.nonzero(inside & (band == (sh + 1) % n_part))[:, 0]
        pick.append(cand[:Pn * Nl].reshape(Pn, Nl))
    rows = torch.cat(pick, 1)                          # (Pn, n_part * Nl)
    return Gaussians(*(torch.stack([f[rows[p]] for p in range(Pn)])
                       for f in g))


#: the exchange checks ``exchange_rank`` runs, by name
EX_CHECKS = ("fwd", "tau", "step", "starve", "pad", "wire")


def _ex_ov(ov) -> dict:
    return {k: v.numpy() for k, v in ov.items()}


def exchange_rank(mesh, scene_path, out_dir, tag, shape, axes, checks,
                  pad_grid=None):
    """The sparse-overlap exchange against the all-gather on a ``(shape,
    axes)`` mesh built on this world, two views of the scene's batch, K =
    16, the reference's ``EXCHANGE_SCRIPT`` cases: ``checks`` names which
    (``EX_CHECKS``).  Every rank saves ``<tag>_rank<r>.npz``: its
    coordinates, the probes, and per case the loss, its tiles and its
    overflow counters (``<case>_<counter>``; the tiles as ``<case>_px``); rank 0 also the gathered
    trainables of each step case (``<case>_g_<field>``)."""
    g, cams, gts, masks, grid, meta = load_scene(scene_path)
    m = mesh_mod.make_mesh(shape, axes, timeout_s=PG_TIMEOUT_S)
    Pn, V = g.means.shape[0], 2
    gt_t, mask_t = D._tile_view_batches(gts, masks, grid)
    vi = torch.arange(V)
    batch = {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
             "cam": select(cams, vi)}
    gl = D.gs_shard_state(g, m)
    b = D.gs_shard_batch(batch, m, V, n_parts=Pn)
    cam = b["cam"]
    rank = dist.get_rank()
    out = {"coords": np.asarray(m.coords)}

    def fwd(case, grid_=grid, b_=b, views_=V, **kw):
        f = D.make_gs_forward(m, grid_, K=16, impl="ref", views=views_,
                              return_overflow=True, **kw)
        res = f(gl, b_["cam"], b_["gt_tiles"], b_["mask_tiles"])
        out[f"{case}_loss"] = np.asarray(float(res[0]), np.float64)
        if kw.get("return_tiles"):
            out[f"{case}_px"] = res[1].detach().numpy()
        for k, v in _ex_ov(res[-1]).items():
            out[f"{case}_{k}"] = v

    E = D.probe_gs_exchange(D.ExchangeSchedule(), m, grid, gl, cam, views=V)
    B = D.probe_gs_exchange(D.ExchangeSchedule(), m, grid, gl, cam, views=V,
                            per_edge=True)
    out.update(E=np.asarray(E), B=np.asarray(B),
               raw=np.asarray(D.make_gs_exchange_probe(m, grid, views=V)(
                   gl, cam)),
               raw_m=D.make_gs_exchange_probe(m, grid, views=V,
                                              per_edge=True)(gl, cam))
    budgets = {"none": None, "scalar": E, "matrix": B}
    if "fwd" in checks:
        for kname, kt in (("dense", None), ("tiered", (4, 8, 16))):
            fwd(f"gather_{kname}", k_tiers=kt, return_tiles=True)
            for bname, eb in budgets.items():
                fwd(f"{bname}_{kname}", k_tiers=kt, return_tiles=True,
                    exchange=True, exchange_budget=eb)
    if "tau" in checks:
        # heavy edges on a derangement: window_assignment leaves the
        # identity, and which rank renders which band cannot move the loss
        g_tau = _banded_state(cams, grid, m.axis_size("part"), Pn,
                              g.means.shape[1] // m.axis_size("part"))
        gl = D.gs_shard_state(g_tau, m)
        one = {"gt_tiles": gt_t[:1], "mask_tiles": mask_t[:1],
               "cam": select(cams, torch.arange(1))}
        b1 = D.gs_shard_batch(one, m, 1, n_parts=Pn)
        B_tau = D.probe_gs_exchange(D.ExchangeSchedule(), m, grid, gl,
                                    b1["cam"], views=1, per_edge=True)
        out["B_tau"] = np.asarray(B_tau)
        fwd("gather_tau", b_=b1, views_=1, k_tiers=(4, 8, 16))
        fwd("tau", b_=b1, views_=1, k_tiers=(4, 8, 16), exchange=True,
            exchange_budget=B_tau)
        gl = D.gs_shard_state(g, m)
    if "starve" in checks:
        fwd("starved", return_tiles=True, exchange=True, exchange_budget=1)
        B_st = np.asarray(B).copy()
        B_st[0, 1] = 1
        fwd("starved_edge", exchange=True, exchange_budget=B_st)
    if "pad" in checks:
        # a strip of 3 tiles over a "part" axis of 2: padded sub-windows
        pgrid = TileGrid(*pad_grid)
        from repro_torch.core.cameras import orbital_rig
        cams_p = orbital_rig(V, (0.5, 0.5, 0.5), 1.6, width=pgrid.width,
                             height=pgrid.height, device=m.device)
        zeros = torch.zeros((Pn, V, pgrid.height, pgrid.width, 3))
        gp, mp = D._tile_view_batches(zeros, None, pgrid)
        bp = D.gs_shard_batch({"gt_tiles": gp, "mask_tiles": mp,
                               "cam": select(cams_p, vi)}, m, V,
                              n_parts=Pn)
        Bp = D.probe_gs_exchange(D.ExchangeSchedule(), m, pgrid, gl,
                                 bp["cam"], views=V, per_edge=True)
        fwd("pad_gather", grid_=pgrid, b_=bp)
        fwd("pad_none", grid_=pgrid, b_=bp, exchange=True)
        fwd("pad_matrix", grid_=pgrid, b_=bp, exchange=True,
            exchange_budget=Bp)
    if "wire" in checks:
        for pname, pkw in (("bf16", dict(dtype_policy="bf16")),
                           ("split", dict(gather_mode="split"))):
            for kname, kt in (("dense", None), ("tiered", (4, 8, 16))):
                fwd(f"{pname}_gather_{kname}", k_tiers=kt, return_tiles=True,
                    **pkw)
                fwd(f"{pname}_ex_{kname}", k_tiers=kt, return_tiles=True,
                    exchange=True, exchange_budget=E, **pkw)
    steps = []
    if "step" in checks:
        for kname, kt, akw in (
                ("dense", None, {}),
                ("sorted", (4, 8, 16), dict(assign_impl="sorted",
                                            assign_budget=8))):
            steps += [(f"step_gather_{kname}", kt, akw),
                      (f"step_ex_{kname}", kt,
                       dict(akw, exchange=True, exchange_budget=E))]
        steps.append(("step_starved", None, dict(exchange=True,
                                                 exchange_budget=1)))
    if "wire" in checks:
        for kname, kt in (("dense", None), ("tiered", (4, 8, 16))):
            steps += [(f"step_bf16_gather_{kname}", kt,
                       dict(dtype_policy="bf16")),
                      (f"step_bf16_ex_{kname}", kt,
                       dict(dtype_policy="bf16", exchange=True,
                            exchange_budget=E))]
    for case, kt, ckw in steps:
        cfg = GSTrainCfg(K=16, lr_colors=5e-2, **ckw)
        step = D.make_gs_train_step(m, cfg, grid, meta["extent"], impl="ref",
                                    views=V, k_tiers=kt,
                                    return_overflow=True)
        g1, o1, loss, ov = step(gl, init_opt(gl), b)
        out[f"{case}_loss"] = np.asarray(float(loss), np.float64)
        for k, v in _ex_ov(ov).items():
            out[f"{case}_{k}"] = v
        g1, o1 = D.gather_partitions((g1, o1), m)
        if rank == 0:
            for k in FIELDS:
                out[f"{case}_g_{k}"] = getattr(g1, k).numpy()
                out[f"{case}_m_{k}"] = o1.m[k].numpy()
    np.savez(os.path.join(out_dir, f"{tag}_rank{rank}.npz"), **out)


def cli_probe_rank(mesh, argv, out_path):
    """``cli_rank`` with the calls of ``D.probe_gs_exchange`` counted, the
    count to ``<out_path>.probes<rank>``."""
    calls = []
    real = D.probe_gs_exchange

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    D.probe_gs_exchange = counted
    try:
        cli_rank(mesh, argv, out_path)
    finally:
        D.probe_gs_exchange = real
    with open(f"{out_path}.probes{dist.get_rank()}", "w") as f:
        f.write(str(len(calls)))


def card_exchange_rank(mesh, scene_path, out_dir, reps=10):
    """The sparse-overlap exchange on a ``card_scene`` on this rank's card
    ("part" mesh), view 0, the CLI's cfg: the probed (n, n) demand and the
    budgets (scalar, matrix, and a forced one: the demand with every edge
    (s, s + 1) raised to Nl, which moves the ladder's window assignment
    off the identity); the forward loss and counters of the gather and of
    the exchange under each budget; then the transport alone (the uniform
    all-to-all at the scalar budget and the ladder at the matrix, on the
    f32 tables), CUDA events (3 calls to warm up, then ``reps`` back to
    back per event pair), the ranks' max.  Rank 0 writes
    ``exchange.json``."""
    from repro_torch.core.tiling import TileGrid

    dev = mesh.device
    z = torch.load(scene_path, map_location=dev)
    g = D.gs_shard_state(Gaussians(**z["g"]), mesh)
    cams = Camera(*z["cam"])
    grid = TileGrid(*z["grid"])
    Pn, Nl = g.means.shape[:2]
    n = mesh.axis_size("part")
    me = mesh.index("part")
    cfg = GSTrainCfg()
    gt_t, mask_t = D._tile_view_batches(z["gts"], z["masks"], grid)
    vi = torch.arange(1, device=dev)
    batch = D.gs_shard_batch({"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
                              "cam": select(cams, vi)}, mesh, 1, n_parts=Pn)
    del gt_t, mask_t, z
    cam = batch["cam"]
    demand = D.make_gs_exchange_probe(mesh, grid, views=1, per_edge=True)(
        g, cam)
    E = D.probe_gs_exchange(D.ExchangeSchedule(), mesh, grid, g, cam,
                            views=1)
    B = D.probe_gs_exchange(D.ExchangeSchedule(), mesh, grid, g, cam,
                            views=1, per_edge=True)
    B_tau = np.maximum(demand, 1)
    B_tau[np.arange(n), (np.arange(n) + 1) % n] = Nl
    impl, abudget = D.resolve_assignment_global(
        mesh, g, cams, grid, assign_impl=cfg.assign_impl,
        assign_budget=cfg.assign_budget)
    out = {"demand": demand.tolist(), "E": int(E), "B": B.tolist(),
           "B_tau": B_tau.tolist(), "Nl": int(Nl), "cases": {}}
    for name, ex, eb in (("gather", False, None), ("scalar", True, E),
                         ("matrix", True, B), ("forced", True, B_tau)):
        sched = cfg.tier_schedule()
        D.probe_gs_schedule(sched, mesh, grid, g, [cam], views=1,
                            assign_impl=impl, assign_budget=abudget,
                            exchange=ex)
        fwd = D.make_gs_forward(mesh, grid, K=cfg.assign_K, views=1,
                                k_tiers=sched.k_tiers,
                                tier_caps=sched.tier_caps, assign_impl=impl,
                                assign_budget=abudget, return_overflow=True,
                                exchange=ex, exchange_budget=eb)
        with torch.no_grad():
            loss, ov = fwd(g, cam, batch["gt_tiles"], batch["mask_tiles"])
        out["cases"][name] = {"loss": float(loss),
                              "overflow": {k: v.tolist()
                                           for k, v in ov.items()}}
        if eb is not None and np.ndim(eb) == 2:
            bm = np.minimum(np.asarray(eb), Nl)
            tau = D.window_assignment(bm)
            band = tau[(np.arange(n) + np.arange(n)[:, None]) % n]
            out["cases"][name]["tau"] = tau.tolist()
            out["cases"][name]["E_shift"] = [
                int(bm[np.arange(n), band[k]].max()) for k in range(n)]
    # the transport alone, on this rank's f32 tables of view 0
    group = mesh.group(D._axes(mesh).data)
    with torch.no_grad():
        splats = D._project_rows(g, cam, True)
        tabs = [x.reshape((-1,) + tuple(x.shape[2:])).contiguous()
                for x in D.wire_tables(splats, "f32")]
        del splats
        hit = D._exchange_hits(
            (tabs[0][..., 0], tabs[0][..., 1], tabs[1][..., 0],
             tabs[1][..., 2] > 0.5), grid, 0, grid.n_tiles,
            -(-grid.n_tiles // n), n)
        R = tabs[0].shape[0]

        def timed(fn):
            for _ in range(3):
                fn()
            t = torch.tensor([_event_ms(fn, reps, dev) / reps], device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return float(t)

        bm = np.minimum(B, Nl)
        e_shift = out["cases"]["matrix"]["E_shift"]
        for name, eb, tau in (("all_to_all", E, None),
                              ("ladder", bm, D.window_assignment(bm))):
            move = D._pack_exchange(hit, group, me, eb, tau)[0]
            if tau is None:
                bufs = [x.new_zeros((n, R, E, x.shape[-1])) for x in tabs]

                def transport():
                    return [D._all_to_all(b, group) for b in bufs]
                received = R * (n - 1) * E
            else:
                bufs = [[x.new_zeros((R, e_shift[k], x.shape[-1]))
                         for k in range(1, n)] for x in tabs]

                def transport():
                    return [D._shift(b, group, k + 1) for t in bufs
                            for k, b in enumerate(t)]
                received = R * sum(e_shift[1:])
            out[name] = {"move_ms": timed(lambda: [move(x) for x in tabs]),
                         "transport_ms": timed(transport),
                         "rows_received": received,
                         "mb_received": received * 76 / 1e6}
            del bufs
        out["gather_rows_received"] = R * (n - 1) * Nl
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "exchange.json"), "w") as f:
            json.dump(out, f)


def cost_rank(mesh, out_dir, dataset, res, n_parts):
    """``dryrun.gs_train_cell`` of ``dataset`` on this world's mesh, one
    step under ``cost_analysis.analyze`` (pods of world / n_pod ranks).
    Every rank writes its summary (``per_op`` dropped), the bytes a splat
    of its f32 wire tables and the rows it gathers from."""
    from repro_torch.core.projection import project
    from repro_torch.launch.cost_analysis import analyze
    from repro_torch.launch.dryrun import gs_train_cell

    step, args, meta = gs_train_cell(dataset, mesh, res=res, n_parts=n_parts,
                                     view_batch=1)
    pod_size = dist.get_world_size() // mesh.axis_size("pod") \
        if "pod" in mesh.axis_names else 0
    r = analyze(step, *args, pod_size=pod_size)
    r.pop("per_op")
    g, batch = args[0], args[2]
    with torch.no_grad():
        tables = D.wire_tables(project(g, select(batch["cam"], 0)), "f32")
    r["bytes_per_splat"] = D.wire_bytes_per_splat(tables)
    r["rows"] = g.means.shape[0] * g.means.shape[1]
    r["meta"] = meta
    with open(os.path.join(out_dir, f"cost_rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(r, f)

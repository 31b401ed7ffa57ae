"""The ``serve`` traffic driver: closed-loop viewers in front of the
program's render server.

Set-up makes the points (``scene``), builds the served model from them
with the program's ``from_points`` at the configuration's opacity, resolves
the assignment impl and budget with the program's ``resolve_assignment``
over a probe rig of this mix's distances (as the package's host entry
points do), builds ``GSRenderServer`` and serves one warm-up round of every
viewer (for ring traffic, one whole lap, so the window starts with every
ring's tables cached).  In the window each viewer whose image has come
back submits its next pose; then the harness calls ``flush``.  A request's
latency runs from its ``submit`` to its image on the host.

The output check, after the window and with the server freed: a sample of
the served images, drawn from the seed, is rendered again by the plain
reference at the snapped pose from its own extraction of the points, and
the mean absolute difference of each image is compared.  The sample is
uniform over the window's answers (a reservoir).
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from gsbench import fields, reference, scene
from gsbench.harness import Run, forbidden_loaded, judge
from gsbench.trace import DeviceTrace


def run_serve(run: Run):
    from repro_torch.core.cameras import Camera, stack
    from repro_torch.core.gaussians import from_points
    from repro_torch.core.render import resolve_assignment
    from repro_torch.core.serving import GSRenderServer, ServeCfg
    from repro_torch.core.tiling import TileGrid
    from repro_torch.kernels import rasterize

    cfg_d, tr = run.cell.config, run.cell.traffic
    sc = cfg_d["serve"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(run.device)
    W = H = int(cfg_d["image"])
    grid = TileGrid(W, H, int(sc["tile_h"]), int(sc["tile_w"]))
    focal = reference.focal_for(W)
    f32 = dict(dtype=torch.float32, device=dev)

    def cam_of(view):
        return Camera(torch.from_numpy(view).to(dev),
                      torch.tensor(focal, **f32), torch.tensor(focal, **f32),
                      W, H)

    with run.spans.span("setup.points"):
        pts, cols, rows, count = scene.source(run.cell).points(
            cfg_d, run.seed, dev)
        prog_points = pts.cpu().numpy()
        g = from_points(pts, cols, opacity=float(sc["opacity"]), device=dev)
        del pts, cols
    center, _, radius = scene.frame(prog_points)
    poses = scene.ViewerPoses(tr, center, radius, run.seed)
    with run.spans.span("setup.resolve_assignment"):
        probe = stack(cam_of(v) for v in poses.probe(int(tr["probe_views"])))
        impl, budget = resolve_assignment(g, probe, grid)
        del probe
    server = GSRenderServer(g, grid, ServeCfg(
        K=int(sc["K"]), max_batch=int(sc["max_batch"]),
        cache_entries=int(sc["cache_entries"]), assign_impl=impl,
        assign_budget=budget))
    n_view = poses.viewers
    run.say(f"points {len(prog_points)} of {count} crossings (R = "
            f"{cfg_d['resolution']}); assignment {impl} budget {budget}; "
            f"{n_view} viewers, poses {tr['poses']}, LOD thresholds "
            f"{server.lod_dists}, scene radius {radius:.6f}")
    del g

    def round_trip(views):
        """Submit one pose a viewer, flush -> (results, submit times,
        return time)."""
        sent = []
        with run.spans.span("submit"):
            for v in views:
                sent.append(time.time())
                server.submit(cam_of(v))
        with run.spans.span("flush"):
            res = server.flush()
        return res, sent, time.time()

    with run.spans.span("setup.warmup"):
        for _ in range(int(tr["warmup_rounds"])):
            round_trip([poses.next(v) for v in range(n_view)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    tel0 = server.telemetry()

    # ---- the window --------------------------------------------------------
    keep_max = int(tr["check_max"])
    pick = scene.rng(run.seed, 4)
    lat, kept, attempted, failed = [], [], 0, 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rasterize.RECORDER = [] if run.trace else None
    with DeviceTrace(run.trace and dev.type == "cuda") as trace:
        t0 = time.time()
        setup_s = t0 - run.t_start
        while time.time() - t0 < run.seconds:
            views = [poses.next(v) for v in range(n_view)]
            attempted += len(views)
            res, sent, back = round_trip(views)
            if len(res) != len(views):
                failed += len(views) - len(res)
            for r, view, s in zip(res, views, sent):
                lat.append(back - s)
                # a uniform sample of the window's answers (reservoir)
                j = int(pick.integers(len(lat)))
                if len(kept) < keep_max:
                    kept.append((view, r.rgb, r.cache_hit))
                elif j < keep_max:
                    kept[j] = (view, r.rgb, r.cache_hit)
        t1 = time.time()
    launches, rasterize.RECORDER = rasterize.RECORDER, None
    window_s = t1 - t0
    tel = {k: v - tel0.get(k, 0) for k, v in server.telemetry().items()}
    failed += tel.get("rejected", 0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    forbidden = forbidden_loaded()
    n_model = int(server.ladder[0].active.sum())
    del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = len(lat)
    lat_ms = np.asarray(lat) * 1e3
    p95 = float(np.quantile(lat_ms, 0.95)) if done else float("nan")
    run.say("set-up spans " + ", ".join(
        f"{n} {(b - a) / 1e9:.2f} s" for n, a, b in run.spans.items
        if n.startswith("setup")) + f"; set-up {setup_s:.2f} s")
    run.say(f"window {window_s:.3f} s, {done} requests ({attempted} "
            f"attempted), latency ms median {np.median(lat_ms):.2f} p95 "
            f"{p95:.2f} ({int(np.sum(lat_ms > p95))} beyond); telemetry "
            f"{tel}; {len(kept)} images kept for the check "
            f"({sum(k[2] for k in kept)} cache hits)")

    t_check = time.time()
    with run.spans.span("check"):
        readings = check_serve(run, cfg_d, prog_points, rows, count, kept,
                               focal, dev)
    run.say(f"output check {time.time() - t_check:.1f} s")
    correct, checks = judge(readings, run.cell.limits)
    ctx = types.SimpleNamespace(
        kind="serve", trace=trace if run.trace else None, spans=run.spans,
        launches=launches or [], window_s=window_s, steps=0, step_times=[],
        requests=done, telemetry=tel,
        shapes={"splats": n_model, "width": W, "height": H,
                "K": int(sc["K"])},
        cards=1, busy=[trace.busy_s() if run.trace else None])
    return {
        "correct": correct and failed == 0 and done > 0 and len(kept) > 0,
        "attempted": attempted, "failed": failed,
        "e2e": {"serve_req_per_s": done / window_s,
                "serve_p95_ms": p95,
                "peak_mem_gib": peak / 2**30,
                "setup_s": setup_s},
        "device_count": 1,
        "memory_peak_bytes": max(setup_peak, peak),
        "forbidden": forbidden, "ctx": ctx, "checks": checks}


def check_serve(run, cfg_d, prog_points, rows, count, kept, focal, dev):
    """The reference's readings of the kept images."""
    sc = cfg_d["serve"]
    W = H = int(cfg_d["image"])
    prec = reference.Precision("f32")
    out = {}
    with prec.backend_flags():
        allpts = scene.source(run.cell).reference_points(cfg_d, dev)
        if allpts.shape[0] != count:
            return {"points_gap": float("inf")}
        pts = allpts[torch.from_numpy(rows).to(dev)]
        del allpts
        out["points_gap"] = float(
            (pts - torch.from_numpy(prog_points).to(dev)).abs().max())
        s = reference.init_splats(pts, fields.height_colors(pts),
                                  pts.shape[0], float(sc["opacity"]))
        gaps = []
        for view, rgb, _ in kept:
            v, fx, _ = reference.snap_pose(view, focal, focal)
            ref_rgb, _ = reference.render_image(
                s, torch.from_numpy(v).to(dev), float(fx), width=W,
                height=H, tile_h=int(sc["tile_h"]), tile_w=int(sc["tile_w"]),
                K=int(sc["K"]), bg=1.0, prec=prec)
            gaps.append(reference.image_gap(rgb, ref_rgb))
    out["image_gap"] = max(gaps) if gaps else float("nan")
    run.say(f"image gaps {[f'{x:.3e}' for x in gaps]}")
    return out

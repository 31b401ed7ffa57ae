"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates and the script exits nonzero):

1. device    require a CUDA card; print its name and power limit; pin TF32
             off for matmuls and cuDNN.
2. build     compile the CUDA tile compositor from
             ``src/repro_torch/kernels/csrc/rasterize_fwd.cu`` with nvcc.
3. kernel    hold the kernel against its plain PyTorch versions on the card
             (K in {1, 16, 64, 256, 300}, tiles 16x16 and 8x128, dead and
             saturated splats, 37 tiles) at max abs error <= 1e-5.
4. serve     the paper's smallest dataset at full size: the 4,000,000-point
             kingsnake isosurface as a merged splat model, served by
             ``GSRenderServer`` at 1024x1024 with 16x16 tiles (K=64,
             max_batch=8) to a 16-view near/far rig, twice.  The second
             pass must be all cache hits and bit-identical to the first,
             and the kernel must have launched once per dispatch.  A small
             scene served on the card must match the same server on the CPU.
5. timing    the kernel and the plain version on the first dispatch's own
             tile features (V=8, 1024x1024, 16x16 tiles, K=64): agreement,
             CUDA-event medians, the bound; then the time of each stage of
             that dispatch.

The second-to-last line is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.gs_datasets import get_gs_dataset  # noqa: E402
from repro_torch.core.cameras import Camera, concat, orbital_rig  # noqa: E402
from repro_torch.core.cameras import select, stack  # noqa: E402
from repro_torch.core.gaussians import from_points  # noqa: E402
from repro_torch.core.projection import project  # noqa: E402
from repro_torch.core.render import _composite, assign_tables  # noqa: E402
from repro_torch.core.render import rasterize_batched  # noqa: E402
from repro_torch.core.render import resolve_assignment  # noqa: E402
from repro_torch.core.render import table_features  # noqa: E402
from repro_torch.core.serving import GSRenderServer, ServeCfg  # noqa: E402
from repro_torch.core.tiling import TileGrid, gather_features_at  # noqa: E402
from repro_torch.core.tiling import quantize_pose, splat_features  # noqa: E402
from repro_torch.core.tiling import tile_origins, untile_image  # noqa: E402
from repro_torch.data.isosurface import point_cloud_for  # noqa: E402
from repro_torch.kernels import ops, rasterize, ref  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
#: cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: operations counted per splat-pixel (see the note in rasterize_fwd.cu)
OPS_PER_SPLAT_PIXEL = 27
TOL = 1e-5


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tile_inputs(rng, T, K, th, tw, device, dead_frac=0.2, sat_frac=0.2):
    """Random well-conditioned splat rows over a T-tile strip, with dead
    (alpha 0) and saturated (opacity 3, clamped at 0.99) rows."""
    n = T * K
    mean = rng.uniform([-4, -4], [tw * T + 4, th + 4], size=(n, 2))
    ang = rng.uniform(0, np.pi, size=n)
    ia = 1.0 / rng.uniform(0.8, 6.0, size=n) ** 2
    ib = 1.0 / rng.uniform(0.8, 6.0, size=n) ** 2
    ca, sa = np.cos(ang), np.sin(ang)
    conic = np.stack(
        [
            ca * ca * ia + sa * sa * ib,
            ca * sa * (ia - ib),
            sa * sa * ia + ca * ca * ib,
        ],
        -1,
    )
    rgb = rng.uniform(0, 1, size=(n, 3))
    alpha = rng.uniform(0.05, 0.95, size=n)
    alpha[rng.uniform(size=n) < sat_frac] = 3.0
    alpha[rng.uniform(size=n) < dead_frac] = 0.0
    feat = np.concatenate([mean, conic, rgb, alpha[:, None], np.zeros((n, 7))], -1)
    origins = np.stack([np.arange(T) * tw, np.zeros(T)], -1)
    return (
        torch.tensor(feat.reshape(T, K, 16), dtype=torch.float32, device=device),
        torch.tensor(origins, dtype=torch.float32, device=device),
    )


def kernel_phase(device):
    """Kernel vs both plain versions over the sweep -> max abs error."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for th, tw in ((16, 16), (8, 128)):
        for K in (1, 16, 64, 256, 300):
            feats, origins = tile_inputs(rng, 37, K, th, tw, device)
            out = rasterize.rasterize_fwd(feats, origins, tile_h=th, tile_w=tw)
            err = max(
                (out - fn(feats, origins, tile_h=th, tile_w=tw)).abs().max().item()
                for fn in (ref.rasterize_tiles_ref, ref.rasterize_tiles_unrolled)
            )
            log(f"kernel K={K:3d} tile {th}x{tw}: max abs err {err:.3e}")
            if not err <= TOL:
                raise AssertionError(f"K={K} tile {th}x{tw}: err {err} > {TOL}")
            worst = max(worst, err)
    # the dispatcher never takes the plain version on a CUDA tensor, and the
    # kernel's backward is not faked by autograd through the plain version
    feats, origins = tile_inputs(rng, 3, 8, 16, 16, device)
    try:
        ops.rasterize_tiles(feats, origins, tile_h=16, tile_w=16, impl="ref")
    except ValueError:
        pass
    else:
        raise AssertionError("impl='ref' ran on CUDA tensors")
    feats.requires_grad_(True)
    out = ops.rasterize_tiles(feats, origins, tile_h=16, tile_w=16)
    try:
        out.sum().backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("the CUDA rasterizer's backward did not raise")
    return worst


def mixed_rig(center, near_r, far_r, n_near, n_far, res, device):
    """Near orbit (LOD rung 0) + far orbit (coarser rung), as the serving
    CLI of the JAX package builds it."""
    return concat(
        [
            orbital_rig(n_near, center, near_r, width=res, height=res, device=device),
            orbital_rig(n_far, center, far_r, width=res, height=res, device=device),
        ]
    )


def serve_phase(
    device,
    *,
    dataset="kingsnake",
    n_points=4_000_000,
    res=1024,
    tile=16,
    K=64,
    max_batch=8,
    n_near=8,
    n_far=8,
):
    """Build the merged model and serve the rig twice -> (server, rig,
    results of both passes, timings, info with the kernel launches of the
    two passes and the assignment knobs)."""
    times = {}
    t0 = time.perf_counter()
    pts, cols = point_cloud_for(get_gs_dataset(dataset, "full").volume, n_points)
    times["point_cloud_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = from_points(pts, cols, opacity=0.9, device=device)
    sync(device)
    times["from_points_s"] = time.perf_counter() - t0
    grid = TileGrid(res, res, tile, tile)
    center = 0.5 * (pts.max(0) + pts.min(0)).astype(np.float64)
    rig = mixed_rig(center, 1.5, 7.5, n_near, n_far, res, device)

    # the server's default ("auto", no budget) resolves to the O(T*N) dense
    # sweep; probe a sorted-path budget over the whole rig, as the JAX
    # package's host entry points do
    t0 = time.perf_counter()
    assign_impl, budget = resolve_assignment(g, rig, grid)
    times["probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = ServeCfg(
        K=K, max_batch=max_batch, assign_impl=assign_impl, assign_budget=budget
    )
    server = GSRenderServer(g, grid, cfg)
    sync(device)
    times["lod_ladder_s"] = time.perf_counter() - t0
    passes = []
    rasterize.LAUNCHES = 0  # count the launches of the two passes only
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        results = server.serve(rig)
        sync(device)
        times[f"{name}_pass_s"] = dt = time.perf_counter() - t0
        times[f"{name}_req_per_s"] = len(results) / dt
        passes.append(results)
    info = {
        "launches": rasterize.LAUNCHES,
        "n_points": int(len(pts)),
        "assign_impl": assign_impl,
        "assign_budget": budget,
        "rungs_live": [int(r.active.sum()) for r in server.ladder],
        "lod_dists": list(server.lod_dists),
    }
    return server, rig, passes, times, info


def check_passes(server, passes, n_views):
    """The serving contract on the two passes -> (telemetry, coverage)."""
    cold, warm = passes
    if len(cold) != n_views or len(warm) != n_views:
        raise AssertionError("not every request was answered")
    if any(r.cache_hit for r in cold) or not all(r.cache_hit for r in warm):
        raise AssertionError("pass 1 must miss and pass 2 must hit the cache")
    h, w = server.grid.height, server.grid.width
    for c, r in zip(cold, warm):
        if c.rgb.shape != (h, w, 3) or c.coverage.shape != (h, w):
            raise AssertionError(f"bad image shape {c.rgb.shape}")
        if not (np.isfinite(c.rgb).all() and np.isfinite(c.coverage).all()):
            raise AssertionError("non-finite image")
        same = np.array_equal(c.rgb, r.rgb) and np.array_equal(c.coverage, r.coverage)
        if not same:
            raise AssertionError(f"request {r.request_id}: hit != miss")
        if (c.rung, c.K) != (r.rung, r.K):
            raise AssertionError("serving decisions changed between passes")
    tel = server.telemetry()
    if tel["assign"] != 0 or tel["tiles"] != 0:
        raise AssertionError(f"assignment overflow: {tel}")
    if {r.rung for r in cold} != {0, 1}:
        raise AssertionError("the rig must span both LOD rungs")
    # far views hold the object in a few percent of the frame, so the test
    # is: every image is opaque somewhere and the near views cover a share
    cov = [float(r.coverage.mean()) for r in cold]
    if min(float(r.coverage.max()) for r in cold) < 0.5 or max(cov) < 0.05:
        raise AssertionError(f"trivial coverage: {cov}")
    return tel, cov


def canonical_cams(server, rig, views):
    """The bucket-snapped cameras the server rendered for ``views``, as one
    view-batched Camera in dispatch order."""
    dev = server.device
    cams = []
    for v in views:
        cam = select(rig, v)
        _, (view, fx, fy) = quantize_pose(cam.view, cam.fx, cam.fy)
        cams.append(
            Camera(
                torch.from_numpy(view).to(dev),
                torch.tensor(fx, device=dev),
                torch.tensor(fy, device=dev),
                cam.width,
                cam.height,
            )
        )
    return stack(cams)


def cached_tables(server, rig, results, views):
    """The cached (idx, score) tables of ``views``, cut to the K served."""
    idx, score = [], []
    for v in views:
        i, s = server.cached_table(select(rig, v), rung=results[v].rung)
        idx.append(i[..., : results[v].K])
        score.append(s[..., : results[v].K])
    return torch.stack(idx), torch.stack(score)


def cuda_time_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing_phase(server, rig, results, views, reps=25):
    """Kernel vs plain version on one dispatch's own tile features (the
    canonical cameras, cached tables and projection the server used):
    agreement with the served images, error, times and bound."""
    grid = server.grid
    th, tw = grid.tile_h, grid.tile_w
    idx, score = cached_tables(server, rig, results, views)
    rung = results[views[0]].rung
    feats = table_features(
        server.ladder[rung], canonical_cams(server, rig, views), idx, score
    )
    V, T, K, F = feats.shape
    flat = feats.reshape(V * T, K, F).contiguous()
    origins = tile_origins(grid, flat.device).repeat(V, 1)
    out = rasterize.rasterize_fwd(flat, origins, tile_h=th, tile_w=tw)
    plain = ref.rasterize_tiles_ref(flat, origins, tile_h=th, tile_w=tw)
    err = (out - plain).abs().max().item()
    tiles = out.reshape(V, T, 4, th, tw)
    img = _composite(untile_image(tiles, grid), server.cfg.bg)
    served = np.stack([results[v].rgb for v in views])
    served_err = float(np.abs(img.rgb.cpu().numpy() - served).max())
    log(
        f"serving-shape features {tuple(feats.shape)}: kernel vs plain max abs "
        f"err {err:.3e}; kernel image vs served image {served_err:.3e}"
    )
    if not (err <= TOL and served_err <= TOL):
        raise AssertionError(f"serving-shape disagreement {err} / {served_err}")

    def kernel():
        rasterize.rasterize_fwd(flat, origins, tile_h=th, tile_w=tw)

    def plain_version():
        ref.rasterize_tiles_ref(flat, origins, tile_h=th, tile_w=tw)

    # in turns within one process: plain, kernel, kernel, plain
    ms_p1 = cuda_time_ms(plain_version, reps)
    ms_k1 = cuda_time_ms(kernel, reps)
    ms_k2 = cuda_time_ms(kernel, reps)
    ms_p2 = cuda_time_ms(plain_version, reps)
    ops_count = V * T * K * th * tw * OPS_PER_SPLAT_PIXEL
    n_bytes = 4 * (flat.numel() + origins.numel() + out.numel())
    t_ops = ops_count / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    log(
        f"timing V={V} T={T} K={K} tile {th}x{tw}: kernel {ms_k1:.4f} / "
        f"{ms_k2:.4f} ms, plain {ms_p1:.3f} / {ms_p2:.3f} ms; bound "
        f"{max(t_ops, t_bytes):.4f} ms ({ops_count / 1e9:.2f} GFLOP -> "
        f"{t_ops:.4f} ms, {n_bytes / 1e6:.1f} MB -> {t_bytes:.4f} ms)"
    )
    return {
        "max_abs_err": err,
        "ms": statistics.median([ms_k1, ms_k2]),
        "plain_ms": statistics.median([ms_p1, ms_p2]),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def breakdown_phase(server, rig, results, views, assign):
    """Host-clock time of each stage of one dispatch of ``views`` (the warm
    path, then the cold path's table extraction with the server's
    ``assign`` = (impl, budget)), each stage between two device
    synchronisations, second of two runs -> {stage: ms}."""
    rung = results[views[0]].rung
    g = server.ladder[rung]
    grid = server.grid
    idx, score = cached_tables(server, rig, results, views)
    stages = {}

    def stage(name, fn):
        sync(server.device)
        t0 = time.perf_counter()
        out = fn()
        sync(server.device)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    def extract():
        impl, budget = assign
        K = server.cfg.K
        return assign_tables(g, cams, grid, K, assign_impl=impl, assign_budget=budget)

    for _ in range(2):
        cams = stage("canonical_cams", lambda: canonical_cams(server, rig, views))
        splats = stage("project", lambda: project(g, cams))
        feat = stage("splat_features", lambda: splat_features(splats))
        tf = stage("gather", lambda: gather_features_at(feat, idx, score))
        tiles = stage("rasterize_fwd", lambda: rasterize_batched(tf, grid))
        img = stage(
            "untile_composite",
            lambda: _composite(untile_image(tiles, grid), server.cfg.bg),
        )
        stage("to_host", lambda: (img.rgb.cpu().numpy(), img.coverage.cpu().numpy()))
        stage("assign_tables_cold", extract)
    rounded = {k: round(v, 3) for k, v in stages.items()}
    log(f"breakdown of one {len(views)}-view dispatch (ms) {json.dumps(rounded)}")
    return stages


def small_scene_check(device):
    """A small scene served by the port on the card and on the CPU: the
    same decisions and telemetry, images within 1e-4 (projection and
    matmuls round differently on the two devices)."""
    pts, cols = point_cloud_for("sphere_shell", 400)
    out = []
    for dev in (device, "cpu"):
        g = from_points(pts, cols, opacity=0.9, device=dev)
        server = GSRenderServer(
            g,
            TileGrid(32, 32, 8, 16),
            ServeCfg(K=16, max_batch=4, lod_dists=(4.0,)),
            center=(0.5, 0.5, 0.5),
        )
        rig = mixed_rig((0.5, 0.5, 0.5), 1.5, 8.0, 3, 3, 32, dev)
        out.append((server.serve(rig), server.telemetry()))
    (res_d, tel_d), (res_c, tel_c) = out
    err = max(float(np.abs(a.rgb - b.rgb).max()) for a, b in zip(res_d, res_c))
    same = all(
        (a.rung, a.K, a.cache_hit, a.shed) == (b.rung, b.K, b.cache_hit, b.shed)
        for a, b in zip(res_d, res_c)
    )
    log(f"small scene, card vs CPU: max abs err {err:.3e}, decisions equal {same}")
    if not (same and tel_d == tel_c and err <= 1e-4):
        raise AssertionError(f"small scene differs: {err} {tel_d} {tel_c}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is still enabled")
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind} x{torch.cuda.device_count()}, torch {torch.__version__}")

    # 2. build
    t0 = time.perf_counter()
    lib = rasterize.build(verbose=True)
    log(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")

    # 3. kernel against the plain versions
    sweep_err = kernel_phase(device)

    # 4. serve at paper scale; the launch count covers the two passes only
    torch.cuda.reset_peak_memory_stats()
    server, rig, passes, times, info = serve_phase(device)
    launches = info["launches"]
    n_views = rig.view.shape[0]
    tel, cov = check_passes(server, passes, n_views)
    log(f"model {info}")
    log("times " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    log(f"telemetry {tel}")
    log(f"coverage per request {[round(c, 3) for c in cov]}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory {peak_gib:.2f} GiB")
    if launches != tel["batches"] or launches == 0:
        raise AssertionError(f"{launches} launches for {tel['batches']} dispatches")
    small_scene_check(device)

    # 5. kernel time on the first dispatch's own features (the near views)
    near = [v for v in range(n_views) if passes[0][v].rung == 0]
    near = near[: server.cfg.max_batch]
    stats = timing_phase(server, rig, passes[0], near)
    assign = (info["assign_impl"], info["assign_budget"])
    breakdown_phase(server, rig, passes[0], near, assign)
    record = {
        "name": "rasterize_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rasterize_fwd.cu",
        "replaces": "src/repro/kernels/rasterize.py:96",
        "launches": launches,
        "max_abs_err": max(sweep_err, stats["max_abs_err"]),
        "ms": stats["ms"],
        "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"],
        "bound_by": stats["bound_by"],
        "library_ms": None,
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    device_info = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

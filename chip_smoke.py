"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates and the script exits nonzero):

1. device    require a CUDA card; print its name and power limit; pin TF32
             off for matmuls and cuDNN.
2. build     compile both CUDA kernels, ``rasterize_fwd.cu`` and
             ``rasterize_bwd.cu`` under ``src/repro_torch/kernels/csrc/``,
             with nvcc (the two builds run in parallel).
3. kernels   hold each kernel against its plain PyTorch versions on the card
             (tiles 16x16 and 8x128 at K in {1, 16, 64, 256, 300}, and the
             launch layout's edge cases: tiles 1x1, 5x7, 8x16, 32x32 at K
             on the chunk and row-group edges; dead and saturated splats,
             37 tiles): the forward at max abs error <= 1e-5, the backward
             at the reference's saturated-case gate (rtol = atol = 5e-4
             against autograd of the plain forward, and 2e-4 against the
             single-sweep emulation), padding columns and dead slots
             exactly 0, two runs equal; a backward through the dispatcher
             launches ``rasterize_bwd`` once.  Then each kernel's inner
             loop is counted from the built library's SASS (``cuobjdump``)
             for its issue-rate ceiling.
4. serve     the paper's smallest dataset at full size: the 4,000,000-point
             kingsnake isosurface as a merged splat model, served by
             ``GSRenderServer`` at 1024x1024 with 16x16 tiles (K=64,
             max_batch=8) to a 16-view near/far rig, twice.  The second
             pass must be all cache hits and bit-identical to the first,
             and the kernel must have launched once per dispatch.  A small
             scene served on the card must match the same server on the CPU;
             then the forward kernel's time on the first dispatch's own
             tile features and the time of each stage of that dispatch.
5. train     ``run_pipeline`` on the same 4,000,000-point kingsnake scene:
             two partitions with 3% ghost halos (capacity x 1.3), 1024x1024
             images in 4096 16x16 tiles, the auto tier ladder (8, 32, 64),
             120 steps of one view each over 16 views, densify after steps
             110 and 120 with a tier re-probe after each.  Cut: 16 views of
             the paper's 448, and 120 steps; the model and the images are
             full size.  Every loss finite and falling in each partition,
             the densify events change the live count, tier overflow goes
             through ``note_overflow``, bwd launches == fwd launches > 0
             during training, merged PSNR/SSIM printed.  The same pipeline
             on a small scene on the card and on the CPU must agree.
6. timing    one train step's own tier tables (partition 0's initial model,
             view 0, the first probe's caps): both kernels against their
             plain versions at every tier's K, each with its own bound and
             issue-rate ceiling, the time of each stage of one step, and a
             ``torch.profiler`` trace of three steps (device time by
             kernel, the device's busy share of the window).

Kernel times are CUDA-event times over a run of back-to-back launches per
event pair, divided by the count (``ms``); ``call_ms`` brackets one call,
wrapper and enqueue included.  ``python3 chip_smoke.py --save-inputs DIR``
also saves the timed kernels' inputs (the serving dispatch's tile table and
the train step's tier tables) to ``DIR`` for ``tools/torch_kernel_ab.py``.

The second-to-last line is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Phase 5 rehearses on the CPU at a
small size with ``train_phase("cpu", tier="cpu", resolution=32, tile=8,
K=16, steps=110, n_views=4)``: one densify event, after the last step (on
a scene of a few thousand splats the 512 children of an event raise the
loss for some steps, so the loss check would see the jump).
"""

import argparse
import contextlib
import json
import math
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
from repro_torch.core import pipeline as pipeline_mod  # noqa: E402
from repro_torch.core import train as train_mod  # noqa: E402
from repro_torch.core.cameras import Camera, concat, orbital_rig  # noqa: E402
from repro_torch.core.cameras import select, stack  # noqa: E402
from repro_torch.core.gaussians import from_points  # noqa: E402
from repro_torch.core.projection import project  # noqa: E402
from repro_torch.core.masking import gs_loss  # noqa: E402
from repro_torch.core.pipeline import PipelineCfg  # noqa: E402
from repro_torch.core.render import _assign_views  # noqa: E402
from repro_torch.core.render import rasterize_tiles_tiered  # noqa: E402
from repro_torch.core.render import tier_tables  # noqa: E402
from repro_torch.core.render import _composite, assign_tables  # noqa: E402
from repro_torch.core.render import rasterize_batched  # noqa: E402
from repro_torch.core.render import resolve_assignment  # noqa: E402
from repro_torch.core.render import table_features  # noqa: E402
from repro_torch.core.serving import GSRenderServer, ServeCfg  # noqa: E402
from repro_torch.core.tiling import TierSchedule, TileGrid  # noqa: E402
from repro_torch.core.tiling import bin_tiles_by_occupancy  # noqa: E402
from repro_torch.core.tiling import tile_occupancy  # noqa: E402
from repro_torch.core.tiling import gather_features_at  # noqa: E402
from repro_torch.core.train import GSTrainCfg, adam_update  # noqa: E402
from repro_torch.core.train import group_lrs, init_opt  # noqa: E402
from repro_torch.core.tiling import quantize_pose, splat_features  # noqa: E402
from repro_torch.core.tiling import tile_origins, untile_image  # noqa: E402
from repro_torch.data.isosurface import point_cloud_for  # noqa: E402
from repro_torch import as_numpy  # noqa: E402
from repro_torch.kernels import ops, rasterize, ref  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
#: cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: operations per splat-pixel of the algorithm, as the plain version writes
#: it (the notes in rasterize_fwd.cu and rasterize_bwd.cu): the count of
#: work behind each bound, not the instructions a kernel issues (those are
#: counted from SASS for the issue-rate ceiling, ``rasterize.hot_loop``)
OPS_PER_SPLAT_PIXEL = 27
BWD_OPS_PER_SPLAT_PIXEL = 85
#: warp instructions an SM issues per clock (4 schedulers, one each)
ISSUE_PER_CLOCK = 4
TOL = 1e-5
#: backward gates: the reference's saturated-case tolerance against autograd
#: of the plain forward (tests/test_kernel_rasterize.py:145), and its
#: unsaturated one against the single-sweep emulation of the same algorithm
BWD_TOL = 5e-4
BWD_EMUL_TOL = 2e-4
#: the sweeps: the tiles the port uses at K across one and several chunks,
#: and the launch layout's edge cases -- tiles whose pixel count is not a
#: multiple of 32 x 4 or whose threads are not whole columns -- at K on the
#: old and new chunk edges (32; forward 128, backward 96) and row groups (3)
SWEEP = [(th, tw, K) for th, tw in ((16, 16), (8, 128)) for K in (1, 16, 64, 256, 300)]
SWEEP += [
    (th, tw, K)
    for th, tw in ((1, 1), (5, 7), (8, 16), (32, 32))
    for K in (1, 31, 33, 97, 129)
]


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
    for th, tw, K in SWEEP:
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
    return worst


def bwd_gate(got, want, tol):
    """Max over elements of |got - want| / (tol + tol * |want|): <= 1 is
    ``allclose(got, want, rtol=tol, atol=tol)``."""
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def bwd_kernel_phase(device):
    """The backward kernel against its plain version (autograd of the plain
    forward) and the single-sweep emulation over the sweep -> max abs error
    against the plain version."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for th, tw, K in SWEEP:
        feats, origins = tile_inputs(rng, 37, K, th, tw, device, dead_frac=0.25)
        out = rasterize.rasterize_fwd(feats, origins, tile_h=th, tile_w=tw)
        gout = torch.tensor(
            rng.normal(size=tuple(out.shape)), dtype=torch.float32, device=device
        )
        args = (feats, origins, out, gout)
        got = rasterize.rasterize_bwd(*args, tile_h=th, tile_w=tw)
        again = rasterize.rasterize_bwd(*args, tile_h=th, tile_w=tw)
        plain = ref.rasterize_bwd_ref(*args, tile_h=th, tile_w=tw)
        emul = ref.rasterize_bwd_emulate(*args, tile_h=th, tile_w=tw)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        g_ref = bwd_gate(got, plain, BWD_TOL)
        g_emul = bwd_gate(got, emul, BWD_EMUL_TOL)
        dead = feats[..., 8] == 0
        log(
            f"bwd K={K:3d} tile {th}x{tw}: max abs err {err:.3e} vs plain "
            f"(|g| max {plain.abs().max().item():.3e}), "
            f"{(got - emul).abs().max().item():.3e} vs emulation; gate "
            f"{g_ref:.3f} / {g_emul:.3f}"
        )
        if not (g_ref <= 1.0 and g_emul <= 1.0):
            raise AssertionError(f"bwd K={K} tile {th}x{tw}: gate {g_ref} {g_emul}")
        if got[..., 9:].abs().max().item() != 0.0:
            raise AssertionError("padding columns carry gradient")
        if dead.any() and got[..., :8][dead].abs().max().item() != 0.0:
            raise AssertionError("dead slots carry geometry/colour gradient")
        if not torch.equal(got, again):
            raise AssertionError("the backward kernel is not deterministic")
        worst = max(worst, err)
    # the dispatcher never takes the plain version on a CUDA tensor, and its
    # backward is the kernel: exactly one rasterize_bwd launch per backward
    feats, origins = tile_inputs(rng, 3, 8, 16, 16, device)
    try:
        ops.rasterize_tiles(feats, origins, tile_h=16, tile_w=16, impl="ref")
    except ValueError:
        pass
    else:
        raise AssertionError("impl='ref' ran on CUDA tensors")
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.detach().to(dtype).requires_grad_(True)
        o = origins.clone().requires_grad_(True)
        gout = torch.randn((3, 4, 16, 16), device=device)
        before = rasterize.BWD_LAUNCHES
        out = ops.rasterize_tiles(f, o, tile_h=16, tile_w=16)
        out.backward(gout)
        if rasterize.BWD_LAUNCHES != before + 1:
            raise AssertionError("the backward did not launch rasterize_bwd once")
        if f.grad.dtype != dtype or o.grad.abs().max().item() != 0.0:
            raise AssertionError(f"cotangent dtype {f.grad.dtype} / origins grad")
        f32 = f.detach().to(torch.float32)
        want = ref.rasterize_bwd_ref(
            f32, origins, out.detach(), gout, tile_h=16, tile_w=16
        )
        if dtype == torch.float32 and bwd_gate(f.grad, want, BWD_TOL) > 1.0:
            raise AssertionError("dispatcher backward disagrees with the plain version")
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


def cuda_time_ms(fn, reps, launches=1, hold_ms=0.0):
    """Median over ``reps`` CUDA-event pairs of the time per call of ``fn``,
    each pair bracketing ``launches`` back-to-back calls (after a warm-up).
    ``hold_ms`` first keeps the device busy that long (``torch.cuda._sleep``,
    before the start event), so the host enqueues the whole run before the
    device reaches it and the calls run without gaps even where a call's
    host side takes longer than its kernel."""
    fn()
    torch.cuda.synchronize()
    cycles = int(hold_ms * 2e6)  # at most 2 GHz: at least hold_ms
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def kernel_times(fn, reps=15, window_ms=4.0):
    """A kernel wrapper's time two ways -> {"ms": per launch, over runs of
    back-to-back launches filling at least ``window_ms`` of device time per
    event pair, enqueued behind a hold of the device; "call_ms": one call
    per event pair (wrapper and enqueue included, what one caller waits);
    "launches": the launches per pair}."""
    call = cuda_time_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e2  # host time of one call
    torch.cuda.synchronize()
    n = max(10, min(1000, math.ceil(window_ms / max(call, 1e-3))))
    ms = cuda_time_ms(fn, reps, n, hold_ms=2 * n * host_ms + 1.0)
    return {"ms": ms, "call_ms": call, "launches": n}


def sm_clock_mhz(fn, seconds=1.0):
    """Median SM clock (MHz) that ``nvidia-smi`` samples every 20 ms while
    ``fn`` runs back to back for ``seconds``, and the card's maximum."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm"]
    query += ["--format=csv,noheader,nounits", "-i", "0"]
    proc = subprocess.Popen(query + ["-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        text, _ = proc.communicate()
    rows = [[float(x) for x in ln.split(",")] for ln in text.splitlines() if ln.strip()]
    if not rows:
        raise AssertionError("nvidia-smi gave no clock samples")
    return statistics.median(r[0] for r in rows), rows[0][1]


def issue_ceiling_ms(loop, T, K, th, tw, clock_mhz):
    """The least time the kernel's inner loop can take at the issue rate:
    its instructions per splat-pixel (``loop``, from ``rasterize.hot_loop``)
    over every (thread, slot) of the launch, 32 threads a warp instruction,
    ISSUE_PER_CLOCK warp instructions per clock per SM."""
    threads, ppt, _ = rasterize.launch_geometry(th, tw)
    warp_instr = T * K * threads * ppt / 32 * loop["per_splat_pixel"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return warp_instr / (ISSUE_PER_CLOCK * sms * clock_mhz * 1e6) * 1e3


def time_against_plain(kernel, plain, reps=15, plain_reps=5):
    """In turns within one process: plain, kernel, kernel, plain -> the
    kernel's back-to-back ``ms`` (median of the two, and both), its
    ``call_ms``, the plain version's one-call ``plain_ms``."""
    p1 = cuda_time_ms(plain, plain_reps)
    k1 = kernel_times(kernel, reps)
    k2 = kernel_times(kernel, reps)
    p2 = cuda_time_ms(plain, plain_reps)
    return {
        "ms": statistics.median([k1["ms"], k2["ms"]]),
        "ms_runs": [k1["ms"], k2["ms"]],
        "call_ms": statistics.median([k1["call_ms"], k2["call_ms"]]),
        "launches_per_pair": k1["launches"],
        "plain_ms": statistics.median([p1, p2]),
    }


def bound(splat_pixels, ops_per_splat_pixel, n_bytes):
    """The least time of the work: its operations over the f32 peak or its
    bytes (each input read once, each output written once) over the memory
    rate, whichever is longer."""
    t_ops = splat_pixels * ops_per_splat_pixel / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops,
        "bytes_ms": t_bytes,
    }


def timing_phase(server, rig, results, views, issue, reps=15, save_dir=None):
    """Kernel vs plain version on one dispatch's own tile features (the
    canonical cameras, cached tables and projection the server used):
    agreement with the served images, error, times, bound and issue-rate
    ceiling (``issue``: the forward's hot loop; the SM clock is sampled
    here, under this shape)."""
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

    if save_dir is not None:
        torch.save({"feats": flat, "origins": origins, "tile": (th, tw)},
                   Path(save_dir) / "serve.pt")

    def kernel():
        rasterize.rasterize_fwd(flat, origins, tile_h=th, tile_w=tw)

    def plain_version():
        ref.rasterize_tiles_ref(flat, origins, tile_h=th, tile_w=tw)

    stats = time_against_plain(kernel, plain_version, reps)
    n_bytes = 4 * (flat.numel() + origins.numel() + out.numel())
    stats.update(bound(V * T * K * th * tw, OPS_PER_SPLAT_PIXEL, n_bytes))
    clock, clock_max = sm_clock_mhz(kernel)
    stats.update(
        max_abs_err=err,
        clock_mhz=clock,
        ceiling_ms=issue_ceiling_ms(issue, V * T, K, th, tw, clock),
    )
    log(
        f"timing fwd V={V} T={T} K={K} tile {th}x{tw}: "
        + json.dumps(stats)
        + f" (SM clock {clock:.0f} of {clock_max:.0f} MHz)"
    )
    return stats


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class RecordingSchedule(TierSchedule):
    """A TierSchedule that records every probe and overflow counter it is
    fed (the telemetry ``fit_partition`` drives it with)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.probes = []  # caps after each probe
        self.overflows = []  # (counter, caps grew) per step

    def probe(self, occupancy):
        out = super().probe(occupancy)
        self.probes.append(self.tier_caps)
        return out

    def note_overflow(self, overflow, n_tiles):
        ov = int(as_numpy(overflow).sum())
        grew = super().note_overflow(overflow, n_tiles)
        self.overflows.append((ov, grew))
        return grew


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def recording_fit(records, device):
    """``fit_partition`` as ``run_pipeline`` calls it, with a
    RecordingSchedule, the densify events, both kernels' launches, the
    losses and the wall time of each partition recorded in ``records``;
    the first partition also keeps its step-0 inputs for the timing."""
    fit = train_mod.fit_partition
    densify = train_mod.densify_and_prune

    def run(g0, cams, gts, masks, cfg, **kw):
        sched = RecordingSchedule(cfg.resolved_k_tiers(), slack=cfg.tier_slack)
        events = []

        def counted(g, opt, *a, **k):
            out = densify(g, opt, *a, **k)
            events.append((int(g.active.sum()), int(out[0].active.sum())))
            return out

        f0, b0 = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
        sync(device)
        t0 = time.perf_counter()
        with patched(train_mod, "densify_and_prune", counted):
            g1, opt, losses = fit(g0, cams, gts, masks, cfg, schedule=sched, **kw)
        sync(device)
        rec = {
            "seconds": time.perf_counter() - t0,
            "losses": losses,
            "fwd": rasterize.LAUNCHES - f0,
            "bwd": rasterize.BWD_LAUNCHES - b0,
            "probes": sched.probes,
            "overflows": sched.overflows,
            "densify": events,
            "k_tiers": sched.k_tiers,
            "active": (int(g0.active.sum()), int(g1.active.sum())),
            "capacity": g0.capacity,
        }
        if not records:
            rec.update(
                g0=g0,
                cams=cams,
                grid=kw["grid"],
                cfg=cfg,
                extent=kw["extent"],
                gt0=gts[:1].clone(),
                mask0=None if masks is None else masks[:1].clone(),
            )
        records.append(rec)
        return g1, opt, losses

    return run


def timed(times, label, fn, device):
    """``fn`` with the wall time of each call appended to ``times``."""

    def run(*a, **kw):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(device)
        times.append((label, time.perf_counter() - t0))
        return out

    return run


def run_recorded_pipeline(cfg, device):
    """``run_pipeline(cfg)`` with per-partition records and stage times ->
    (result, records, stage times, launches of the whole run: both counts
    are set to 0 just before it and read just after)."""
    records, times = [], []
    with contextlib.ExitStack() as stack:
        fit = recording_fit(records, device)
        stack.enter_context(patched(pipeline_mod, "fit_partition", fit))
        for name in ("build_scene", "render_views", "partition_points"):
            fn = timed(times, name, getattr(pipeline_mod, name), device)
            stack.enter_context(patched(pipeline_mod, name, fn))
        rasterize.LAUNCHES = rasterize.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        result = pipeline_mod.run_pipeline(cfg, device=device)
        launches = {"fwd": rasterize.LAUNCHES, "bwd": rasterize.BWD_LAUNCHES}
        times.append(("run_pipeline_total", time.perf_counter() - t0))
    return result, records, times, launches


def train_phase(
    device,
    *,
    dataset="kingsnake",
    tier="full",
    n_parts=2,
    resolution=1024,
    steps=120,
    K=64,
    densify_every=10,
    n_views=16,
    tile=16,
):
    """``run_pipeline`` at the given size (the defaults: the full-size
    kingsnake scene) -> (result, records, launches of the whole run),
    checked: losses finite and falling in each partition, densify events
    that change the live count, the tier telemetry fed every step, and
    (on the card) bwd launches == fwd launches > 0 in training."""
    cfg = PipelineCfg(
        dataset=dataset,
        tier=tier,
        n_parts=n_parts,
        resolution=resolution,
        steps=steps,
        K=K,
        densify_every=densify_every,
        n_views=n_views,
        train=GSTrainCfg(K=K, tile_h=tile, tile_w=tile),
    )
    log(
        f"train: run_pipeline({dataset}/{tier}, n_parts={n_parts}, "
        f"{resolution}^2, {tile}x{tile} tiles, steps={steps}, K={K}, "
        f"densify_every={densify_every}, n_views={n_views}) on {device}; "
        f"cuts: {n_views} views (paper 448), {steps} steps"
    )
    result, records, times, launches = run_recorded_pipeline(cfg, device)
    # fit_partition densifies from step 100 on (its default densify_from)
    n_events = sum(
        1 for i in range(100, steps) if densify_every and (i + 1) % densify_every == 0
    )
    for p, rec in enumerate(records):
        losses = np.asarray(rec["losses"])
        first, last = losses[:10].mean(), losses[-10:].mean()
        grown = sum(g for _, g in rec["overflows"])
        dropped = [o for o, _ in rec["overflows"] if o]
        log(
            f"partition {p}: capacity {rec['capacity']}, active "
            f"{rec['active'][0]} -> {rec['active'][1]}, densify {rec['densify']}, "
            f"ladder {rec['k_tiers']}, probed caps {rec['probes']}, overflowing "
            f"steps {len(dropped)} ({sum(dropped)} tiles, caps grew {grown}x), "
            f"launches fwd {rec['fwd']} bwd {rec['bwd']}, {rec['seconds']:.3f} s"
        )
        log(f"partition {p} losses {[round(x, 5) for x in rec['losses']]}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"partition {p}: non-finite loss")
        if not last < first:
            raise AssertionError(f"partition {p}: loss did not fall {first} -> {last}")
        changed = any(a != b for a, b in rec["densify"])
        if len(rec["densify"]) != n_events or (n_events and not changed):
            raise AssertionError(f"partition {p}: densify events {rec['densify']}")
        if len(rec["probes"]) != 1 + n_events or len(rec["overflows"]) != steps:
            raise AssertionError(f"partition {p}: tier telemetry not fed every step")
        on_card = torch.device(device).type == "cuda"
        if on_card and not rec["bwd"] == rec["fwd"] > 0:
            raise AssertionError(f"partition {p}: launches {rec['fwd']} / {rec['bwd']}")
    if not (math.isfinite(result.psnr) and math.isfinite(result.ssim)):
        raise AssertionError(f"merged metrics {result.psnr} {result.ssim}")
    log(
        f"merged: {result.n_gaussians} gaussians, PSNR {result.psnr:.4f} dB, SSIM "
        f"{result.ssim:.5f}, grad_sim {result.grad_sim:.5f}, boundary PSNR "
        f"{result.boundary_psnr:.4f} SSIM {result.boundary_ssim:.5f} "
        f"(frac {result.boundary_frac:.4f}); run launches {launches}"
    )
    log("train stage times (s) " + json.dumps([(k, round(v, 4)) for k, v in times]))
    return result, records, launches


#: card vs CPU on the small scene, 12 steps: the losses of each partition
#: (relative) and the merged PSNR (dB) / SSIM.  Sources of difference: the
#: gather transpose's atomics, the kernels' reduction order, cuDNN's
#: convolution and the projection's matmul rounding, fed through Adam.
SMALL_LOSS_RTOL = 1e-3
SMALL_PSNR_ATOL = 0.01
SMALL_SSIM_ATOL = 1e-4


def small_pipeline_check(device):
    """``run_pipeline`` on the CPU-tier sphere_shell scene on the card and
    on the CPU from the same input: losses and final PSNR/SSIM agree."""
    cfg = PipelineCfg(
        dataset="sphere_shell",
        n_parts=2,
        resolution=32,
        steps=12,
        K=16,
        n_views=4,
        train=GSTrainCfg(K=16, tile_h=8, tile_w=16),
    )
    (res_d, rec_d, _, _), (res_c, rec_c, _, _) = (
        run_recorded_pipeline(cfg, dev) for dev in (device, "cpu")
    )
    loss_err = max(
        float(np.max(np.abs(np.subtract(a["losses"], b["losses"])) / b["losses"]))
        for a, b in zip(rec_d, rec_c)
    )
    psnr_err = abs(res_d.psnr - res_c.psnr)
    ssim_err = abs(res_d.ssim - res_c.ssim)
    log(
        f"small pipeline, card vs CPU: losses max rel diff {loss_err:.3e}, PSNR "
        f"{res_d.psnr:.5f} vs {res_c.psnr:.5f} dB ({psnr_err:.3e}), SSIM "
        f"{res_d.ssim:.6f} vs {res_c.ssim:.6f} ({ssim_err:.3e})"
    )
    if not (
        loss_err <= SMALL_LOSS_RTOL
        and psnr_err <= SMALL_PSNR_ATOL
        and ssim_err <= SMALL_SSIM_ATOL
    ):
        raise AssertionError("the small pipeline differs between card and CPU")


def step_inputs(rec):
    """Partition 0's step-0 inputs -> (its initial model, view 0, the grid,
    the ladder, the first probe's caps, the assignment knobs the trainer
    resolved)."""
    g, cams, grid = rec["g0"], rec["cams"], rec["grid"]
    cam = select(cams, torch.arange(1, device=g.means.device))
    impl, budget = resolve_assignment(g, cams, grid)
    assign = {"assign_impl": impl, "assign_budget": budget}
    return g, cam, grid, rec["k_tiers"], rec["probes"][0], assign


def step_tables(splats, grid, k_tiers, caps, assign):
    """One step's tier tables from its splats -> (per-tier feats, origins,
    flat ids, plan)."""
    idx, score, _ = _assign_views(splats, grid, K=k_tiers[-1], block=4096, **assign)
    return tier_tables(
        splat_features(splats), idx, score, grid, k_tiers=k_tiers, tier_caps=caps
    )


def train_timing_phase(rec, issue, reps=15, plain_reps=5, save_dir=None):
    """Both kernels vs their plain versions on one train step's own tier
    tables, at each tier's K, each tier with its own bound and issue-rate
    ceiling (``issue``: {kernel: hot loop}; the SM clock is sampled under
    the top tier) -> {"fwd": {K: stats}, "bwd": {K: stats}}."""
    g, cam, grid, k_tiers, caps, assign = step_inputs(rec)
    th, tw = grid.tile_h, grid.tile_w
    with torch.no_grad():
        splats = project(g, cam)
        feats, origins, _, plan = step_tables(splats, grid, k_tiers, caps, assign)
    log(
        f"step tables: ladder {k_tiers}, caps {caps}, tiles placed "
        f"{plan.counts[0].tolist()}, assignment {assign}"
    )
    tiers = [t for t in zip(k_tiers, feats, origins) if t[1].shape[0]]
    gen = torch.Generator(device=tiers[0][1].device).manual_seed(0)
    planes = []
    for k, tf, og in tiers:
        out = rasterize.rasterize_fwd(tf, og, tile_h=th, tile_w=tw)
        gout = torch.randn(tuple(out.shape), generator=gen, device=tf.device)
        planes.append((k, tf, og, out, gout))
    if save_dir is not None:
        torch.save({"tiers": planes, "tile": (th, tw)}, Path(save_dir) / "train.pt")
    _, tf, og, out, gout = planes[-1]
    top = dict(tile_h=th, tile_w=tw)
    clocks = {
        "fwd": sm_clock_mhz(lambda: rasterize.rasterize_fwd(tf, og, **top)),
        "bwd": sm_clock_mhz(lambda: rasterize.rasterize_bwd(tf, og, out, gout, **top)),
    }
    clocks = {name: median for name, (median, _) in clocks.items()}
    log(f"SM clock (MHz) under the top tier: {clocks}")
    result = {"fwd": {}, "bwd": {}}
    for k, tf, og, out, gout in planes:
        T = tf.shape[0]
        n = T * k * th * tw
        args = (tf, og, out, gout)

        def kernel_fwd():
            return rasterize.rasterize_fwd(tf, og, tile_h=th, tile_w=tw)

        def plain_fwd():
            return ref.rasterize_tiles_ref(tf, og, tile_h=th, tile_w=tw)

        def kernel_bwd():
            return rasterize.rasterize_bwd(*args, tile_h=th, tile_w=tw)

        def plain_bwd():
            return ref.rasterize_bwd_ref(*args, tile_h=th, tile_w=tw)

        err = (kernel_fwd() - plain_fwd()).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"tier K={k}: forward err {err}")
        got, want = kernel_bwd(), plain_bwd()
        bwd_err = (got - want).abs().max().item()
        gate = bwd_gate(got, want, BWD_TOL)
        if not gate <= 1.0:
            raise AssertionError(f"tier K={k}: backward disagrees, gate {gate}")
        fwd_bytes = 4 * (tf.numel() + og.numel() + out.numel())
        bwd_bytes = 4 * (2 * tf.numel() + og.numel() + out.numel() + gout.numel())
        for name, kern, plain, ops_per, n_bytes, e in (
            ("fwd", kernel_fwd, plain_fwd, OPS_PER_SPLAT_PIXEL, fwd_bytes, err),
            ("bwd", kernel_bwd, plain_bwd, BWD_OPS_PER_SPLAT_PIXEL, bwd_bytes, bwd_err),
        ):
            stats = time_against_plain(kern, plain, reps, plain_reps)
            stats.update(bound(n, ops_per, n_bytes))
            stats.update(
                tiles=T,
                max_abs_err=e,
                clock_mhz=clocks[name],
                ceiling_ms=issue_ceiling_ms(
                    issue[f"rasterize_{name}"], T, k, th, tw, clocks[name]
                ),
            )
            if name == "bwd":
                stats["gate"] = gate
            result[name][k] = stats
            log(f"train {name} tier K={k}: {json.dumps(stats)}")
    return result


def train_breakdown_phase(rec):
    """Host-clock time of each stage of one train step on partition 0's
    step-0 inputs (each stage between two device synchronisations, second
    of two runs), and of the whole step -> {stage: ms}.  The bwd launches
    run inside 'backward'; they are also timed on their own."""
    g, cam, grid, k_tiers, caps, assign = step_inputs(rec)
    cfg, gt0, mask0 = rec["cfg"], rec["gt0"], rec["mask0"]
    th, tw = grid.tile_h, grid.tile_w
    lrs = group_lrs(cfg, rec["extent"])
    opt = init_opt(g)
    step = train_mod.make_train_step(cfg, grid, rec["extent"], tier_caps=caps, **assign)
    stages = {}

    def stage(name, fn):
        sync(cam.view.device)
        t0 = time.perf_counter()
        out = fn()
        sync(cam.view.device)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    def loss_fn():
        rgb = _composite(untile_image(tiles, grid), cfg.bg).rgb
        mask = None if mask0 is None else mask0[0]
        return gs_loss(rgb, gt0[0], mask, lambda_dssim=cfg.lambda_dssim)

    def bwd_launches(planes):
        for f, o, out in planes:
            gout = torch.ones_like(out)
            rasterize.rasterize_bwd(f, o, out, gout, tile_h=th, tile_w=tw)

    for _ in range(2):
        tr = {k: p.detach().requires_grad_(True) for k, p in g.trainable().items()}
        gg = g.with_trainable(tr)
        splats = stage("project", lambda: project(gg, cam))
        idx, score, _ = stage(
            "assign",
            lambda: _assign_views(splats, grid, K=k_tiers[-1], block=4096, **assign),
        )
        stage(
            "occupancy_binning",
            lambda: bin_tiles_by_occupancy(tile_occupancy(score), k_tiers, caps),
        )
        feat = splat_features(splats)
        tiers = {"k_tiers": k_tiers, "tier_caps": caps}
        feats, origins, ids, _ = stage(
            "gather_with_binning", lambda: tier_tables(feat, idx, score, grid, **tiers)
        )
        tiles = stage(
            "rasterize_fwd_launches",
            lambda: rasterize_tiles_tiered(
                feats, origins, ids, grid.n_tiles, tile_h=th, tile_w=tw
            ),
        )
        loss = stage("untile_loss", loss_fn)
        grads = stage("backward", lambda: torch.autograd.grad(loss, list(tr.values())))
        grads = dict(zip(tr, grads))
        stage("adam", lambda: adam_update(cfg, lrs, g.trainable(), grads, opt))
        detached = [(f.detach(), o) for f, o in zip(feats, origins) if f.shape[0]]
        planes = [
            (f, o, rasterize.rasterize_fwd(f, o, tile_h=th, tile_w=tw))
            for f, o in detached
        ]
        stage("rasterize_bwd_launches_alone", lambda: bwd_launches(planes))
        stage("whole_step", lambda: step(g, opt, cam, gt0, mask0))
    log(
        "breakdown of one train step (ms) "
        + json.dumps({k: round(v, 3) for k, v in stages.items()})
    )
    return stages


def train_profile_phase(rec, steps=3, top=12):
    """Device time by kernel name over ``steps`` train steps on partition
    0's step-0 inputs (``torch.profiler``, device activity only, after one
    warm-up step), and the share of the window's wall time in which the
    device ran anything -> (rows, busy share, window ms per step)."""
    g, cam, grid, _, caps, assign = step_inputs(rec)
    cfg, gt0, mask0 = rec["cfg"], rec["gt0"], rec["mask0"]
    dev = cam.view.device
    step = train_mod.make_train_step(cfg, grid, rec["extent"], tier_caps=caps, **assign)
    opt = init_opt(g)
    step(g, opt, cam, gt0, mask0)
    sync(dev)
    act = torch.profiler.ProfilerActivity
    on_card = dev.type == "cuda"
    with torch.profiler.profile(activities=[act.CUDA if on_card else act.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(g, opt, cam, gt0, mask0)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
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
    share = busy / wall_us
    log(
        f"profile of {steps} train steps: {wall_us / steps / 1e3:.3f} ms per step "
        f"(traced), device busy {100 * share:.1f}% of the window, "
        f"{len(spans)} device events, {len(rows)} names"
    )
    for name, (n, t) in rows[:top]:
        log(f"  {t / steps / 1e3:8.3f} ms/step  x{n // steps:<4d} {name[:90]}")
    return rows, share, wall_us / steps / 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument(
        "--save-inputs",
        metavar="DIR",
        help="also save the timed kernels' inputs to DIR (serve.pt, train.pt)",
    )
    args = parser.parse_args(argv)
    save_dir = args.save_inputs
    if save_dir is not None:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
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

    # 2. build: both kernels, in parallel
    t0 = time.perf_counter()
    libs = rasterize.build(verbose=True)
    log(f"built {[p.name for p in libs.values()]} in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against the plain versions; their inner loops from SASS
    sweep_err = kernel_phase(device)
    bwd_sweep_err = bwd_kernel_phase(device)
    issue = {
        name: rasterize.hot_loop(rasterize.sass(name), f"{name}_kernelILb1E")
        for name in rasterize.SOURCES
    }
    log(f"inner loops from SASS (the one-column build): {json.dumps(issue)}")

    # 4. serve at paper scale; the launch count covers the two passes only
    torch.cuda.reset_peak_memory_stats()
    server, rig, passes, times, info = serve_phase(device)
    serve_launches = info["launches"]
    n_views = rig.view.shape[0]
    tel, cov = check_passes(server, passes, n_views)
    log(f"model {info}")
    log("times " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    log(f"telemetry {tel}")
    log(f"coverage per request {[round(c, 3) for c in cov]}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve: peak device memory {peak_gib:.2f} GiB")
    if serve_launches != tel["batches"] or serve_launches == 0:
        raise AssertionError(f"{serve_launches} launches, {tel['batches']} dispatches")
    small_scene_check(device)
    # the forward kernel's time on the first dispatch's own features
    near = [v for v in range(n_views) if passes[0][v].rung == 0]
    near = near[: server.cfg.max_batch]
    stats = timing_phase(
        server, rig, passes[0], near, issue["rasterize_fwd"], save_dir=save_dir
    )
    assign = (info["assign_impl"], info["assign_budget"])
    breakdown_phase(server, rig, passes[0], near, assign)
    del server, rig, passes
    torch.cuda.empty_cache()

    # 5. train at paper scale; the counts cover the whole run_pipeline
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, records, train_launches = train_phase(device)
    log(
        f"train: phase {time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    small_pipeline_check(device)

    # 6. kernel times on one train step's own tier tables, and its stages
    tiers = train_timing_phase(records[0], issue, save_dir=save_dir)
    bwd_stats = tiers["bwd"][max(tiers["bwd"])]  # the top tier
    train_breakdown_phase(records[0])
    train_profile_phase(records[0])
    fwd_errs = [sweep_err, stats["max_abs_err"]]
    fwd_errs += [t["max_abs_err"] for t in tiers["fwd"].values()]
    bwd_errs = [bwd_sweep_err] + [t["max_abs_err"] for t in tiers["bwd"].values()]
    log(
        f"launches on the main paths: serve fwd {serve_launches}; train fwd "
        f"{train_launches['fwd']} bwd {train_launches['bwd']}"
    )
    kernels = [
        {
            "name": "rasterize_fwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rasterize_fwd.cu",
            "replaces": "src/repro/kernels/rasterize.py:96",
            "launches": serve_launches + train_launches["fwd"],
            "max_abs_err": max(fwd_errs),
            "ms": stats["ms"],
            "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"],
            "library_ms": None,
        },
        {
            "name": "rasterize_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rasterize_bwd.cu",
            "replaces": "src/repro/kernels/rasterize.py:169",
            "launches": train_launches["bwd"],
            "max_abs_err": max(bwd_errs),
            "ms": bwd_stats["ms"],
            "plain_ms": bwd_stats["plain_ms"],
            "bound_ms": bwd_stats["bound_ms"],
            "bound_by": bwd_stats["bound_by"],
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device_info = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GS render serving driver (CLI), port of ``repro.launch.serve_gs``.

    # serve a trainer's checkpoint tree (it must hold merged/): mixed
    # near/far camera batches, two passes (the second must hit the
    # pose-bucket cache), telemetry JSON out:
    python -m repro_torch.launch.serve_gs --ckpt-dir /tmp/gs --views 6 \
        --passes 2 --telemetry-json /tmp/serve.json

Loads the merged checkpoint ONCE (shape-free restore: the merged capacity
is a training outcome), builds the LOD ladder, then answers camera
requests through the bounded-queue batcher (core/serving.py): each pass
submits a mixed near/far orbital rig (near views exercise rung 0, far
views the pruned rungs) and flushes.  Exit is nonzero if a repeat pass
fails to hit the cache.  ``--device`` (default ``cuda``) picks the card or
the CPU.  The telemetry JSON also holds the restore's seconds, the
compositor's forward kernel's launches in this process and the
projection's (forward, backward) launches.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.cameras import concat, orbital_rig
from repro_torch.core.serving import GSRenderServer
from repro_torch.kernels import project as project_kernels
from repro_torch.kernels import rasterize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="checkpoints",
                    help="a trainer's checkpoint tree (must contain "
                         "merged/)")
    ap.add_argument("--views", type=int, default=6,
                    help="cameras per pass (half near, half far)")
    ap.add_argument("--passes", type=int, default=2,
                    help="times to serve the SAME rig (pass >= 2 must hit "
                         "the pose-bucket cache)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-entries", type=int, default=64)
    ap.add_argument("--near", type=float, default=1.0,
                    help="near orbit radius, in units of the training rig "
                         "radius")
    ap.add_argument("--far", type=float, default=5.0,
                    help="far orbit radius (same units) — drives LOD rung "
                         "selection")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--telemetry-json", default=None,
                    help="write the serving telemetry + per-pass stats "
                         "as JSON")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda, or cpu)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    server, extra = GSRenderServer.from_checkpoint(
        args.ckpt_dir, device=args.device, impl=args.impl,
        max_batch=args.max_batch, cache_entries=args.cache_entries)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    restore_s = time.perf_counter() - t0
    meta = extra.get("scene", {})
    g0 = server.ladder[0]
    n_dev = torch.cuda.device_count() if server.device.type == "cuda" else 1
    print(f"[serve-gs] devices={n_dev} "
          f"model={int(g0.active.sum()):,} live splats "
          f"grid={server.grid.width}x{server.grid.height} "
          f"ladder K={server.schedule.k_tiers} "
          f"lod rungs={[int(r.active.sum()) for r in server.ladder]} "
          f"dists={tuple(round(d, 3) for d in server.lod_dists)} "
          f"restore={restore_s:.3f}s")

    # mixed near/far rig around the checkpointed scene frame: near views
    # stay on rung 0, far views select the pruned rungs
    rig_r = float(meta.get("radius", server.radius))
    center = meta.get("center", server.center)
    res = server.grid.width
    n_near = max(1, args.views // 2)
    n_far = max(1, args.views - n_near)
    rig = concat([
        orbital_rig(n_near, center, rig_r * args.near, width=res,
                    height=res, device=server.device),
        orbital_rig(n_far, center, rig_r * args.far, width=res, height=res,
                    device=server.device)])

    passes = []
    for p in range(args.passes):
        t0 = time.perf_counter()
        results = server.serve(rig)
        dt = time.perf_counter() - t0
        hits = sum(r.cache_hit for r in results)
        rungs = sorted({r.rung for r in results})
        assert all(np.isfinite(r.rgb).all() for r in results)
        print(f"[serve-gs] pass {p}: {len(results)} requests in "
              f"{dt * 1e3:.1f}ms ({len(results) / dt:.1f} req/s)  "
              f"cache hits {hits}/{len(results)}  rungs {rungs}")
        passes.append({"requests": len(results), "wall_s": dt,
                       "req_per_s": len(results) / dt, "hits": hits,
                       "rungs": rungs})

    tel = server.telemetry()
    print(f"[serve-gs] telemetry {tel}")
    if args.telemetry_json:
        with open(args.telemetry_json, "w") as f:
            json.dump({"telemetry": tel, "passes": passes,
                       "scene": meta, "restore_s": restore_s,
                       "kernel_launches": rasterize.LAUNCHES,
                       "project_launches": [
                           project_kernels.PROJECT_LAUNCHES,
                           project_kernels.PROJECT_BWD_LAUNCHES]}, f, indent=1)
        print(f"[serve-gs] telemetry -> {args.telemetry_json}")
    if args.passes >= 2 and passes[-1]["hits"] < passes[-1]["requests"]:
        raise SystemExit(
            "[serve-gs] FAIL: repeat pass hit the cache on only "
            f"{passes[-1]['hits']}/{passes[-1]['requests']} requests")
    print("[serve-gs] ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

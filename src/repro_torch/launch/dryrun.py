"""Dry run: every (architecture x input-shape) cell's step, run once on
``meta`` tensors under ``launch.cost_analysis`` and recorded with its
roofline on one H100.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
on 512 forced host devices and parses the HLO.  Here the cell's step (the
port's ``make_train_step``, ``make_prefill_step`` or ``make_decode_step``
on ``param_specs``, ``opt_state_specs`` and ``input_specs``) runs once on
``meta`` tensors -- shapes only, nothing allocated, no card needed -- and
every op it dispatches is charged.  The values are per card, on one mesh,
``card`` (the LM port runs one model on one card).

  python -m repro_torch.launch.dryrun --arch all --shape all
  python -m repro_torch.launch.dryrun --gs
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k

Per-cell JSON lands in <out>/card/<arch>__<shape>.json with the reference's
keys (``hlo`` holds the analyzer's dict, so ``benchmarks/roofline.py``
formats the records unchanged) and is cached (re-runs skip finished cells
unless --force).  ``bound_s`` is the least time of the step on the card:
its FLOPs at the bf16 peak or its compulsory bytes (arguments read once,
outputs written once) at the HBM rate, whichever is longer.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import all_arch_ids, get_spec
from repro_torch.configs.gs_datasets import FULL as GS_FULL
from repro_torch.configs.gs_datasets import get_gs_dataset
from repro_torch.core import distributed as D
from repro_torch.core.cameras import Camera, orbital_rig
from repro_torch.core.gaussians import Gaussians, from_points
from repro_torch.core.tiling import TileGrid
from repro_torch.core.train import GSOptState, GSTrainCfg, init_opt
from repro_torch.core.train import make_train_step as gs_train_step
from repro_torch.launch.cost_analysis import analyze
from repro_torch.models.params import param_specs
from repro_torch.models.steps import (SHAPES, TrainCfg, input_specs,
                                      make_decode_step, make_prefill_step,
                                      make_train_step, opt_state_specs)

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W power
# limit: bf16 tensor-core peak, HBM3 rate, NVLink rate each way
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
#: device memory of one card
CARD_BYTES = 80e9

GS_CELLS = {
    # name -> (dataset, resolution)
    "gs-kingsnake": ("kingsnake", 2048),
    "gs-rayleigh-taylor": ("rayleigh_taylor", 2048),
    "gs-richtmyer-meshkov": ("richtmyer_meshkov", 2048),
    "gs-richtmyer-meshkov-1k": ("richtmyer_meshkov", 1024),
}

SKIP_REASON = ("long_500k needs sub-quadratic attention (pure "
               "full-attention arch; DESIGN.md §5)")


def model_flops(spec, shape_name: str) -> float:
    """Assignment definition: 6*N*D train / 2*N*D inference, N active params,
    D tokens processed globally."""
    sh = SHAPES[shape_name]
    n = spec.param_count(active_only=True)
    if sh["kind"] == "train":
        return 6.0 * n * sh["batch"] * sh["seq"]
    if sh["kind"] == "prefill":
        return 2.0 * n * sh["batch"] * sh["seq"]
    return 2.0 * n * sh["batch"]  # decode: one token per sequence


def lm_step(spec, shape_name: str, *, batch=None, seq=None):
    """-> (the cell's step, its ``meta`` arguments): the train step on
    (params, opt state, batch), prefill on (params, batch), or decode on
    (params, caches, tokens, pos) with ``pos`` the last cache position as a
    Python int.  ``batch`` / ``seq`` replace the shape's where given."""
    saved = SHAPES[shape_name]
    sh = SHAPES[shape_name] = dict(saved, batch=batch or saved["batch"],
                                   seq=seq or saved["seq"])
    try:
        io = input_specs(spec, shape_name)
    finally:
        SHAPES[shape_name] = saved
    if sh["kind"] == "train":
        cfg = TrainCfg(total_steps=10_000)
        return make_train_step(spec, cfg), (
            param_specs(spec), opt_state_specs(spec, cfg), io["batch"])
    if sh["kind"] == "prefill":
        return make_prefill_step(spec), (param_specs(spec), io["batch"])
    return make_decode_step(spec), (param_specs(spec), io["caches"],
                                    io["tokens"], sh["seq"] - 1)


def lm_cell(spec, shape_name: str) -> dict:
    """The cell's step run once on ``meta`` tensors -> ``analyze``'s dict."""
    step, args = lm_step(spec, shape_name)
    return analyze(step, *args)


def gs_meta(cell: str) -> dict:
    """The dense GS cell's sizes: one partition on one card, N rounded up
    to a multiple of 4096, K = 64, 8x128 tiles (the reference's rules with
    its mesh's data axis at 1)."""
    ds_name, res = GS_CELLS[cell]
    n_parts, mult = 1, 4096
    n_per_part = -(-GS_FULL[ds_name].n_points // n_parts // mult) * mult
    return {"dataset": ds_name, "resolution": res, "n_parts": n_parts,
            "gaussians_per_part": n_per_part, "K": 64,
            "tiles": TileGrid(res, res, 8, 128).n_tiles}


def gs_model_flops(meta: dict) -> float:
    """Analytic "useful" flops of the dense step: the rasterization forward
    and backward, projection and the loss (the dense tile assignment is
    implementation overhead, not model flops)."""
    T, K, pix = meta["tiles"], meta["K"], 8 * 128
    raster = meta["n_parts"] * T * K * pix * (30 + 45)
    proj = meta["n_parts"] * meta["gaussians_per_part"] * 300 * 3
    loss = meta["n_parts"] * T * pix * 3 * 2 * 49 * 6   # ssim convs fwd+bwd
    return float(raster + proj + loss)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def gs_cell(cell: str):
    """The dense GS step (``k_tiers=None``, dense assignment, the plain
    compositor: what ``meta`` tensors take) of one partition at the
    dataset's full size, run once on ``meta`` tensors -> (``analyze``'s
    dict, meta, model flops).  The step is ``core.train.make_train_step``:
    the distributed step builds its tile bounds on its mesh's device and
    does not run on ``meta`` tensors."""
    meta = gs_meta(cell)
    res, N = meta["resolution"], meta["gaussians_per_part"]
    cfg = GSTrainCfg(K=meta["K"], tile_h=8, tile_w=128)
    grid = TileGrid(res, res, cfg.tile_h, cfg.tile_w)
    g = Gaussians(_meta(N, 3), _meta(N, 3), _meta(N, 4), _meta(N),
                  _meta(N, 3), _meta(N, dtype=torch.bool),
                  _meta(N, dtype=torch.int32))
    tr = g.trainable()
    opt = GSOptState(m=dict(tr), v=dict(tr), step=_meta(dtype=torch.int32),
                     grad_accum=_meta(N), grad_count=_meta(N))
    cam = Camera(view=_meta(4, 4), fx=_meta(), fy=_meta(), width=res,
                 height=res)
    step = gs_train_step(cfg, grid, 1.0, k_tiers=None, assign_impl="dense")
    hlo = analyze(step, g, opt, cam, _meta(res, res, 3),
                  _meta(res, res, dtype=torch.bool))
    meta["step"] = "core.train.make_train_step"
    return hlo, meta, gs_model_flops(meta)


def gs_train_cell(dataset: str, mesh, *, res: int = 64, n_parts: int = 2,
                  view_batch: int = 0, tier: str = "cpu"):
    """The PRODUCTION GS train step -- the tiered ``make_gs_train_step``
    that ``fit_partitions`` dispatches every step -- on a ("part", "view")
    mesh, at its strip-sized caps (the always-exact shape, an upper bound
    on any probed-cap step), on real tensors of the mesh's device: random
    splats from seed 0 in every live slot and an orbital rig ->
    (step, its arguments on this rank, meta).  The counterpart of
    ``lower_gs_train_cell``."""
    vb = view_batch or mesh.axis_size("view")
    cfg = GSTrainCfg(view_batch=vb)
    ds = get_gs_dataset(dataset, tier)
    mult = mesh.axis_size("part")           # N is sharded over "part"
    n_per_part = -(-int(ds.n_points * ds.capacity_factor)
                   // n_parts // mult) * mult
    grid = TileGrid(res, res, cfg.tile_h, cfg.tile_w)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    live = ds.n_points // n_parts
    parts = [from_points(torch.rand((live, 3), generator=gen, device=dev)
                         - 0.5, capacity=n_per_part, device=dev)
             for _ in range(n_parts)]
    g = Gaussians(*(torch.stack(f) for f in zip(*parts)))
    opt = init_opt(g)
    T = grid.n_tiles
    batch = {
        "gt_tiles": torch.rand((vb, n_parts * T, 3, grid.tile_h,
                                grid.tile_w), generator=gen, device=dev),
        "mask_tiles": torch.ones((vb, n_parts * T, grid.tile_h,
                                  grid.tile_w), dtype=torch.bool,
                                 device=dev),
        "cam": orbital_rig(vb, (0.0, 0.0, 0.0), 2.5, width=res, height=res,
                           device=dev),
    }
    step = D.make_gs_train_step(mesh, cfg, grid, extent=1.0, views=vb,
                                return_overflow=True)
    gl, ol = D.gs_shard_state((g, opt), mesh)
    meta = {
        "dataset": dataset, "resolution": res, "n_parts": n_parts,
        "gaussians_per_part": n_per_part, "view_batch": vb,
        "k_tiers": cfg.resolved_k_tiers(), "tiles": T,
    }
    return step, (gl, ol, D.gs_shard_batch(batch, mesh, vb,
                                           n_parts=n_parts)), meta


def run_cell(arch: str, shape: str, out_dir: str,
             force: bool = False) -> str:
    """Analyze one cell and write its record -> a one-line status."""
    os.makedirs(f"{out_dir}/card", exist_ok=True)
    path = f"{out_dir}/card/{arch}__{shape}.json"
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)["status"] + " (cached)"

    rec = {"arch": arch, "shape": shape, "mesh": "card", "mesh_shape": [1],
           "mesh_axes": ["card"], "n_devices": 1}
    is_gs = arch.startswith("gs-")
    if not is_gs:
        spec = get_spec(arch)
        if shape in spec.skip_shapes:
            rec.update(status="skip", reason=SKIP_REASON)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            return "skip"

    try:
        t0 = time.time()
        if is_gs:
            hlo, meta, mflops = gs_cell(arch)
            rec["gs_meta"] = meta
        else:
            hlo = lm_cell(spec, shape)
            mflops = model_flops(spec, shape)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["argument_size_in_bytes"] = hlo["argument_bytes"]
        rec["output_size_in_bytes"] = hlo["output_bytes"]
        rec["fits_one_card"] = hlo["argument_bytes"] <= CARD_BYTES
        rec["hlo"] = hlo
        rec["model_flops_global"] = mflops
        rec["model_flops_per_device"] = mflops / rec["n_devices"]
        rec["roofline"] = {
            "compute_s": hlo["flops"] / PEAK_FLOPS,
            "memory_s": hlo["hbm_bytes"] / HBM_BW,
            "collective_s": hlo["collective_wire_bytes"] / LINK_BW,
        }
        rec["bottleneck"] = max(rec["roofline"], key=rec["roofline"].get)
        rec["useful_flops_ratio"] = (
            rec["model_flops_per_device"] / hlo["flops"]
            if hlo["flops"] else 0.0)
        rec["bound_s"] = bound_s(hlo)
        rec["status"] = "ok"
    except Exception:
        rec["status"] = "error"
        rec["traceback"] = traceback.format_exc()[-4000:]

    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "error":
        return "error: " + rec["traceback"].strip().splitlines()[-1][:150]
    r = rec["roofline"]
    return (f"ok  trace {rec['trace_s']:.1f}s  compute "
            f"{r['compute_s']*1e3:.2f}ms mem {r['memory_s']*1e3:.2f}ms "
            f"coll {r['collective_s']*1e3:.2f}ms -> {rec['bottleneck']}  "
            f"bound {rec['bound_s']*1e3:.3f}ms")


def bound_s(hlo: dict) -> float:
    """The least time of the analyzed work on one card: its FLOPs at the
    bf16 peak or its compulsory bytes at the HBM rate, the longer."""
    return max(hlo["flops"] / PEAK_FLOPS, hlo["compulsory_bytes"] / HBM_BW)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="all",
                    help="csv of arch ids, 'all' (LM), or gs cell names")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card", choices=["card"])
    ap.add_argument("--gs", action="store_true", help="run the GS cells")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.gs:
        archs = list(GS_CELLS) if args.arch == "all" \
            else args.arch.split(",")
        shapes = ["train"]
    else:
        archs = all_arch_ids() if args.arch == "all" else args.arch.split(",")
        shapes = list(SHAPES) if args.shape == "all" \
            else args.shape.split(",")
    cells = [(a, s) for a in archs for s in shapes]
    print(f"dry-run: {len(cells)} cells on meta tensors, one card's "
          "roofline")
    errors = 0
    for i, (arch, shape) in enumerate(cells):
        t0 = time.time()
        msg = run_cell(arch, shape, args.out, args.force)
        errors += msg.startswith("error")
        print(f"[{i+1}/{len(cells)}] {args.mesh:6s} {arch:28s} {shape:12s} "
              f"{msg}  ({time.time()-t0:.0f}s)", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())

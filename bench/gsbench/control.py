"""The control of the output check: the plain reference put in the
program's place and computed in TF32 (matrix products and convolutions
with TF32 operands), the step below the configuration's float32 that would
tempt a later change.  A sound check has to find it not correct.

``train_readings`` takes the TF32 reference through the cell's first
three steps (the same inputs, views and step count as a run's check) and
reads it as a run reads the program; ``serve_readings`` renders a cell's
poses (drawn as its traffic draws them) in TF32 and reads the images.  The
program is not involved.
"""

from __future__ import annotations

import torch

from gsbench import fields, reference, scene


def _inputs(cfg: dict, seed: int, dev, src):
    allpts = src.reference_points(cfg, dev)
    rows = scene.select_rows(allpts.shape[0], int(cfg["points"]), seed)
    pts = allpts[torch.from_numpy(rows).to(dev)]
    return pts, fields.height_colors(pts)


def train_readings(cfg: dict, seed: int, dev, precision: str = "tf32",
                   fault: str = "none", ranks: int = 1, src=scene.DENSE):
    """The check's numbers for the reference in ``precision`` against the
    float32 reference -> {name: reading}, on the points of ``src``'s
    reference side (``scene.source``).  ``fault`` plants one of a
    training step's faults in the float32 reference put in the program's
    place instead: ``"half_batch"`` (the loss over the first half of the
    partitions' tiles alone) or ``"no_exchange"`` (the "part" all-gather
    over ``ranks`` ranks left out: rank 0 renders its own block of each
    partition's slots)."""
    tc = cfg["train"]
    P, V = int(cfg["partitions"]), int(cfg["views"])
    W = H = int(cfg["image"])
    th, tw, K = int(tc["tile_h"]), int(tc["tile_w"]), int(tc["K"])
    pts, cols = _inputs(cfg, seed, dev, src)
    pts_np = pts.cpu().numpy()
    center, extent, _ = scene.frame(pts_np)
    views_np = scene.train_views(V, center, extent)
    focal = reference.focal_for(W)
    blocks = reference.partition(pts_np, P, float(tc["ghost_frac"]) * extent)
    cap = int(max(len(b[0]) for b in blocks) * float(tc["capacity_factor"]))
    views = [torch.from_numpy(views_np[i]).to(dev) for i in range(3)]
    cap = -(-cap // ranks) * ranks
    runs = {}
    sides = [("ref", "f32"), ("prog", "f32" if fault != "none" else precision)]
    for side, name in sides:
        prec = reference.Precision(name)
        planted = side == "prog" and fault != "none"
        with prec.backend_flags():
            init, gts, masks = [], [[], [], []], [[], [], []]
            for rows_p, _, _ in blocks:
                ix = torch.from_numpy(rows_p).to(dev)
                init.append(reference.init_splats(
                    pts[ix], cols[ix], cap, float(tc["init_opacity"])))
                if planted and fault == "no_exchange":
                    init[-1]["active"][cap // ranks:] = False
                gt_s = reference.init_splats(pts[ix], cols[ix], len(rows_p),
                                             float(tc["gt_opacity"]))
                for i in range(3):
                    rgb, cov = reference.render_image(
                        gt_s, views[i], focal, width=W, height=H,
                        tile_h=th, tile_w=tw, K=K, bg=0.0, prec=prec)
                    gts[i].append(rgb)
                    masks[i].append(reference.coverage_mask(cov, prec))
            masks = [torch.stack(x) for x in masks]
            if planted and fault == "half_batch":
                for m in masks:
                    m[P // 2:] = False
            elif planted and fault != "no_exchange":
                raise ValueError(f"unknown fault {fault!r}")
            p0 = {k: torch.stack([s[k] for s in init])
                  for k in reference.FIELDS}
            losses, first, params = reference.train_steps(
                init, views, focal, [torch.stack(x) for x in gts], masks,
                steps=3, width=W, height=H, tile_h=th, tile_w=tw, K=K,
                extent=extent, prec=prec)
            runs[side] = (losses, first,
                          {k: params[k] - p0[k] for k in reference.FIELDS})
    (l_ref, g_ref, c_ref), (l_c, g_c, c_c) = runs["ref"], runs["prog"]
    keep = reference.moved_leaves(g_ref)
    return {"points_gap": 0.0,
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l_c, l_ref)),
            "grad_gap": reference.leaf_gaps(g_c, g_ref)[0],
            "change_gap": reference.leaf_gaps(c_c, c_ref, keep)[0]}


def serve_readings(cfg: dict, traffic: dict, seed: int, dev, n: int = 8,
                   precision: str = "tf32", src=scene.DENSE):
    """The image gap of ``n`` of the traffic's poses rendered in
    ``precision`` against float32 -> {name: reading}, on the points of
    ``src``'s reference side (``scene.source``)."""
    sc = cfg["serve"]
    W = H = int(cfg["image"])
    pts, cols = _inputs(cfg, seed, dev, src)
    center, _, radius = scene.frame(pts.cpu().numpy())
    poses = scene.ViewerPoses(traffic, center, radius, seed)
    focal = reference.focal_for(W)
    s = reference.init_splats(pts, cols, pts.shape[0], float(sc["opacity"]))
    gaps = []
    for i in range(n):
        v, fx, _ = reference.snap_pose(poses.next(i % poses.viewers), focal,
                                       focal)
        view = torch.from_numpy(v).to(dev)
        imgs = []
        for name in ("f32", precision):
            prec = reference.Precision(name)
            with prec.backend_flags():
                imgs.append(reference.render_image(
                    s, view, float(fx), width=W, height=H,
                    tile_h=int(sc["tile_h"]), tile_w=int(sc["tile_w"]),
                    K=int(sc["K"]), bg=1.0, prec=prec)[0])
        gaps.append(float((imgs[0] - imgs[1]).abs().mean()))
    return {"points_gap": 0.0, "image_gap": max(gaps)}

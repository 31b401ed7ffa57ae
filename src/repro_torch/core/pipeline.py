"""End-to-end single-host pipeline for the paper's workflow (§II, Fig. 1):

  volume -> isosurface point cloud -> camera rig -> spatial partitioning
  (+ghost cells) -> per-partition GT renders + background masks ->
  independent per-partition training -> merge -> global evaluation.

Port of ``repro.core.pipeline`` (``PipelineCfg``, ``PipelineResult``,
``build_scene``, ``gt_gaussians``, ``init_partition_gaussians``,
``coverage_masks``, ``render_views``, ``run_pipeline``, and the timeseries
driver's ingest: ``TimestepData``, ``prepare_timestep``,
``TimestepPrefetcher``).  Renders and masks stay on the device as tensors;
``PipelineResult`` carries the images as host numpy arrays, as the
reference does.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch import check_device
from repro_torch.configs.gs_datasets import GSDataset, get_gs_dataset
from repro_torch.core import merge as merge_mod
from repro_torch.core import metrics
from repro_torch.core.cameras import Camera, orbital_rig, select
from repro_torch.core.gaussians import Gaussians, from_points
from repro_torch.core.masking import dilate_mask
from repro_torch.core.partition import PartitionData, partition_points
from repro_torch.core.render import (occupancy_probe, render_batch,
                                     resolve_assignment)
from repro_torch.core.tiling import (DEFAULT_ASSIGN_IMPL, TileGrid,
                                     auto_tier_caps)
from repro_torch.core.train import GSTrainCfg, fit_partition
from repro_torch.data.isosurface import point_cloud_for
from repro_torch.runtime.checkpoint import tree_flatten


@dataclasses.dataclass
class PipelineCfg:
    dataset: str = "sphere_shell"
    tier: str = "cpu"
    n_parts: int = 2
    resolution: int = 64
    steps: int = 200
    K: int = 48
    use_ghost: bool = True          # ablation switches (Fig. 2/4)
    use_mask: bool = True
    densify_every: int = 0
    train: GSTrainCfg = dataclasses.field(default_factory=GSTrainCfg)
    n_views: Optional[int] = None   # override dataset default
    seed: int = 0


@dataclasses.dataclass
class PipelineResult:
    merged: Gaussians
    parts: List[Gaussians]
    psnr: float
    ssim: float
    grad_sim: float
    train_seconds: List[float]
    n_gaussians: int
    gt_images: np.ndarray
    renders: np.ndarray
    # metrics restricted to partition-boundary pixels (paper Fig. 2)
    boundary_psnr: float = float("nan")
    boundary_ssim: float = float("nan")
    boundary_frac: float = 0.0


def build_scene(ds: GSDataset, seed: int = 0, t: float = 0.0):
    """-> (points, colors, extent); host numpy, identical to the
    reference's."""
    points, colors = point_cloud_for(ds.volume, ds.n_points, seed=seed, t=t)
    extent = float(np.linalg.norm(points.max(0) - points.min(0)))
    return points, colors, extent


def gt_gaussians(points, colors, *, owner_id: int = 0,
                 device="cuda") -> Gaussians:
    """Ground-truth splats straight from the point cloud (paper Fig. 4a)."""
    return from_points(points, colors, owner_id=owner_id, opacity=0.95,
                       device=device)


def init_partition_gaussians(pd: PartitionData, *,
                             capacity: Optional[int] = None,
                             opacity: float = 0.6,
                             device="cuda") -> Gaussians:
    """Trainable splats for one partition's (owned + ghost) points;
    ``capacity`` reserves free slots for densification (padding slots
    carry the partition's own id so densified children dedupe
    correctly)."""
    dev = check_device(device)
    cap = capacity or len(pd.points)
    g0 = from_points(pd.points, pd.colors, capacity=cap, opacity=opacity,
                     device=dev)
    return g0._replace(owner=torch.cat([
        torch.from_numpy(np.asarray(pd.owner, np.int32)).to(dev),
        torch.full((cap - len(pd.points),), pd.part_id, dtype=torch.int32,
                   device=dev)]))


def coverage_masks(part_cov, *, threshold: float = 1.0 / 255.0,
                   dilation: int = 2):
    """(V, H, W) coverage renders -> (V, H, W) bool training masks
    (thresholded + dilated; paper §II step 4)."""
    return torch.stack([dilate_mask(c > threshold, dilation)
                        for c in part_cov])


def render_views(g: Gaussians, cams: Camera, grid: TileGrid, *, K: int,
                 impl: str = "auto", bg: float = 1.0, batch: int = 8,
                 coarse: Optional[int] = None,
                 coarse_budget: Optional[int] = None,
                 k_tiers: Optional[tuple] = None,
                 tier_caps: Optional[tuple] = None,
                 assign_impl: str = DEFAULT_ASSIGN_IMPL,
                 assign_budget: Optional[int] = None):
    """-> (V, H, W, 3) rgb + (V, H, W) coverage, on the gaussians' device.

    Renders ``batch`` views per ``render_batch`` dispatch.  ``k_tiers``
    enables occupancy-tiered rasterization (K is then ignored): with no
    ``tier_caps`` the caps are sized from an occupancy probe of the FIRST
    chunk (slack 1.25), and a later chunk that outgrows them is rendered
    again with doubled caps, so every image is exact; explicit
    ``tier_caps`` are never altered and a RuntimeWarning reports tiles they
    dropped.  When the sorted assignment is in play and no budget is
    given, ``resolve_assignment`` probes the whole rig's bbox counts
    first.  ``coarse``/``coarse_budget`` turn on the dense sweep's
    superblock pre-cull, in the probe and the renders alike.  (The
    reference's ``schedule=`` knob has no caller there and is not
    ported.)"""
    assign_impl, assign_budget = resolve_assignment(
        g, cams, grid, assign_impl=assign_impl, assign_budget=assign_budget)
    V = cams.view.shape[0]
    batch = max(1, min(batch, V))
    dev = cams.view.device
    auto_caps = k_tiers is not None and tier_caps is None
    if k_tiers is not None:
        k_tiers = tuple(int(k) for k in k_tiers)
        if tier_caps is None:
            first = select(cams, torch.arange(batch, device=dev))
            occ0 = occupancy_probe(g, first, grid, K=k_tiers[-1],
                                   coarse=coarse,
                                   assign_impl=assign_impl,
                                   assign_budget=assign_budget)
            tier_caps = auto_tier_caps(occ0, k_tiers, slack=1.25)
        tier_caps = tuple(int(c) for c in tier_caps)

    def rfn(cc):
        with torch.no_grad():
            return render_batch(g, cc, grid, K=K, impl=impl, bg=bg,
                                coarse=coarse, coarse_budget=coarse_budget,
                                k_tiers=k_tiers, tier_caps=tier_caps,
                                assign_impl=assign_impl,
                                assign_budget=assign_budget)

    rgbs, covs = [], []
    for s in range(0, V, batch):
        cc = select(cams, torch.arange(s, min(s + batch, V), device=dev))
        out = rfn(cc)
        if k_tiers is not None:
            ov = int(out.overflow.sum())
            while ov and auto_caps:
                # this chunk outgrew the first-chunk caps: double and retry
                # (caps clamp at the tile count, where binning cannot drop)
                tier_caps = tuple(min(grid.n_tiles, max(8, 2 * c))
                                  for c in tier_caps)
                out = rfn(cc)
                ov = int(out.overflow.sum())
            if ov:
                warnings.warn(
                    f"render_views: {ov} tile(s) in views [{s}, "
                    f"{s + cc.view.shape[0]}) overflowed the explicit "
                    f"tier_caps={tier_caps} and rendered as background; "
                    "grow the caps (or pass tier_caps=None to auto-size)",
                    RuntimeWarning)
        rgbs.append(out.rgb)
        covs.append(out.coverage)
    return torch.cat(rgbs), torch.cat(covs)


@dataclasses.dataclass
class TimestepData:
    """Everything the distributed driver consumes for one timestep."""
    t: float
    points: np.ndarray
    colors: np.ndarray
    extent: float
    parts: List[PartitionData]
    g0: Gaussians            # fresh batched (P, N) init: the cold-start
    #                          state AND the restore / warm template
    gts: torch.Tensor        # (P, V, H, W, 3) bg = 0 training targets
    masks: Optional[torch.Tensor]   # (P, V, H, W) bool, or None


def _stack(parts):
    """Per-partition Gaussians -> one batched (P, N) Gaussians."""
    return type(parts[0])(*(torch.stack(fs) for fs in zip(*parts)))


def prepare_timestep(ds: GSDataset, cams: Camera, grid: TileGrid, *,
                     t: float = 0.0, seed: int = 0, n_parts: int = 2,
                     capacity: int, K: int = 48, use_ghost: bool = True,
                     use_mask: bool = True, device="cuda",
                     scene=None) -> TimestepData:
    """One timestep's ingest: extraction -> partition (+ ghosts) -> fresh
    equal-capacity (P, N) init -> each partition's bg = 0 GT renders ->
    coverage masks, on ``cams``' device.

    The rig and grid are FIXED across a series (built once from the t = 0
    scene), so every timestep's GT tensors share one shape; ``capacity`` is
    series-constant too (the warm-started state keeps its (P, N) layout),
    and a partition that outgrows it raises a ValueError rather than
    dropping points.  ``scene`` is ``build_scene(ds, seed, t=t)``'s
    (points, colors, extent) when the caller already has it.  The training
    CLI's ``--gs`` prep is this call at t = 0."""
    dev = check_device(device)
    points, colors, extent = scene if scene is not None \
        else build_scene(ds, seed, t=t)
    ghost_w = ds.ghost_frac * extent if use_ghost else 0.0
    parts, _ = partition_points(points, colors, n_parts, ghost_width=ghost_w)
    over = [(pd.part_id, len(pd.points)) for pd in parts
            if len(pd.points) > capacity]
    if over:
        raise ValueError(
            f"timestep t={t}: partition(s) {over} exceed the series "
            f"capacity {capacity} — raise the dataset capacity_factor (the "
            "(P, N) layout is fixed across the series by the warm-started "
            "state)")
    g0 = _stack([init_partition_gaussians(pd, capacity=capacity, device=dev)
                 for pd in parts])
    gts, masks = [], []
    for pd in parts:
        part_gt, part_cov = render_views(
            gt_gaussians(pd.points, pd.colors, device=dev), cams, grid, K=K,
            bg=0.0)
        gts.append(part_gt)
        if use_mask:
            masks.append(coverage_masks(part_cov))
        del part_cov
    return TimestepData(
        t=t, points=points, colors=colors, extent=extent, parts=parts,
        g0=g0, gts=torch.stack(gts),
        masks=torch.stack(masks) if use_mask else None)


class TimestepPrefetcher:
    """One-slot background ingest: ``submit`` schedules a call (a
    ``prepare_timestep``) on a single worker thread, ``get`` blocks for and
    clears the result and re-raises the worker's exception.  While timestep
    t trains, the worker extracts, partitions and renders t + 1.  One slot
    is deliberate: a second would hold another (P, V, H, W, 3) GT tensor
    for no latency win.

    On a CUDA ``device`` the worker runs on its own stream (the kernels
    launch on the calling thread's current stream); ``get`` makes the
    caller's current stream wait for the worker's work, and records that
    stream on every tensor of the result, so the caching allocator does not
    hand their blocks to the worker's stream while the caller still uses
    them."""

    def __init__(self, device="cuda"):
        self.device = check_device(device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._fut = None

    def _run(self, fn, args, kwargs):
        if self._stream is None:
            return fn(*args, **kwargs), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = fn(*args, **kwargs)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def submit(self, fn, /, *args, **kwargs):
        if self._fut is not None:
            raise RuntimeError("prefetch slot already occupied — get() the "
                               "pending timestep first")
        self._fut = self._pool.submit(self._run, fn, args, kwargs)

    def get(self):
        if self._fut is None:
            raise RuntimeError("nothing prefetched — submit() first")
        fut, self._fut = self._fut, None
        out, done = fut.result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            tree = vars(out) if dataclasses.is_dataclass(out) else out
            for x in tree_flatten(tree)[0]:
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(stream)
        return out

    def close(self):
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_pipeline(cfg: PipelineCfg, *, device="cuda") -> PipelineResult:
    """The paper's workflow on one device (``device="cpu"`` runs the plain
    PyTorch versions)."""
    dev = check_device(device)
    ds = get_gs_dataset(cfg.dataset, cfg.tier)
    n_views = cfg.n_views or ds.n_views
    points, colors, extent = build_scene(ds, cfg.seed)
    center = 0.5 * (points.max(0) + points.min(0))
    radius = 1.6 * extent / 2 + 1e-3
    W = H = cfg.resolution
    grid = TileGrid(W, H, cfg.train.tile_h, cfg.train.tile_w)
    cams = orbital_rig(n_views, center, radius, width=W, height=H,
                       device=dev)

    # global ground truth (full point cloud)
    gt_imgs, _ = render_views(gt_gaussians(points, colors, device=dev), cams,
                              grid, K=cfg.K)

    # partition (+ optional ghosts)
    ghost_w = ds.ghost_frac * extent if cfg.use_ghost else 0.0
    parts, _ = partition_points(points, colors, cfg.n_parts,
                                ghost_width=ghost_w)

    trained: List[Gaussians] = []
    times: List[float] = []
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    for pd in parts:
        cap = int(len(pd.points) * ds.capacity_factor) if cfg.densify_every \
            else len(pd.points)
        g0 = init_partition_gaussians(pd, capacity=cap, device=dev)

        # per-partition GT renders of OWN data (+ghosts) and coverage masks
        part_gt, part_cov = render_views(
            gt_gaussians(pd.points, pd.colors, device=dev), cams, grid,
            K=cfg.K)
        masks = coverage_masks(part_cov) if cfg.use_mask else None
        del part_cov

        _sync(dev)
        t0 = time.perf_counter()
        g1, _, _ = fit_partition(
            g0, cams, part_gt, masks, cfg.train, steps=cfg.steps,
            extent=extent, generator=generator,
            densify_every=cfg.densify_every, grid=grid)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        trained.append(g1)
        del part_gt, masks

    merged = merge_mod.merge_partitions(trained, [p.part_id for p in parts])
    renders, _ = render_views(merged, cams, grid, K=cfg.K)

    def mean_metric(fn, masks=None):
        return float(np.mean([
            float(fn(renders[v], gt_imgs[v],
                     None if masks is None else masks[v]))
            for v in range(n_views)]))

    ps = mean_metric(metrics.psnr)
    ss = mean_metric(metrics.ssim)
    gs = mean_metric(metrics.grad_sim)

    # boundary-region metrics (paper Fig. 2): pixels covered by points
    # within a FIXED eval halo of any partition boundary
    eval_gw = ds.ghost_frac * extent
    eparts, _ = partition_points(points, colors, cfg.n_parts,
                                 ghost_width=eval_gw)
    bpts = [p.points[p.n_owned:] for p in eparts if p.n_ghost]
    b_ps, b_ss, b_frac = float("nan"), float("nan"), 0.0
    if bpts:
        bpts = np.concatenate(bpts)
        _, bcov = render_views(
            gt_gaussians(bpts, np.zeros_like(bpts), device=dev), cams, grid,
            K=cfg.K)
        bmasks = bcov > 0.5
        b_frac = float(bmasks.to(torch.float32).mean())
        if bool(bmasks.any()):
            b_ps = mean_metric(metrics.psnr, bmasks)
            b_ss = mean_metric(metrics.ssim, bmasks)

    return PipelineResult(
        merged=merged, parts=trained, psnr=ps, ssim=ss, grad_sim=gs,
        train_seconds=times, n_gaussians=int(merged.active.sum()),
        gt_images=gt_imgs.cpu().numpy(), renders=renders.cpu().numpy(),
        boundary_psnr=b_ps, boundary_ssim=b_ss, boundary_frac=b_frac,
    )

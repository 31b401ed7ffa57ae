"""GS render serving: a batched request-queue server over a merged model.

Port of ``repro.core.serving``.  One server holds ONE merged gaussian set
on one device (built in memory, or restored from the merged checkpoint a
trainer wrote with ``from_checkpoint``) and turns a stream of camera
requests into batched renders:

  submit(cam) -> bounded queue -> flush() coalesces pending requests into
  view-batched dispatches (one CUDA compositor launch each) ->
  per-request RenderResult, in submission order.

Three serving mechanisms ride on the batcher, as in the reference:

  pose-bucket assignment cache
      Each request's pose is snapped to a quantized bucket
      (``tiling.quantize_pose``) and the per-view (T, K) assignment table
      is cached under that bucket key (on the model's device).  A hit
      skips assignment; it renders the canonical bucket pose from the
      cached table through the same program as the cold miss, so it is
      bit-identical to it.  LRU eviction under a static entry budget;
      evictions and inserts dropped by a zero budget are counted.

  LOD ladder
      Impact-pruned compactions of the merged model, built once; requests
      select a rung by camera distance (``select_rung``).

  load shedding
      Under queue pressure (pending >= shed_at) requests are still served
      at a lower rung of the serving K-ladder, from a prefix of the cached
      Kmax table (``tiling.slice_table``); shed requests and over-cap
      rejections are counted.

The reference pads each dispatch to a power of two only to bound its jit
traces; the eager port dispatches the requests as they are, with the same
results, ``RenderResult`` fields and telemetry (less the reference's
``"tiles"`` counter, which nothing increments).

Spans (``runtime.spans``, recorded under a profiler): ``serve.submit`` a
request, ``serve.flush``, ``serve.dispatch`` a batch holding
``serve.tables`` (``serve.assign`` for its misses), ``serve.render`` and
``serve.readback``.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import as_numpy
from repro_torch.core.cameras import Camera, select, stack
from repro_torch.core.dtypes import check_policy
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.render import assign_tables, render_batch_tables
from repro_torch.core.tiling import (DEFAULT_ASSIGN_IMPL, POSE_BINS,
                                     TierSchedule, TileGrid,
                                     grow_tile_budget, quantize_pose,
                                     slice_table)
from repro_torch.runtime import spans
from repro_torch.runtime.checkpoint import (CheckpointManager,
                                            dequantize_cold, unshaped_like)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the bounded queue is at capacity; the
    rejection is counted in telemetry["rejected"] before raising."""


# ---------------------------------------------------------------------------
# LOD ladder: impact-ranked pruning masks + compaction
# ---------------------------------------------------------------------------


def splat_impact(g: Gaussians) -> np.ndarray:
    """(N,) float64 screen-impact score for LOD ranking: opacity x mean
    squared scale.  Inactive rows score -inf.  Host-side numpy, identical
    to the reference."""
    active = as_numpy(g.active)
    alpha = 1.0 / (1.0 + np.exp(-as_numpy(g.opacity_logit).astype(np.float64)))
    area = np.exp(2.0 * as_numpy(g.log_scales).astype(np.float64)).mean(-1)
    return np.where(active, alpha * area, -np.inf)


def lod_keep_mask(g: Gaussians, frac: float,
                  cap: Optional[int] = None) -> np.ndarray:
    """(N,) bool keep mask: the top ``ceil(frac * n_live)`` live splats by
    ``splat_impact`` (optionally capped at ``cap`` rows).  Deterministic:
    stable argsort, ties broken by row index."""
    active = as_numpy(g.active)
    n_live = int(active.sum())
    n_keep = min(n_live, int(np.ceil(float(frac) * n_live)))
    if cap is not None:
        n_keep = min(n_keep, int(cap))
    order = np.argsort(-splat_impact(g), kind="stable")
    keep = np.zeros(active.shape[0], bool)
    keep[order[:n_keep]] = True
    return keep & active


def compact(g: Gaussians, keep: np.ndarray, *,
            round_to: int = 256) -> Gaussians:
    """Boolean compaction of ``keep`` rows into a fresh buffer on the
    model's device whose capacity rounds up to ``round_to`` (pad rows
    zero / inactive).  Row order is preserved."""
    keep_t = torch.as_tensor(np.asarray(keep, bool), device=g.means.device)
    n = int(keep_t.sum())
    cap = max(round_to, -(-n // round_to) * round_to)
    fields = {}
    for name in Gaussians._fields:
        a = getattr(g, name)[keep_t]
        pad = a.new_zeros((cap - n,) + tuple(a.shape[1:]))
        fields[name] = torch.cat([a, pad])            # bool pad -> False
    return Gaussians(**fields)


def build_lod_ladder(g: Gaussians, fracs: Sequence[float], *,
                     cap: Optional[int] = None,
                     round_to: int = 256) -> List[Gaussians]:
    """One compacted model per rung: rung 0 keeps ``fracs[0]`` (normally
    1.0), later rungs keep less; only the LAST rung is capped at ``cap``."""
    rungs = []
    for i, frac in enumerate(fracs):
        rung_cap = cap if i == len(fracs) - 1 else None
        rungs.append(compact(g, lod_keep_mask(g, frac, rung_cap),
                             round_to=round_to))
    return rungs


def camera_eye(view) -> np.ndarray:
    """(4,4) world->camera matrix -> (3,) world-space camera position."""
    v = as_numpy(view).astype(np.float64)
    return -v[:3, :3].T @ v[:3, 3]


def camera_distance(view, center) -> float:
    """Distance from the camera eye to the scene center."""
    return float(np.linalg.norm(camera_eye(view)
                                - np.asarray(center, np.float64)))


def select_rung(distance: float, thresholds: Sequence[float]) -> int:
    """LOD rung for a camera distance: the number of ladder thresholds the
    camera sits beyond (monotone in ``distance``)."""
    rung = 0
    for t in thresholds:
        if distance > float(t):
            rung += 1
    return rung


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeCfg:
    """Static serving configuration (the reference's fields and defaults).
    ``impl`` is the rasterizer impl ("auto": the CUDA kernel on a card, the
    plain version on the CPU)."""
    K: int = 64                       # assignment depth (cached table K)
    k_ladder: Tuple[int, ...] = ()    # serving K ladder; () = auto from K
    impl: str = "auto"
    bg: float = 1.0
    max_batch: int = 8                # views per coalesced dispatch
    queue_cap: int = 64               # bounded queue capacity
    shed_at: Optional[int] = None     # pending depth that starts shedding
                                      # (default: queue_cap // 2)
    shed_rung: int = 0                # ladder rung served under pressure
    cache_entries: int = 64           # pose-bucket cache LRU budget
    pose_bins: float = POSE_BINS      # quantization (buckets per unit)
    lod_fracs: Tuple[float, ...] = (1.0, 0.4)   # keep-fraction per rung
    lod_cap: Optional[int] = None     # cap on the coarsest rung's rows
    lod_dists: Tuple[float, ...] = ()  # rung thresholds; () = auto
    lod_round_to: int = 256
    assign_impl: str = DEFAULT_ASSIGN_IMPL
    assign_budget: Optional[int] = None
    dtype_policy: str = "f32"         # "bf16" stores the kernel feature
                                      # tables in bf16; compositing is f32

    def __post_init__(self):
        check_policy(self.dtype_policy)

    def resolved_ladder(self) -> Tuple[int, ...]:
        """Serving K ladder, ascending, topped by ``K``."""
        if self.k_ladder:
            ks = tuple(int(k) for k in self.k_ladder)
            if ks != tuple(sorted(ks)) or ks[-1] != self.K:
                raise ValueError(f"k_ladder must ascend to K={self.K}: {ks}")
            return ks
        return tuple(sorted({max(1, self.K // 8), max(1, self.K // 2),
                             self.K}))


@dataclasses.dataclass
class RenderResult:
    """One served request: images (host numpy) + the serving decisions that
    shaped them."""
    request_id: int
    rgb: np.ndarray          # (H, W, 3)
    coverage: np.ndarray     # (H, W)
    rung: int                # LOD rung served
    K: int                   # per-tile depth rendered (< ladder top == shed)
    cache_hit: bool
    shed: bool


@dataclasses.dataclass
class _Request:
    rid: int
    cam: Camera              # canonical (bucket-snapped) single-view camera
    key: tuple               # pose bucket key
    rung: int
    k: int
    shed: bool
    hit: bool


class GSRenderServer:
    """One merged model, served on the device its tensors live on.
    Synchronous core (submit/flush); ``center`` / ``radius`` anchor the LOD
    distance ladder (probed from the live means when omitted)."""

    def __init__(self, g: Gaussians, grid: TileGrid,
                 cfg: Optional[ServeCfg] = None, *, center=None,
                 radius: Optional[float] = None):
        self.cfg = cfg = cfg or ServeCfg()
        self.grid = grid
        self.device = g.means.device
        # TierSchedule owns the serving K ladder: shedding serves
        # schedule.k_tiers[shed_rung], full quality serves schedule.kmax
        self.schedule = TierSchedule(cfg.resolved_ladder())
        if not (0 <= cfg.shed_rung < len(self.schedule.k_tiers)):
            raise ValueError(f"shed_rung {cfg.shed_rung} outside ladder "
                             f"{self.schedule.k_tiers}")

        live = as_numpy(g.active)
        means = as_numpy(g.means).astype(np.float64)[live]
        if center is None:
            center = 0.5 * (means.max(0) + means.min(0)) if len(means) \
                else np.zeros(3)
        self.center = np.asarray(center, np.float64)
        if radius is None:
            radius = float(np.linalg.norm(means - self.center, axis=-1).max()) \
                if len(means) else 1.0
        self.radius = float(radius)

        self.ladder = build_lod_ladder(g, cfg.lod_fracs, cap=cfg.lod_cap,
                                       round_to=cfg.lod_round_to)
        n_thresh = len(cfg.lod_fracs) - 1
        if cfg.lod_dists:
            if len(cfg.lod_dists) != n_thresh:
                raise ValueError(
                    f"lod_dists needs {n_thresh} thresholds for "
                    f"{len(cfg.lod_fracs)} rungs, got {len(cfg.lod_dists)}")
            self.lod_dists = tuple(float(d) for d in cfg.lod_dists)
        else:
            # auto ladder: rung i+1 beyond ~4x the scene radius, doubling
            # per rung — orbit-distance cameras stay on the full model
            self.lod_dists = tuple(self.radius * 4.0 * (2.0 ** i)
                                   for i in range(n_thresh))

        # per-rung assignment impl/budget, re-resolved on assign overflow
        # (grow_tile_budget) so a starved budget is counted AND repaired
        self._assign: List[Tuple[str, Optional[int]]] = [
            (cfg.assign_impl, cfg.assign_budget) for _ in self.ladder]
        self._cache: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" \
            = OrderedDict()
        self._queue: List[_Request] = []
        self._next_rid = 0
        self._telemetry: Dict[str, int] = {
            "requests": 0, "batches": 0, "hits": 0, "misses": 0,
            "evictions": 0, "cache_overflow": 0, "shed": 0, "rejected": 0,
            "assign": 0,
        }

    # -- checkpoint loading -------------------------------------------------

    #: subdirectory of a trainer's checkpoint tree holding the merged-model
    #: checkpoint
    MERGED_SUBDIR = "merged"

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str,
                        cfg: Optional[ServeCfg] = None, *, device="cuda",
                        **overrides):
        """Load the merged checkpoint under ``<ckpt_dir>/merged`` onto
        ``device`` and build a server around it -> ``(server, extra)``.
        The template is shape-free (``checkpoint.unshaped_like``): the
        merged capacity is a training outcome.  int8 cold attributes are
        dequantized with the scales on ``extra["quant"]``.
        ``extra["scene"]`` (center/radius/resolution/tile shape) anchors
        the grid and the LOD ladder; cfg.K defaults to the training K.
        ``overrides`` are ServeCfg field replacements applied over the
        meta-defaulted cfg (mutually exclusive with ``cfg``)."""
        if cfg is not None and overrides:
            raise ValueError("pass cfg= or field overrides, not both")
        mgr = CheckpointManager(os.path.join(ckpt_dir, cls.MERGED_SUBDIR),
                                keep=2)
        g, extra, step = mgr.restore_latest(unshaped_like(Gaussians),
                                            device=device)
        if step is None:
            raise FileNotFoundError(
                f"no merged checkpoint under {ckpt_dir}/{cls.MERGED_SUBDIR} "
                "(a trainer writes it after the merge)")
        g = dequantize_cold(g, extra.get("quant"))
        meta = extra.get("scene", {})
        res = int(meta.get("resolution", 64))
        grid = TileGrid(res, res, int(meta.get("tile_h", 8)),
                        int(meta.get("tile_w", 16)))
        if cfg is None:
            cfg = dataclasses.replace(
                ServeCfg(K=int(meta.get("K", ServeCfg.K))), **overrides)
        center = meta.get("center")
        radius = meta.get("radius")
        server = cls(g, grid, cfg,
                     center=None if center is None else np.asarray(center),
                     radius=None if radius is None else float(radius))
        return server, extra

    # -- request intake -----------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._queue)

    def telemetry(self) -> Dict[str, int]:
        """Copy of the serving counters (0 == nothing dropped or degraded)."""
        return dict(self._telemetry)

    def clear_cache(self):
        """Drop every cached table; telemetry counters are NOT reset."""
        self._cache.clear()

    def cached_table(self, cam: Camera, *, rung: int = 0):
        """The cached (idx, score) table a request for ``cam`` at ``rung``
        would hit, or None (does not touch LRU order or counters)."""
        key, _ = quantize_pose(cam.view, cam.fx, cam.fy,
                               bins=self.cfg.pose_bins)
        return self._cache.get((key, rung))

    def submit(self, cam: Camera) -> int:
        """Enqueue one camera request -> request id.  Raises QueueFullError
        at the queue cap (counted).  Past ``shed_at`` pending requests the
        request is marked shed: still served, at the ladder's ``shed_rung``
        K (counted).  Span ``serve.submit``, identified by the request id."""
        with spans.span("serve.submit") as sp:
            if tuple(cam.view.shape) != (4, 4):
                raise ValueError("submit takes a single-view Camera; use "
                                 "serve() for a batched rig")
            if (cam.width, cam.height) != (self.grid.width, self.grid.height):
                raise ValueError(
                    f"camera {cam.width}x{cam.height} does not match the "
                    f"serving grid {self.grid.width}x{self.grid.height}")
            cfg = self.cfg
            if len(self._queue) >= cfg.queue_cap:
                self._telemetry["rejected"] += 1
                raise QueueFullError(
                    f"request queue at cap {cfg.queue_cap}; rejection counted "
                    "(telemetry['rejected'])")
            shed_at = cfg.shed_at if cfg.shed_at is not None \
                else max(1, cfg.queue_cap // 2)
            shed = len(self._queue) >= shed_at
            key, (cview, cfx, cfy) = quantize_pose(
                cam.view, cam.fx, cam.fy, bins=cfg.pose_bins)
            f32 = dict(dtype=torch.float32, device=self.device)
            canon = Camera(torch.from_numpy(cview).to(self.device),
                           torch.tensor(cfx, **f32), torch.tensor(cfy, **f32),
                           cam.width, cam.height)
            rung = select_rung(camera_distance(cview, self.center),
                               self.lod_dists)
            k = int(self.schedule.k_tiers[cfg.shed_rung]) if shed \
                else int(self.schedule.kmax)
            rid = self._next_rid
            self._next_rid += 1
            self._telemetry["requests"] += 1
            if shed:
                self._telemetry["shed"] += 1
            self._queue.append(_Request(rid=rid, cam=canon, key=key,
                                        rung=rung, k=k, shed=shed,
                                        hit=False))
            sp.tag(rid)
            return rid

    # -- cache --------------------------------------------------------------

    def _cache_get(self, key: tuple, rung: int):
        entry = self._cache.get((key, rung))
        if entry is not None:
            self._cache.move_to_end((key, rung))
            self._telemetry["hits"] += 1
        else:
            self._telemetry["misses"] += 1
        return entry

    def _cache_put(self, key: tuple, rung: int, idx: torch.Tensor,
                   score: torch.Tensor):
        if self.cfg.cache_entries <= 0:
            # zero budget: nothing can be cached — counted, not silent
            self._telemetry["cache_overflow"] += 1
            return
        self._cache[(key, rung)] = (idx, score)
        self._cache.move_to_end((key, rung))
        while len(self._cache) > self.cfg.cache_entries:
            self._cache.popitem(last=False)
            self._telemetry["evictions"] += 1

    # -- batching -----------------------------------------------------------

    def _tables_for(self, reqs: List[_Request], rung: int):
        """Per-request (T, Kmax) tables: cache hits are read back, misses
        are assigned as one batch and populate the cache.  Span
        ``serve.tables``; the misses' assignment, its overflow read back
        included, span ``serve.assign``."""
        with spans.span("serve.tables"):
            tables: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
            misses = []
            for i, r in enumerate(reqs):
                entry = self._cache_get(r.key, rung)
                if entry is None:
                    misses.append(i)
                else:
                    r.hit = True
                    tables[i] = entry
            if misses:
                with spans.span("serve.assign"):
                    impl, budget = self._assign[rung]
                    cams = stack(reqs[i].cam for i in misses)
                    idx, score, ov = assign_tables(
                        self.ladder[rung], cams, self.grid, self.cfg.K,
                        assign_impl=impl, assign_budget=budget)
                    n_ov = int(ov.sum())
                if n_ov:
                    # starved sorted-path budget: count it and grow for future
                    # misses (already-cached tables stay as extracted)
                    self._telemetry["assign"] += n_ov
                    if budget is not None:
                        self._assign[rung] = (
                            impl, grow_tile_budget(budget, self.grid.n_tiles))
                for j, i in enumerate(misses):
                    entry = (idx[j], score[j])
                    tables[i] = entry
                    self._cache_put(reqs[i].key, rung, *entry)
            return [tables[i] for i in range(len(reqs))]

    def _dispatch(self, reqs: List[_Request]) -> List[RenderResult]:
        """Render one (rung, k)-homogeneous group of <= max_batch requests
        as a single view-batched dispatch from assignment tables.  Span
        ``serve.dispatch`` (identified by the request ids), holding
        ``serve.tables``, ``serve.render`` and ``serve.readback`` (the
        images' copies to the host, counter ``readback_bytes``)."""
        with spans.span("serve.dispatch", [r.rid for r in reqs]):
            cfg = self.cfg
            rung, k = reqs[0].rung, reqs[0].k
            tables = self._tables_for(reqs, rung)
            with spans.span("serve.render"):
                idx = torch.stack([t[0] for t in tables])
                score = torch.stack([t[1] for t in tables])
                idx, score = slice_table(idx, score, k)   # shed rungs: prefix
                out = render_batch_tables(
                    self.ladder[rung], stack(r.cam for r in reqs), self.grid,
                    idx, score, impl=cfg.impl, bg=cfg.bg,
                    dtype_policy=cfg.dtype_policy)
            self._telemetry["batches"] += 1
            with spans.span("serve.readback"):
                rgb = out.rgb.cpu().numpy()
                cov = out.coverage.cpu().numpy()
                spans.count("readback_bytes", rgb.nbytes + cov.nbytes)
            return [RenderResult(request_id=r.rid, rgb=rgb[i], coverage=cov[i],
                                 rung=rung, K=k, cache_hit=r.hit, shed=r.shed)
                    for i, r in enumerate(reqs)]

    def flush(self) -> List[RenderResult]:
        """Serve EVERY pending request -> results in submission order.
        Requests group by (rung, k) and each group coalesces into
        view-batched renders of up to ``max_batch`` views.  Span
        ``serve.flush``."""
        with spans.span("serve.flush"):
            reqs, self._queue = self._queue, []
            groups: Dict[Tuple[int, int], List[_Request]] = {}
            for r in reqs:
                groups.setdefault((r.rung, r.k), []).append(r)
            results: List[RenderResult] = []
            for key in sorted(groups):
                rs = groups[key]
                for s in range(0, len(rs), self.cfg.max_batch):
                    results.extend(
                        self._dispatch(rs[s:s + self.cfg.max_batch]))
            return sorted(results, key=lambda r: r.request_id)

    def serve(self, rig: Camera) -> List[RenderResult]:
        """Submit every view of a batched rig and flush, in waves that
        respect the queue bound without tripping the rejection counter,
        -> results in rig order."""
        results = []
        for v in range(rig.view.shape[0]):
            if self.pending >= self.cfg.queue_cap:
                results.extend(self.flush())
            self.submit(select(rig, v))
        results.extend(self.flush())
        return sorted(results, key=lambda r: r.request_id)

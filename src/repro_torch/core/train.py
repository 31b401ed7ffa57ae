"""Per-partition 3D-GS trainer: per-group Adam + densify/clone/split/prune.

Port of ``repro.core.train``.  The gaussian buffer has a fixed capacity with
an ``active`` mask: densify writes children into free slots (at most
``max_new`` per event) and prune clears the mask.  Densification pressure is
the accumulated positional gradient norm.  Every partition of the pipeline
runs one instance of this trainer on its own (owned + ghost) gaussians with
its own masked loss.

The reference is functional (``jax.value_and_grad`` over the trainable
dict); here a step takes the trainable fields as fresh leaf tensors,
differentiates the loss with ``torch.autograd.grad`` -- through the CUDA
``rasterize_bwd`` kernel on the card -- and returns NEW gaussians and
optimizer state, leaving its inputs untouched.

``coarse`` turns on the dense sweep's superblock pre-cull in the step
and the tier probe; it needs ``assign_impl="dense"`` ("auto" resolves to
"sorted" on large grids, which ignores it), and its drops count in the
"assign" counter, which grows only the sorted budget.  The distributed
step ignores ``coarse``, and this trainer ignores the distributed step's
``gather_mode``, ``grad_compress``, ``exchange`` and
``exchange_budget``, as the reference's do; its checkpoints record
``grad_compress`` beside ``dtype_policy``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import as_numpy
from repro_torch.core.cameras import Camera, select
from repro_torch.core.dtypes import check_policy
from repro_torch.core.gaussians import Gaussians, quat_to_rotmat
from repro_torch.core.masking import gs_loss
from repro_torch.core.render import (occupancy_probe, render_batch,
                                     resolve_assignment)
from repro_torch.core.tiling import (DEFAULT_TILE_BUDGET, TierSchedule,
                                     TileGrid, grow_tile_budget)

@dataclasses.dataclass(frozen=True)
class GSTrainCfg:
    """Trainer config: the reference's fields and defaults.

    Rasterization is occupancy-tiered by default: ``k_tiers`` resolves to a
    K ladder (``"auto"`` derives one from ``K``; a tuple pins it; ``None``
    or ``dense_k=`` trains dense at a fixed K).  Tier caps are telemetry,
    owned by a ``core.tiling.TierSchedule`` that ``fit_partition``
    re-probes after every densify/prune; ``tier_slack`` is its headroom.
    """
    # per-group LRs (3D-GS reference); lr_means is scaled by the extent
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_colors: float = 2.5e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15
    lambda_dssim: float = 0.2
    K: int = 64
    tile_h: int = 8
    tile_w: int = 16
    bg: float = 1.0             # white background (paper renders)
    impl: str = "auto"
    view_batch: int = 1         # views per minibatch step (loss = view mean)
    coarse: Optional[int] = None
    assign_impl: str = "auto"
    assign_budget: Optional[int] = None
    k_tiers: Union[str, Tuple[int, ...], None] = "auto"
    dense_k: Optional[int] = None
    tier_slack: float = 1.25
    # densification
    densify_grad_thresh: float = 5e-6
    percent_dense: float = 0.01     # split/clone size boundary (x extent)
    max_new: int = 512              # per densify event (static budget)
    densify_cap: Optional[int] = None   # ceiling on LIVE splats (growth)
    prune_opacity: float = 0.005
    prune_scale: float = 0.5        # x extent: prune absurdly large splats
    split_shrink: float = 1.6
    # options of the distributed step (core/distributed.py): "f32" |
    # "split" wire tables, the strip prefilter, the sparse-overlap exchange
    # in place of the "part" all-gather (``exchange_budget`` None: probed
    # and grown by fit_partitions; an int pins it), the mixed-precision
    # policy, gradient compression ("none" | "bf16" | "int8" with error
    # feedback)
    gather_mode: str = "f32"
    strip_budget: float = 1.0
    exchange: bool = False
    exchange_budget: Optional[int] = None
    dtype_policy: str = "f32"
    grad_compress: str = "none"

    def __post_init__(self):
        check_policy(self.dtype_policy)
        if self.grad_compress not in ("none", "bf16", "int8"):
            raise ValueError(
                f"unknown grad_compress {self.grad_compress!r}; expected "
                "'none', 'bf16' or 'int8'")

    def resolved_k_tiers(self) -> Optional[Tuple[int, ...]]:
        """The active K ladder, or None for dense rasterization."""
        if self.dense_k is not None or self.k_tiers is None:
            return None
        if self.k_tiers == "auto":
            ladder = []
            for k in (self.K // 8, self.K // 2, self.K):
                k = int(k)
                if k >= 1 and (not ladder or k > ladder[-1]):
                    ladder.append(k)
            return tuple(ladder)
        return tuple(int(k) for k in self.k_tiers)

    @property
    def assign_K(self) -> int:
        """Dense-path assignment depth (``dense_k`` overrides ``K``)."""
        return self.dense_k if self.dense_k is not None else self.K

    def tier_schedule(self) -> Optional[TierSchedule]:
        """A fresh TierSchedule for this cfg, or None when training dense."""
        kt = self.resolved_k_tiers()
        return None if kt is None else TierSchedule(kt, slack=self.tier_slack)


class GSOptState(NamedTuple):
    """Adam moments per trained field (the reference's (m, v) dict layout)
    and the densify statistics."""
    m: dict
    v: dict
    step: torch.Tensor         # () int32
    grad_accum: torch.Tensor   # (N,) accumulated positional grad norms
    grad_count: torch.Tensor   # (N,)


def init_opt(g: Gaussians) -> GSOptState:
    """Fresh optimizer state (float32 moments, zero densify stats)."""
    tr = g.trainable()
    dev = g.means.device

    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in tr.items()}

    acc = tuple(g.means.shape[:-1])
    return GSOptState(zeros(), zeros(),
                      torch.zeros((), dtype=torch.int32, device=dev),
                      torch.zeros(acc, dtype=torch.float32, device=dev),
                      torch.zeros(acc, dtype=torch.float32, device=dev))


def group_lrs(cfg: GSTrainCfg, extent: float) -> dict:
    return {
        "means": cfg.lr_means * extent,
        "log_scales": cfg.lr_scales,
        "quats": cfg.lr_quats,
        "opacity_logit": cfg.lr_opacity,
        "colors": cfg.lr_colors,
    }


def _as_view_batch(cam: Camera, gt, mask):
    """(cam, gt, mask) with a leading view axis V; a single view becomes a
    V = 1 batch."""
    if cam.view.dim() == 2:
        cam = Camera(cam.view[None], cam.fx.reshape(1), cam.fy.reshape(1),
                     cam.width, cam.height)
        gt = gt[None]
        mask = None if mask is None else mask[None]
    return cam, gt, mask


def adam_update(cfg: GSTrainCfg, lrs: dict, tr: dict, grads: dict,
                opt: GSOptState):
    """One per-group Adam step -> (new trainable dict, new m, new v, the
    step count).  The reference's arithmetic (``train.py:305-320``), in
    float32, on new tensors."""
    step_i = opt.step + 1
    t = step_i.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=t.device), t)
    new_tr, new_m, new_v = {}, {}, {}
    for k, p in tr.items():
        gr = grads[k].to(torch.float32)
        m = cfg.b1 * opt.m[k] + (1 - cfg.b1) * gr
        v = cfg.b2 * opt.v[k] + (1 - cfg.b2) * gr * gr
        d = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        new_tr[k] = (p - lrs[k] * d).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_tr, new_m, new_v, step_i


def loss_and_grads(cfg: GSTrainCfg, grid: TileGrid, g: Gaussians,
                   cam: Camera, gt, mask=None, *, k_tiers, tier_caps,
                   assign_impl, assign_budget):
    """The train step's loss (the view mean of ``gs_loss``), its gradient
    w.r.t. each trained field, and the overflow counters -> (loss,
    overflow, grads) -- the counterpart of the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)`` inside its step."""
    tr = {k: p.detach().requires_grad_(True)
          for k, p in g.trainable().items()}
    cam, gt, mask = _as_view_batch(cam, gt, mask)
    with torch.enable_grad():
        out = render_batch(g.with_trainable(tr), cam, grid, K=cfg.assign_K,
                           impl=cfg.impl, bg=cfg.bg, coarse=cfg.coarse,
                           k_tiers=k_tiers,
                           tier_caps=tier_caps, assign_impl=assign_impl,
                           assign_budget=assign_budget,
                           dtype_policy=cfg.dtype_policy)
        losses = torch.stack([
            gs_loss(out.rgb[v], gt[v], None if mask is None else mask[v],
                    lambda_dssim=cfg.lambda_dssim)
            for v in range(out.rgb.shape[0])])
        loss = losses.mean()
        names = list(tr)
        got = torch.autograd.grad(loss, [tr[k] for k in names],
                                  allow_unused=True)
    grads = {k: torch.zeros_like(tr[k]) if gr is None else gr
             for k, gr in zip(names, got)}
    dev = loss.device
    overflow = {
        "tiles": (torch.zeros((), dtype=torch.int32, device=dev)
                  if out.overflow is None
                  else out.overflow.sum().to(torch.int32)),
        "assign": out.assign_overflow.sum().to(torch.int32),
    }
    return loss.detach(), overflow, grads


#: sentinel: "no explicit argument -- resolve from the train cfg"
_FROM_CFG = object()


def _check_resume_policy(extra: dict, cfg: GSTrainCfg):
    """Refuse to resume across a dtype-policy / grad-compress boundary.

    A checkpoint trains forward under the SAME numerics it was written
    with: switching dtype_policy mid-run would fork the loss curve with no
    record, and switching grad_compress changes the step state layout.
    Checkpoints that predate the knobs carry no record and are treated as
    the defaults ("f32"/"none")."""
    saved_pol = extra.get("dtype_policy", "f32")
    if saved_pol != cfg.dtype_policy:
        raise ValueError(
            f"checkpoint was written under dtype_policy={saved_pol!r} but "
            f"this run uses {cfg.dtype_policy!r}; resume must keep the "
            f"policy — rerun with --dtype-policy {saved_pol} or point "
            "--ckpt-dir at a fresh directory")
    saved_gc = extra.get("grad_compress", "none")
    if saved_gc != cfg.grad_compress:
        raise ValueError(
            f"checkpoint was written under grad_compress={saved_gc!r} but "
            f"this run uses {cfg.grad_compress!r}; resume must keep the "
            "mode (the error-feedback state rides the checkpoint) — rerun "
            f"with --grad-compress {saved_gc} or use a fresh --ckpt-dir")


def make_train_step(cfg: GSTrainCfg, grid: TileGrid, extent: float, *,
                    k_tiers=_FROM_CFG, tier_caps: Optional[tuple] = None,
                    return_overflow: bool = False,
                    assign_impl=_FROM_CFG, assign_budget=_FROM_CFG):
    """Minibatch-of-views train step: ``step(g, opt, cam, gt, mask=None) ->
    (g, opt, loss)``, plus an overflow dict with ``return_overflow``.

    cam/gt/mask may carry a leading view axis (loss is the view mean).
    Rasterization is tiered by default (``k_tiers`` unset takes
    ``cfg.resolved_k_tiers()``; ``None`` forces dense; a tuple pins the
    ladder).  ``tier_caps`` None falls back to the always-exact full-grid
    caps.  The overflow dict holds () int32 counters summed over the view
    batch: ``"tiles"`` (dropped tiles past the tier caps, for
    ``TierSchedule.note_overflow``) and ``"assign"`` (bbox slots dropped
    past the sorted path's budget, for ``tiling.grow_tile_budget``).
    ``assign_impl``/``assign_budget`` override the cfg's knobs."""
    lrs = group_lrs(cfg, extent)
    if k_tiers is _FROM_CFG:
        k_tiers = cfg.resolved_k_tiers()
    if assign_impl is _FROM_CFG:
        assign_impl = cfg.assign_impl
    if assign_budget is _FROM_CFG:
        assign_budget = cfg.assign_budget
    if k_tiers is not None:
        k_tiers = tuple(int(k) for k in k_tiers)
        if tier_caps is None:
            tier_caps = (grid.n_tiles,) * len(k_tiers)
        tier_caps = tuple(int(c) for c in tier_caps)

    def step(g: Gaussians, opt: GSOptState, cam: Camera, gt, mask=None):
        loss, overflow, grads = loss_and_grads(
            cfg, grid, g, cam, gt, mask, k_tiers=k_tiers, tier_caps=tier_caps,
            assign_impl=assign_impl, assign_budget=assign_budget)
        with torch.no_grad():
            new_tr, new_m, new_v, step_i = adam_update(
                cfg, lrs, g.trainable(), grads, opt)
            gnorm = torch.linalg.norm(grads["means"].to(torch.float32),
                                      dim=-1)
            new_opt = GSOptState(
                m=new_m, v=new_v, step=step_i,
                grad_accum=opt.grad_accum + gnorm,
                grad_count=opt.grad_count + (gnorm > 0).to(torch.float32))
        out = (g.with_trainable(new_tr), new_opt, loss)
        return out + (overflow,) if return_overflow else out

    return step


# ---------------------------------------------------------------------------
# Densification (fixed-capacity, budgeted)
# ---------------------------------------------------------------------------


def _first_true(mask, size: int):
    """Indices of the first ``size`` True entries of a 1-D mask, padded
    with -1 (``jnp.nonzero(mask, size=size, fill_value=-1)``)."""
    idx = torch.nonzero(mask).flatten()[:size]
    pad = idx.new_full((size - idx.shape[0],), -1)
    return torch.cat([idx, pad])


def densify_and_prune(g: Gaussians, opt: GSOptState, generator,
                      cfg: GSTrainCfg, extent: float, *, eps=None):
    """One densify event.  Up to ``cfg.max_new`` hot sources act; their
    children land in free slots (clone, or split along the source's own
    shape); transparent or huge splats are pruned; the Adam moments of the
    written slots and the densify statistics are reset.
    ``cfg.densify_cap`` bounds the LIVE count.

    ``eps`` (max_new', 3) is the split noise (the reference draws
    ``jax.random.normal(key, (M, 3))``, which torch cannot reproduce; a
    parity test passes that draw in); by default it is drawn from
    ``generator``, a ``torch.Generator`` on the gaussians' device seeded by
    the caller.  Returns new (g, opt); the inputs are not modified."""
    dev = g.means.device
    cap = g.capacity
    M = min(cfg.max_new, cap)
    avg = opt.grad_accum / torch.clamp(opt.grad_count, min=1.0)
    smax = torch.exp(g.log_scales).max(dim=-1).values
    hot = (avg > cfg.densify_grad_thresh) & g.active
    is_split = hot & (smax > cfg.percent_dense * extent)

    src_idx = _first_true(hot, M)
    free_idx = _first_true(~g.active, M)
    ok = (src_idx >= 0) & (free_idx >= 0)
    if cfg.densify_cap is not None:
        headroom = torch.clamp(cfg.densify_cap - g.active.sum(), min=0)
        ok = ok & (torch.arange(M, device=dev) < headroom)
    src = torch.where(ok, src_idx, 0)
    dest = free_idx[ok]

    src_split = is_split[src]
    if eps is None:
        eps = torch.randn((M, 3), generator=generator, device=dev)
    if not isinstance(eps, torch.Tensor):
        eps = torch.from_numpy(np.array(eps, dtype=np.float32))
    eps = eps.to(device=dev, dtype=torch.float32)
    R = quat_to_rotmat(g.quats[src])
    offset = torch.einsum("nij,nj->ni", R, torch.exp(g.log_scales[src]) * eps)
    offset = torch.where(src_split[:, None], offset, 0.0)
    log_shrink = torch.log(torch.tensor(cfg.split_shrink,
                                        dtype=torch.float32, device=dev))
    shrink = torch.where(src_split[:, None], log_shrink, 0.0)

    def put(arr, val):
        arr = arr.clone()
        arr[dest] = val[ok]
        return arr

    new = g._replace(
        means=put(g.means, g.means[src] + offset),
        log_scales=put(g.log_scales, g.log_scales[src] - shrink),
        quats=put(g.quats, g.quats[src]),
        opacity_logit=put(g.opacity_logit, g.opacity_logit[src]),
        colors=put(g.colors, g.colors[src]),
        active=put(g.active, ok),
        owner=put(g.owner, g.owner[src]),
    )
    # split sources shrink in place (one child stays in the source slot,
    # one lands in the free slot)
    both = ok & src_split
    at = src[both]
    means = new.means.clone()
    means[at] = means[at] + (-offset[both])
    log_scales = new.log_scales.clone()
    log_scales[at] = log_scales[at] + (-log_shrink)
    new = new._replace(means=means, log_scales=log_scales)

    # prune: transparent or absurdly large
    alpha = torch.sigmoid(new.opacity_logit)
    keep = (alpha > cfg.prune_opacity) \
        & (torch.exp(new.log_scales).max(dim=-1).values
           < cfg.prune_scale * extent)
    new = new._replace(active=new.active & keep)

    def zero_at(tree):
        out = {}
        for k, x in tree.items():
            x = x.clone()
            x[dest] = 0.0
            out[k] = x
        return out

    opt = GSOptState(m=zero_at(opt.m), v=zero_at(opt.v), step=opt.step,
                     grad_accum=torch.zeros_like(opt.grad_accum),
                     grad_count=torch.zeros_like(opt.grad_count))
    return new, opt


def reset_opacity(g: Gaussians, ceiling: float = 0.01) -> Gaussians:
    """Periodic opacity clamp (reference: counters floaters)."""
    cap_logit = torch.log(torch.tensor(ceiling / (1 - ceiling),
                                       dtype=torch.float32,
                                       device=g.opacity_logit.device))
    return g._replace(opacity_logit=torch.minimum(g.opacity_logit,
                                                  cap_logit))


# ---------------------------------------------------------------------------
# Host-loop trainer
# ---------------------------------------------------------------------------


def fit_partition(g: Gaussians, cams: Camera, gts, masks, cfg: GSTrainCfg,
                  *, steps: int, extent: float, generator=None,
                  densify_every: int = 0, densify_from: int = 100,
                  log_every: int = 0, grid: Optional[TileGrid] = None,
                  view_batch: Optional[int] = None,
                  schedule: Optional[TierSchedule] = None,
                  ckpt=None, ckpt_every: int = 0,
                  partition: Optional[int] = None,
                  densify_cap: Optional[int] = None,
                  densify_noise: Optional[Iterable] = None):
    """Train one partition for ``steps`` steps cycling over its camera set.

    gts (V, H, W, 3) and masks (V, H, W) bool (or None) on the gaussians'
    device.  Returns (g, opt, losses).  Each step consumes ``view_batch``
    consecutive views (default ``cfg.view_batch``).

    Tier-schedule lifecycle (tiered by default): a ``TierSchedule``
    (``schedule=`` or a fresh one from the cfg) is probed on the first
    minibatch's occupancy unless it already has caps; each step trains at
    its (k_tiers, tier_caps); a step that drops tiles grows the caps
    (``note_overflow``) and a step whose sorted assignment overflowed its
    budget grows the budget (``grow_tile_budget``), so no truncation
    persists silently; each densify/prune re-resolves the assignment
    budget and re-probes the tiers.

    ``generator`` (a ``torch.Generator`` on the gaussians' device, default
    seeded 0) draws the split noise; ``densify_noise`` instead supplies it,
    one (max_new', 3) array per densify event of the WHOLE run, in order (a
    parity test passes the reference's draws).

    Checkpoint/resume: with ``ckpt`` (a ``runtime.CheckpointManager``) the
    newest complete checkpoint is restored -- (g, opt) plus the
    TierSchedule state stored alongside them, so the resumed run keeps its
    probed caps and makes no initial probe -- the split noise of the
    densify events before that step is skipped (one draw of the generator
    per event, or one entry of ``densify_noise``), and training continues
    from that step; ``ckpt_every`` saves periodically (under
    ``partition_<k>/`` when ``partition`` is given).  ``losses`` covers
    only the steps this call ran."""
    dev = g.means.device
    if grid is None:
        grid = TileGrid(cams.width, cams.height, cfg.tile_h, cfg.tile_w)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    noise = None if densify_noise is None else iter(densify_noise)
    sched = schedule if schedule is not None else cfg.tier_schedule()
    dcfg = dataclasses.replace(cfg, densify_cap=densify_cap) \
        if densify_cap is not None else cfg
    opt = init_opt(g)
    n_views = gts.shape[0]
    vb = max(1, min(view_batch or cfg.view_batch, n_views))

    def densify_at(i):
        return densify_every and i >= densify_from \
            and (i + 1) % densify_every == 0

    start = 0
    if ckpt is not None:
        (g, opt), extra, latest = ckpt.restore_latest(
            (g, opt), partition=partition, device=dev)
        if latest is not None:
            _check_resume_policy(extra, cfg)
            if sched is not None and extra.get("schedule"):
                sched.load_state(extra["schedule"])
            start = latest
    # skip the split noise of the densify events before ``start``, so a
    # resumed run splits with the same noise as an uninterrupted one
    n_split = min(cfg.max_new, g.capacity)
    for i in range(start):
        if densify_at(i):
            if noise is not None:
                next(noise)
            else:
                torch.randn((n_split, 3), generator=generator, device=dev)
    probe_vi = torch.arange(min(n_views, max(vb, 2)), device=dev) % n_views
    assign = {"impl": cfg.assign_impl, "budget": cfg.assign_budget}

    def probe_assign(gg):
        # radii are trained parameters: re-size the sorted budget
        impl, budget = resolve_assignment(gg, cams, grid,
                                          assign_impl=cfg.assign_impl,
                                          assign_budget=cfg.assign_budget)
        assign.update(impl=impl, budget=budget)

    def reprobe(gg):
        sched.probe(occupancy_probe(gg, select(cams, probe_vi), grid,
                                    K=sched.kmax, coarse=cfg.coarse,
                                    assign_impl=assign["impl"],
                                    assign_budget=assign["budget"]))

    step_cache = {}

    def get_step():
        spec = ((sched.k_tiers, sched.tier_caps) if sched else None,
                assign["impl"], assign["budget"])
        if spec not in step_cache:
            step_cache[spec] = make_train_step(
                cfg, grid, extent,
                k_tiers=sched.k_tiers if sched else None,
                tier_caps=sched.tier_caps if sched else None,
                return_overflow=True,
                assign_impl=assign["impl"], assign_budget=assign["budget"])
        return step_cache[spec]

    def note_assign_overflow(ov):
        if assign["impl"] != "sorted" or int(np.asarray(as_numpy(ov)).sum()) \
                <= 0:
            return
        cur = assign["budget"] or DEFAULT_TILE_BUDGET
        assign["budget"] = grow_tile_budget(cur, grid.n_tiles)

    probe_assign(g)
    if sched is not None and sched.tier_caps is None:
        reprobe(g)
    losses = []
    for i in range(start, steps):
        vi = (i * vb + torch.arange(vb, device=dev)) % n_views
        mask = None if masks is None else masks[vi]
        g, opt, loss, overflow = get_step()(g, opt, select(cams, vi),
                                            gts[vi], mask)
        losses.append(float(loss))
        if sched is not None:
            # dropped tiles rendered as background in this step's loss; the
            # caps grow for the next steps
            sched.note_overflow(overflow["tiles"], grid.n_tiles)
        note_assign_overflow(overflow["assign"])
        if densify_at(i):
            eps = None if noise is None else next(noise)
            g, opt = densify_and_prune(g, opt, generator, dcfg, extent,
                                       eps=eps)
            probe_assign(g)
            if sched is not None:
                reprobe(g)
        if ckpt is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, (g, opt), partition=partition,
                      extra={"schedule":
                             sched.state_dict() if sched else None,
                             "dtype_policy": cfg.dtype_policy,
                             "grad_compress": cfg.grad_compress})
        if log_every and (i + 1) % log_every == 0:
            print(f"  step {i+1:5d}  loss {losses[-1]:.4f} "
                  f"active {int(g.active.sum())}")
    return g, opt, losses

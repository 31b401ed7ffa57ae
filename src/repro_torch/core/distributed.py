"""Distributed 3D-GS trainer over torch.distributed: the paper's
"train every partition in parallel" on a ("pod", "part", "model", "view")
rank mesh (any subset holding "part", or its legacy alias "data").

Port of ``repro.core.distributed``.  The reference is
one ``shard_map`` SPMD program; here every rank runs the same eager code
on its shard and the collectives are explicit:

  pod    one spatial partition (or several) per pod: the leading P of the
         (P, N) state is split over "pod" and the pods train
         independently; the only cross-pod traffic is the scalar loss
         partials' psum and the overflow counters.
  part   gaussian-parallel: the (P, N) state is split over "part" along N.
         Each rank projects its own rows, builds the per-splat wire tables
         (features + aux, or under ``gather_mode="split"`` an f32
         geometry table + a bf16 kernel table), casts them to the dtype
         policy's storage dtype and all-gathers them over "part"
         (Grendel's handoff: raw gaussians and optimizer state never
         move).
  model  pixel-parallel: each rank assigns, rasterizes and takes the loss
         of its own strip of T / n_model tiles of every partition it
         holds (``strip_budget < 1`` first compacts the gathered table to
         the splats whose y-span touches the strip).  The gaussians are
         replicated along it.
  view   view-parallel: the view minibatch is split over "view"; each rank
         projects, gathers and rasterizes only its V / n_view views.  The
         loss is one scalar pmean over "view"; the gaussians are replicated
         along it.

The collectives are ``torch.autograd.Function``s whose backward is what
JAX's shard_map transpose does (``_AllGather``: all-gather / reduce-
scatter; ``_Psum``: psum / psum, and pmean = psum / n); the step
seeds the replicated loss's cotangent with 1 / world (the transpose of a
replicated output) and sums the gaussians' gradients over ("model",
"view") (the transpose of an input replicated along them).  Every
host-side decision (assignment budget, tier caps, overflow growth,
densify) is made from all-reduced numbers, so every rank builds the same
static shapes.  With ``grad_compress`` the summed gradients go through
``optim.compress`` before Adam; the int8 scale of each tensor is a MAX
all-reduce over ("pod", "part"), the ranks holding its distinct blocks.

The sparse-overlap exchange (``exchange=True``) replaces the "part"
all-gather: each "part" rank renders only its sub-window of ceil(Tl /
n_part) tiles of its strip, and receives only the rows whose tile bboxes
overlap it.  A scalar budget (rows a (source, destination) edge carries)
moves one uniform ``dist.all_to_all_single`` (``_AllToAll``); an (n, n)
budget matrix moves a ragged ladder of ring shifts
(``dist.batch_isend_irecv``, ``_Shift``), each shift's slab sized by its
worst edge.  The received rows are packed source-major, ascending within
a source: an order-preserving subsequence of the all-gather table, so the
(score, index) top-K picks the same splats.  ``ExchangeSchedule`` sizes
the budget from a probe (``probe_gs_exchange``) and grows it from the
step's overflow counters; ``rebalance_partitions`` deals live rows evenly
over the "part" shards.

Under a profiler (``runtime.spans``) a step records ``train.step`` with
``train.batch``, ``train.forward`` (``project``, ``train.gather``),
``train.backward``, ``train.adam``, ``train.readback`` and
``train.schedule``, and every collective its ``wire_bytes``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import as_numpy
from repro_torch.core.cameras import Camera, select
from repro_torch.core.dtypes import cast_tables, check_policy, to_f32
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.metrics import tile_ssim_map
from repro_torch.core.projection import Splats2D, project
from repro_torch.core.render import max_tile_count
from repro_torch.core.tiling import (DEFAULT_ASSIGN_IMPL, DEFAULT_TILE_BUDGET,
                                     FEAT_DIM, NEG, SORTED_MIN_TILES,
                                     TierSchedule, TileGrid,
                                     auto_tile_budget, bin_tiles_by_occupancy,
                                     grow_tile_budget, resolve_assign_impl,
                                     sorted_assign_window, splat_features,
                                     tile_bounds, tile_image, tile_occupancy,
                                     tile_tiers, topk_by_score_then_index,
                                     window_overlap_mask)
from repro_torch.core.train import (GSOptState, GSTrainCfg,
                                    _check_resume_policy, adam_update,
                                    densify_and_prune, group_lrs, init_opt)
from repro_torch.kernels.ops import rasterize_tiles, rasterize_tiles_tiered
from repro_torch.optim.compress import compress_grads
from repro_torch.runtime import spans
from repro_torch.runtime.checkpoint import (tree_flatten, tree_map,
                                            unshaped_like)

#: the forward's table layouts
GATHER_MODES = ("f32", "split")


class MeshAxes(NamedTuple):
    """Resolved mesh-axis names; None = axis absent from this mesh."""
    pod: Optional[str]
    data: str            # gaussian axis: "part" (canonical) or "data" alias
    model: Optional[str]
    view: Optional[str]


def _axes(mesh) -> MeshAxes:
    """Map a mesh's axis names onto the four roles: "part" (or the legacy
    "data") is mandatory; "pod", "model" and "view" are optional.  Any
    other axis name is an error."""
    names = mesh.axis_names
    data = "part" if "part" in names else ("data" if "data" in names else None)
    if data is None:
        raise ValueError(
            "mesh must carry a gaussian axis named 'part' (or legacy "
            f"'data'); got axes {names}")
    ax = MeshAxes(pod="pod" if "pod" in names else None, data=data,
                  model="model" if "model" in names else None,
                  view="view" if "view" in names else None)
    extra = [n for n in names if n not in ax]
    if extra:
        raise ValueError(f"unknown mesh axes {extra}; expected a subset of "
                         "('pod', 'part'|'data', 'model', 'view')")
    return ax


def _tile_axes(ax: MeshAxes) -> tuple:
    """The present axes the flat (P*T,) tile axis is cut over: (pod,
    model)."""
    return tuple(a for a in (ax.pod, ax.model) if a)


def _size(mesh, axis: Optional[str]) -> int:
    return 1 if axis is None else mesh.axis_size(axis)


def _index(mesh, axis: Optional[str]) -> int:
    return 0 if axis is None else mesh.index(axis)


def _check_views(mesh, views: Optional[int]) -> Optional[int]:
    """-> the per-rank view count, or None for an unbatched step."""
    n_view = _size(mesh, _axes(mesh).view)
    if views is None:
        if n_view > 1:
            raise ValueError(
                f"mesh has a 'view' axis of size {n_view} but views=None; "
                f"pass views=V (a multiple of {n_view}) to shard the view "
                "minibatch")
        return None
    if views % n_view:
        raise ValueError(f"views={views} must divide by the 'view' axis "
                         f"size {n_view}")
    return views // n_view


# ---------------------------------------------------------------------------
# Layout: a global (P, N) state and a (V, P*T) batch -> this rank's shard
# ---------------------------------------------------------------------------


def _rows(mesh, axis: Optional[str], n: int, what: str) -> slice:
    """This rank's contiguous 1 / size share of ``n`` items over ``axis``."""
    k = _size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} {what} do not divide over the {k} "
                         f"'{axis}' shards")
    nl = n // k
    i = _index(mesh, axis)
    return slice(i * nl, (i + 1) * nl)


def _strip(mesh, n_tiles: int):
    """This rank's "model" strip of an ``n_tiles`` grid -> (t0, Tl): the
    flat offset of its first tile (None: the strip is the whole grid) and
    its tile count."""
    model = _axes(mesh).model
    n_model = _size(mesh, model)
    if n_tiles % n_model:
        raise ValueError(f"{n_tiles} tiles do not divide over the {n_model} "
                         "'model' strips")
    Tl = n_tiles // n_model
    return (None if n_model == 1 else _index(mesh, model) * Tl), Tl


def gs_shard_state(tree, mesh):
    """Cut a global (P, N) state tree (``Gaussians``, ``GSOptState`` or a
    tuple of them) into this rank's block: every leaf of rank >= 2 is split
    along P over "pod" and along N over "part" (replicated along "model"
    and "view"); scalars (the Adam step) are replicated.  The counterpart
    of ``gs_shardings`` / ``gs_state_specs``."""
    ax = _axes(mesh)

    def cut(x):
        if not isinstance(x, torch.Tensor) or x.dim() < 2:
            return x
        return x[_rows(mesh, ax.pod, x.shape[0], "partitions"),
                 _rows(mesh, ax.data, x.shape[1], "gaussian slots")
                 ].contiguous()
    return tree_map(cut, tree)


def _cut_tiles(x, mesh, n_parts: Optional[int], lead: int):
    """(.., P*T, ...) flat tiles -> this rank's (.., Pl*Tl, ...): the
    "model" strip of each of its "pod" partitions, partition-major (the
    order the step renders them in).  The reference cuts the flat axis in
    one contiguous chunk per device instead, which is the same block only
    when each pod holds one partition."""
    ax = _axes(mesh)
    if _size(mesh, ax.pod) == 1 and _size(mesh, ax.model) == 1:
        return x
    if n_parts is None:
        raise ValueError(f"a mesh with axes {_tile_axes(ax)} cuts the batch "
                         "per partition: pass n_parts=P")
    T = x.shape[lead] // n_parts
    y = x.reshape(tuple(x.shape[:lead]) + (n_parts, T)
                  + tuple(x.shape[lead + 1:]))
    t0, Tl = _strip(mesh, T)
    t0 = t0 or 0
    y = y[(slice(None),) * lead + (_rows(mesh, ax.pod, n_parts, "partitions"),
                                   slice(t0, t0 + Tl))]
    return y.reshape(tuple(x.shape[:lead]) + (-1,)
                     + tuple(x.shape[lead + 1:])).contiguous()


def gs_shard_batch(batch: dict, mesh, views: Optional[int] = None, *,
                   n_parts: Optional[int] = None) -> dict:
    """Cut a global batch -- gt_tiles (V, P*T, 3, th, tw), mask_tiles
    (V, P*T, th, tw) and a cam with (V, 4, 4) views; without the V axis
    for ``views=None`` -- to this rank's V / n_view views and, over "pod"
    and "model", to its partitions' tile strips (``n_parts`` = P, needed
    when either axis has more than one rank).  The counterpart of
    ``gs_batch_specs``."""
    vloc = _check_views(mesh, views)
    out = dict(batch)
    if vloc is not None:
        i = _index(mesh, _axes(mesh).view)
        sl = slice(i * vloc, (i + 1) * vloc)
        cam = batch["cam"]
        out = {"gt_tiles": batch["gt_tiles"][sl],
               "mask_tiles": batch["mask_tiles"][sl],
               "cam": cam._replace(view=cam.view[sl], fx=cam.fx[sl],
                                   fy=cam.fy[sl])}
    lead = 0 if vloc is None else 1
    for k in ("gt_tiles", "mask_tiles"):
        out[k] = _cut_tiles(out[k], mesh, n_parts, lead)
    return out


def gather_partitions(tree, mesh):
    """The inverse of ``gs_shard_state``: all-gather every (Pl, Nl, ...)
    leaf over "part" (N) and "pod" (P) into the global (P, N, ...) tree
    (every rank gets it).  Used for checkpoints, densify and the CLI's
    merge.  Leaves of a bool dtype travel as uint8."""
    ax = _axes(mesh)
    part, pod = mesh.group(ax.data), mesh.group(ax.pod)

    def gather(x):
        if not isinstance(x, torch.Tensor) or x.dim() < 2:
            return x
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        if part is not None:
            y = _all_gather(y, part, 1)
        if pod is not None:
            y = _all_gather(y, pod, 0)
        return y.to(torch.bool) if x.dtype == torch.bool else y
    with torch.no_grad():
        return tree_map(gather, tree)


def fit_slots(tree, like):
    """A global (g, opt[, err]) state tree, ``like``'s structure, fitted to
    ``like``'s N: the CLI rounds its capacity up to a multiple of the
    "part" size, so a checkpoint written on another mesh may hold another
    N'.  The slot axis is axis 1 of every splat field, moment, densify sum
    and residual (the step counter has none); every other axis must be
    ``like``'s, else ValueError (the checkpoint is another run's).  Slots
    past a shorter N' come from ``like`` and must be dead there; slots past
    a longer N' are cut and must be dead (else ValueError) -> the tree."""
    (g, opt, *err), (g_like, opt_like, *err_like) = tree, like
    n_had, n = g.means.shape[1], g_like.means.shape[1]

    def fit(name, x, ref):
        want = (ref.shape[0], n_had) + tuple(ref.shape[2:])
        if tuple(x.shape) != want:
            raise ValueError(
                f"checkpoint leaf {name}: shape {tuple(x.shape)} != expected "
                f"{want} (axis 1, the slots, may differ): it is not this "
                f"run's layout")
        if n <= n_had:
            return x[:, :n]
        return torch.cat([x, ref[:, n_had:].to(x.device, x.dtype)], 1)

    def fit_fields(prefix, t, t_like):
        # a dict of fields (moments, residual) or a NamedTuple (the splats)
        if isinstance(t, dict):
            return {k: fit(prefix + k, x, t_like[k]) for k, x in t.items()}
        return type(t)(*(fit(prefix + k, x, getattr(t_like, k))
                         for k, x in t._asdict().items()))

    if tuple(opt.step.shape) != tuple(opt_like.step.shape):
        raise ValueError(f"checkpoint leaf step: shape {tuple(opt.step.shape)}"
                         f" != expected {tuple(opt_like.step.shape)}")
    out = (fit_fields("", g, g_like), opt._replace(
        m=fit_fields("m.", opt.m, opt_like.m),
        v=fit_fields("v.", opt.v, opt_like.v),
        grad_accum=fit("grad_accum", opt.grad_accum, opt_like.grad_accum),
        grad_count=fit("grad_count", opt.grad_count, opt_like.grad_count)))
    out += tuple(fit_fields("err.", e, e_like)
                 for e, e_like in zip(err, err_like))
    if n < n_had and bool(g.active[:, n:].any()):
        raise ValueError(
            f"the checkpoint holds {n_had} slots a partition, live past "
            f"{n}: it does not fit this run's {n} slots")
    if n > n_had and bool(g_like.active[:, n_had:].any()):
        raise ValueError(
            f"the checkpoint holds {n_had} slots a partition and this run's "
            f"{n}-slot layout is live past them: it is not this run's")
    return out


# ---------------------------------------------------------------------------
# Collectives with shard_map's transposes
# ---------------------------------------------------------------------------


# Each collective counts ``wire_bytes``: the bytes this rank receives in
# it, by the ring algorithms' count (NCCL's bus bytes): an all-gather the
# other ranks' blocks, a reduce-scatter (n - 1) chunks, an all-reduce
# 2 (n - 1) / n of the tensor, an all-to-all (n - 1) / n of it, a shift
# the whole slab.


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _count_wire(nbytes: int):
    if nbytes:                     # a one-rank group moves nothing
        spans.count("wire_bytes", nbytes)


def _all_gather(x, group, dim: int):
    """Plain all-gather of ``x`` over ``group``, concatenated along dim."""
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    _count_wire((n - 1) * _nbytes(x0))
    if dist.get_backend(group) == "nccl":
        out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
        dist.all_gather_into_tensor(out, x0, group=group)
    else:
        parts = [torch.empty_like(x0) for _ in range(n)]
        dist.all_gather(parts, x0, group=group)
        out = torch.cat(parts)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim: int):
    """Sum ``x`` over ``group`` and keep this rank's chunk along dim
    (gloo has no reduce-scatter: an all-reduce, then the slice)."""
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    chunk = x0.shape[0] // n
    if dist.get_backend(group) == "nccl":
        out = x0.new_empty((chunk,) + tuple(x0.shape[1:]))
        _count_wire((n - 1) * _nbytes(out))
        dist.reduce_scatter_tensor(out, x0, op=dist.ReduceOp.SUM,
                                   group=group)
    else:
        r = dist.get_group_rank(group, dist.get_rank())
        out = _all_reduce(x0, dist.ReduceOp.SUM, group)[r * chunk:
                                                        (r + 1) * chunk]
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; backward: the reduce-scatter (sum)
    that lands each rank's rows' gradients back on it."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def _all_reduce(x, op, group=None):
    """A plain all-reduce of a copy of ``x``."""
    n = dist.get_world_size(group)
    _count_wire(2 * (n - 1) * _nbytes(x) // n)
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _Psum(torch.autograd.Function):
    """All-reduce sum; its transpose is again an all-reduce sum (a pmean is
    a psum over the group's size, and so is its transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


def _psum(x, group):
    """Differentiable psum over ``group`` (None: one rank, the identity)."""
    return x if group is None else _Psum.apply(x, group)


def _gather(x, group, dim: int):
    """Differentiable tiled all-gather over ``group`` along ``dim`` (None:
    one rank, the identity)."""
    return x if group is None else _AllGather.apply(x.contiguous(), group,
                                                    dim)


def _all_to_all(x, group):
    """Chunk d of ``x`` (along dim 0, one per rank of ``group``) goes to
    rank d; chunk s of the result came from rank s."""
    x = x.contiguous()
    out = torch.empty_like(x)
    n = dist.get_world_size(group)
    _count_wire((n - 1) * _nbytes(x) // n)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Uniform all-to-all over dim 0; its transpose is the same
    all-to-all of the gradient (chunk s goes back to rank s)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _shift(x, group, k: int):
    """Ring shift by ``k`` over ``group``: send ``x`` to rank (s + k) % n,
    receive the same shape from rank (s - k) % n."""
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    _count_wire(_nbytes(out))
    peer = lambda r: dist.get_global_rank(group, r % n)  # noqa: E731
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer(me + k), group),
        dist.P2POp(dist.irecv, out, peer(me - k), group)])
    for r in reqs:
        r.wait()
    return out


class _Shift(torch.autograd.Function):
    """One rung of the exchange ladder, ``_shift`` by ``k``; its transpose
    sends the gradient back by ``-k``."""

    @staticmethod
    def forward(ctx, x, group, k: int):
        ctx.group, ctx.k = group, k
        return _shift(x, group, k)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.k), None, None


def _world_max(values, device):
    """Element-wise MAX over every rank of a list of ints."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=device)
    return [int(v) for v in _all_reduce(t, dist.ReduceOp.MAX).tolist()]


# ---------------------------------------------------------------------------
# Per-rank pipeline pieces
# ---------------------------------------------------------------------------


def _assign_tiles_local(mean2d, radius, depth, valid, lo, hi, *, K: int,
                        block: int, impl: str = "dense",
                        grid: Optional[TileGrid] = None,
                        t0: Optional[int] = None,
                        tile_budget: Optional[int] = None):
    """Top-K front-most splats for this rank's tile window.

    mean2d (Pl, N, 2), radius/depth/valid (Pl, N); lo/hi (Tl, 2) window
    bounds -> idx (Pl, Tl, K) int32, score (Pl, Tl, K), overflow () int32
    (the sorted path's dropped bbox candidates summed over Pl; 0 on the
    dense sweep).  ``impl`` "auto" resolves on the GLOBAL grid, as the
    single-device dispatcher does; both impls share the two-key (score
    desc, splat index asc) order, so they are bit-identical whenever the
    sorted budget covers the scene.  The sorted path takes the traced
    budget rule (a missing budget is DEFAULT_TILE_BUDGET) and ``t0``, the
    flat offset of the window in the full ``grid`` (None: the window is
    the whole grid)."""
    Pl, N = mean2d.shape[:2]
    dev = mean2d.device
    if grid is not None:
        impl = resolve_assign_impl(impl, grid.n_tiles, tile_budget)
    Tl = lo.shape[0]
    if impl == "sorted":
        outs = [sorted_assign_window(
            mean2d[p, :, 0], mean2d[p, :, 1], radius[p], valid[p], depth[p],
            grid, K=K, t0=t0, n_local=Tl, tile_budget=tile_budget,
            exact_budget=False) for p in range(Pl)]
        idx, score, ov = zip(*outs)
        return (torch.stack(idx), torch.stack(score),
                torch.stack(ov).sum().to(torch.int32))
    block = min(block, max(N, K))
    top_s = torch.full((Pl, Tl, K), NEG, dtype=torch.float32, device=dev)
    top_i = torch.zeros((Pl, Tl, K), dtype=torch.int32, device=dev)
    for b0 in range(0, N, block):
        m = mean2d[:, b0:b0 + block]                   # (Pl, B, 2)
        r = radius[:, b0:b0 + block]
        B = m.shape[1]
        cx = torch.clamp(m[:, None, :, 0], lo[None, :, :1], hi[None, :, :1])
        cy = torch.clamp(m[:, None, :, 1], lo[None, :, 1:], hi[None, :, 1:])
        dx = m[:, None, :, 0] - cx
        dy = m[:, None, :, 1] - cy
        hit = (dx * dx + dy * dy) <= (r * r)[:, None, :]
        hit = hit & valid[:, None, b0:b0 + block]
        score = torch.where(hit, -depth[:, None, b0:b0 + block], NEG)
        idx = torch.arange(b0, b0 + B, dtype=torch.int32,
                           device=dev).expand(Pl, Tl, B)
        top_s, top_i = topk_by_score_then_index(
            torch.cat([top_s, score], -1), torch.cat([top_i, idx], -1), K)
    return top_i, top_s, torch.zeros((), dtype=torch.int32, device=dev)


def _loss_partials(pred, gt, mask, *, win_size: int = 7):
    """Local partial sums for masked L1 + per-tile D-SSIM.

    pred/gt (Tl', C, th, tw); mask (Tl', th, tw) -> 4 scalars (l1_num,
    l1_den, ssim_num, ssim_den) to be summed across ranks."""
    a = pred.to(torch.float32)
    b = gt.to(torch.float32)
    m = mask.to(torch.float32)
    mc = m[:, None]
    l1n = ((a - b).abs() * mc).sum()
    l1d = mc.sum() * a.shape[1]
    sm = tile_ssim_map(a, b, win_size=win_size)          # (Tl', th, tw, C)
    sn = (sm * m[..., None]).sum()
    sd = m.sum() * sm.shape[-1]
    return torch.stack([l1n, l1d, sn, sd])


def _project_rows(g: Gaussians, cam: Camera, views: bool) -> Splats2D:
    """Project a (Pl, Nl) shard -> (Vl, Pl, Nl, ...) splats with a view
    batch, (Pl, Nl, ...) without: one ``project`` of the Pl * Nl rows."""
    rows = tuple(g.means.shape[:2])
    flat = project(Gaussians(*(f.reshape((-1,) + tuple(f.shape[2:]))
                               for f in g)), cam)
    lead = 1 if views else 0
    return Splats2D(*(f.reshape(tuple(f.shape[:lead]) + rows
                                + tuple(f.shape[lead + 1:])) for f in flat))


def _check_forward_opts(gather_mode, dtype_policy):
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"unknown gather_mode {gather_mode!r}; expected "
                         f"one of {GATHER_MODES}")
    check_policy(dtype_policy)


def wire_tables(splats: Splats2D, gather_mode: str):
    """This rank's per-splat tables, the rows the "part" all-gather moves
    (before the policy cast).  "f32": the 16-column ``splat_features`` and
    a detached (radius, depth, valid) aux.  "split": ``geo`` (mx, my,
    valid-masked radius, depth), 4 float32 columns, and ``rest`` (the conic
    c/det, -b/det, a/det with det clamped at 1e-12, rgb, valid-masked
    alpha, 0), 8 bfloat16 columns under every policy -- 16 + 16 = 32 bytes
    of wire a splat (24 under the bf16 policy) against the f32 pair's 64 +
    12 = 76 (38)."""
    if gather_mode != "split":
        aux = torch.stack([splats.radius, splats.depth,
                           splats.valid.to(torch.float32)], -1).detach()
        return splat_features(splats), aux
    geo = torch.stack([splats.mean2d[..., 0], splats.mean2d[..., 1],
                       torch.where(splats.valid, splats.radius, 0.0),
                       splats.depth], -1)
    a, b, c = splats.cov2d[..., 0], splats.cov2d[..., 1], splats.cov2d[..., 2]
    det = torch.clamp(a * c - b * b, min=1e-12)
    alpha = torch.where(splats.valid, splats.alpha, 0.0)
    rest = torch.stack([c / det, -b / det, a / det, splats.rgb[..., 0],
                        splats.rgb[..., 1], splats.rgb[..., 2], alpha,
                        torch.zeros_like(alpha)], -1).to(torch.bfloat16)
    return geo, rest


def wire_bytes_per_splat(tables) -> int:
    """Bytes a splat moves over "part": the tables' widths times their
    element sizes."""
    return sum(t.shape[-1] * t.element_size() for t in tables)


def strip_rows(n_rows: int, strip_budget: float) -> int:
    """Rows of the strip prefilter's compacted table: ``n_rows *
    strip_budget`` truncated, then rounded up to a multiple of 128."""
    return -(-int(n_rows * strip_budget) // 128) * 128


def _first_rows(mask, n_keep: int):
    """mask (R, N) bool -> (R, n_keep) int64: the rows where it holds, in
    their original order, filled with N past the last one (and cut at
    n_keep)."""
    R, N = mask.shape
    pos = torch.cumsum(mask, dim=1) - 1
    slot = torch.where(mask & (pos < n_keep), pos, n_keep)
    cand = torch.full((R, n_keep + 1), N, dtype=torch.int64,
                      device=mask.device)
    cand.scatter_(1, slot, torch.arange(N, device=mask.device).expand(R, N))
    return cand[:, :n_keep]


def _strip_candidates(my, radius, valid, ylo, yhi, n_keep: int):
    """The strip prefilter's row choice: my/radius/valid (R, N) -> (R,
    n_keep) int64 rows of the splats whose circle's y-span touches [ylo,
    yhi], in their original order, filled with N past the last one (and
    cut at n_keep: the budget must cover the strip's splats)."""
    return _first_rows(valid & (my + radius >= ylo) & (my - radius <= yhi),
                       n_keep)


def _take_rows(x, cand):
    """x (R, N, C) -> (R, M, C) rows ``cand`` (R, M), rows == N filled with
    0.  Differentiable: the gradient scatters back to the rows taken, and
    the fill rows' gradient lands on a pad row that is dropped."""
    pad = torch.cat([x, x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))], 1)
    return torch.gather(pad, 1, cand[..., None].expand(
        tuple(cand.shape) + tuple(x.shape[2:])))


def _sub_window(grid: TileGrid, n_model: int, n_part: int):
    """The exchange's split of a "model" strip over "part" -> (Tl, sub,
    pad): the strip's tile count, each part rank's ceil(Tl / n_part)-tile
    sub-window, and the pad tiles past the strip's end."""
    Tl = grid.n_tiles // n_model
    sub = -(-Tl // n_part)
    return Tl, sub, sub * n_part - Tl


def _window_rects(grid: TileGrid, dev, t0_strip: int, Tl: int, band: int,
                  sub: int):
    """lo / hi (sub, 2) of sub-window ``band`` of the strip at flat offset
    ``t0_strip``: the rects of its real tiles, then degenerate ones (lo
    1e9, hi -1e9) that no circle hits for the pad tiles past the strip."""
    lo_f, hi_f = tile_bounds(grid, dev)
    a = t0_strip + band * sub
    real = max(0, min(sub, Tl - band * sub))
    lo = torch.full((sub, 2), 1e9, dtype=lo_f.dtype, device=dev)
    hi = torch.full((sub, 2), -1e9, dtype=hi_f.dtype, device=dev)
    lo[:real], hi[:real] = lo_f[a:a + real], hi_f[a:a + real]
    return lo, hi


def _exchange_hits(geom_l, grid: TileGrid, t0_strip: int, Tl: int, sub: int,
                   n: int):
    """(mx, my, radius, valid) (R, Nl) of this rank's rows -> bool (n, R,
    Nl): slab d holds the rows whose bboxes can touch sub-window d of the
    strip (the pad tiles past its end count nothing)."""
    mx, my, rad, val = geom_l
    return window_overlap_mask(
        mx, my, rad, val, grid,
        t0=[t0_strip + d * sub for d in range(n)], n_local=sub,
        t_end=t0_strip + Tl if sub * n > Tl else None)


def _pack_exchange(hit, group, me: int, budget, tau):
    """The exchange's packing of this rank's overlap ``hit`` (n, R, Nl) ->
    (move, overflow, edges, demand).  ``move(x)`` maps a local (R, Nl, C)
    table to the received (R, M, C) one: the first rows of each (source,
    row) hit, ascending, packed source-major (fill rows are index Nl:
    zeros, dead to assignment and compositing).  ``overflow`` () counts
    the hits past their edge's budget.

    ``budget`` an int E: every edge carries E rows, one uniform
    ``_AllToAll`` (destination d renders band d).  Or the (n, n) matrix Bm
    (source, band), clipped at Nl, with ``tau[i]`` the band part rank i
    renders: a ladder of ring shifts, shift k carrying every (s -> (s + k)
    % n) edge in a slab of ``max_s Bm[s, tau[(s + k) % n]]`` rows, each
    source masking its slab past its own edge budget; then ``edges`` (n,)
    is this rank's overflow per band and ``demand`` (n,) its largest hit
    count per band (else both None)."""
    n, R, Nl = hit.shape
    counts = hit.sum(-1)                                       # (n, R)
    tail = lambda x: tuple(x.shape[2:])  # noqa: E731
    if np.ndim(budget) == 0:
        E = int(budget)
        cand = _first_rows(hit.reshape(n * R, Nl), E).reshape(
            n, R, E).transpose(0, 1).reshape(R, n * E)

        def move(x):
            sent = _take_rows(x, cand).reshape((R, n, E) + tail(x))
            sent = sent.transpose(0, 1)
            got = sent if group is None else _AllToAll.apply(sent, group)
            # axis 0 is now the source: flatten it source-major
            return got.transpose(0, 1).reshape((R, n * E) + tail(x))
        return move, torch.clamp(counts - E, min=0).sum(), None, None
    ring = (np.arange(n) + np.arange(n)[:, None]) % n    # ring[k, s]
    band = np.asarray(tau)[ring]               # band[k, s]: shift k's band
    e_shift = [int(budget[np.arange(n), band[k]].max()) for k in range(n)]
    b_row = torch.as_tensor(budget[me], device=hit.device)
    edges = torch.clamp(counts - b_row[:, None], min=0).sum(1)
    cands = []
    for k in range(n):
        c = _first_rows(hit[int(band[k, me])], e_shift[k])
        c[:, int(budget[me, band[k, me]]):] = Nl
        cands.append(c)

    def move(x):
        got = [_take_rows(x, c) for c in cands]
        got = [got[0]] + [_Shift.apply(got[k], group, k)
                          for k in range(1, n)]
        # shift k delivered source (me - k) % n: pack source-major
        return torch.cat([got[(me - s) % n] for s in range(n)], 1)
    return move, edges.sum(), edges, counts.amax(1)


def make_gs_forward(mesh, grid: TileGrid, *, K: int, impl: str = "auto",
                    lambda_dssim: float = 0.2,
                    assign_block: Optional[int] = None,
                    return_tiles: bool = False, gather_mode: str = "f32",
                    strip_budget: float = 1.0, views: Optional[int] = None,
                    k_tiers: Optional[tuple] = None,
                    tier_caps: Optional[tuple] = None,
                    return_overflow: bool = False, win_size: int = 7,
                    assign_impl: str = DEFAULT_ASSIGN_IMPL,
                    assign_budget: Optional[int] = None,
                    exchange: bool = False, exchange_budget=None,
                    dtype_policy: str = "f32"):
    """The distributed forward of one rank: ``fwd(g, cam, gt, mask) ->
    loss`` (plus the rank's tiles with ``return_tiles`` and the overflow
    dict with ``return_overflow``), differentiable w.r.t. the rank's
    gaussian rows.

    g is this rank's (Pl, Nl) shard; cam / gt (Pl*Tl, 3, th, tw) / mask
    (Pl*Tl, th, tw) its part of the batch -- with ``views=V`` they carry a
    leading V / n_view axis (``gs_shard_batch``).  Steps, as the
    reference's all-gather path: project locally, build the wire tables
    (``wire_tables``: ``splat_features`` + (radius, depth, valid), or the
    split mode's f32 ``geo`` + bf16 ``rest``), cast them to
    ``dtype_policy``'s storage dtype (``cast_tables``: bf16 halves the
    all-gather and its reduce-scatter transpose), all-gather them over
    "part", fold the local views into the partition axis, promote the
    assignment geometry (mean, radius, depth, valid) to float32, assign the
    top-K per tile of this rank's "model" strip (``strip_budget < 1``:
    first keep the ``strip_rows(N, strip_budget)`` first splats whose
    y-span touches the strip, in their order, so the (score, index)
    tie-break is unchanged), rasterize (one launch at K, or one per
    occupancy tier with ``k_tiers`` at its static ``tier_caps``; None =
    the always-exact full-domain caps; the kernel rows are gathered from
    the tables in their storage dtype and promoted to float32 at
    ``ops.rasterize_tiles``), and reduce the masked L1 + per-tile D-SSIM
    partials: summed over ("pod", "part", "model"), the per-view losses
    averaged over the local views and then over "view".

    ``exchange=True`` swaps the all-gather for the sparse-overlap exchange
    (module docstring): the local views fold into the partition axis
    first, the overlap of each local row with each part rank's sub-window
    comes from the policy-rounded float32 geometry (``_exchange_hits``),
    the rows travel under ``exchange_budget`` (``_pack_exchange``: None =
    Nl, always exact; an int; or an (n_part, n_part) matrix, see
    ``check_budget_matrix``, whose ``window_assignment`` picks the band
    each part rank renders -- the identity under ``return_tiles``), and
    each rank assigns, rasterizes and takes the loss of its own sub-window
    (gt / mask arrive with the whole strip and are sliced here; pad tiles
    are zero-masked).  ``return_tiles`` then gives the unflattened ([Vl,]
    Pl, sub, 4, th, tw) and needs the strip to divide over "part"; the
    strip prefilter is refused.

    The overflow dict holds () int32 counters: ``"tiles"`` (tiered tiles
    dropped past the caps) and ``"assign"`` (sorted-assignment candidates
    dropped past ``assign_budget``), summed over ("pod", "model", "view")
    -- and over "part" under the exchange, whose sub-windows are distinct
    -- and ``"exchange"`` (rows dropped past the exchange budget; 0 on the
    gather path), summed over every axis.  A matrix budget adds the (n, n)
    int32 ``"exchange_edges"`` (the drops per (source, band), summed over
    every axis) and ``"exchange_demand"`` (the in-step probe: each
    source's largest hit count per band, MAX over ("pod", "model",
    "view"))."""
    _check_forward_opts(gather_mode, dtype_policy)
    ax = _axes(mesh)
    vloc = _check_views(mesh, views)
    part_group = mesh.group(ax.data)
    loss_group = mesh.group(ax.pod, ax.data, ax.model)
    view_group = mesh.group(ax.view)
    all_group = mesh.group(ax.pod, ax.data, ax.model, ax.view)
    # under the gather every "part" rank holds a redundant copy of its
    # window: the counters sum over the other axes only
    rest_group = mesh.group(ax.pod, ax.model, ax.view)
    count_group = all_group if exchange else rest_group
    n_view = _size(mesh, ax.view)
    n_part = _size(mesh, ax.data)
    t0, Tl = _strip(mesh, grid.n_tiles)
    t0_strip = t0 or 0
    dev = mesh.device
    me = _index(mesh, ax.data)
    budget_mat = None
    if exchange:
        if strip_budget < 1.0:
            raise ValueError(
                "exchange=True subsumes the strip prefilter; strip_budget "
                f"must stay 1.0 (got {strip_budget})")
        _, sub, pad = _sub_window(grid, _size(mesh, ax.model), n_part)
        if pad and return_tiles:
            raise ValueError(
                f"return_tiles with exchange=True needs the {Tl}-tile "
                f"window to divide by the '{ax.data}' axis (size {n_part}):"
                " padded sub-windows cannot reassemble into the (P, T) "
                "tile layout (the loss-only path pads instead)")
        if exchange_budget is not None and np.ndim(exchange_budget) != 0:
            budget_mat = check_budget_matrix(exchange_budget, n_part)
        Wl = sub
    else:
        lo, hi = tile_bounds(grid, dev)
        if t0 is not None:
            lo, hi = lo[t0:t0 + Tl], hi[t0:t0 + Tl]
        ylo, yhi = lo[:, 1].min(), hi[:, 1].max()
        Wl = Tl

    def window(Nl: int):
        """The exchange's plan at Nl local rows -> (budget, tau, band, t0,
        lo, hi): the edge budget clipped at Nl, the band each part rank
        renders (None for a scalar budget: rank d renders band d), this
        rank's band and its sub-window's flat offset and rects."""
        if budget_mat is None:
            budget = min(int(exchange_budget), Nl) if exchange_budget else Nl
            tau = None
        else:
            budget = np.minimum(budget_mat, Nl)
            tau = np.arange(n_part) if return_tiles \
                else window_assignment(budget)
        band = me if tau is None else int(tau[me])
        return (budget, tau, band, t0_strip + band * sub) \
            + _window_rects(grid, dev, t0_strip, Tl, band, sub)

    if k_tiers is not None:
        k_tiers = tuple(int(k) for k in k_tiers)
        K = k_tiers[-1]                  # assignment depth = largest tier
        if tier_caps is not None:
            tier_caps = tuple(int(c) for c in tier_caps)
    if assign_block is None:
        assign_block = max(1024, 4096 // vloc) if views else 4096
    nax = 2 if views else 1
    lead = 1 if views else 0

    split = gather_mode == "split"

    def fold(x):
        return x.reshape((-1,) + tuple(x.shape[2:])) if views else x

    def subwin(x, band: int):
        """(lead, Pl*Tl, ...) strip tiles -> the (lead, Pl*sub, ...) tiles
        of sub-window ``band``, pad tiles zero."""
        y = x.reshape(tuple(x.shape[:lead]) + (-1, Tl)
                      + tuple(x.shape[lead + 1:]))
        if pad:
            y = torch.cat([y, y.new_zeros(tuple(y.shape[:lead + 1]) + (pad,)
                                          + tuple(y.shape[lead + 2:]))],
                          lead + 1)
        y = y.narrow(lead + 1, band * sub, sub)
        return y.reshape(tuple(x.shape[:lead]) + (-1,)
                         + tuple(x.shape[lead + 1:]))

    def fwd(g: Gaussians, cam: Camera, gt, mask):
        if exchange:
            budget, tau, band, t0_w, lo_w, hi_w = window(g.means.shape[1])
        else:
            t0_w, lo_w, hi_w = t0, lo, hi
        splats = _project_rows(g, cam, bool(views))
        # the policy cast comes BEFORE the collective: the payload (and the
        # transpose of its gradient) is in the storage dtype
        tabs = cast_tables(wire_tables(splats, gather_mode), dtype_policy)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ex_ov, edges, demand = zero, None, None
        with spans.span("train.gather"):
            if exchange:
                tabs = [fold(x) for x in tabs]              # (R, Nl, C)
                with torch.no_grad():
                    # the overlap from the policy-rounded f32 geometry: the
                    # arithmetic the receiver's assignment runs
                    first = tabs[0].detach().to(torch.float32)
                    if split:
                        rad = first[..., 2]
                        val = rad > 0
                    else:
                        rad = tabs[1][..., 0].to(torch.float32)
                        val = tabs[1][..., 2] > 0.5
                    hit = _exchange_hits(
                        (first[..., 0], first[..., 1], rad, val), grid,
                        t0_strip, Tl, sub, n_part)
                    move, ex_ov, edges, demand = _pack_exchange(
                        hit, part_group, me, budget, tau)
                    del hit, first
                tabs = [move(x) for x in tabs]
                gt, mask = subwin(gt, band), subwin(mask, band)
            else:
                tabs = [fold(_gather(x, part_group, nax)) for x in tabs]
        if split:
            geo, rest = tabs
            # f32 and differentiable: the kernel rows take the mean from it
            geo = to_f32(geo)
        else:
            feat, aux = tabs
        with torch.no_grad():
            # the assignment geometry in f32 (the policy-rounded values):
            # (mx, my, radius, depth, valid)
            if split:
                geom = torch.cat([geo.detach(), (geo[..., 2:3] > 0).to(
                    torch.float32)], -1)
            else:
                geom = torch.cat([feat[..., 0:2].detach(), aux],
                                 -1).to(torch.float32)
        if strip_budget < 1.0:
            with torch.no_grad():
                cand = _strip_candidates(
                    geom[..., 1], geom[..., 2], geom[..., 4] > 0.5, ylo, yhi,
                    strip_rows(geom.shape[1], strip_budget))
                geom = _take_rows(geom, cand)
            if split:
                geo, rest = _take_rows(geo, cand), _take_rows(rest, cand)
            else:
                feat = _take_rows(feat, cand)
        with torch.no_grad():
            idx, score, assign_ov = _assign_tiles_local(
                geom[..., 0:2], geom[..., 2], geom[..., 3], geom[..., 4] > 0.5,
                lo_w, hi_w, K=K, block=assign_block, impl=assign_impl,
                grid=grid, t0=t0_w, tile_budget=assign_budget)
            live = score > NEG / 2                           # (Pl, Wl, K)
        del geom
        Pl = idx.shape[0]
        mean_tab = geo[..., 0:2] if split else None

        def features_for(p_rows, idx_rows, live_rows):
            rows = (p_rows[..., None].long(), idx_rows.long())
            if split:
                rest_t = to_f32(rest[rows])
                alpha = torch.where(live_rows, rest_t[..., 6], 0.0)
                return torch.cat([mean_tab[rows], rest_t[..., :6],
                                  alpha[..., None],
                                  rest_t.new_zeros(tuple(rest_t.shape[:-1])
                                                   + (FEAT_DIM - 9,))], -1)
            feat_t = feat[rows]
            alpha = torch.where(live_rows, feat_t[..., 8], 0.0)
            return torch.cat([feat_t[..., :8], alpha[..., None],
                              feat_t[..., 9:]], -1)

        origins = lo_w.repeat(Pl, 1)                         # (Pl*Wl, 2)
        if k_tiers is not None:
            n_flat = Pl * Wl
            idx_f = idx.reshape(n_flat, K)
            live_f = live.reshape(n_flat, K)
            caps = tier_caps if tier_caps is not None \
                else (n_flat,) * len(k_tiers)
            with torch.no_grad():
                plan = bin_tiles_by_occupancy(
                    live_f.sum(-1).to(torch.int32), k_tiers, caps)
            overflow_l = plan.overflow
            tier_feats, tier_origins = [], []
            origins_p = torch.cat([origins, origins.new_zeros((1, 2))])
            for k, ids in zip(k_tiers, plan.tile_ids):
                safe = torch.clamp(ids, max=n_flat - 1).long()
                live_rows = live_f[safe, :k] & (ids < n_flat)[:, None]
                tier_feats.append(features_for(
                    torch.div(safe, Wl, rounding_mode="floor"),
                    idx_f[safe, :k], live_rows))
                tier_origins.append(
                    origins_p[torch.clamp(ids, max=n_flat).long()])
            tiles = rasterize_tiles_tiered(
                tier_feats, tier_origins, plan.tile_ids, n_flat,
                tile_h=grid.tile_h, tile_w=grid.tile_w, impl=impl)
        else:
            p_rows = torch.arange(Pl, dtype=torch.int32,
                                  device=dev)[:, None].expand(Pl, Wl)
            tile_feat = features_for(p_rows, idx, live)     # (Pl, Wl, K, F)
            tiles = rasterize_tiles(tile_feat.reshape(Pl * Wl, K, FEAT_DIM),
                                    origins, tile_h=grid.tile_h,
                                    tile_w=grid.tile_w, impl=impl)
            overflow_l = torch.zeros((), dtype=torch.int32, device=dev)

        # masked loss partials, summed over (pod, part, model); the view
        # axis adds one scalar pmean at the end
        if views:
            pred_v = tiles[:, :3].reshape((vloc, -1, 3) + tuple(
                tiles.shape[2:]))
            parts = torch.stack([
                _loss_partials(pred_v[v], gt[v], mask[v], win_size=win_size)
                for v in range(vloc)], -1)                   # (4, Vl)
        else:
            parts = _loss_partials(tiles[:, :3], gt, mask, win_size=win_size)
        l1n, l1d, sn, sd = _psum(parts, loss_group)
        loss = ((1 - lambda_dssim) * l1n / torch.clamp(l1d, min=1.0)
                + lambda_dssim * (1.0 - sn / torch.clamp(sd, min=1.0)) / 2.0)
        if views:
            loss = _psum(loss.mean(), view_group) / n_view
        if not (return_tiles or return_overflow):
            return loss
        outs = (loss,)
        if return_tiles:
            if exchange:
                tiles = tiles.reshape(((vloc,) if views else ())
                                      + (-1, Wl) + tuple(tiles.shape[1:]))
            elif views:
                tiles = tiles.reshape((vloc, -1) + tuple(tiles.shape[1:]))
            outs += (tiles,)
        if return_overflow:
            with torch.no_grad():
                cnt = torch.stack([overflow_l.to(torch.int64),
                                   assign_ov.to(torch.int64)])
                if count_group is not None:
                    cnt = _all_reduce(cnt, dist.ReduceOp.SUM, count_group)
                ex = ex_ov.to(torch.int64).reshape(1)
                if all_group is not None:
                    ex = _all_reduce(ex, dist.ReduceOp.SUM, all_group)
                ov = {"tiles": cnt[0].to(torch.int32),
                      "assign": cnt[1].to(torch.int32),
                      "exchange": ex[0].to(torch.int32)}
                if edges is not None:
                    # each "part" rank owns row ``me`` of the matrices
                    em = torch.zeros((2, n_part, n_part), dtype=torch.int64,
                                     device=dev)
                    em[0, me], em[1, me] = edges, demand
                    if all_group is not None:
                        em[0] = _all_reduce(em[0], dist.ReduceOp.SUM,
                                            all_group)
                    if part_group is not None:
                        em[1] = _all_reduce(em[1], dist.ReduceOp.SUM,
                                            part_group)
                    if rest_group is not None:
                        em[1] = _all_reduce(em[1], dist.ReduceOp.MAX,
                                            rest_group)
                    ov["exchange_edges"] = em[0].to(torch.int32)
                    ov["exchange_demand"] = em[1].to(torch.int32)
            outs += (ov,)
        return outs

    return fwd


# ---------------------------------------------------------------------------
# Distributed occupancy probe (tier-schedule telemetry)
# ---------------------------------------------------------------------------


def make_gs_probe(mesh, grid: TileGrid, *, k_tiers,
                  views: Optional[int] = None,
                  assign_block: Optional[int] = None,
                  assign_impl: str = DEFAULT_ASSIGN_IMPL,
                  assign_budget: Optional[int] = None,
                  exchange: bool = False):
    """The tier-schedule probe of one rank: ``probe(g, cam) ->
    (tier_counts (n_tiers,) int64, max_occ)``, identical on every rank.

    Runs the forward's project -> table all-gather -> view fold ->
    assignment over this rank's "model" strip at the ladder's Kmax, counts
    tiles per desired tier over this rank's FOLDED (Vl * Pl * Tl,) binning
    domain -- the domain the tiered forward bins -- and all-reduces
    (counts, max occupancy) with MAX over the world, so every rank feeds
    ``TierSchedule.probe_counts`` the same numbers and builds the same
    static shapes.  ``k_tiers`` must be the schedule's FULL ladder.  The
    probe ignores ``strip_budget``: the exact table's occupancy bounds
    every budgeted variant's.  ``exchange=True`` bins the exchange's
    domain instead, (Vl * Pl * sub,): part rank i's sub-window i of its
    strip (pad tiles get the degenerate rects, so they bin nothing), still
    from the whole all-gathered table, whose occupancy bounds any
    budgeted exchange table's."""
    ax = _axes(mesh)
    vloc = _check_views(mesh, views)
    ladder = tuple(int(k) for k in k_tiers)
    K = ladder[-1]
    if assign_block is None:
        assign_block = max(1024, 4096 // vloc) if views else 4096
    part_group = mesh.group(ax.data)
    t0, Tl = _strip(mesh, grid.n_tiles)
    if exchange:
        _, sub, _ = _sub_window(grid, _size(mesh, ax.model),
                                _size(mesh, ax.data))
        pi = _index(mesh, ax.data)
        lo, hi = _window_rects(grid, mesh.device, t0 or 0, Tl, pi, sub)
        t0 = (t0 or 0) + pi * sub
    else:
        lo, hi = tile_bounds(grid, mesh.device)
        if t0 is not None:
            lo, hi = lo[t0:t0 + Tl], hi[t0:t0 + Tl]
    nax = 2 if views else 1

    @torch.no_grad()
    def probe(g: Gaussians, cam: Camera):
        splats = _project_rows(g, cam, bool(views))
        aux_l = torch.stack(
            [splats.mean2d[..., 0], splats.mean2d[..., 1],
             torch.where(splats.valid, splats.radius, 0.0), splats.depth],
            -1)
        aux = _gather(aux_l, part_group, nax)
        if views:
            aux = aux.reshape((-1,) + tuple(aux.shape[2:]))
        radius = aux[..., 2]
        _, score, _ = _assign_tiles_local(
            aux[..., 0:2], radius, aux[..., 3], radius > 0, lo, hi, K=K,
            block=assign_block, impl=assign_impl, grid=grid, t0=t0,
            tile_budget=assign_budget)
        occ = tile_occupancy(score).reshape(-1)
        tiers = tile_tiers(occ, ladder)
        counts = [int((tiers == i).sum()) for i in range(len(ladder))]
        out = _world_max(counts + [int(occ.max()) if occ.numel() else 0],
                         mesh.device)
        return out[:-1], out[-1]

    return probe


def folded_tile_count(mesh, grid: TileGrid, n_parts: int,
                      views: Optional[int] = None,
                      exchange: bool = False) -> int:
    """Per-rank flat tile count of the distributed binning domain,
    ``Vl * Pl * Tl`` with Pl = P / n_pod and Tl = T / n_model -- the cap
    clamp / ``note_overflow`` ``n_tiles``; ``exchange=True`` takes the
    sub-window, ``Vl * Pl * ceil(Tl / n_part)``.  ``n_parts`` is the
    GLOBAL P."""
    ax = _axes(mesh)
    vloc = views // _size(mesh, ax.view) if views else 1
    t_loc = grid.n_tiles // _size(mesh, ax.model)
    if exchange:
        t_loc = -(-t_loc // _size(mesh, ax.data))
    return vloc * (n_parts // _size(mesh, ax.pod)) * t_loc


def probe_gs_schedule(sched: TierSchedule, mesh, grid: TileGrid,
                      g: Gaussians, cam, *, views: Optional[int] = None,
                      assign_impl: str = DEFAULT_ASSIGN_IMPL,
                      assign_budget: Optional[int] = None,
                      exchange: bool = False):
    """Probe ``sched`` against the mesh and update it host-side via
    ``probe_counts`` -> the new ``(k_tiers, tier_caps)``, identical on
    every rank.  ``g`` is this rank's (Pl, Nl) shard; ``cam`` is this
    rank's part of one view batch or a list of them (counts max-merged:
    the caps cover the worst probed batch)."""
    probe_fn = make_gs_probe(mesh, grid, k_tiers=tuple(sched.ladder),
                             views=views, assign_impl=assign_impl,
                             assign_budget=assign_budget, exchange=exchange)
    counts, max_occ = None, 0
    for cb in _cam_batches(cam):
        c, m = probe_fn(g, cb)
        counts = c if counts is None else [max(a, b)
                                           for a, b in zip(counts, c)]
        max_occ = max(max_occ, m)
    n_parts = g.means.shape[0] * _size(mesh, _axes(mesh).pod)
    return sched.probe_counts(
        counts, max_occ,
        n_tiles=folded_tile_count(mesh, grid, n_parts, views,
                                  exchange=exchange))


def _cam_batches(cam) -> list:
    """One view batch (a ``Camera``) or a sequence of them -> a list."""
    return [cam] if isinstance(cam, Camera) else list(cam)


def resolve_assignment_global(mesh, g: Gaussians, cams: Camera,
                              grid: TileGrid, *,
                              assign_impl: str = DEFAULT_ASSIGN_IMPL,
                              assign_budget: Optional[int] = None):
    """``render.resolve_assignment`` over the GLOBAL (P, N) state from this
    rank's rows: the per-splat bbox tile counts over the whole rig are
    maxed locally and then over the world, so every rank resolves the same
    ``(impl, budget)``."""
    candidate = (assign_impl == "sorted"
                 or (assign_impl == "auto"
                     and grid.n_tiles >= SORTED_MIN_TILES))
    if assign_budget is None and candidate:
        local = max(max_tile_count(Gaussians(*(f[p] for f in g)), cams, grid)
                    for p in range(g.means.shape[0]))
        (best,) = _world_max([local], mesh.device)
        assign_budget = auto_tile_budget(best, grid.n_tiles)
    impl = resolve_assign_impl(assign_impl, grid.n_tiles, assign_budget)
    return impl, (assign_budget if impl == "sorted" else None)


# ---------------------------------------------------------------------------
# Sparse-exchange edge budget: checks, window assignment, schedule, probe
# ---------------------------------------------------------------------------


def check_budget_matrix(budget, n_data: Optional[int] = None) -> np.ndarray:
    """Validate a per-edge exchange budget matrix: square (n_part, n_part)
    integer entries ``B[src, dst] >= 1``, and with ``n_data`` exactly the
    "part" axis' size (a wrong size is refused, never padded) -> the int64
    numpy matrix."""
    B = np.asarray(budget)
    if B.ndim != 2 or B.shape[0] != B.shape[1]:
        raise ValueError(
            "exchange budget matrix must be square (n_part, n_part); got "
            f"shape {B.shape}")
    if n_data is not None and B.shape[0] != n_data:
        raise ValueError(
            f"exchange budget matrix is {B.shape[0]}x{B.shape[1]} but the "
            f"'part' axis has {n_data} devices — one row/column per device "
            "is required (undersized/oversized matrices are refused, never "
            "padded)")
    if not np.issubdtype(B.dtype, np.integer):
        if not np.all(B == np.floor(B)):
            raise ValueError("exchange budget matrix entries must be "
                             "integers")
    B = B.astype(np.int64)
    if (B < 1).any():
        raise ValueError(
            "exchange budget matrix entries must be >= 1 (every edge needs "
            f"at least one slot); min entry is {int(B.min())}")
    return B


def window_assignment(budget) -> np.ndarray:
    """The band (sub-window) each "part" rank renders under a budget
    matrix: a permutation ``tau`` that lowers the ladder's wire rows
    ``sum_k max_s B[s, tau[(s + k) % n]]`` over the shifts k >= 1 (shift 0
    is local, hence free).  Greedy seeding puts each source's heaviest
    band on its own shift (steepest source first), then 2-opt swaps on
    that cost; the identity unless the result is strictly cheaper.
    Deterministic, numpy only."""
    B = np.asarray(budget, np.int64)
    n = B.shape[0]
    if n <= 1:
        return np.zeros((n,), np.int64)
    shifts = [(np.arange(n) + k) % n for k in range(1, n)]

    def cost(tau):
        return sum(int(B[np.arange(n), tau[s]].max()) for s in shifts)

    tau = -np.ones(n, np.int64)
    used = np.zeros(n, bool)
    for s in np.argsort(-B.max(1), kind="stable"):
        d = int(np.argmax(np.where(used, -1, B[s])))
        tau[s] = d
        used[d] = True
    best = cost(tau)
    improved = True
    while improved:
        improved = False
        for i in range(n):
            for j in range(i + 1, n):
                t2 = tau.copy()
                t2[i], t2[j] = t2[j], t2[i]
                w = cost(t2)
                if w < best:
                    best, tau, improved = w, t2, True
    ident = np.arange(n, dtype=np.int64)
    return tau if best < cost(ident) else ident


class ExchangeSchedule:
    """The sparse exchange's edge budget, sized from telemetry and guarded
    by the step's overflow counters (the ``TierSchedule`` contract):
    ``budget`` is None (not probed yet), one int for every edge, or an
    (n_part, n_part) int matrix ``B[src, dst]``.

      probe_budget(max_edge, n_local)  size it from a probed count (an
          int, or an (n, n) demand matrix) times ``slack``, rounded up to
          ``round_to``, clamped to [1, n_local];
      note_overflow(ov, n_local)       grow it by ``growth`` after a step
          dropped rows (only the starved edges, given a matching (n, n)
          counter); True when it changed;
      ensure(demand, n_local)          grow, never shrink, to cover a
          demand (rounded, clamped); True when it changed;
      budget_key()                     a hashable snapshot (step caches);
      state_dict / load_state / from_state  the JSON the checkpoints carry
          in ``extra["exchange"]`` (a matrix as nested lists), key for key
          the reference's."""

    def __init__(self, *, slack: float = 1.5, round_to: int = 16,
                 growth: float = 2.0, budget=None):
        self.slack = float(slack)
        self.round_to = int(round_to)
        self.growth = float(growth)
        self.budget = self._coerce(budget)

    def _coerce(self, budget):
        if budget is None:
            return None
        if np.ndim(budget) == 0:
            return int(budget)
        return check_budget_matrix(budget)

    def _sized(self, demand, n_local: int) -> np.ndarray:
        b = np.ceil(np.maximum(np.asarray(demand, np.int64), 1)
                    * self.slack).astype(np.int64)
        b = -(-b // self.round_to) * self.round_to
        return np.clip(b, 1, int(n_local))

    def probe_budget(self, max_edge, n_local: int):
        if np.ndim(max_edge) == 2:
            self.budget = check_budget_matrix(
                self._sized(np.asarray(max_edge), n_local))
        else:
            self.budget = int(self._sized(int(max_edge), n_local))
        return self.budget

    def note_overflow(self, overflow, n_local: int) -> bool:
        if self.budget is None:
            return False
        ov = np.asarray(overflow)
        if np.ndim(self.budget) == 2:
            B = np.asarray(self.budget)
            starved = (ov > 0) if ov.shape == B.shape \
                else np.full(B.shape, int(ov.sum()) > 0)
            if not starved.any():
                return False
            grown = np.minimum(
                int(n_local),
                np.maximum(self.round_to,
                           np.ceil(B * self.growth).astype(np.int64)))
            new = np.where(starved, np.maximum(B, grown), B)
            if (new == B).all():
                return False
            self.budget = new
            return True
        if int(ov.sum()) <= 0:
            return False
        grown = min(int(n_local),
                    max(self.round_to,
                        int(np.ceil(self.budget * self.growth))))
        if grown <= self.budget:
            return False
        self.budget = grown
        return True

    def ensure(self, demand, n_local: int) -> bool:
        if self.budget is None:
            return False
        d = np.maximum(np.asarray(demand, np.int64), 1)
        need = np.clip(-(-d // self.round_to) * self.round_to, 1,
                       int(n_local))
        if np.ndim(self.budget) == 2:
            old = np.asarray(self.budget)
            new = np.maximum(old, check_budget_matrix(need, old.shape[0]))
            if (new == old).all():
                return False
            self.budget = new
            return True
        new = max(int(self.budget), int(need))
        if new == self.budget:
            return False
        self.budget = new
        return True

    def budget_key(self):
        if self.budget is None or np.ndim(self.budget) == 0:
            return self.budget
        return tuple(tuple(int(x) for x in row)
                     for row in np.asarray(self.budget))

    def state_dict(self) -> dict:
        b = self.budget
        if b is not None and np.ndim(b) == 2:
            b = [[int(x) for x in row] for row in np.asarray(b)]
        return {"slack": self.slack, "round_to": self.round_to,
                "growth": self.growth, "budget": b}

    def load_state(self, state: dict) -> "ExchangeSchedule":
        self.slack = float(state["slack"])
        self.round_to = int(state["round_to"])
        self.growth = float(state["growth"])
        self.budget = self._coerce(state["budget"])
        return self

    @classmethod
    def from_state(cls, state: dict) -> "ExchangeSchedule":
        return cls().load_state(state)

    def __repr__(self):
        b = self.budget
        if b is not None and np.ndim(b) == 2:
            B = np.asarray(b)
            b = (f"{B.shape[0]}x{B.shape[1]}"
                 f"[{int(B.min())}..{int(B.max())}]")
        return (f"ExchangeSchedule(budget={b}, "
                f"slack={self.slack}, round_to={self.round_to})")


def make_gs_exchange_probe(mesh, grid: TileGrid, *,
                           views: Optional[int] = None,
                           per_edge: bool = False):
    """The exchange-budget probe of one rank: ``probe(g, cam)`` -> the
    worst per-edge overlap count (an int, MAX over the world), or with
    ``per_edge`` the (n_part, n_part) int64 numpy demand matrix (row s:
    source s's largest count toward each band; rows assembled by a SUM
    over "part", then MAX over ("pod", "model", "view")), identical on
    every rank.  The counts are ``window_overlap_mask``'s, the forward's
    packing predicate, on the projected float32 splats; no table moves."""
    ax = _axes(mesh)
    vloc = _check_views(mesh, views)
    n_part = _size(mesh, ax.data)
    t0, Tl = _strip(mesh, grid.n_tiles)
    _, sub, _ = _sub_window(grid, _size(mesh, ax.model), n_part)
    me = _index(mesh, ax.data)
    dev = mesh.device

    @torch.no_grad()
    def probe(g: Gaussians, cam: Camera):
        s = _project_rows(g, cam, bool(vloc))
        cols = (s.mean2d[..., 0], s.mean2d[..., 1],
                torch.where(s.valid, s.radius, 0.0), s.valid)
        if vloc:
            cols = tuple(x.reshape((-1,) + tuple(x.shape[2:])) for x in cols)
        counts = _exchange_hits(cols, grid, t0 or 0, Tl, sub,
                                n_part).sum(-1)             # (n, R)
        if not per_edge:
            return _world_max([int(counts.max())], dev)[0]
        dm = torch.zeros((n_part, n_part), dtype=torch.int64, device=dev)
        dm[me] = counts.amax(1)
        part, rest = mesh.group(ax.data), mesh.group(ax.pod, ax.model,
                                                     ax.view)
        if part is not None:
            dm = _all_reduce(dm, dist.ReduceOp.SUM, part)
        if rest is not None:
            dm = _all_reduce(dm, dist.ReduceOp.MAX, rest)
        return dm.cpu().numpy()

    return probe


def probe_gs_exchange(esched: ExchangeSchedule, mesh, grid: TileGrid,
                      g: Gaussians, cam, *, views: Optional[int] = None,
                      per_edge: bool = False):
    """Size ``esched`` from ``make_gs_exchange_probe`` over one view batch
    or several (max-merged on the host) -> the new budget, identical on
    every rank.  ``g`` is this rank's (Pl, Nl) shard: Nl clamps the
    budget."""
    probe_fn = make_gs_exchange_probe(mesh, grid, views=views,
                                      per_edge=per_edge)
    mx = None
    for cb in _cam_batches(cam):
        got = probe_fn(g, cb)
        mx = got if mx is None else np.maximum(mx, got)
    return esched.probe_budget(mx, g.means.shape[1])


# ---------------------------------------------------------------------------
# Distributed train step
# ---------------------------------------------------------------------------


#: sentinel: "no explicit argument -- resolve from the train cfg"
_FROM_CFG = object()


def make_gs_train_step(mesh, cfg: GSTrainCfg, grid: TileGrid, extent: float,
                       *, impl: str = "auto", views: Optional[int] = None,
                       assign_block: Optional[int] = None,
                       k_tiers=_FROM_CFG,
                       tier_caps: Optional[tuple] = None,
                       return_overflow: bool = False, win_size: int = 7,
                       assign_impl=_FROM_CFG, assign_budget=_FROM_CFG,
                       exchange=_FROM_CFG, exchange_budget=_FROM_CFG):
    """``step(g, opt, batch) -> (g, opt, loss[, overflow])`` on this rank's
    shard: the distributed forward, its gradient, and the per-group Adam
    update (``train.adam_update``) with the densify statistics on this
    rank's rows.  Gradients never mix partitions; the loss (and so the
    gradient) averages over the view batch.  ``k_tiers`` unset takes
    ``cfg.resolved_k_tiers()`` (None forces dense); ``tier_caps`` None the
    always-exact full-domain caps.  Returns new state; the inputs are not
    modified.

    ``cfg.dtype_policy`` and ``cfg.gather_mode`` pick the forward's wire
    tables; the loss, the gradients and Adam stay float32.  ``exchange``
    and ``exchange_budget`` (unset: the cfg's) pick the sparse-overlap
    exchange (``make_gs_forward``).
    ``cfg.grad_compress != "none"`` changes the signature to ``step(g,
    opt, err, batch) -> (g, opt, err, loss[, overflow])``: the gradients,
    summed over ("model", "view") and cast to float32, go through
    ``optim.compress.compress_grads`` before Adam (and the densify
    statistics).  ``err`` is the int8 error-feedback residual, a dict
    shaped like this rank's trainables (None starts from zeros), and None
    for the stateless "bf16"; the int8 scale of each tensor is the max
    over ("pod", "part"), the ranks holding its other blocks."""
    if k_tiers is _FROM_CFG:
        k_tiers = cfg.resolved_k_tiers()
    if assign_impl is _FROM_CFG:
        assign_impl = cfg.assign_impl
    if assign_budget is _FROM_CFG:
        assign_budget = cfg.assign_budget
    if exchange is _FROM_CFG:
        exchange = cfg.exchange
    if exchange_budget is _FROM_CFG:
        exchange_budget = cfg.exchange_budget
    ax = _axes(mesh)
    # the gaussians are replicated along "model" and "view"
    rep_group = mesh.group(ax.model, ax.view)
    # ... and split along "pod" and "part": a tensor's blocks
    shard_group = mesh.group(ax.pod, ax.data)
    compress = cfg.grad_compress
    lrs = group_lrs(cfg, extent)
    fwd = make_gs_forward(mesh, grid, K=cfg.assign_K, impl=impl,
                          lambda_dssim=cfg.lambda_dssim,
                          gather_mode=cfg.gather_mode,
                          strip_budget=cfg.strip_budget, views=views,
                          assign_block=assign_block, k_tiers=k_tiers,
                          tier_caps=tier_caps, return_overflow=True,
                          win_size=win_size, assign_impl=assign_impl,
                          assign_budget=assign_budget, exchange=exchange,
                          exchange_budget=exchange_budget,
                          dtype_policy=cfg.dtype_policy)
    world = dist.get_world_size()

    def grads_of(g: Gaussians, batch, err=None):
        """-> (loss, overflow, gradients, err): spans ``train.forward`` and
        ``train.backward`` (the gradient, its sum over the replicas and,
        with ``grad_compress``, its compression)."""
        tr = {k: p.detach().requires_grad_(True)
              for k, p in g.trainable().items()}
        names = list(tr)
        with torch.enable_grad():
            with spans.span("train.forward"):
                loss, overflow = fwd(g.with_trainable(tr), batch["cam"],
                                     batch["gt_tiles"], batch["mask_tiles"])
            # the replicated loss's cotangent, spread over the world (what
            # shard_map's transpose feeds each device)
            seed = torch.full_like(loss, 1.0 / world)
        with spans.span("train.backward"):
            with torch.enable_grad():
                got = torch.autograd.grad(loss, [tr[k] for k in names],
                                          grad_outputs=seed,
                                          allow_unused=True)
            grads = {k: torch.zeros_like(tr[k]) if gr is None else gr
                     for k, gr in zip(names, got)}
            with torch.no_grad():
                if rep_group is not None:
                    # sum the replicated gaussians' gradients over
                    # ("model", "view") (one flat all-reduce)
                    flat = torch.cat([grads[k].reshape(-1) for k in names])
                    n = dist.get_world_size(rep_group)
                    _count_wire(2 * (n - 1) * _nbytes(flat) // n)
                    dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                    group=rep_group)
                    off = 0
                    for k in names:
                        n = grads[k].numel()
                        grads[k] = flat[off:off + n].view_as(grads[k])
                        off += n
                if compress != "none":
                    grads, err, _ = compress_grads(
                        {k: v.to(torch.float32) for k, v in grads.items()},
                        compress, err, group=shard_group)
        return loss.detach(), overflow, grads, err

    @torch.no_grad()
    def update(g: Gaussians, opt: GSOptState, grads):
        with spans.span("train.adam"):
            new_tr, new_m, new_v, step_i = adam_update(
                cfg, lrs, g.trainable(), grads, opt)
            gnorm = torch.linalg.norm(grads["means"].to(torch.float32), dim=-1)
            new_opt = GSOptState(
                m=new_m, v=new_v, step=step_i,
                grad_accum=opt.grad_accum + gnorm,
                grad_count=opt.grad_count + (gnorm > 0).to(torch.float32))
            return g.with_trainable(new_tr), new_opt

    def step(g: Gaussians, opt: GSOptState, batch):
        loss, overflow, grads, _ = grads_of(g, batch)
        out = update(g, opt, grads) + (loss,)
        return out + (overflow,) if return_overflow else out

    def step_compressed(g: Gaussians, opt: GSOptState, err, batch):
        loss, overflow, grads, err = grads_of(g, batch, err)
        out = update(g, opt, grads) + (err, loss)
        return out + (overflow,) if return_overflow else out

    return step if compress == "none" else step_compressed


def zero_err(g: Gaussians, mode: str):
    """The error-feedback state a compressed step starts from: float32
    zeros shaped like ``g``'s trainables for "int8", None otherwise."""
    if mode != "int8":
        return None
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in g.trainable().items()}


# ---------------------------------------------------------------------------
# Distributed schedule driver (host loop)
# ---------------------------------------------------------------------------


def _tile_view_batches(gts, masks, grid: TileGrid):
    """Per-partition images -> the distributed flat-tile batch layout.

    gts (P, V, H, W, 3), masks (P, V, H, W) bool or None -> (gt_tiles
    (V, P*T, 3, th, tw) float32, mask_tiles (V, P*T, th, tw) bool), on
    the images' device.  masks=None means "every IMAGE pixel counts":
    grid padding stays masked off, as the single-device full-image loss
    never sees pad pixels."""
    gts = torch.as_tensor(gts)
    Pn, V = gts.shape[:2]
    T = grid.n_tiles
    gt_t = tile_image(gts.to(torch.float32), grid)   # (P, V, T, 3, th, tw)
    gt_t = gt_t.transpose(0, 1).reshape((V, Pn * T) + tuple(gt_t.shape[3:]))
    if masks is None:
        masks = torch.ones((Pn, V) + tuple(gts.shape[2:4]),
                           dtype=torch.float32, device=gts.device)
    m = tile_image(torch.as_tensor(masks)[..., None].to(torch.float32),
                   grid)
    mask_t = m.transpose(0, 1)[:, :, :, 0].reshape(
        (V, Pn * T) + tuple(m.shape[4:])) > 0.5
    return gt_t.contiguous(), mask_t.contiguous()


def _partition(tree, p: int):
    """Partition ``p`` of a (P, N) (g, opt) tree (the Adam step stays)."""
    return tree_map(lambda x: x[p] if isinstance(x, torch.Tensor)
                    and x.dim() >= 2 else x, tree)


def _stack_partitions(trees):
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor) and xs[0].dim() >= 1:
            return torch.stack(xs)
        return xs[0]
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    return treedef.unflatten([stack(*xs) for xs in zip(*(f[0]
                                                          for f in flat))])


def _deal_rows(active: np.ndarray, n_data: int, threshold: float):
    """``rebalance_partitions``' permutation of a global (P, N) ``active``
    mask -> (P, N) int64 (row i of the dealt layout takes row perm[p, i]),
    or None when no partition's skew exceeds ``threshold``."""
    Pn, N = active.shape
    Nl = N // n_data
    shard_live = active.reshape(Pn, n_data, Nl).sum(-1)
    skew = shard_live.max(-1) / np.maximum(shard_live.mean(-1), 1.0)
    if float(skew.max()) <= threshold:
        return None
    perm = np.empty((Pn, N), np.int64)
    for p in range(Pn):
        order = np.argsort(~active[p], kind="stable")
        L = int(active[p].sum())
        szs = np.full(n_data, L // n_data, np.int64)
        szs[: L % n_data] += 1
        starts = np.concatenate([[0], np.cumsum(szs)[:-1]])
        dest = np.empty(N, np.int64)
        for i in range(n_data):
            dest[starts[i]: starts[i] + szs[i]] = i * Nl + np.arange(szs[i])
        dest[L:] = np.concatenate(
            [np.arange(i * Nl + szs[i], (i + 1) * Nl) for i in range(n_data)])
        perm[p, dest] = order
    return perm


def _permute_rows(tree, perm: np.ndarray):
    """Apply a (P, N) row permutation to every (P, N, ...) leaf."""
    Pn, N = perm.shape
    idx = None

    def take(x):
        nonlocal idx
        if not (isinstance(x, torch.Tensor) and x.dim() >= 2
                and tuple(x.shape[:2]) == (Pn, N)):
            return x
        if idx is None:
            idx = torch.as_tensor(perm, device=x.device)
        return torch.stack([x[p][idx[p]] for p in range(Pn)])
    return tree_map(take, tree)


def rebalance_partitions(g: Gaussians, opt: GSOptState, mesh, *,
                         threshold: float = 1.5):
    """Deal each partition's live rows evenly over the "part" shards of
    the GLOBAL (P, N) state: when the most crowded shard holds more than
    ``threshold`` times the partition's mean live count, the live rows, in
    their order, are dealt in contiguous near-equal blocks (block i fills
    the front of shard i, the dead rows the rest).  A pure permutation:
    shapes stay, the optimizer rows travel with their splats, and equal
    inputs give the same permutation on every rank (a stable sort, no
    random draw), so every rank runs it on the gathered state and keeps
    its block.  Contiguous blocks keep each shard a compact run of the
    partition's spatial order.  ``threshold=0`` forces the deal.  Only the
    mesh's "part" size is read.  -> (g, opt, moved); the inputs when
    nothing moved."""
    perm = _deal_rows(as_numpy(g.active).astype(bool),
                      _size(mesh, _axes(mesh).data), threshold)
    if perm is None:
        return g, opt, False
    return _permute_rows(g, perm), _permute_rows(opt, perm), True


def fit_partitions(g: Gaussians, cams: Camera, gts, masks, cfg: GSTrainCfg,
                   *, mesh, steps: int, extent: float, generator=None,
                   densify_every: int = 0, densify_from: int = 100,
                   grid: Optional[TileGrid] = None,
                   view_batch: Optional[int] = None,
                   schedule: Optional[TierSchedule] = None,
                   impl: str = "auto", win_size: int = 7,
                   rebalance_every: int = 0,
                   rebalance_threshold: float = 1.5, ckpt=None,
                   ckpt_every: int = 0, log_every: int = 0,
                   warm_start=None, densify_cap: Optional[int] = None,
                   exchange_schedule=None,
                   densify_noise: Optional[Iterable] = None,
                   step_times: Optional[list] = None):
    """Distributed tier-schedule driver: every partition of the GLOBAL
    batched (P, N) layout trained in one step on ``mesh``, with the same
    probe -> train -> overflow growth -> densify -> re-probe lifecycle as
    ``train.fit_partition``.  Every rank calls it with the same arguments.

    g: (P, N, ...) Gaussians; gts (P, V, H, W, 3); masks (P, V, H, W) bool
    or None; all on the mesh's device.  Each step consumes ``view_batch``
    consecutive views (default cfg.view_batch), split over "view".
    Returns (g, opt, losses) with g/opt this rank's shard
    (``gather_partitions`` gives the global tree) and ``losses`` the steps
    this call ran (identical on every rank).

    Densify runs on the GATHERED global state, partition by partition,
    with ``train.densify_and_prune``; the split noise comes from
    ``generator`` (a ``torch.Generator`` on the mesh's device, default
    seeded 0, the same on every rank; one (max_new', 3) draw per partition
    per event) or from ``densify_noise`` (one (P, max_new', 3) entry per
    densify event of the whole run).  Then each rank keeps its (pod,
    part) block.

    Checkpoints hold the GLOBAL (P, N) (g, opt) tree with the TierSchedule
    state in ``extra["schedule"]`` -- the reference's ``fit_partitions``
    layout, restorable at any world size: rank 0 writes after a gather,
    every rank restores and cuts its rows; a resume skips the initial
    probe (unless ``extra["tile_split"]``, the writer's ("pod", "model",
    "view") sizes, differs from this mesh's: its caps fit other tile
    domains) and fast-forwards the split noise.  ``warm_start=(tree, extra,
    step)`` is the same resume from a host (g, opt[, err]) tree.

    Under ``cfg.grad_compress="int8"`` the error-feedback residual is step
    state: the state tree is (g, opt, err), checkpointed in the same
    global (P, N) layout (so a resume at any world size keeps it), set to
    zeros after every densify event (rows moved), and dropped on
    ``warm_start`` (a new timestep's field moved under the rows).  The
    resume policy check runs before the tree restore: another
    ``grad_compress`` has another leaf count.

    Under ``cfg.exchange`` the step runs the sparse-overlap exchange.  Its
    budget is ``cfg.exchange_budget`` when set (pinned: never re-probed),
    else the ``ExchangeSchedule`` (``exchange_schedule``, default a fresh
    one) is probed at init -- per edge, an (n, n) matrix, when "part" has
    more than one rank -- over up to 4 view batches.  Each step's counter
    grows the starved edges (``note_overflow``) and its in-step demand
    matrix is kept as a running max; after densify the budget is grown to
    that demand + ``cfg.max_new`` (``ensure``; a re-probe without one).
    The schedule rides the checkpoints in ``extra["exchange"]``: a resume
    or a warm start restores it without a probe.  ``rebalance_every=R``
    runs ``rebalance_partitions`` on the gathered state every R steps at
    ``rebalance_threshold``; a deal that moved rows drops the demand,
    re-probes the budget and zeroes the int8 residual.

    ``step_times``, a list, gets each step's wall seconds appended: from
    the batch's slicing to its loss read back (which waits for the
    device), densify and checkpoints not included."""
    compress = cfg.grad_compress
    dev = mesh.device
    if grid is None:
        grid = TileGrid(cams.width, cams.height, cfg.tile_h, cfg.tile_w)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    noise = None if densify_noise is None else iter(densify_noise)
    ax = _axes(mesh)
    Pn = g.means.shape[0]
    V = gts.shape[1]
    vb = max(1, min(view_batch or cfg.view_batch, V))
    vloc = _check_views(mesh, vb)
    v0 = _index(mesh, ax.view) * vloc
    sched = schedule if schedule is not None else cfg.tier_schedule()
    m_dev = folded_tile_count(mesh, grid, Pn, views=vb,
                              exchange=cfg.exchange)
    ex = exchange_schedule if exchange_schedule is not None else (
        ExchangeSchedule(budget=cfg.exchange_budget) if cfg.exchange
        else None)
    ex_pinned = cfg.exchange_budget is not None
    n_data = _size(mesh, ax.data)
    Nl = g.means.shape[1] // n_data
    # per-edge budgets need a real "part" axis (a 1x1 matrix is a scalar)
    ex_per_edge = cfg.exchange and not ex_pinned and n_data > 1
    dcfg = dataclasses.replace(cfg, densify_cap=densify_cap) \
        if densify_cap is not None else cfg
    rank0 = dist.get_rank() == 0

    # this rank's partitions' tile strips of every view
    gt_tiles, mask_tiles = (_cut_tiles(x, mesh, Pn, 1)
                            for x in _tile_view_batches(gts, masks, grid))
    opt = init_opt(g)
    err = zero_err(g, compress)

    def state_tree(gg, oo, ee):
        # the int8 residual rides the checkpoint
        return (gg, oo, ee) if compress == "int8" else (gg, oo)

    # how the ranks split the tile domain ("pod", "model", "view"): the
    # caps a checkpoint carries fit the split it was written under
    split = [_size(mesh, a) for a in (ax.pod, ax.model, ax.view)]

    def load_schedule(extra):
        if sched is not None and extra.get("schedule"):
            sched.load_state(extra["schedule"])
            if extra.get("tile_split", [1, 1, 1]) != split:
                sched.tier_caps = None       # re-probe on this mesh
        if ex is not None and extra.get("exchange"):
            ex.load_state(extra["exchange"])

    start, losses = 0, []
    if ckpt is not None:
        latest = ckpt.latest_restorable_step()
        if latest is not None:
            _check_resume_policy(ckpt.manifest_extra(latest), cfg)
            like = state_tree(g, opt, err)
            tree, extra = ckpt.restore(latest, unshaped_like(like),
                                       device=dev)
            tree = fit_slots(tree, like)
            g, opt = tree[0], tree[1]
            if compress == "int8":
                err = tree[2]
            load_schedule(extra)
            start = latest
    if start == 0 and warm_start is not None:
        wtree, wextra, wstep = warm_start
        wextra = wextra or {}
        _check_resume_policy(wextra, cfg)
        # the int8 residual (wtree[2], if any) stays behind: err is zeros
        g, opt = tree_map(lambda x: torch.as_tensor(np.asarray(as_numpy(x)))
                          .to(dev), (wtree[0], wtree[1]))
        load_schedule(wextra)
        start = wstep

    def densify_at(i):
        return densify_every and i >= densify_from \
            and (i + 1) % densify_every == 0

    # skip the split noise of the densify events before ``start``
    n_split = min(cfg.max_new, g.means.shape[1])
    for i in range(start):
        if densify_at(i):
            if noise is not None:
                next(noise)
            else:
                for _ in range(Pn):
                    torch.randn((n_split, 3), generator=generator,
                                device=dev)

    g, opt, err = gs_shard_state((g, opt, err), mesh)
    assign = {"impl": cfg.assign_impl, "budget": cfg.assign_budget}

    def probe_assign(gg):
        impl_, budget = resolve_assignment_global(
            mesh, gg, cams, grid, assign_impl=cfg.assign_impl,
            assign_budget=cfg.assign_budget)
        assign.update(impl=impl_, budget=budget)

    n_probe = 2 if vb < 2 and V > 1 else 1
    if cfg.exchange:
        # a per-edge budget has no worst-edge slack: probe a few batches
        n_probe = max(n_probe, min(-(-V // vb), 4))
    probe_cams = []
    for b in range(n_probe):
        vi = (b * vb + torch.arange(vb, device=dev)) % V
        probe_cams.append(select(cams, vi[v0:v0 + vloc]))

    def reprobe(gg):
        probe_gs_schedule(sched, mesh, grid, gg, probe_cams, views=vb,
                          assign_impl=assign["impl"],
                          assign_budget=assign["budget"],
                          exchange=cfg.exchange)

    def reprobe_exchange(gg):
        # a pinned budget is never re-probed
        if ex is not None and not ex_pinned:
            probe_gs_exchange(ex, mesh, grid, gg, probe_cams, views=vb,
                              per_edge=ex_per_edge)

    probe_assign(g)
    if sched is not None and sched.tier_caps is None:
        reprobe(g)
    if ex is not None and ex.budget is None:
        # a resume restored the budget: no probe
        probe_gs_exchange(ex, mesh, grid, g, probe_cams, views=vb,
                          per_edge=ex_per_edge)

    step_cache = {}
    ex_demand = None        # running max of the steps' in-step demand

    def get_step():
        spec = ((sched.k_tiers, sched.tier_caps) if sched else None,
                assign["impl"], assign["budget"],
                ex.budget_key() if ex else None)
        if spec not in step_cache:
            step_cache[spec] = make_gs_train_step(
                mesh, cfg, grid, extent, impl=impl, views=vb,
                k_tiers=sched.k_tiers if sched else None,
                tier_caps=sched.tier_caps if sched else None,
                return_overflow=True, win_size=win_size,
                assign_impl=assign["impl"], assign_budget=assign["budget"],
                exchange=cfg.exchange,
                exchange_budget=ex.budget if ex else None)
        return step_cache[spec]

    def save(step_no, gg, oo, ee):
        tree = gather_partitions(state_tree(gg, oo, ee), mesh)
        if rank0:
            ckpt.save(step_no, tree,
                      extra={"schedule": sched.state_dict() if sched
                             else None,
                             "exchange": ex.state_dict() if ex else None,
                             "dtype_policy": cfg.dtype_policy,
                             "grad_compress": cfg.grad_compress,
                             "tile_split": split})
        dist.barrier()

    def densify(gg, oo):
        gg_all, oo_all = gather_partitions((gg, oo), mesh)
        eps_all = None if noise is None else next(noise)
        outs = [densify_and_prune(
            *_partition((gg_all, oo_all), p), generator, dcfg, extent,
            eps=None if eps_all is None else eps_all[p]) for p in range(Pn)]
        return gs_shard_state(_stack_partitions(outs), mesh)

    for i in range(start, steps):
        with spans.span("train.step", i):
            t_step = time.perf_counter()
            with spans.span("train.batch"):
                vi = (i * vb + torch.arange(vb, device=dev)) % V
                vi = vi[v0:v0 + vloc]
                batch = {"gt_tiles": gt_tiles[vi],
                         "mask_tiles": mask_tiles[vi],
                         "cam": select(cams, vi)}
            if compress == "none":
                g, opt, loss, ov = get_step()(g, opt, batch)
            else:
                g, opt, err, loss, ov = get_step()(g, opt, err, batch)
            with spans.span("train.readback"):
                losses.append(float(loss))
            if step_times is not None:
                step_times.append(time.perf_counter() - t_step)
            with spans.span("train.schedule"):
                if sched is not None:
                    # a positive (all-reduced) counter grows the caps for
                    # the next steps: a one-step blip, never a persistent
                    # truncation
                    sched.note_overflow(ov["tiles"], m_dev)
                if assign["impl"] == "sorted" and int(ov["assign"]) > 0:
                    assign["budget"] = grow_tile_budget(
                        assign["budget"] or DEFAULT_TILE_BUDGET, grid.n_tiles)
                if ex is not None:
                    # a matrix budget grows only its starved edges
                    ex.note_overflow(as_numpy(ov.get("exchange_edges",
                                                     ov["exchange"])), Nl)
                    if "exchange_demand" in ov:
                        dm = as_numpy(ov["exchange_demand"])
                        ex_demand = dm if ex_demand is None \
                            else np.maximum(ex_demand, dm)
        if densify_at(i):
            g, opt = densify(g, opt)
            err = zero_err(g, compress)   # rows moved: the residual is stale
            probe_assign(g)
            if sched is not None:
                reprobe(g)
            if ex is not None and not ex_pinned and ex_demand is not None:
                # densify adds at most cfg.max_new rows a partition: the
                # running demand + max_new bounds every edge after it
                ex.ensure(ex_demand + cfg.max_new, Nl)
            else:
                reprobe_exchange(g)
        if rebalance_every and (i + 1) % rebalance_every == 0:
            # the skew from the gathered mask; the state only when it moves
            perm = _deal_rows(as_numpy(gather_partitions(g.active, mesh)),
                              n_data, rebalance_threshold)
            if perm is not None:
                g, opt = gs_shard_state(_permute_rows(
                    gather_partitions((g, opt), mesh), perm), mesh)
                err = zero_err(g, compress)  # rows moved across shards
                # the demand history describes no edge any more
                ex_demand = None
                reprobe_exchange(g)
        if ckpt is not None and ckpt_every and (i + 1) % ckpt_every == 0 \
                and (i + 1) < steps:
            save(i + 1, g, opt, err)
        if log_every and (i + 1) % log_every == 0 and rank0:
            print(f"  step {i+1:5d}  loss {losses[-1]:.4f}  "
                  f"schedule {sched if sched else 'dense'}", flush=True)
    if ckpt is not None and steps > start:
        save(steps, g, opt, err)
    return g, opt, losses


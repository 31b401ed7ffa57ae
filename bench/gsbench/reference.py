"""The plain reference the benchmark holds the program's output against.

Plain PyTorch and numpy, float32, with no kernel, no cache, no batching
and nothing of the program: the 3D Gaussian-splatting arithmetic written
out from its description (3D-GS, Kerbl et al. 2023, as the paper's trainer
uses it), with the repository's conventions frozen here:

- cameras: a Fibonacci-spiral orbit looking at the scene centre, 50 degree
  field of view, +z forward (``orbit_views``); serving snaps a pose to a
  lattice of 1/1024 (``snap_pose``);
- initial splats: one per point, isotropic scale (bbox volume / n)^(1/3),
  identity rotation, the given opacity, logit colours (``init_splats``);
- partitions: a quantile grid over the points, ghost copies within
  ``ghost_width`` of a neighbour's slab, each block Morton-ordered
  (``partition``);
- projection: EWA with a 0.3 px dilation, radius ceil(3 sqrt(lambda_max)),
  culled off-screen, behind the 0.05 near plane, at alpha <= 1/255 or a
  degenerate covariance (``project``);
- assignment: each tile keeps its K front-most splats whose circle meets
  the tile's rectangle, depth ascending then splat index (``tile_tables``;
  a sort over the splat-tile pairs, not the program's sweep or scatter);
- compositing: front to back with alpha clamped at 0.99, alphas under
  1/255 skipped, no early stop (``composite``, vectorised over K);
- loss: 0.8 masked L1 + 0.2 masked D-SSIM with 7-wide windows inside each
  8x16 tile, over every partition's tiles together (``tile_loss``);
- Adam with per-group rates, eps 1e-15 (``adam``).

``precision="tf32"`` computes every matrix product and convolution with
its operands rounded to TF32 (10-bit mantissa), as the tensor cores do:
the control that a correct check has to fail.  The default is float32
with TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEAR = 0.05
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
DILATE = 0.3
FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (10-bit mantissa,
    ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Precision:
    """The arithmetic of matrix products and convolutions: "f32" (TF32
    off) or "tf32" (operands rounded to TF32, the control)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def op(self, x):
        """``x`` at this precision; gradients pass through unrounded."""
        if self.name != "tf32":
            return x
        return x + (to_tf32(x.detach()) - x).detach()

    def matmul(self, a, b):
        return torch.matmul(self.op(a), self.op(b))

    def conv2d(self, x, w, **kw):
        return F.conv2d(self.op(x), self.op(w), **kw)

    @contextlib.contextmanager
    def backend_flags(self):
        """cuBLAS / cuDNN TF32 switches set to this precision for the
        duration (restored after)."""
        want = self.name == "tf32"
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = want
        torch.backends.cudnn.allow_tf32 = want
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def look_at(eye, center, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World -> camera (4, 4) float64; the camera looks down +z."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    if np.linalg.norm(s) < 1e-8:
        s = np.cross(f, np.array([1.0, 0.0, 0.0]))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, -f @ eye
    return m


def focal_for(width: int, fov_deg: float = 50.0) -> float:
    return float(np.float32(0.5 * width / np.tan(np.radians(fov_deg) / 2)))


def orbit_views(n: int, center, radius: float) -> np.ndarray:
    """The training rig: n Fibonacci-spiral eyes at ``radius`` round
    ``center`` -> (n, 4, 4) float32 view matrices."""
    center = np.asarray(center, np.float64)
    golden = (1 + 5 ** 0.5) / 2
    out = []
    for i in range(n):
        z = 0.95 * (2 * (i + 0.5) / n - 1)
        r = np.sqrt(max(1 - z * z, 1e-9))
        phi = 2 * np.pi * i / golden
        eye = center + radius * np.array([r * np.cos(phi), r * np.sin(phi),
                                          z])
        out.append(look_at(eye, center))
    return np.stack(out).astype(np.float32)


def snap_pose(view, fx: float, fy: float, bins: float = 1024.0):
    """A pose snapped to the serving lattice -> (view (4, 4) float32, fx,
    fy float32)."""
    v = np.asarray(view, np.float64).reshape(4, 4)
    qv = np.rint(v * bins)
    qf = np.rint(np.asarray([fx, fy], np.float64) * (bins / 1024.0))
    f = (qf * (1024.0 / bins)).astype(np.float32)
    return (qv / bins).astype(np.float32), f[0], f[1]


# ---------------------------------------------------------------------------
# partitions and initial splats
# ---------------------------------------------------------------------------


def _spread(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        v = (v | (v << np.uint64(shift))) & np.uint64(mask)
    return v


def morton_order(points: np.ndarray) -> np.ndarray:
    """Stable argsort of 21-bit-per-axis Z-order codes over the bbox."""
    p = np.asarray(points, np.float64)
    if len(p) == 0:
        return np.zeros((0,), np.int64)
    lo = p.min(0)
    span = np.maximum(p.max(0) - lo, 1e-12)
    top = (1 << 21) - 1
    q = np.minimum((p - lo) / span * top, top).astype(np.uint64)
    code = (_spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1))
            | (_spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def _grid3(n: int):
    best, cost = (n, 1, 1), float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        for b in range(1, n // a + 1):
            if (n // a) % b:
                continue
            c = n // a // b
            k = max(a, b, c) / min(a, b, c)
            if k < cost:
                best, cost = (a, b, c), k
    return best


def partition(points: np.ndarray, n_parts: int, ghost_width: float):
    """Quantile-grid partitions with ghost copies -> a list of (row indices
    into ``points`` (owned, then ghosts, each block Morton-ordered), owner
    partition of each row, number owned)."""
    points = np.asarray(points, np.float32)
    grid = _grid3(n_parts)
    edges = []
    for ax, g in enumerate(grid):
        qs = np.quantile(points[:, ax], np.linspace(0, 1, g + 1))
        qs[0] -= 1e-6
        qs[-1] += 1e-6
        for i in range(1, len(qs)):
            qs[i] = max(qs[i], qs[i - 1] + 1e-9)
        edges.append(qs)
    coords, near_lo, near_hi = [], [], []
    for ax, g in enumerate(grid):
        e = edges[ax]
        c = np.clip(np.searchsorted(e[1:-1], points[:, ax], side="right"),
                    0, g - 1)
        coords.append(c)
        near_lo.append((points[:, ax] - e[c] < ghost_width) & (c > 0))
        near_hi.append((e[c + 1] - points[:, ax] < ghost_width)
                       & (c < g - 1))
    gx, gy, _ = grid
    ids = coords[0] + coords[1] * gx + coords[2] * gx * gy
    ghosts = [[] for _ in range(n_parts)]
    for d in np.ndindex(3, 3, 3):
        off = [x - 1 for x in d]
        if off == [0, 0, 0]:
            continue
        m = np.ones(len(points), bool)
        for ax, o in enumerate(off):
            if o == -1:
                m &= near_lo[ax]
            elif o == 1:
                m &= near_hi[ax]
        if not m.any():
            continue
        nb = ((coords[0] + off[0]) + (coords[1] + off[1]) * gx
              + (coords[2] + off[2]) * gx * gy)
        for p in np.unique(nb[m]):
            ghosts[int(p)].append(np.nonzero(m & (nb == p))[0])
    out = []
    for p in range(n_parts):
        own = np.nonzero(ids == p)[0]
        gh = (np.unique(np.concatenate(ghosts[p])) if ghosts[p]
              else np.zeros((0,), np.int64))
        gh = gh[ids[gh] != p]
        own = own[morton_order(points[own])]
        gh = gh[morton_order(points[gh])]
        rows = np.concatenate([own, gh])
        out.append((rows, ids[rows].astype(np.int32), len(own)))
    return out


def init_splats(points: torch.Tensor, colors: torch.Tensor, capacity: int,
                opacity: float) -> Dict[str, torch.Tensor]:
    """One splat per point in a buffer of ``capacity`` rows (pad rows zero
    and inactive): the five trained fields and ``active``."""
    n = points.shape[0]
    dev = points.device
    f32 = dict(dtype=torch.float32, device=dev)
    bbox = points.max(0).values - points.min(0).values
    scale = torch.clamp(torch.prod(bbox), min=1e-12) / max(n, 1)
    scale = scale ** (1.0 / 3.0)
    pad = capacity - n

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    c = torch.clamp(colors.to(torch.float32), 1e-4, 1 - 1e-4)
    return {
        "means": padded(points.to(torch.float32)),
        "log_scales": torch.log(scale).expand(capacity, 3).clone(),
        "quats": torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(capacity, 1),
        "opacity_logit": torch.log(torch.tensor(opacity / (1 - opacity),
                                                **f32)).expand(capacity)
        .clone(),
        "colors": padded(torch.log(c / (1 - c))),
        "active": torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                             torch.zeros(pad, dtype=torch.bool, device=dev)]),
    }


# ---------------------------------------------------------------------------
# projection, assignment, compositing
# ---------------------------------------------------------------------------


def _rotations(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(s: Dict[str, torch.Tensor], view: torch.Tensor, focal: float,
            width: int, height: int, prec: Precision):
    """Splats seen by one camera -> dict of (N,) / (N, k) tensors: ``feat``
    (N, 9) [u, v, conic a, b, c, r, g, b, alpha], ``radius``, ``depth``,
    ``valid``."""
    R = view[:3, :3]
    t = view[:3, 3]
    p = prec.matmul(s["means"], R.T) + t
    x, y, z = p.unbind(-1)
    zc = torch.clamp(z, min=NEAR)
    u = focal * x / zc + width / 2.0
    v = focal * y / zc + height / 2.0
    zero = torch.zeros_like(zc)
    J = torch.stack([torch.stack([focal / zc, zero, -focal * x / (zc * zc)],
                                 -1),
                     torch.stack([zero, focal / zc, -focal * y / (zc * zc)],
                                 -1)], -2)
    Rq = _rotations(s["quats"])
    RS = Rq * torch.exp(s["log_scales"])[..., None, :]
    cov3 = prec.matmul(RS, RS.transpose(-1, -2))
    T = prec.matmul(J, R)
    cov2 = prec.matmul(prec.matmul(T, cov3), T.transpose(-1, -2))
    a = cov2[..., 0, 0] + DILATE
    b = cov2[..., 0, 1]
    c = cov2[..., 1, 1] + DILATE
    det = a * c - b * b
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=1e-9))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=1e-9)))
    alpha = torch.sigmoid(s["opacity_logit"])
    rgb = torch.sigmoid(s["colors"])
    valid = ((z > NEAR) & (u + radius > 0) & (u - radius < width)
             & (v + radius > 0) & (v - radius < height) & s["active"]
             & (alpha > ALPHA_MIN) & (det > 1e-12))
    dc = torch.clamp(det, min=1e-12)
    feat = torch.cat([torch.stack([u, v, c / dc, -b / dc, a / dc], -1), rgb,
                      torch.where(valid, alpha, 0.0)[:, None]], -1)
    return {"feat": feat, "radius": radius.detach(), "depth": z.detach(),
            "valid": valid}


def tile_tables(u, v, radius, depth, valid, *, width: int, height: int,
                tile_h: int, tile_w: int, K: int):
    """The K front-most splats of each tile -> (idx (T, K) int64, live
    (T, K) bool), tiles row-major.  Every (splat, tile) pair of the splat's
    bounding rows and columns is tested (circle against the tile's
    rectangle), the hits sorted by (tile, depth, splat index)."""
    dev = u.device
    nx, ny = -(-width // tile_w), -(-height // tile_h)
    T = nx * ny
    ids = torch.nonzero(valid).squeeze(1)
    u, v, r, d = u[ids], v[ids], radius[ids], depth[ids]
    x0 = torch.clamp(torch.ceil((u - r) / tile_w).long() - 1, 0, nx - 1)
    x1 = torch.clamp(torch.floor((u + r) / tile_w).long(), 0, nx - 1)
    y0 = torch.clamp(torch.ceil((v - r) / tile_h).long() - 1, 0, ny - 1)
    y1 = torch.clamp(torch.floor((v + r) / tile_h).long(), 0, ny - 1)
    bw = x1 - x0 + 1
    cnt = bw * (y1 - y0 + 1)
    owner = torch.repeat_interleave(torch.arange(len(ids), device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(owner.shape[0], device=dev) - first[owner]
    tx = x0[owner] + off % bw[owner]
    ty = y0[owner] + off // bw[owner]
    lox = (tx * tile_w).to(torch.float32)
    loy = (ty * tile_h).to(torch.float32)
    dx = u[owner] - torch.clamp(u[owner], lox, lox + tile_w)
    dy = v[owner] - torch.clamp(v[owner], loy, loy + tile_h)
    hit = dx * dx + dy * dy <= (r * r)[owner]
    owner, tile = owner[hit], (ty * nx + tx)[hit]
    # rank of each splat in (depth, index) order; ids ascend already
    order = torch.sort(d, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev)
    key = tile * len(ids) + rank[owner]
    key, perm = torch.sort(key)
    owner, tile = owner[perm], tile[perm]
    start = torch.searchsorted(key, torch.arange(T, device=dev) * len(ids))
    slot = torch.arange(key.shape[0], device=dev) - start[tile]
    keep = slot < K
    idx = torch.zeros((T, K), dtype=torch.int64, device=dev)
    live = torch.zeros((T, K), dtype=torch.bool, device=dev)
    idx[tile[keep], slot[keep]] = ids[owner[keep]]
    live[tile[keep], slot[keep]] = True
    return idx, live


def composite(feats, *, width: int, height: int, tile_h: int, tile_w: int):
    """Per-tile splat lists (T, K, 9), front first, empty rows at alpha 0
    -> (T, 4, th, tw) [r, g, b, coverage], premultiplied."""
    T = feats.shape[0]
    nx = -(-width // tile_w)
    dev = feats.device
    t = torch.arange(T, device=dev)
    ox = ((t % nx) * tile_w).to(torch.float32)
    oy = ((t // nx) * tile_h).to(torch.float32)
    px = ox[:, None, None, None] + (torch.arange(tile_w, device=dev) + 0.5)
    py = oy[:, None, None, None] + (torch.arange(tile_h, device=dev)
                                    + 0.5)[:, None]
    f = feats[:, :, None, None, :]                     # (T, K, 1, 1, 9)
    dx = px - f[..., 0]
    dy = py - f[..., 1]
    sig = 0.5 * (f[..., 2] * dx * dx + f[..., 4] * dy * dy) \
        + f[..., 3] * dx * dy
    a = torch.clamp(f[..., 8] * torch.exp(-torch.clamp(sig, min=0.0)),
                    max=ALPHA_MAX)
    a = torch.where(a >= ALPHA_MIN, a, 0.0)            # (T, K, th, tw)
    keep = 1.0 - a
    trans = torch.cat([torch.ones_like(keep[:, :1]),
                       torch.cumprod(keep, 1)[:, :-1]], 1)
    w = trans * a
    rgb = (w[:, :, None] * feats[:, :, 5:8, None, None]).sum(1)
    cov = 1.0 - torch.prod(keep, 1)
    return torch.cat([rgb, cov[:, None]], 1)


def render_tiles(s, view, focal, *, width, height, tile_h, tile_w, K,
                 prec: Precision):
    """One camera's (T, 4, th, tw) tiles of splats ``s``."""
    pr = project(s, view, focal, width, height, prec)
    with torch.no_grad():
        idx, live = tile_tables(pr["feat"][:, 0], pr["feat"][:, 1],
                                pr["radius"], pr["depth"], pr["valid"],
                                width=width, height=height, tile_h=tile_h,
                                tile_w=tile_w, K=K)
    f = pr["feat"][idx]
    f = torch.cat([f[..., :8], torch.where(live, f[..., 8], 0.0)[..., None]],
                  -1)
    return composite(f, width=width, height=height, tile_h=tile_h,
                     tile_w=tile_w)


def untile(tiles, *, width: int, height: int):
    """(T, C, th, tw) row-major tiles -> (H, W, C)."""
    _, C, th, tw = tiles.shape
    nx, ny = -(-width // tw), -(-height // th)
    img = tiles.reshape(ny, nx, C, th, tw).permute(0, 3, 1, 4, 2)
    return img.reshape(ny * th, nx * tw, C)[:height, :width]


def tile(img, *, tile_h: int, tile_w: int):
    """(H, W, C) -> (T, C, th, tw) row-major tiles (zero past the edge)."""
    H, W, C = img.shape
    nx, ny = -(-W // tile_w), -(-H // tile_h)
    img = F.pad(img, (0, 0, 0, nx * tile_w - W, 0, ny * tile_h - H))
    t = img.reshape(ny, tile_h, nx, tile_w, C).permute(0, 2, 4, 1, 3)
    return t.reshape(ny * nx, C, tile_h, tile_w)


def coverage_mask(cov, prec: Precision):
    """(H, W) coverage -> the training mask: > 1/255, dilated twice by a
    3x3 square."""
    m = (cov > 1.0 / 255.0).to(torch.float32)[None, None]
    k = torch.ones((1, 1, 3, 3), dtype=torch.float32, device=m.device)
    for _ in range(2):
        m = torch.clamp(prec.conv2d(m, k, padding=1), max=1.0)
    return m[0, 0] > 0.5


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------


def _window(size: int = 7, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def tile_loss(pred, gt, mask, prec: Precision, *, lam: float = 0.2,
              win: int = 7):
    """pred / gt (T, 3, th, tw), mask (T, th, tw) bool -> the masked L1 +
    D-SSIM loss, SSIM windows zero-padded at every tile edge."""
    a, b = pred, gt
    m = mask.to(torch.float32)
    T, C, th, tw = a.shape
    l1 = ((a - b).abs() * m[:, None]).sum() / torch.clamp(m.sum() * C,
                                                          min=1.0)
    w = _window(win, device=a.device)[None, None]

    def filt(x):
        return prec.conv2d(x.reshape(T * C, 1, th, tw), w,
                           padding=win // 2).reshape(T, C, th, tw)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = filt(a), filt(b)
    s_aa = filt(a * a) - mu_a * mu_a
    s_bb = filt(b * b) - mu_b * mu_b
    s_ab = filt(a * b) - mu_a * mu_b
    ssim = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (s_aa + s_bb + c2))
    ss = (ssim * m[:, None]).sum() / torch.clamp(m.sum() * C, min=1.0)
    return (1.0 - lam) * l1 + lam * (1.0 - ss) / 2.0


def group_lrs(extent: float) -> Dict[str, float]:
    return {"means": 1.6e-4 * extent, "log_scales": 5e-3, "quats": 1e-3,
            "opacity_logit": 5e-2, "colors": 2.5e-3}


def adam(params, grads, m, v, step: int, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step (bias-corrected) on dicts of tensors -> (params, m, v)."""
    dev = next(iter(params.values())).device
    t = torch.tensor(float(step), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), t)
    out_p, out_m, out_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mk = b1 * m[k] + (1 - b1) * g
        vk = b2 * v[k] + (1 - b2) * g * g
        out_p[k] = p - lrs[k] * ((mk / bc1) / (torch.sqrt(vk / bc2) + eps))
        out_m[k], out_v[k] = mk, vk
    return out_p, out_m, out_v


# ---------------------------------------------------------------------------
# whole renders and training steps
# ---------------------------------------------------------------------------


def render_image(s, view, focal, *, width, height, tile_h, tile_w, K, bg,
                 prec: Precision):
    """-> (rgb (H, W, 3) over background ``bg``, coverage (H, W))."""
    with torch.no_grad():
        tiles = render_tiles(s, view, focal, width=width, height=height,
                             tile_h=tile_h, tile_w=tile_w, K=K, prec=prec)
        img = untile(tiles, width=width, height=height)
    cov = img[..., 3]
    return img[..., :3] + (1.0 - cov[..., None]) * bg, cov


def train_steps(parts: List[Dict[str, torch.Tensor]], views, focal, gts,
                masks, *, steps: int, width, height, tile_h, tile_w, K,
                extent: float, prec: Precision, opt=None):
    """``steps`` Adam steps of every partition together, step i on camera
    ``views[i]`` with targets ``gts[i]`` (P, H, W, 3) and masks ``masks[i]``
    (P, H, W) -> (losses, the first step's gradients, the final trained
    fields), each dict of (P, N, ...) tensors stacked over partitions.
    ``opt=(m, v, done)`` continues an Adam run that has taken ``done``
    steps (moments as (P, N, ...) dicts); the default starts one."""
    lrs = group_lrs(extent)
    params = {k: torch.stack([p[k] for p in parts]) for k in FIELDS}
    active = torch.stack([p["active"] for p in parts])
    if opt is None:
        m = {k: torch.zeros_like(x) for k, x in params.items()}
        v = {k: torch.zeros_like(x) for k, x in params.items()}
        done = 0
    else:
        m, v, done = opt
    losses, first = [], None
    P = active.shape[0]
    for i in range(steps):
        leaves = {k: x.detach().requires_grad_(True)
                  for k, x in params.items()}
        with torch.enable_grad():
            preds = [render_tiles(
                {**{k: leaves[k][p] for k in FIELDS}, "active": active[p]},
                views[i], focal, width=width, height=height, tile_h=tile_h,
                tile_w=tile_w, K=K, prec=prec)[:, :3] for p in range(P)]
            gt_t = torch.cat([tile(gts[i][p], tile_h=tile_h, tile_w=tile_w)
                              for p in range(P)])
            m_t = torch.cat([tile(masks[i][p][..., None].to(torch.float32),
                                  tile_h=tile_h, tile_w=tile_w)[:, 0] > 0.5
                             for p in range(P)])
            loss = tile_loss(torch.cat(preds), gt_t, m_t, prec)
            got = torch.autograd.grad(loss, [leaves[k] for k in FIELDS])
        grads = dict(zip(FIELDS, got))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            params, m, v = adam(params, grads, m, v, done + i + 1, lrs)
        losses.append(float(loss.detach()))
    return losses, first, params


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None):
    """By leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's -> (worst gap, {leaf:
    gap})."""
    keep = list(ref) if keep is None else keep
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    med = float(np.median(list(norms.values())))
    gaps = {}
    for k in keep:
        pn = float(torch.linalg.norm(prog[k].double()))
        gaps[k] = abs(pn - norms[k]) / max(norms[k], med, 1e-30)
    return (max(gaps.values()) if gaps else 0.0), gaps


def moved_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: norm at
    least a thousandth of the median leaf's."""
    norms = {k: float(torch.linalg.norm(g.double())) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def image_gap(served: np.ndarray, ref: torch.Tensor) -> float:
    """Mean absolute difference of two (H, W, 3) images."""
    return float((torch.from_numpy(np.asarray(served)).to(ref.device)
                  - ref).abs().mean())

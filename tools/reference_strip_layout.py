"""Hold the JAX reference's distributed forward against its single-device
render when a "pod" shard holds several partitions AND the "model" axis
cuts the tiles (Pl > 1, n_model > 1).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/reference_strip_layout.py

The scene is ``tests/test_distributed.py``'s SCRIPT scene (two partitions
of 256 splats, 32x32, 8x16 tiles, K = 16, one view).  On four forced host
devices it runs ``repro.core.distributed.make_gs_forward(return_tiles=
True)`` on ("pod", "data", "model") meshes 2x1x2 (one partition a pod,
the case the reference's tests run) and 1x1x2 (both partitions on every
device) and prints, for each, the largest tile difference from the
single-device ``render_tiles`` and the loss beside ``tile_l1_dssim_loss``.
The reference cuts the flat (P*T,) tile axis into one contiguous chunk per
(pod, model) device, while each device renders strip ``model_index`` of
each of its partitions: the two agree only when Pl = 1.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.cameras import orbital_rig, select  # noqa: E402
from repro.core.distributed import gs_shardings, make_gs_forward  # noqa: E402
from repro.core.gaussians import from_points  # noqa: E402
from repro.core.masking import tile_l1_dssim_loss  # noqa: E402
from repro.core.render import render_tiles  # noqa: E402
from repro.core.tiling import TileGrid  # noqa: E402
from repro.data.isosurface import point_cloud_for  # noqa: E402


def main():
    N, res, K = 256, 32, 16
    grid = TileGrid(res, res, 8, 16)
    pts, cols = point_cloud_for("sphere_shell", 2 * N)
    g_all = from_points(jnp.asarray(pts[:2 * N]), jnp.asarray(cols[:2 * N]),
                        opacity=0.8)
    parts = [jax.tree.map(lambda x: x[i * N:(i + 1) * N], g_all)
             for i in range(2)]
    g = jax.tree.map(lambda *xs: jnp.stack(xs), *parts)
    cam = select(orbital_rig(2, (0.5, 0.5, 0.5), 1.6, width=res,
                             height=res), 0)
    ref = jnp.concatenate([render_tiles(p, cam, grid, K=K, impl="ref")[0]
                           for p in parts])
    gt = jnp.clip(ref[:, :3] + 0.05, 0, 1)
    mask = jnp.ones((ref.shape[0], grid.tile_h, grid.tile_w), bool)
    ref_loss = float(tile_l1_dssim_loss(ref[:, :3], gt, mask, win_size=7))
    for shape in ((2, 1, 2), (1, 1, 2)):
        devices = np.asarray(jax.devices()[:int(np.prod(shape))])
        mesh = jax.sharding.Mesh(devices.reshape(shape),
                                 ("pod", "data", "model"))
        fwd = make_gs_forward(mesh, grid, K=K, impl="ref", return_tiles=True)
        g_sh = gs_shardings(mesh)[0]
        loss, tiles = jax.jit(fwd)(jax.device_put(g, g_sh), cam, gt, mask)
        err = float(jnp.abs(tiles - ref).max())
        print(f"mesh (pod, data, model) {shape}: Pl = {2 // shape[0]}, "
              f"n_model = {shape[2]}: max |tiles - render_tiles| = {err:.6g}; "
              f"loss {float(loss):.9g} vs tile_l1_dssim_loss {ref_loss:.9g} "
              f"(diff {abs(float(loss) - ref_loss):.3g})", flush=True)


if __name__ == "__main__":
    main()

"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the work, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at the 700 W
limit).  The compositor's counts follow its plain version
(``reference.composite``): 27 operations a splat-pixel forward, 85
backward; bytes are each operand read once and each output written once,
float32 rows of F columns.  A step's count adds projection, the loss and
Adam, from the cell's shapes alone, so it reads the same work whatever
implements it:

- projection: 280 operations a splat and view forward (the camera
  transform, the Jacobian, the 3x3 covariance from scale and quaternion,
  its 2x2 projection, eigenvalue, radius, sigmoids, cull tests, conic),
  twice that backward;
- compositing: H * W * K splat-pixels a view and partition, K the table
  depth (the most each pixel may blend);
- loss: 1,500 operations a pixel forward (L1 and five 7x7 filtered maps
  of three channels for SSIM), twice that backward;
- Adam: 12 operations a parameter, 14 parameters a splat slot.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3
KERNEL_OPS = {"rasterize_fwd": 27, "rasterize_bwd": 85}
PROJECT_OPS = 280
LOSS_OPS = 1500
ADAM_OPS = 12
PARAMS_PER_SPLAT = 14


def kernel_bound_s(name: str, T: int, K: int, F: int, tile_h: int,
                   tile_w: int) -> float:
    """The least time of one compositor launch over T tiles of K rows:
    operations at the f32 peak or bytes at the memory rate, the longer."""
    ops = KERNEL_OPS[name] * T * K * tile_h * tile_w
    feats, origins = 4 * T * K * F, 4 * T * 2
    planes = 4 * T * 4 * tile_h * tile_w
    if name == "rasterize_fwd":
        n_bytes = feats + origins + planes
    else:
        n_bytes = feats + origins + 2 * planes + feats
    return max(ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S)


def train_step_flops(*, partitions: int, slots: int, views: int,
                     width: int, height: int, K: int) -> float:
    """Operations of one training step: ``views`` views of every one of
    ``partitions`` partitions of ``slots`` splat slots each."""
    px = width * height
    per_view = (slots * PROJECT_OPS * 3
                + px * K * (KERNEL_OPS["rasterize_fwd"]
                            + KERNEL_OPS["rasterize_bwd"])
                + px * LOSS_OPS * 3)
    return partitions * (views * per_view
                         + slots * PARAMS_PER_SPLAT * ADAM_OPS)


def serve_request_flops(*, splats: int, width: int, height: int,
                        K: int) -> float:
    """Operations of one served image: projection of every splat and the
    forward compositor over the image."""
    return (splats * PROJECT_OPS
            + width * height * K * KERNEL_OPS["rasterize_fwd"])

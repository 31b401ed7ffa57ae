"""CUDA EWA projection (forward and backward) for Hopper, bound with ctypes.

Replaces no Pallas kernel: the JAX package leaves the projection to XLA's
fusion.  The sources are ``csrc/project_fwd.cu`` and ``csrc/project_bwd.cu``
(their header notes give the design and what bounds each), which share the
arithmetic of ``csrc/project_math.cuh``.  They are built by
``kernels/rasterize.build`` with the compositor's sources -- every ``nvcc``
process started together, under the same digest and flags -- and loaded
here with ``ctypes``.

``project_fwd`` / ``project_bwd`` take CUDA tensors only; the plain PyTorch
version is ``core/projection.project_ref``, and ``core/projection.project``
picks between them by the tensors' device.  One thread a splat loops over
the views, so one launch covers any (V, N).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import rasterize

#: kernel launches made by ``project_fwd`` / ``project_bwd`` in this process
#: -- one per call that launched the kernel, and nowhere else
PROJECT_LAUNCHES = 0
PROJECT_BWD_LAUNCHES = 0
#: None, or (while ``launch.cost_analysis.analyze`` runs) a list that each
#: launch appends ``(kernel name, V, N)`` to
RECORDER = None

_libs = None


def _bind(paths: dict) -> dict:
    """The built libraries' C entry points, typed for ctypes."""
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    fwd = ctypes.CDLL(str(paths["project_fwd"])).project_fwd_launch
    fwd.argtypes = [ptr] * 13 + [i64, i32] + [f32] * 4 + [ptr]
    fwd.restype = i32
    bwd = ctypes.CDLL(str(paths["project_bwd"])).project_bwd_launch
    bwd.argtypes = [ptr] * 12 + [i64, i32, f32, ptr]
    bwd.restype = i32
    return {"fwd": fwd, "bwd": bwd}


def _load():
    global _libs
    with rasterize._LOCK:
        if _libs is None:
            _libs = _bind(rasterize.build())
        return _libs


def _check(name, device, **tensors):
    """Each tensor on ``device``, float32 (``active`` bool), contiguous, of
    the shape given beside it: {arg: (tensor, shape)}."""
    for arg, (x, shape) in tensors.items():
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{name} runs the CUDA kernel and takes CUDA "
                             f"tensors on one device; {arg} is on {x.device}"
                             f", not {device}")
        want = torch.bool if arg == "active" else torch.float32
        if x.dtype != want:
            raise ValueError(f"{name}: {arg} must be {want}; got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}; got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors ({arg})")


def _views(view) -> int:
    if view.dim() != 3 or tuple(view.shape[1:]) != (4, 4):
        raise ValueError(f"view must be (V, 4, 4); got {tuple(view.shape)}")
    return view.shape[0]


def _count(name: str, V: int, N: int):
    global PROJECT_LAUNCHES, PROJECT_BWD_LAUNCHES
    with rasterize._LOCK:
        if name == "project_fwd":
            PROJECT_LAUNCHES += 1
        else:
            PROJECT_BWD_LAUNCHES += 1
        if RECORDER is not None:
            RECORDER.append((name, V, N))


def project_fwd(means, log_scales, quats, alpha, active, view, fx, fy, *,
                width: int, height: int, near: float, alpha_min: float):
    """means, log_scales (N, 3), quats (N, 4), alpha (N,) float32, active
    (N,) bool, view (V, 4, 4), fx, fy (V,) float32, all contiguous on one
    CUDA device -> (mean2d (V, N, 2), cov2d (V, N, 3), depth (V, N), radius
    (V, N), valid (V, N) bool).  Launches on the current stream; raises on
    any CUDA launch error."""
    N, V = means.shape[0], _views(view)
    dev = means.device
    _check("project_fwd", dev, means=(means, (N, 3)),
           log_scales=(log_scales, (N, 3)), quats=(quats, (N, 4)),
           alpha=(alpha, (N,)), active=(active, (N,)), view=(view, (V, 4, 4)),
           fx=(fx, (V,)), fy=(fy, (V,)))
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((V, N, 2), **f32), torch.empty((V, N, 3), **f32),
           torch.empty((V, N), **f32), torch.empty((V, N), **f32),
           torch.empty((V, N), dtype=torch.bool, device=dev))
    if N == 0 or V == 0:
        return out
    launch = _load()["fwd"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*(x.data_ptr() for x in (means, log_scales, quats, alpha,
                                               active, view, fx, fy) + out),
                     N, V, float(width), float(height), near, alpha_min,
                     stream)
    if err != 0:
        raise RuntimeError(f"project_fwd: CUDA launch failed with error "
                           f"{err}")
    _count("project_fwd", V, N)
    return out


def project_bwd(means, log_scales, quats, view, fx, fy, g_mean2d, g_cov2d,
                g_depth, *, near: float):
    """Gradient of ``project_fwd``'s mean2d, cov2d and depth w.r.t. means,
    log_scales and quats, summed over the views.

    The forward's inputs (as ``project_fwd``) and the cotangents g_mean2d
    (V, N, 2), g_cov2d (V, N, 3), g_depth (V, N), all float32 and contiguous
    on one CUDA device -> (d_means (N, 3), d_log_scales (N, 3), d_quats (N,
    4)).  Launches on the current stream; raises on any CUDA launch error.
    No atomics: repeated calls give identical gradients."""
    N, V = means.shape[0], _views(view)
    dev = means.device
    _check("project_bwd", dev, means=(means, (N, 3)),
           log_scales=(log_scales, (N, 3)), quats=(quats, (N, 4)),
           view=(view, (V, 4, 4)), fx=(fx, (V,)), fy=(fy, (V,)),
           g_mean2d=(g_mean2d, (V, N, 2)), g_cov2d=(g_cov2d, (V, N, 3)),
           g_depth=(g_depth, (V, N)))
    grads = (torch.empty((N, 3), dtype=torch.float32, device=dev),
             torch.empty((N, 3), dtype=torch.float32, device=dev),
             torch.empty((N, 4), dtype=torch.float32, device=dev))
    if N == 0:
        return grads
    launch = _load()["bwd"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*(x.data_ptr() for x in (means, log_scales, quats, view,
                                               fx, fy, g_mean2d, g_cov2d,
                                               g_depth) + grads),
                     N, V, near, stream)
    if err != 0:
        raise RuntimeError(f"project_bwd: CUDA launch failed with error "
                           f"{err}")
    _count("project_bwd", V, N)
    return grads

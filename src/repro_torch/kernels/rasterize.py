"""CUDA tile compositor (forward) for Hopper, bound with ctypes.

Replaces the Pallas TPU kernel ``repro.kernels.rasterize.rasterize_fwd``.
The source is ``csrc/rasterize_fwd.cu`` (its header note gives the design
and what bounds it); it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point at first use, under
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt.

``rasterize_fwd`` takes CUDA tensors only; the plain PyTorch versions live
in ``kernels/ref.py`` and the dispatcher (``kernels/ops.py``) picks between
them by the tensors' device.  The backward kernel (``rasterize_bwd``) is
ported with the training slice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: kernel launches made by ``rasterize_fwd`` in this process — one per
#: call that launched the kernel, and nowhere else
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "rasterize_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_TILE_PIXELS = 1024            # one thread per pixel, one block per tile

_lib = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA rasterizer")


def build(*, verbose: bool = False) -> Path:
    """Compile ``csrc/rasterize_fwd.cu`` (once per source/flags hash) and
    return the shared library's path.  ``verbose`` adds ``-Xptxas -v`` and
    prints the compiler's report (registers, shared memory, spills)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"rasterize_fwd_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rasterize_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def rasterize_fwd(feats, origins, *, tile_h: int, tile_w: int):
    """feats (T, K, F >= 9), origins (T, 2), both on one CUDA device ->
    (T, 4, tile_h, tile_w) float32 [r, g, b, coverage].  Inputs are
    promoted to float32; they must be contiguous.  Launches on the current
    stream; raises on any CUDA launch error."""
    global LAUNCHES
    if not (feats.is_cuda and origins.is_cuda):
        raise ValueError("rasterize_fwd runs the CUDA kernel and takes CUDA "
                         f"tensors; got {feats.device} / {origins.device}")
    if feats.device != origins.device:
        raise ValueError(f"feats on {feats.device}, origins on "
                         f"{origins.device}")
    feats = feats.to(torch.float32)
    origins = origins.to(torch.float32)
    if feats.dim() != 3 or feats.shape[2] < 9:
        raise ValueError(f"feats must be (T, K, F >= 9); got "
                         f"{tuple(feats.shape)}")
    T, K, F = feats.shape
    if tuple(origins.shape) != (T, 2):
        raise ValueError(f"origins must be ({T}, 2); got "
                         f"{tuple(origins.shape)}")
    if not (feats.is_contiguous() and origins.is_contiguous()):
        raise ValueError("rasterize_fwd takes contiguous tensors")
    if not 1 <= tile_h * tile_w <= MAX_TILE_PIXELS:
        raise ValueError(f"tile {tile_h}x{tile_w} needs 1..{MAX_TILE_PIXELS} "
                         "pixels (one thread per pixel)")
    if T >= 2**31:
        raise ValueError(f"{T} tiles exceed the kernel's grid")
    out = torch.empty((T, 4, tile_h, tile_w), dtype=torch.float32,
                      device=feats.device)
    if T == 0:
        return out
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.rasterize_fwd_launch(feats.data_ptr(), origins.data_ptr(),
                                       out.data_ptr(), T, K, F, tile_h,
                                       tile_w, stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return out

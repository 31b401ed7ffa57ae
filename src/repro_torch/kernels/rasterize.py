"""CUDA tile compositor (forward and backward) for Hopper, bound with ctypes.

Replaces the Pallas TPU kernels ``repro.kernels.rasterize.rasterize_fwd``
and ``rasterize_bwd``.  The sources are ``csrc/rasterize_fwd.cu`` and
``csrc/rasterize_bwd.cu`` (their header notes give the design and what
bounds each), which share the alpha arithmetic of ``csrc/alpha_terms.cuh``.
Each is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point at first use -- with the projection's pair
(``kernels/project.py``), all four ``nvcc`` processes started together --
under ``build/repro_torch_kernels/`` at the repository root, and loaded
with ``ctypes``.  A library's file name carries a hash of every file under
``csrc/`` and of the flags, so an edit to any source rebuilds them all.

Both kernels run one block per tile with ``PIXELS_PER_THREAD`` pixels per
thread; ``launch_geometry`` computes the block and its shared memory, and
``slot_pixels`` the pixel each (thread, slot) carries, as
``csrc/tile_layout.cuh`` lays them out (the C entry points refuse any
other layout).  ``hot_loop`` counts the instructions of a built kernel's
inner loop from its SASS, for the issue-rate ceiling.

``rasterize_fwd`` / ``rasterize_bwd`` take CUDA tensors only; the plain
PyTorch versions live in ``kernels/ref.py`` and the dispatcher
(``kernels/ops.py``) picks between them by the tensors' device.  The
build, the first load and the launch counts are guarded by one lock, so
two threads (a training loop and the timeseries ingest worker) may make
their first calls at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

#: kernel launches made by ``rasterize_fwd`` / ``rasterize_bwd`` in this
#: process -- one per call that launched the kernel, and nowhere else
LAUNCHES = 0
BWD_LAUNCHES = 0
#: None, or (while ``launch.cost_analysis.analyze`` runs) a list that each
#: launch appends ``(kernel name, T, K, F, tile_h, tile_w)`` to
RECORDER = None

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source; each builds into its own library.  The
#: projection's pair is bound by ``kernels/project.py``
SOURCES = {"rasterize_fwd": CSRC / "rasterize_fwd.cu",
           "rasterize_bwd": CSRC / "rasterize_bwd.cu",
           "project_fwd": CSRC / "project_fwd.cu",
           "project_bwd": CSRC / "project_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
#: pixels each thread carries (csrc/tile_layout.cuh kPix); a block is
#: whole warps of at most 1024 / 4 = 256 threads, one block per tile
PIXELS_PER_THREAD = 4
MAX_TILE_PIXELS = 1024
#: feature rows staged per shared-memory pass (kChunk of each .cu), the
#: backward's rows per warp reduction (kGroup) and its 32 sums per group
#: (kValues), and the bytes of one staged row (kRowFloats = 12 floats)
FWD_CHUNK = 128
BWD_CHUNK = 96
BWD_GROUP = 3
BWD_VALUES = 32
ROW_BYTES = 48

_libs = None
#: one build / load at a time, and whole count updates
_LOCK = threading.RLock()


class LaunchGeometry(NamedTuple):
    threads: int             # whole warps, <= MAX_TILE_PIXELS / 4
    pixels_per_thread: int
    smem_bytes: int          # dynamic shared memory of one block


def launch_geometry(tile_h: int, tile_w: int, *,
                    backward: bool = False) -> LaunchGeometry:
    """The block of one tile for the forward (or the backward) kernel:
    ceil(th * tw / 4) threads rounded up to whole warps, 4 pixels each, and
    its dynamic shared memory (the staged rows; the backward adds one slot
    per warp, row group and value).  Above 48 KB the C entry points raise
    the kernel's dynamic shared-memory limit to it."""
    npix = tile_h * tile_w
    if not (tile_h >= 1 and tile_w >= 1 and npix <= MAX_TILE_PIXELS):
        raise ValueError(f"tile {tile_h}x{tile_w} needs 1..{MAX_TILE_PIXELS} "
                         f"pixels ({PIXELS_PER_THREAD} per thread, at most "
                         f"{MAX_TILE_PIXELS // PIXELS_PER_THREAD} threads)")
    threads = -(-npix // PIXELS_PER_THREAD)
    threads = -(-threads // 32) * 32
    if backward:
        slots = (threads // 32) * (BWD_CHUNK // BWD_GROUP) * BWD_VALUES
        smem = BWD_CHUNK * ROW_BYTES + 4 * slots
    else:
        smem = FWD_CHUNK * ROW_BYTES
    return LaunchGeometry(threads, PIXELS_PER_THREAD, smem)


def slot_pixels(tile_h: int, tile_w: int) -> torch.Tensor:
    """(threads, pixels_per_thread) int64: the row-major pixel that thread
    t carries in slot s, ``s * threads + t`` (the kernels' rule), or -1
    where that slot is idle."""
    threads, ppt, _ = launch_geometry(tile_h, tile_w)
    p = torch.arange(ppt)[None, :] * threads + torch.arange(threads)[:, None]
    return torch.where(p < tile_h * tile_w, p, -1)


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


def _digest() -> str:
    """Hash of every file under csrc/ (names and bytes) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.rglob("*")):
        if f.is_file():
            h.update(f.relative_to(CSRC).as_posix().encode() + b"\0")
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(*, verbose: bool = False) -> dict:
    """Compile each kernel source (once per csrc/ + flags hash), all
    ``nvcc`` processes started together, and return {name: library path}.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills)."""
    with _LOCK:
        return _build(verbose)


def _build(verbose: bool) -> dict:
    digest = _digest()
    libs = {name: BUILD_DIR / f"{name}_{digest}.so" for name in SOURCES}
    todo = [n for n, lib in libs.items() if verbose or not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = libs[name].with_name(f"{libs[name].name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
            continue
        if verbose:
            print(text, end="")
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def sass(name: str) -> str:
    """``cuobjdump -sass`` of kernel ``name``'s built library (the
    toolkit's ``cuobjdump``, beside ``nvcc``)."""
    lib = build()[name]
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                         r"([^;]*);")


def hot_loop(sass_text: str, function: str) -> dict:
    """The innermost loop of the SASS function whose (mangled) name holds
    ``function`` that issues a ``MUFU.EX2`` -- each splat-pixel's one
    ``expf`` -- as instruction counts: every instruction between a
    backward branch (``BRA 0x...``, as ``cuobjdump`` prints it) and its
    target once.  ``per_splat_pixel`` is the instructions over the EX2s,
    what one pixel's step over one row costs a thread, row loads, loop
    overhead and warp reductions included."""
    body, name = [], None
    for line in sass_text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            continue
        m = _SASS_INSTR.search(line)
        if m and name is not None and function in name:
            body.append((int(m.group(1), 16), m.group(3), m.group(4)))
    if not body:
        raise ValueError(f"no SASS function matching {function!r}")
    loops = []
    for addr, op, args in body:
        to = re.search(r"0x([0-9a-f]+)", args)
        if op.split(".")[0] == "BRA" and to and int(to.group(1), 16) <= addr:
            ops = [o for a, o, _ in body if int(to.group(1), 16) <= a <= addr]
            if "MUFU.EX2" in ops:
                loops.append(ops)
    if not loops:
        raise ValueError(f"{function}: no loop issues MUFU.EX2")
    ops = min(loops, key=len)
    count = {"instructions": len(ops), "ex2": ops.count("MUFU.EX2")}
    for prefix in ("SHFL", "MUFU", "LDS", "BRA", "FFMA", "FMUL", "FADD"):
        count[prefix.lower()] = sum(o.split(".")[0] == prefix for o in ops)
    count["per_splat_pixel"] = count["instructions"] / count["ex2"]
    return count


def _bind(paths: dict) -> dict:
    """The built libraries' C entry points, typed for ctypes."""
    fwd = ctypes.CDLL(str(paths["rasterize_fwd"])).rasterize_fwd_launch
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = ctypes.CDLL(str(paths["rasterize_bwd"])).rasterize_bwd_launch
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return {"fwd": fwd, "bwd": bwd}


def _load():
    global _libs
    with _LOCK:
        if _libs is None:
            _libs = _bind(build())
        return _libs


def _check_tiles(name, feats, origins, tile_h, tile_w):
    """Shared input checks -> (feats, origins) as float32, (T, K, F)."""
    if not (feats.is_cuda and origins.is_cuda):
        raise ValueError(f"{name} runs the CUDA kernel and takes CUDA "
                         f"tensors; got {feats.device} / {origins.device}")
    if feats.device != origins.device:
        raise ValueError(f"feats on {feats.device}, origins on "
                         f"{origins.device}")
    feats = feats.to(torch.float32)
    origins = origins.to(torch.float32)
    if feats.dim() != 3 or feats.shape[2] < 9:
        raise ValueError(f"feats must be (T, K, F >= 9); got "
                         f"{tuple(feats.shape)}")
    T = feats.shape[0]
    if tuple(origins.shape) != (T, 2):
        raise ValueError(f"origins must be ({T}, 2); got "
                         f"{tuple(origins.shape)}")
    if not (feats.is_contiguous() and origins.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    launch_geometry(tile_h, tile_w)         # raises on a tile out of range
    if T >= 2**31:
        raise ValueError(f"{T} tiles exceed the kernel's grid")
    return feats, origins, tuple(feats.shape)


def rasterize_fwd(feats, origins, *, tile_h: int, tile_w: int):
    """feats (T, K, F >= 9), origins (T, 2), both on one CUDA device ->
    (T, 4, tile_h, tile_w) float32 [r, g, b, coverage].  Inputs are
    promoted to float32; they must be contiguous.  Launches on the current
    stream; raises on any CUDA launch error."""
    global LAUNCHES
    feats, origins, (T, K, F) = _check_tiles("rasterize_fwd", feats, origins,
                                             tile_h, tile_w)
    out = torch.empty((T, 4, tile_h, tile_w), dtype=torch.float32,
                      device=feats.device)
    if T == 0:
        return out
    launch = _load()["fwd"]
    geometry = launch_geometry(tile_h, tile_w)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = launch(feats.data_ptr(), origins.data_ptr(), out.data_ptr(), T,
                     K, F, tile_h, tile_w, *geometry, stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd: CUDA launch failed with error "
                           f"{err}")
    with _LOCK:
        LAUNCHES += 1
        if RECORDER is not None:
            RECORDER.append(("rasterize_fwd", T, K, F, tile_h, tile_w))
    return out


def rasterize_bwd(feats, origins, out, gout, *, tile_h: int, tile_w: int):
    """Gradient of ``rasterize_fwd``'s output w.r.t. its features.

    feats (T, K, F >= 9), origins (T, 2), the forward's out and its
    cotangent gout (T, 4, tile_h, tile_w), all on one CUDA device ->
    gfeats (T, K, F) float32, columns 9.. exactly 0.  Inputs are promoted
    to float32 and must be contiguous.  Launches on the current stream;
    raises on any CUDA launch error.  The sums run in a fixed order (no
    atomics), so repeated calls give identical gradients."""
    global BWD_LAUNCHES
    feats, origins, (T, K, F) = _check_tiles("rasterize_bwd", feats, origins,
                                             tile_h, tile_w)
    want = (T, 4, tile_h, tile_w)
    planes = []
    for name, x in (("out", out), ("gout", gout)):
        if not x.is_cuda or x.device != feats.device:
            raise ValueError(f"{name} on {x.device}, feats on {feats.device}")
        x = x.to(torch.float32)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}; got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("rasterize_bwd takes contiguous tensors")
        planes.append(x)
    out, gout = planes
    gfeats = torch.empty((T, K, F), dtype=torch.float32, device=feats.device)
    if T == 0 or K == 0:
        return gfeats
    launch = _load()["bwd"]
    geometry = launch_geometry(tile_h, tile_w, backward=True)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = launch(feats.data_ptr(), origins.data_ptr(), out.data_ptr(),
                     gout.data_ptr(), gfeats.data_ptr(), T, K, F, tile_h,
                     tile_w, *geometry, stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd: CUDA launch failed with error "
                           f"{err}")
    with _LOCK:
        BWD_LAUNCHES += 1
        if RECORDER is not None:
            RECORDER.append(("rasterize_bwd", T, K, F, tile_h, tile_w))
    return gfeats

"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates and the script exits nonzero):

1. device    require a CUDA card; print its name and power limit; pin TF32
             off for matmuls and cuDNN.
2. build     compile the four CUDA kernels, ``rasterize_fwd.cu``,
             ``rasterize_bwd.cu``, ``project_fwd.cu`` and ``project_bwd.cu``
             under ``src/repro_torch/kernels/csrc/``, with nvcc (the builds
             run in parallel).
3. kernels   hold each kernel against its plain PyTorch versions on the card
             (tiles 16x16 and 8x128 at K in {1, 16, 64, 256, 300}, and the
             launch layout's edge cases: tiles 1x1, 5x7, 8x16, 32x32 at K
             on the chunk and row-group edges; dead and saturated splats,
             37 tiles): the forward at max abs error <= 1e-5, the backward
             at the reference's saturated-case gate (rtol = atol = 5e-4
             against autograd of the plain forward, and 2e-4 against the
             single-sweep emulation), padding columns and dead slots
             exactly 0, two runs equal; a backward through the dispatcher
             launches ``rasterize_bwd`` once.  Then each kernel's inner
             loop is counted from the built library's SASS (``cuobjdump``)
             for its issue-rate ceiling.
3b. project  the projection pair against the plain version
             (``projection.project_ref``) on the card at the main path's
             shapes, a random cloud of splats in the 1024x1024 rig: 2 x
             2.88M slots at V = 1 (training) and 4M splats at V = 8
             (serving).  Gates: every float field within 1e-6 of its
             magnitude; radius and valid equal wherever the pre-ceil radius
             and the radius box's edges lie 1e-4 (or 1e-6 of their
             magnitude, where that is larger) from the value that flips
             them; the gradients within rtol 1e-5 and 1e-6 of the field's
             largest of autograd of the plain version, two backward calls
             equal.  Printed per shape: each kernel's ms (back-to-back
             launches, and one call) beside its bytes bound and the plain
             version's ms (forward, and autograd's backward).
4. serve     the paper's smallest dataset at full size: the 4,000,000-point
             kingsnake isosurface as a merged splat model, served by
             ``GSRenderServer`` at 1024x1024 with 16x16 tiles (K=64,
             max_batch=8) to a 16-view near/far rig, twice.  The second
             pass must be all cache hits and bit-identical to the first,
             and the kernel must have launched once per dispatch.  A small
             scene served on the card must match the same server on the CPU;
             then the forward kernel's time on the first dispatch's own
             tile features and the time of each stage of that dispatch.
5. train     ``run_pipeline`` on the same 4,000,000-point kingsnake scene:
             two partitions with 3% ghost halos (capacity x 1.3), 1024x1024
             images in 4096 16x16 tiles, the auto tier ladder (8, 32, 64),
             120 steps of one view each over 16 views, densify after steps
             110 and 120 with a tier re-probe after each.  Cut: 16 views of
             the paper's 448, and 120 steps; the model and the images are
             full size.  Every loss finite and falling in each partition,
             the densify events change the live count, tier overflow goes
             through ``note_overflow``, bwd launches == fwd launches > 0
             during training, merged PSNR/SSIM printed.  The same pipeline
             on a small scene on the card and on the CPU must agree.
6. timing    one train step's own tier tables (partition 0's initial model,
             view 0, the first probe's caps): both kernels against their
             plain versions at every tier's K, each with its own bound and
             issue-rate ceiling, the time of each stage of one step, and a
             ``torch.profiler`` trace of three steps (device time by
             kernel, the device's busy share of the window).

7. resume    partition 0 of the train phase's scene (2.88M slots, 2.22M
             live, 1024x1024, 16x16 tiles, K=64, the auto tier ladder):
             ``fit_partition`` for 20 steps saving every 10 (densify after
             steps 10 and 20), uninterrupted; then 10 steps into a second
             checkpoint directory and a resume to 20 from a fresh
             ``TierSchedule``.  The restored state equals the saved one leaf
             for leaf, the saved tier caps come back, the resumed run makes
             no initial probe and one re-probe, both kernels launch on every
             resumed step, and the resumed losses are within 1e-3 relative
             of the uninterrupted run's.  Checkpoint bytes and the seconds
             of each save and restore are printed.
8. train     the training CLI as a user runs it, in-process on a world-1
   CLI       NCCL group: ``launch.train.main(["--gs", "--dataset",
             "kingsnake", "--full", "--parts", "2", "--resolution", "1024",
             "--views", "16", "--steps", "80", "--densify-every", "10",
             "--densify-from", "60", "--ckpt-every", "40", ...])``: the
             paper's distributed trainer, both partitions (2 x 2.88M slots)
             in one ``fit_partitions`` step, 8x16 tiles, K=64, the auto tier
             ladder, one view a step; densify after steps 70 and 80.  Cut:
             16 views of 448 and 80 steps.  bwd launches == fwd
             launches > 0 inside ``fit_partitions``, each partition's share
             of the step loss falls (mean of its first 10 steps against its
             last 10), the last step's overflow counters 0,
             merged PSNR/SSIM finite; both kernels held against their
             plain versions (1e-5 forward, 5e-4 backward) and timed on the
             last step's own 8x16 tier tables; the step time beside
             ``fit_partition``'s one-partition step on the same scene over
             the same 80 steps (medians over all steps and over steps
             20-59, before the first densify).  Then the CLI again with
             ``--ckpt-quantize int8`` on a copy of its last checkpoint: no
             step to run, it merges and writes int8.
9. mesh      the distributed step on a world-1 ("pod", "part", "model",
   axes      "view") 1x1x1x1 NCCL mesh: one train step of the CLI's initial
             state (both partitions, 8x16 tiles, view 0, the schedule probed
             as ``fit_partitions`` probes it) at ``strip_budget`` 1.0 and
             0.9, three times each (step ms printed), and each budget's
             forward: the two budgets' forward losses, tiles and step losses
             agree within 1e-6 (at n_model = 1 the strip is the whole grid
             and 0.9 of the 2.88M slots exceeds the 2.22M live splats), and
             both kernels launch in the steps.
9b. wire    the distributed step's wire options on the same world-1 mesh,
             state, view and probed schedule as phase 9: three chained
             ``make_gs_train_step`` steps from the initial state for each of
             six variants -- f32 tables (the baseline), ``dtype_policy=
             "bf16"``, ``gather_mode="split"``, split + bf16,
             ``grad_compress="bf16"`` and ``grad_compress="int8"`` (the
             residual carried across the steps) -- and each variant's
             forward on the initial state.  Printed: each variant's step ms
             (median), the wire bytes a splat of each table layout (from the
             tables' own dtypes and widths), the forward loss and the tile
             gap (max, mean) against f32, the int8 residual's max.  Gates:
             every loss finite, both kernels launched in every variant's
             steps, the compress variants' forward loss equal to f32's
             within 1e-7 (compression comes after the forward), split's mean
             tile gap <= 2e-3 (its max reported beside the reference's
             5e-2); the bf16 policy, which rounds the splat centres
             themselves, is reported only.
9c. exchange the sparse-overlap exchange on the same world-1 mesh, state,
             view and schedule (probed over the exchange's sub-window
             domain): three chained steps of each of six variants -- the
             all-gather, the exchange unbudgeted, at the probed scalar
             budget and as a 1x1 budget matrix, and ``grad_compress=
             "int8"`` gathered and exchanged.  At world 1 the sub-window is
             the whole strip: every loss equal to its gather twin's within
             1e-6 relative, every exchange counter 0, both kernels launched
             in every variant.  A budget of a quarter of the probed demand
             fires the counter with a finite loss, and ``fit_partitions``
             from it (pinned, 4 steps of view 0) grows it past the demand.  Printed:
             step ms, the rows of each table, the packing's own ms.
9d. time-  the timeseries driver as a user runs it, in-process on a
   series    world-1 NCCL group: ``launch.train.main(["--gs",
             "--timeseries", "--dataset", "kingsnake", "--full", "--parts",
             "2", "--resolution", "1024", "--views", "16", "--timesteps",
             "2", "--dt", "0.1", "--steps", "30", "--densify-every", "10",
             "--densify-from", "20", "--densify-cap", C, ...])`` (8x16
             tiles; C is 256 over the smaller partition's live count), then
             ``--timesteps 3`` in the same directory, which restarts at
             timestep 2 from the delta chain.  Gates: t = 0 cold, every
             later timestep warm with no tier probe before its first step,
             the restart's warm tree equal to the first run's last commit
             leaf for leaf, every loss finite, live splats <= max(C, live
             before) at every densify and a densify event in every
             timestep (so the restart skips the split noise of the events
             before it), both kernels launched, each delta's
             manifest naming its base step and that base's digest.
             Printed: step ms per timestep, each timestep's prep seconds in
             the worker against the main thread's wait in ``get()``, the
             first-step loss warm against cold, full and delta bytes, peak
             memory, the final merged PSNR/SSIM.
9e. coarse  the coarse pre-cull on partition 0 of phase 5's initial state
             (view 0, 16x16 tiles, T = 4096, sb = 4: S = 256): at a budget
             of the largest superblock occupancy (counted) equal to the
             dense sweep on live slots with the counter 0; the auto
             budget's value and counter; ms of the dense sweep, the
             pre-cull at both budgets and the sorted assignment; three
             ``fit_partition`` steps with ``coarse=4, assign_impl="dense"``
             against ``coarse=None`` (losses within 1e-6 when the counter
             stays 0, both kernels launched).  Then ``extract_isosurface``
             on the card on the kingsnake field at t = 0.1 at the full
             dataset's R: its count and points (in order, 1e-7) are the
             host extraction's.
9f. LM      the LM serving path, which renders nothing (both kernels'
   serve     counts, set to 0 before it, must stay 0):
             ``launch.serve.main(["--arch", A, "--batch", "4",
             "--prompt-len", "512", "--gen", "64", "--device", "cuda"])`` at
             two published SPECs with random weights from a seed: qwen1.5-4b
             (40 layers, d_model 2560, 20 heads padded to 32, vocab 151,936
             padded to 153,600; ~4.6B bf16 parameters as stored) and
             mamba2-780m (48 SSD layers, d_model 1536, chunk 256).  Gates:
             every logit finite, every generated id < vocab; printed: prefill
             ms, decode ms a step, tokens/s, peak memory.  In float32 at the
             same widths and depths, prefill's logits at the last prompt
             position against the logits after the prompt is replayed token
             by token through a zero cache (qwen 2 x 192 tokens, two KV
             chunks of 128, the second ragged: within 1e-3 of the largest
             |logit|; mamba2 1 x 512, two SSD chunks: printed with each
             layer's gap, and five of its SSD blocks held alone on the
             prefill's own input, chunked against the recurrence, within
             1e-3 -- see LM_SSD_LAYERS).  The ten
             SMOKE archs in float32: prefill and 3 decode steps on the card
             equal the same code on the CPU within 1e-4.  Not on the path, a
             yardstick: the port's ``flash_attention`` and
             ``F.scaled_dot_product_attention`` on the qwen prefill shape
             (bf16, B 4, S 512, 32 heads of 128, causal), CUDA-event ms.
9g. LM      the LM training path, which renders nothing either (both
   train     kernels' counts, set to 0 before it, must stay 0):
             ``launch.train.main(["--arch", "minicpm-2b", "--batch", "8",
             "--seq", "512", "--kv-chunk", "128", "--steps", "4",
             "--device", "cuda", ...])`` at minicpm-2b's published SPEC (40
             layers, d_model 2304, 36 heads padded to 48 of 64, vocab
             122,753 padded to 122,880, tied embeddings, WSD; 3.0B bf16
             parameters, float32 AdamW moments) with random weights from a
             seed, remat and the recomputing flash backward, and its final
             ~30 GB save.  Gates: every loss and grad norm finite, step 1's
             loss within 2 of ln(vocab), lr_scale 0 at step 1 and positive
             after, every parameter leaf moved; printed: step ms, tokens/s,
             peak memory, save s and bytes.  One train step of the same
             SPEC under flash impl "vjp" and "scan": loss within 1e-4 and
             grad norm within 2e-3 (the reference's bounds), step ms and
             peak of each.  Not on the path, a yardstick: forward + backward
             of vjp, scan and ``F.scaled_dot_product_attention`` at the
             CLI's attention shape (bf16, B 8, S 512, 48 heads of 64,
             causal), CUDA-event ms and peak memory; in f32 vjp against
             scan within 2e-5 / 5e-4.  The ten SMOKE archs' two train steps
             in f32 on the card equal the same code on the CPU within 1e-4
             (metrics, m, v, parameters).  The CLI's resume on the card
             (minicpm-2b SMOKE, 2 steps then 4 against 4): the restored
             tree equal to the saved one bit for bit, the tail losses
             within 1e-3.
9h. serve   the two merged checkpoints the CLI wrote (float32, and int8
   from      cold attributes), served by ``repro_torch.launch.serve_gs.main``
   ckpt      (4 views, 2 near and 2 far; max_batch 8; two passes; few
             views because each cold pass runs the dense assignment sweep,
             ~3.2 s a view at 8x16 tiles, three times with the in-memory
             server's): the repeat pass all hits,
             the float32 checkpoint's images equal to a server built in
             memory on the CLI's final state merged here, the int8
             checkpoint under 0.9x the float32 one on disk and its images
             within 0.02 worst pixel / 0.005 mean of the float32 one's
             wherever both served the same splats; the forward kernel held
             against its plain version (1e-5) and timed on the float32
             run's first cold dispatch (8x16 tiles).
10. tooling ``launch/cost_analysis.py``, ``dryrun.py`` and
             ``profile_cell.py`` against the card.  10a: ``dryrun.main``
             in-process for minicpm-2b and qwen1.5-4b at their SPECs
             (train_4k, prefill_32k, decode_32k) and the dense gs-kingsnake
             cell, on ``meta`` tensors: every record ``ok``, each one's
             roofline terms and ``bound_s`` printed.  10b: phase 9g's step
             (minicpm-2b SPEC, B 8 x 512, kv_chunk 128, flash vjp) analyzed
             on ``meta`` tensors; gate: its ``bound_s`` (FLOPs at the bf16
             peak or compulsory bytes at the HBM rate) <= the device-busy
             time of the step 9g profiled; printed: that share and the
             eager byte count's time against the same device time.  10c
             (run right after phase 6, whose inputs it needs): one step of
             phase 6's 16x16 ``fit_partition`` step on the card under
             ``analyze``; gates: both kernels in ``per_op`` as many times
             as the launch counters rose, ``bound_s`` <= the device-busy
             time a step of phase 6's profile; printed: the share.
11. torch-  the paper's launch, run after phase 9d: the training CLI under
   run       ``python -m torch.distributed.run --standalone
             --nproc-per-node N -m repro_torch.launch.train`` with N =
             min(4, cards), one process a card, each joining one NCCL group
             over ``env://`` (``cuda:LOCAL_RANK``): phase 8's arguments with
             8 steps (no densify event yet), its per-step losses within 1e-3
             of phase 8's first 8; then phase 9d's arguments with one more
             timestep in 9d's directory: the N ranks restart the chain the
             world-1 run committed (at timestep 3) and leave its commits as
             they were; then ``python -m repro_torch.launch.serve_gs`` of
             what it merged, 2 views, two passes (the repeat all hits).
             Every rank of every run launches both kernels.  Printed, from
             the record line the CLI's rank 0 prints: per rank the ingest s
             (the timeseries' prep s in the worker and wait s in
             ``get()``), median step ms, peak GiB and launches; rank 0's
             merge + render + write s and peak after it; PSNR / SSIM;
             checkpoint bytes; the serve's restore s and cold / warm req/s;
             the phase's seconds by run.

Kernel times are CUDA-event times over a run of back-to-back launches per
event pair, divided by the count (``ms``); ``call_ms`` brackets one call,
wrapper and enqueue included.  ``python3 chip_smoke.py --save-inputs DIR``
also saves the timed kernels' inputs (the serving dispatch's tile table and
the train step's tier tables) to ``DIR`` for ``tools/torch_kernel_ab.py``.

Every phase that sets the compositor's launch counters to 0 sets the
projection's too, and reports all four.  On the card each Gaussian-splat
path must have launched ``project_fwd``, a training path ``project_bwd``
at least once a step (and no more often than the forward), a serving path
no ``project_bwd``; the LM paths launch neither pair.

The second-to-last line is the ``{"kernels": [...]}`` record (each kernel's
``launches``: the sum over the Gaussian-splat paths' counts, timing loops
and checks left out; ``lm_serve_launches`` and ``lm_train_launches``: its
launches in phases 9f and 9g); the last line
is ``{"ok": true, "device": {...}}``.  Phase 5 rehearses on the CPU at a
small size with ``train_phase("cpu", tier="cpu", resolution=32, tile=8,
K=16, steps=110, n_views=4)``: one densify event, after the last step (on
a scene of a few thousand splats the 512 children of an event raise the
loss for some steps, so the loss check would see the jump).
"""

import argparse
import contextlib
import dataclasses
import io as io_mod
import json
import math
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.gs_datasets import get_gs_dataset  # noqa: E402
from repro_torch.core import pipeline as pipeline_mod  # noqa: E402
from repro_torch.core import train as train_mod  # noqa: E402
from repro_torch.core.cameras import Camera, concat, orbital_rig  # noqa: E402
from repro_torch.core.cameras import select, stack  # noqa: E402
from repro_torch.core.gaussians import from_points  # noqa: E402
from repro_torch.core import projection as proj_mod  # noqa: E402
from repro_torch.core.projection import Splats2D, project  # noqa: E402
from repro_torch.core.gaussians import Gaussians  # noqa: E402
from repro_torch.core.masking import gs_loss  # noqa: E402
from repro_torch.core.dtypes import cast_tables  # noqa: E402
from repro_torch.core.pipeline import PipelineCfg  # noqa: E402
from repro_torch.core.render import _assign_views  # noqa: E402
from repro_torch.core.render import rasterize_tiles_tiered  # noqa: E402
from repro_torch.core.render import tier_tables  # noqa: E402
from repro_torch.core.render import _composite, assign_tables  # noqa: E402
from repro_torch.core.render import rasterize_batched  # noqa: E402
from repro_torch.core.render import resolve_assignment  # noqa: E402
from repro_torch.core.render import table_features  # noqa: E402
from repro_torch.core.serving import GSRenderServer, ServeCfg  # noqa: E402
from repro_torch.core.tiling import TierSchedule, TileGrid  # noqa: E402
from repro_torch.core.tiling import bin_tiles_by_occupancy  # noqa: E402
from repro_torch.core.tiling import tile_occupancy  # noqa: E402
from repro_torch.core.tiling import gather_features_at  # noqa: E402
from repro_torch.core.train import GSTrainCfg, adam_update  # noqa: E402
from repro_torch.core.train import group_lrs, init_opt  # noqa: E402
from repro_torch.core.tiling import quantize_pose, splat_features  # noqa: E402
from repro_torch.core.tiling import tile_origins, untile_image  # noqa: E402
from repro_torch.data.isosurface import point_cloud_for  # noqa: E402
from repro_torch import as_numpy  # noqa: E402
from repro_torch.kernels import ops, rasterize, ref  # noqa: E402
from repro_torch.kernels import project as project_kernels  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.merge import merge_partitions  # noqa: E402
from repro_torch.launch import serve_gs  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import torchrun as torchrun_mod  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.checkpoint import tree_flatten, tree_map  # noqa: E402
from repro_torch.configs import all_arch_ids, get_smoke, get_spec  # noqa: E402
from repro_torch.launch import serve as serve_lm  # noqa: E402
from repro_torch.models import decoder as lm_dec  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import init_params, make_prefill_step  # noqa: E402
from repro_torch.models import zeros_caches  # noqa: E402
from repro_torch.models import TrainCfg, init_opt_state  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.models import make_train_step  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import KERNEL_OPS, analyze  # noqa: E402
from repro_torch.launch.cost_analysis import project_costs  # noqa: E402
from repro_torch.launch.profile_cell import device_profile  # noqa: E402
from repro_torch.models import opt_state_specs, param_specs  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
#: cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: operations per splat-pixel of the algorithm, as the plain version writes
#: it (the notes in rasterize_fwd.cu and rasterize_bwd.cu): the count of
#: work behind each bound, not the instructions a kernel issues (those are
#: counted from SASS for the issue-rate ceiling, ``rasterize.hot_loop``)
OPS_PER_SPLAT_PIXEL = KERNEL_OPS["rasterize_fwd"]
BWD_OPS_PER_SPLAT_PIXEL = KERNEL_OPS["rasterize_bwd"]
#: warp instructions an SM issues per clock (4 schedulers, one each)
ISSUE_PER_CLOCK = 4
TOL = 1e-5
#: backward gates: the reference's saturated-case tolerance against autograd
#: of the plain forward (tests/test_kernel_rasterize.py:145), and its
#: unsaturated one against the single-sweep emulation of the same algorithm
BWD_TOL = 5e-4
BWD_EMUL_TOL = 2e-4
#: the sweeps: the tiles the port uses at K across one and several chunks,
#: and the launch layout's edge cases -- tiles whose pixel count is not a
#: multiple of 32 x 4 or whose threads are not whole columns -- at K on the
#: old and new chunk edges (32; forward 128, backward 96) and row groups (3)
SWEEP = [(th, tw, K) for th, tw in ((16, 16), (8, 128)) for K in (1, 16, 64, 256, 300)]
SWEEP += [
    (th, tw, K)
    for th, tw in ((1, 1), (5, 7), (8, 16), (32, 32))
    for K in (1, 31, 33, 97, 129)
]


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


#: the keys of ``launch_counts``: the compositor's pair, then the projection's
LAUNCH_KEYS = ("fwd", "bwd", "project_fwd", "project_bwd")


def zero_launches():
    """Set every kernel's launch counter to 0."""
    rasterize.LAUNCHES = rasterize.BWD_LAUNCHES = 0
    project_kernels.PROJECT_LAUNCHES = project_kernels.PROJECT_BWD_LAUNCHES = 0


def launch_counts():
    """Every kernel's launch counter: the compositor's as "fwd" / "bwd",
    the projection's as "project_fwd" / "project_bwd"."""
    return dict(zip(LAUNCH_KEYS, (rasterize.LAUNCHES, rasterize.BWD_LAUNCHES,
                                  project_kernels.PROJECT_LAUNCHES,
                                  project_kernels.PROJECT_BWD_LAUNCHES)))


def set_launches(counts):
    """Put back the counters ``launch_counts`` read (a check's calls left
    out of a phase's count)."""
    rasterize.LAUNCHES, rasterize.BWD_LAUNCHES = counts["fwd"], counts["bwd"]
    project_kernels.PROJECT_LAUNCHES = counts["project_fwd"]
    project_kernels.PROJECT_BWD_LAUNCHES = counts["project_bwd"]


def launches_since(counts):
    """Every kernel's launches since ``launch_counts`` read ``counts``."""
    return {k: v - counts[k] for k, v in launch_counts().items()}


def check_projected(label, launches, steps=0):
    """Gate, for a Gaussian-splat path on the card: the projection pair ran
    -- the forward launched, and the backward once or more for each of the
    ``steps`` training steps and never more often than the forward (with
    ``steps`` 0, a path that trains nothing: no backward)."""
    fwd, bwd = launches["project_fwd"], launches["project_bwd"]
    ok = fwd >= bwd >= steps > 0 if steps else fwd > 0 == bwd
    if not ok:
        raise AssertionError(f"{label}: projection launches fwd {fwd} bwd "
                             f"{bwd} over {steps} training steps")


def tile_inputs(rng, T, K, th, tw, device, dead_frac=0.2, sat_frac=0.2):
    """Random well-conditioned splat rows over a T-tile strip, with dead
    (alpha 0) and saturated (opacity 3, clamped at 0.99) rows."""
    n = T * K
    mean = rng.uniform([-4, -4], [tw * T + 4, th + 4], size=(n, 2))
    ang = rng.uniform(0, np.pi, size=n)
    ia = 1.0 / rng.uniform(0.8, 6.0, size=n) ** 2
    ib = 1.0 / rng.uniform(0.8, 6.0, size=n) ** 2
    ca, sa = np.cos(ang), np.sin(ang)
    conic = np.stack(
        [
            ca * ca * ia + sa * sa * ib,
            ca * sa * (ia - ib),
            sa * sa * ia + ca * ca * ib,
        ],
        -1,
    )
    rgb = rng.uniform(0, 1, size=(n, 3))
    alpha = rng.uniform(0.05, 0.95, size=n)
    alpha[rng.uniform(size=n) < sat_frac] = 3.0
    alpha[rng.uniform(size=n) < dead_frac] = 0.0
    feat = np.concatenate([mean, conic, rgb, alpha[:, None], np.zeros((n, 7))], -1)
    origins = np.stack([np.arange(T) * tw, np.zeros(T)], -1)
    return (
        torch.tensor(feat.reshape(T, K, 16), dtype=torch.float32, device=device),
        torch.tensor(origins, dtype=torch.float32, device=device),
    )


def kernel_phase(device):
    """Kernel vs both plain versions over the sweep -> max abs error."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for th, tw, K in SWEEP:
        feats, origins = tile_inputs(rng, 37, K, th, tw, device)
        out = rasterize.rasterize_fwd(feats, origins, tile_h=th, tile_w=tw)
        err = max(
            (out - fn(feats, origins, tile_h=th, tile_w=tw)).abs().max().item()
            for fn in (ref.rasterize_tiles_ref, ref.rasterize_tiles_unrolled)
        )
        log(f"kernel K={K:3d} tile {th}x{tw}: max abs err {err:.3e}")
        if not err <= TOL:
            raise AssertionError(f"K={K} tile {th}x{tw}: err {err} > {TOL}")
        worst = max(worst, err)
    return worst


def bwd_gate(got, want, tol):
    """Max over elements of |got - want| / (tol + tol * |want|): <= 1 is
    ``allclose(got, want, rtol=tol, atol=tol)``."""
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def bwd_kernel_phase(device):
    """The backward kernel against its plain version (autograd of the plain
    forward) and the single-sweep emulation over the sweep -> max abs error
    against the plain version."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for th, tw, K in SWEEP:
        feats, origins = tile_inputs(rng, 37, K, th, tw, device, dead_frac=0.25)
        out = rasterize.rasterize_fwd(feats, origins, tile_h=th, tile_w=tw)
        gout = torch.tensor(
            rng.normal(size=tuple(out.shape)), dtype=torch.float32, device=device
        )
        args = (feats, origins, out, gout)
        got = rasterize.rasterize_bwd(*args, tile_h=th, tile_w=tw)
        again = rasterize.rasterize_bwd(*args, tile_h=th, tile_w=tw)
        plain = ref.rasterize_bwd_ref(*args, tile_h=th, tile_w=tw)
        emul = ref.rasterize_bwd_emulate(*args, tile_h=th, tile_w=tw)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        g_ref = bwd_gate(got, plain, BWD_TOL)
        g_emul = bwd_gate(got, emul, BWD_EMUL_TOL)
        dead = feats[..., 8] == 0
        log(
            f"bwd K={K:3d} tile {th}x{tw}: max abs err {err:.3e} vs plain "
            f"(|g| max {plain.abs().max().item():.3e}), "
            f"{(got - emul).abs().max().item():.3e} vs emulation; gate "
            f"{g_ref:.3f} / {g_emul:.3f}"
        )
        if not (g_ref <= 1.0 and g_emul <= 1.0):
            raise AssertionError(f"bwd K={K} tile {th}x{tw}: gate {g_ref} {g_emul}")
        if got[..., 9:].abs().max().item() != 0.0:
            raise AssertionError("padding columns carry gradient")
        if dead.any() and got[..., :8][dead].abs().max().item() != 0.0:
            raise AssertionError("dead slots carry geometry/colour gradient")
        if not torch.equal(got, again):
            raise AssertionError("the backward kernel is not deterministic")
        worst = max(worst, err)
    # the dispatcher never takes the plain version on a CUDA tensor, and its
    # backward is the kernel: exactly one rasterize_bwd launch per backward
    feats, origins = tile_inputs(rng, 3, 8, 16, 16, device)
    try:
        ops.rasterize_tiles(feats, origins, tile_h=16, tile_w=16, impl="ref")
    except ValueError:
        pass
    else:
        raise AssertionError("impl='ref' ran on CUDA tensors")
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.detach().to(dtype).requires_grad_(True)
        o = origins.clone().requires_grad_(True)
        gout = torch.randn((3, 4, 16, 16), device=device)
        before = rasterize.BWD_LAUNCHES
        out = ops.rasterize_tiles(f, o, tile_h=16, tile_w=16)
        out.backward(gout)
        if rasterize.BWD_LAUNCHES != before + 1:
            raise AssertionError("the backward did not launch rasterize_bwd once")
        if f.grad.dtype != dtype or o.grad.abs().max().item() != 0.0:
            raise AssertionError(f"cotangent dtype {f.grad.dtype} / origins grad")
        f32 = f.detach().to(torch.float32)
        want = ref.rasterize_bwd_ref(
            f32, origins, out.detach(), gout, tile_h=16, tile_w=16
        )
        if dtype == torch.float32 and bwd_gate(f.grad, want, BWD_TOL) > 1.0:
            raise AssertionError("dispatcher backward disagrees with the plain version")
    return worst


#: the projection phase's shapes: (label, splats N, views V)
PROJECT_SHAPES = [("train", 2 * 2_880_000, 1), ("serve", 4_000_000, 8)]
PROJECT_TRAINED = ("means", "log_scales", "quats")
PROJECT_GRAD_RTOL = 1e-5
PROJECT_GRAD_ATOL = 1e-6
PROJECT_MARGIN = 1e-4
PROJECT_REL_MARGIN = 1e-6


def project_scene(rng, n, device):
    """n random splats in the unit cube, each with its own rotation and
    anisotropic scales (0.5-4 thousandths), 5% inactive."""
    f32 = dict(dtype=torch.float32, device=device)
    return Gaussians(
        means=torch.tensor(rng.uniform(0, 1, (n, 3)), **f32),
        log_scales=torch.tensor(np.log(rng.uniform(5e-4, 4e-3, (n, 3))), **f32),
        quats=torch.tensor(rng.normal(size=(n, 4)), **f32),
        opacity_logit=torch.tensor(rng.normal(0, 2, n), **f32),
        colors=torch.tensor(rng.normal(size=(n, 3)), **f32),
        active=torch.tensor(rng.uniform(size=n) > 0.05, device=device),
        owner=torch.zeros(n, dtype=torch.int32, device=device),
    )


def project_flips(s, cam, near=0.05):
    """Bool (V, N): where one rounding could move radius or valid -- the
    pre-ceil radius, an edge of the radius box against the image or z
    within PROJECT_MARGIN, or PROJECT_REL_MARGIN of its magnitude where
    that is larger, of the value that flips it (from the plain version's
    fields)."""
    a, b, c = s.cov2d.unbind(-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - (a * c - b * b), min=1e-9))
    pre = 3.0 * torch.sqrt(torch.clamp(lam1, min=1e-9))
    u, v = s.mean2d.unbind(-1)
    r = s.radius
    edges = torch.stack([u + r, u - r - cam.width, v + r, v - r - cam.height], -1)
    pixels = torch.maximum(u.abs(), v.abs())

    def margin(x):
        return torch.clamp(PROJECT_REL_MARGIN * x.abs(), min=PROJECT_MARGIN)

    return (
        ((pre - torch.round(pre)).abs() <= margin(pre))
        | (edges.abs() <= margin(pixels)[..., None]).any(-1)
        | ((s.depth - near).abs() <= PROJECT_MARGIN)
    )


def project_check(g, cam, rig, label):
    """The kernels against the plain version on the card: every float field
    (max error over its magnitude), radius and valid outside the margin,
    and each gradient's gate (<= 1) against autograd of the plain version
    -> (worst field error, {field: gate}, cotangents)."""
    with torch.no_grad():
        got = project(g, cam)
        want = proj_mod.project_ref(g, cam)
    worst = 0.0
    for name in Splats2D._fields:
        if name not in ("radius", "valid"):
            o, w = getattr(got, name), getattr(want, name)
            scale = max(1.0, w.abs().max().item())
            worst = max(worst, ((o - w).abs() / (scale + w.abs())).max().item())
    flips = project_flips(want, rig)
    differ = (got.radius != want.radius) | (got.valid != want.valid)
    n_held = int((differ & ~flips).sum())
    log(
        f"project {label}: fields max err {worst:.3e} of magnitude; radius/valid "
        f"differ at {int(differ.sum())} splat-views ({int(flips.sum())} within "
        f"the margin), {n_held} outside it; valid {int(want.valid.sum())}"
    )
    if not (worst <= 1e-6 and n_held == 0):
        raise AssertionError(f"project {label}: err {worst}, {n_held} flips held")
    cot = [torch.randn(want.depth.shape + t, device=g.means.device)
           for t in ((2,), (3,), ())]

    def grads(fn):
        tr = {k: getattr(g, k).clone().requires_grad_(True) for k in PROJECT_TRAINED}
        s = fn(g._replace(**tr), cam)
        loss = (s.mean2d * cot[0]).sum() + (s.cov2d * cot[1]).sum()
        (loss + (s.depth * cot[2]).sum()).backward()
        return [tr[k].grad for k in PROJECT_TRAINED]

    got_g, again, want_g = grads(project), grads(project), grads(proj_mod.project_ref)
    gates = {}
    for name, o, a, w in zip(PROJECT_TRAINED, got_g, again, want_g):
        if not torch.equal(o, a):
            raise AssertionError(f"project_bwd {label} {name}: two calls differ")
        atol = PROJECT_GRAD_ATOL * w.abs().max().item()
        gate = (o - w).abs() / (atol + PROJECT_GRAD_RTOL * w.abs())
        gates[name] = gate.max().item()
    log(f"project_bwd {label}: gate (<= 1) {json.dumps(gates)}")
    if max(gates.values()) > 1.0:
        raise AssertionError(f"project_bwd {label}: gate {gates}")
    return worst, gates, cot


def project_phase(device, reps=15, plain_reps=3):
    """3b: the projection pair at the main path's shapes against the plain
    version -> {label: timings and gates}."""
    pk = project_kernels
    rng = np.random.default_rng(5)
    rows = {}
    for label, n, V in PROJECT_SHAPES:
        g = project_scene(rng, n, device)
        rig = orbital_rig(V, (0.5, 0.5, 0.5), 1.6, width=1024, height=1024,
                          device=device)
        cam = rig if V > 1 else select(rig, 0)
        worst, gates, cot = project_check(g, cam, rig, f"{label} (N {n}, V {V})")
        # times: the kernels alone, and the plain version (autograd's
        # backward over a kept graph)
        alpha = torch.sigmoid(g.opacity_logit)
        cams = (rig.view.contiguous(), rig.fx, rig.fy)
        args = (g.means, g.log_scales, g.quats, alpha, g.active, *cams)
        kw = dict(width=1024, height=1024, near=0.05, alpha_min=1.0 / 255.0)
        gcot = [x.reshape((V, n) + x.shape[1 + (V > 1):]).contiguous() for x in cot]
        bwd_args = (g.means, g.log_scales, g.quats, *cams, *gcot)

        def plain_fwd():
            with torch.no_grad():
                proj_mod.project_ref(g, cam)

        tr = {k: getattr(g, k).clone().requires_grad_(True) for k in PROJECT_TRAINED}
        s = proj_mod.project_ref(g._replace(**tr), cam)
        loss = (s.mean2d * cot[0]).sum() + (s.cov2d * cot[1]).sum()
        loss = loss + (s.depth * cot[2]).sum()

        def plain_bwd():
            torch.autograd.grad(loss, list(tr.values()), retain_graph=True)

        times = {
            "fwd": time_against_plain(
                lambda: pk.project_fwd(*args, **kw), plain_fwd, reps, plain_reps
            ),
            "bwd": time_against_plain(
                lambda: pk.project_bwd(*bwd_args, near=0.05), plain_bwd, reps,
                plain_reps,
            ),
        }
        del s, loss, tr
        for part, t in times.items():
            name = f"project_{part}"
            t.update(bound(1, *project_costs(name, V, n)))
            log(
                f"{name} {label} (N {n}, V {V}): {t['ms']:.4f} ms back to back "
                f"({t['ms_runs'][0]:.4f} / {t['ms_runs'][1]:.4f}), one call "
                f"{t['call_ms']:.4f}; bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}); plain {t['plain_ms']:.3f} ms"
            )
        rows[label] = dict(times, max_rel_err=worst, grad_gates=gates)
        del g
        torch.cuda.empty_cache()
    return rows


def mixed_rig(center, near_r, far_r, n_near, n_far, res, device):
    """Near orbit (LOD rung 0) + far orbit (coarser rung), as the serving
    CLI of the JAX package builds it."""
    return concat(
        [
            orbital_rig(n_near, center, near_r, width=res, height=res, device=device),
            orbital_rig(n_far, center, far_r, width=res, height=res, device=device),
        ]
    )


def serve_phase(
    device,
    *,
    dataset="kingsnake",
    n_points=4_000_000,
    res=1024,
    tile=16,
    K=64,
    max_batch=8,
    n_near=8,
    n_far=8,
):
    """Build the merged model and serve the rig twice -> (server, rig,
    results of both passes, timings, info with the kernel launches of the
    two passes and the assignment knobs)."""
    times = {}
    t0 = time.perf_counter()
    pts, cols = point_cloud_for(get_gs_dataset(dataset, "full").volume, n_points)
    times["point_cloud_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = from_points(pts, cols, opacity=0.9, device=device)
    sync(device)
    times["from_points_s"] = time.perf_counter() - t0
    grid = TileGrid(res, res, tile, tile)
    center = 0.5 * (pts.max(0) + pts.min(0)).astype(np.float64)
    rig = mixed_rig(center, 1.5, 7.5, n_near, n_far, res, device)

    # the server's default ("auto", no budget) resolves to the O(T*N) dense
    # sweep; probe a sorted-path budget over the whole rig, as the JAX
    # package's host entry points do
    t0 = time.perf_counter()
    assign_impl, budget = resolve_assignment(g, rig, grid)
    times["probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = ServeCfg(
        K=K, max_batch=max_batch, assign_impl=assign_impl, assign_budget=budget
    )
    server = GSRenderServer(g, grid, cfg)
    sync(device)
    times["lod_ladder_s"] = time.perf_counter() - t0
    passes = []
    zero_launches()  # count the launches of the two passes only
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        results = server.serve(rig)
        sync(device)
        times[f"{name}_pass_s"] = dt = time.perf_counter() - t0
        times[f"{name}_req_per_s"] = len(results) / dt
        passes.append(results)
    info = {
        "launches": rasterize.LAUNCHES,
        "counts": launch_counts(),
        "n_points": int(len(pts)),
        "assign_impl": assign_impl,
        "assign_budget": budget,
        "rungs_live": [int(r.active.sum()) for r in server.ladder],
        "lod_dists": list(server.lod_dists),
    }
    return server, rig, passes, times, info


def check_passes(server, passes, n_views):
    """The serving contract on the two passes -> (telemetry, coverage)."""
    cold, warm = passes
    if len(cold) != n_views or len(warm) != n_views:
        raise AssertionError("not every request was answered")
    if any(r.cache_hit for r in cold) or not all(r.cache_hit for r in warm):
        raise AssertionError("pass 1 must miss and pass 2 must hit the cache")
    h, w = server.grid.height, server.grid.width
    for c, r in zip(cold, warm):
        if c.rgb.shape != (h, w, 3) or c.coverage.shape != (h, w):
            raise AssertionError(f"bad image shape {c.rgb.shape}")
        if not (np.isfinite(c.rgb).all() and np.isfinite(c.coverage).all()):
            raise AssertionError("non-finite image")
        same = np.array_equal(c.rgb, r.rgb) and np.array_equal(c.coverage, r.coverage)
        if not same:
            raise AssertionError(f"request {r.request_id}: hit != miss")
        if (c.rung, c.K) != (r.rung, r.K):
            raise AssertionError("serving decisions changed between passes")
    tel = server.telemetry()
    if tel["assign"] != 0:
        raise AssertionError(f"assignment overflow: {tel}")
    if {r.rung for r in cold} != {0, 1}:
        raise AssertionError("the rig must span both LOD rungs")
    # far views hold the object in a few percent of the frame, so the test
    # is: every image is opaque somewhere and the near views cover a share
    cov = [float(r.coverage.mean()) for r in cold]
    if min(float(r.coverage.max()) for r in cold) < 0.5 or max(cov) < 0.05:
        raise AssertionError(f"trivial coverage: {cov}")
    return tel, cov


def canonical_cams(server, rig, views):
    """The bucket-snapped cameras the server rendered for ``views``, as one
    view-batched Camera in dispatch order."""
    dev = server.device
    cams = []
    for v in views:
        cam = select(rig, v)
        _, (view, fx, fy) = quantize_pose(cam.view, cam.fx, cam.fy)
        cams.append(
            Camera(
                torch.from_numpy(view).to(dev),
                torch.tensor(fx, device=dev),
                torch.tensor(fy, device=dev),
                cam.width,
                cam.height,
            )
        )
    return stack(cams)


def cached_tables(server, rig, results, views):
    """The cached (idx, score) tables of ``views``, cut to the K served."""
    idx, score = [], []
    for v in views:
        i, s = server.cached_table(select(rig, v), rung=results[v].rung)
        idx.append(i[..., : results[v].K])
        score.append(s[..., : results[v].K])
    return torch.stack(idx), torch.stack(score)


def cuda_time_ms(fn, reps, launches=1, hold_ms=0.0):
    """Median over ``reps`` CUDA-event pairs of the time per call of ``fn``,
    each pair bracketing ``launches`` back-to-back calls (after a warm-up).
    ``hold_ms`` first keeps the device busy that long (``torch.cuda._sleep``,
    before the start event), so the host enqueues the whole run before the
    device reaches it and the calls run without gaps even where a call's
    host side takes longer than its kernel."""
    fn()
    torch.cuda.synchronize()
    cycles = int(hold_ms * 2e6)  # at most 2 GHz: at least hold_ms
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def kernel_times(fn, reps=15, window_ms=4.0):
    """A kernel wrapper's time two ways -> {"ms": per launch, over runs of
    back-to-back launches filling at least ``window_ms`` of device time per
    event pair, enqueued behind a hold of the device; "call_ms": one call
    per event pair (wrapper and enqueue included, what one caller waits);
    "launches": the launches per pair}."""
    call = cuda_time_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e2  # host time of one call
    torch.cuda.synchronize()
    n = max(10, min(1000, math.ceil(window_ms / max(call, 1e-3))))
    ms = cuda_time_ms(fn, reps, n, hold_ms=2 * n * host_ms + 1.0)
    return {"ms": ms, "call_ms": call, "launches": n}


def sm_clock_mhz(fn, seconds=1.0):
    """Median SM clock (MHz) that ``nvidia-smi`` samples every 20 ms while
    ``fn`` runs back to back for ``seconds``, and the card's maximum."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm"]
    query += ["--format=csv,noheader,nounits", "-i", "0"]
    proc = subprocess.Popen(query + ["-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        text, _ = proc.communicate()
    rows = [[float(x) for x in ln.split(",")] for ln in text.splitlines() if ln.strip()]
    if not rows:
        raise AssertionError("nvidia-smi gave no clock samples")
    return statistics.median(r[0] for r in rows), rows[0][1]


def issue_ceiling_ms(loop, T, K, th, tw, clock_mhz):
    """The least time the kernel's inner loop can take at the issue rate:
    its instructions per splat-pixel (``loop``, from ``rasterize.hot_loop``)
    over every (thread, slot) of the launch, 32 threads a warp instruction,
    ISSUE_PER_CLOCK warp instructions per clock per SM."""
    threads, ppt, _ = rasterize.launch_geometry(th, tw)
    warp_instr = T * K * threads * ppt / 32 * loop["per_splat_pixel"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return warp_instr / (ISSUE_PER_CLOCK * sms * clock_mhz * 1e6) * 1e3


def time_against_plain(kernel, plain, reps=15, plain_reps=5):
    """In turns within one process: plain, kernel, kernel, plain -> the
    kernel's back-to-back ``ms`` (median of the two, and both), its
    ``call_ms``, the plain version's one-call ``plain_ms``."""
    p1 = cuda_time_ms(plain, plain_reps)
    k1 = kernel_times(kernel, reps)
    k2 = kernel_times(kernel, reps)
    p2 = cuda_time_ms(plain, plain_reps)
    return {
        "ms": statistics.median([k1["ms"], k2["ms"]]),
        "ms_runs": [k1["ms"], k2["ms"]],
        "call_ms": statistics.median([k1["call_ms"], k2["call_ms"]]),
        "launches_per_pair": k1["launches"],
        "plain_ms": statistics.median([p1, p2]),
    }


def bound(splat_pixels, ops_per_splat_pixel, n_bytes):
    """The least time of the work: its operations over the f32 peak or its
    bytes (each input read once, each output written once) over the memory
    rate, whichever is longer."""
    t_ops = splat_pixels * ops_per_splat_pixel / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops,
        "bytes_ms": t_bytes,
    }


def timing_phase(server, rig, results, views, issue, reps=15, save_dir=None):
    """Kernel vs plain version on one dispatch's own tile features (the
    canonical cameras, cached tables and projection the server used):
    agreement with the served images, error, times, bound and issue-rate
    ceiling (``issue``: the forward's hot loop; the SM clock is sampled
    here, under this shape)."""
    grid = server.grid
    th, tw = grid.tile_h, grid.tile_w
    idx, score = cached_tables(server, rig, results, views)
    rung = results[views[0]].rung
    feats = table_features(
        server.ladder[rung], canonical_cams(server, rig, views), idx, score
    )
    V, T, K, F = feats.shape
    flat = feats.reshape(V * T, K, F).contiguous()
    origins = tile_origins(grid, flat.device).repeat(V, 1)
    out = rasterize.rasterize_fwd(flat, origins, tile_h=th, tile_w=tw)
    plain = ref.rasterize_tiles_ref(flat, origins, tile_h=th, tile_w=tw)
    err = (out - plain).abs().max().item()
    tiles = out.reshape(V, T, 4, th, tw)
    img = _composite(untile_image(tiles, grid), server.cfg.bg)
    served = np.stack([results[v].rgb for v in views])
    served_err = float(np.abs(img.rgb.cpu().numpy() - served).max())
    log(
        f"serving-shape features {tuple(feats.shape)}: kernel vs plain max abs "
        f"err {err:.3e}; kernel image vs served image {served_err:.3e}"
    )
    if not (err <= TOL and served_err <= TOL):
        raise AssertionError(f"serving-shape disagreement {err} / {served_err}")

    if save_dir is not None:
        torch.save({"feats": flat, "origins": origins, "tile": (th, tw)},
                   Path(save_dir) / "serve.pt")

    def kernel():
        rasterize.rasterize_fwd(flat, origins, tile_h=th, tile_w=tw)

    def plain_version():
        ref.rasterize_tiles_ref(flat, origins, tile_h=th, tile_w=tw)

    stats = time_against_plain(kernel, plain_version, reps)
    n_bytes = 4 * (flat.numel() + origins.numel() + out.numel())
    stats.update(bound(V * T * K * th * tw, OPS_PER_SPLAT_PIXEL, n_bytes))
    clock, clock_max = sm_clock_mhz(kernel)
    stats.update(
        max_abs_err=err,
        clock_mhz=clock,
        ceiling_ms=issue_ceiling_ms(issue, V * T, K, th, tw, clock),
    )
    log(
        f"timing fwd V={V} T={T} K={K} tile {th}x{tw}: "
        + json.dumps(stats)
        + f" (SM clock {clock:.0f} of {clock_max:.0f} MHz)"
    )
    return stats


def breakdown_phase(server, rig, results, views, assign):
    """Host-clock time of each stage of one dispatch of ``views`` (the warm
    path, then the cold path's table extraction with the server's
    ``assign`` = (impl, budget)), each stage between two device
    synchronisations, second of two runs -> {stage: ms}."""
    rung = results[views[0]].rung
    g = server.ladder[rung]
    grid = server.grid
    idx, score = cached_tables(server, rig, results, views)
    stages = {}

    def stage(name, fn):
        sync(server.device)
        t0 = time.perf_counter()
        out = fn()
        sync(server.device)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    def extract():
        impl, budget = assign
        K = server.cfg.K
        return assign_tables(g, cams, grid, K, assign_impl=impl, assign_budget=budget)

    for _ in range(2):
        cams = stage("canonical_cams", lambda: canonical_cams(server, rig, views))
        splats = stage("project", lambda: project(g, cams))
        feat = stage("splat_features", lambda: splat_features(splats))
        tf = stage("gather", lambda: gather_features_at(feat, idx, score))
        tiles = stage("rasterize_fwd", lambda: rasterize_batched(tf, grid))
        img = stage(
            "untile_composite",
            lambda: _composite(untile_image(tiles, grid), server.cfg.bg),
        )
        stage("to_host", lambda: (img.rgb.cpu().numpy(), img.coverage.cpu().numpy()))
        stage("assign_tables_cold", extract)
    rounded = {k: round(v, 3) for k, v in stages.items()}
    log(f"breakdown of one {len(views)}-view dispatch (ms) {json.dumps(rounded)}")
    return stages


def small_scene_check(device):
    """A small scene served by the port on the card and on the CPU: the
    same decisions and telemetry, images within 1e-4 (projection and
    matmuls round differently on the two devices)."""
    pts, cols = point_cloud_for("sphere_shell", 400)
    out = []
    for dev in (device, "cpu"):
        g = from_points(pts, cols, opacity=0.9, device=dev)
        server = GSRenderServer(
            g,
            TileGrid(32, 32, 8, 16),
            ServeCfg(K=16, max_batch=4, lod_dists=(4.0,)),
            center=(0.5, 0.5, 0.5),
        )
        rig = mixed_rig((0.5, 0.5, 0.5), 1.5, 8.0, 3, 3, 32, dev)
        out.append((server.serve(rig), server.telemetry()))
    (res_d, tel_d), (res_c, tel_c) = out
    err = max(float(np.abs(a.rgb - b.rgb).max()) for a, b in zip(res_d, res_c))
    same = all(
        (a.rung, a.K, a.cache_hit, a.shed) == (b.rung, b.K, b.cache_hit, b.shed)
        for a, b in zip(res_d, res_c)
    )
    log(f"small scene, card vs CPU: max abs err {err:.3e}, decisions equal {same}")
    if not (same and tel_d == tel_c and err <= 1e-4):
        raise AssertionError(f"small scene differs: {err} {tel_d} {tel_c}")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class RecordingSchedule(TierSchedule):
    """A TierSchedule that records every probe and overflow counter it is
    fed (the telemetry ``fit_partition`` drives it with)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.probes = []  # caps after each probe
        self.overflows = []  # (counter, caps grew) per step

    def probe(self, occupancy):
        out = super().probe(occupancy)
        self.probes.append(self.tier_caps)
        return out

    def note_overflow(self, overflow, n_tiles):
        ov = int(as_numpy(overflow).sum())
        grew = super().note_overflow(overflow, n_tiles)
        self.overflows.append((ov, grew))
        return grew


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def recording_fit(records, device):
    """``fit_partition`` as ``run_pipeline`` calls it, with a
    RecordingSchedule, the densify events, both kernels' launches, the
    losses and the wall time of each partition recorded in ``records``;
    the first partition also keeps its step-0 inputs for the timing."""
    fit = train_mod.fit_partition
    densify = train_mod.densify_and_prune

    def run(g0, cams, gts, masks, cfg, **kw):
        sched = RecordingSchedule(cfg.resolved_k_tiers(), slack=cfg.tier_slack)
        events = []

        def counted(g, opt, *a, **k):
            out = densify(g, opt, *a, **k)
            events.append((int(g.active.sum()), int(out[0].active.sum())))
            return out

        c0 = launch_counts()
        sync(device)
        t0 = time.perf_counter()
        with patched(train_mod, "densify_and_prune", counted):
            g1, opt, losses = fit(g0, cams, gts, masks, cfg, schedule=sched, **kw)
        sync(device)
        rec = {
            "seconds": time.perf_counter() - t0,
            "losses": losses,
            **launches_since(c0),
            "probes": sched.probes,
            "overflows": sched.overflows,
            "densify": events,
            "k_tiers": sched.k_tiers,
            "active": (int(g0.active.sum()), int(g1.active.sum())),
            "capacity": g0.capacity,
        }
        if not records:
            rec.update(
                g0=g0,
                cams=cams,
                grid=kw["grid"],
                cfg=cfg,
                extent=kw["extent"],
                gt0=gts[:1].clone(),
                mask0=None if masks is None else masks[:1].clone(),
                gts=gts,
                masks=masks,
            )
        records.append(rec)
        return g1, opt, losses

    return run


def timed(times, label, fn, device):
    """``fn`` with the wall time of each call appended to ``times``."""

    def run(*a, **kw):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(device)
        times.append((label, time.perf_counter() - t0))
        return out

    return run


def run_recorded_pipeline(cfg, device):
    """``run_pipeline(cfg)`` with per-partition records and stage times ->
    (result, records, stage times, launches of the whole run: both counts
    are set to 0 just before it and read just after)."""
    records, times = [], []
    with contextlib.ExitStack() as stack:
        fit = recording_fit(records, device)
        stack.enter_context(patched(pipeline_mod, "fit_partition", fit))
        for name, fn in (
            ("build_scene", pipeline_mod.build_scene),
            ("render_views", pipeline_mod.render_views),
            ("partition_points", pipeline_mod.partition_points),
        ):
            fn = timed(times, name, fn, device)
            stack.enter_context(patched(pipeline_mod, name, fn))
        zero_launches()
        t0 = time.perf_counter()
        result = pipeline_mod.run_pipeline(cfg, device=device)
        launches = launch_counts()
        times.append(("run_pipeline_total", time.perf_counter() - t0))
    return result, records, times, launches


def train_phase(
    device,
    *,
    dataset="kingsnake",
    tier="full",
    n_parts=2,
    resolution=1024,
    steps=120,
    K=64,
    densify_every=10,
    n_views=16,
    tile=16,
):
    """``run_pipeline`` at the given size (the defaults: the full-size
    kingsnake scene) -> (result, records, launches of the whole run),
    checked: losses finite and falling in each partition, densify events
    that change the live count, the tier telemetry fed every step, and
    (on the card) bwd launches == fwd launches > 0 in training, and the
    projection's backward once or more a step."""
    cfg = PipelineCfg(
        dataset=dataset,
        tier=tier,
        n_parts=n_parts,
        resolution=resolution,
        steps=steps,
        K=K,
        densify_every=densify_every,
        n_views=n_views,
        train=GSTrainCfg(K=K, tile_h=tile, tile_w=tile),
    )
    log(
        f"train: run_pipeline({dataset}/{tier}, n_parts={n_parts}, "
        f"{resolution}^2, {tile}x{tile} tiles, steps={steps}, K={K}, "
        f"densify_every={densify_every}, n_views={n_views}) on {device}; "
        f"cuts: {n_views} views (paper 448), {steps} steps"
    )
    result, records, times, launches = run_recorded_pipeline(cfg, device)
    # fit_partition densifies from step 100 on (its default densify_from)
    n_events = sum(
        1 for i in range(100, steps) if densify_every and (i + 1) % densify_every == 0
    )
    for p, rec in enumerate(records):
        losses = np.asarray(rec["losses"])
        first, last = losses[:10].mean(), losses[-10:].mean()
        grown = sum(g for _, g in rec["overflows"])
        dropped = [o for o, _ in rec["overflows"] if o]
        log(
            f"partition {p}: capacity {rec['capacity']}, active "
            f"{rec['active'][0]} -> {rec['active'][1]}, densify {rec['densify']}, "
            f"ladder {rec['k_tiers']}, probed caps {rec['probes']}, overflowing "
            f"steps {len(dropped)} ({sum(dropped)} tiles, caps grew {grown}x), "
            f"launches fwd {rec['fwd']} bwd {rec['bwd']}, {rec['seconds']:.3f} s"
        )
        log(f"partition {p} losses {[round(x, 5) for x in rec['losses']]}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"partition {p}: non-finite loss")
        if not last < first:
            raise AssertionError(f"partition {p}: loss did not fall {first} -> {last}")
        changed = any(a != b for a, b in rec["densify"])
        if len(rec["densify"]) != n_events or (n_events and not changed):
            raise AssertionError(f"partition {p}: densify events {rec['densify']}")
        if len(rec["probes"]) != 1 + n_events or len(rec["overflows"]) != steps:
            raise AssertionError(f"partition {p}: tier telemetry not fed every step")
        on_card = torch.device(device).type == "cuda"
        if on_card and not rec["bwd"] == rec["fwd"] > 0:
            raise AssertionError(f"partition {p}: launches {rec['fwd']} / {rec['bwd']}")
    if not (math.isfinite(result.psnr) and math.isfinite(result.ssim)):
        raise AssertionError(f"merged metrics {result.psnr} {result.ssim}")
    if torch.device(device).type == "cuda":
        check_projected("train", launches, steps * len(records))
    log(
        f"merged: {result.n_gaussians} gaussians, PSNR {result.psnr:.4f} dB, SSIM "
        f"{result.ssim:.5f}, grad_sim {result.grad_sim:.5f}, boundary PSNR "
        f"{result.boundary_psnr:.4f} SSIM {result.boundary_ssim:.5f} "
        f"(frac {result.boundary_frac:.4f}); run launches {launches}"
    )
    log("train stage times (s) " + json.dumps([(k, round(v, 4)) for k, v in times]))
    return result, records, launches


#: card vs CPU on the small scene, 12 steps: the losses of each partition
#: (relative) and the merged PSNR (dB) / SSIM.  Sources of difference: the
#: gather transpose's atomics, the kernels' reduction order, cuDNN's
#: convolution and the projection's matmul rounding, fed through Adam.
SMALL_LOSS_RTOL = 1e-3
#: the step window [from, to) whose median step times compare the batched
#: and the one-partition trainer: past the first steps' allocator growth,
#: before the first densify event
STEADY = (20, 100)
SMALL_PSNR_ATOL = 0.01
SMALL_SSIM_ATOL = 1e-4


def small_pipeline_check(device):
    """``run_pipeline`` on the CPU-tier sphere_shell scene on the card and
    on the CPU from the same input: losses and final PSNR/SSIM agree."""
    cfg = PipelineCfg(
        dataset="sphere_shell",
        n_parts=2,
        resolution=32,
        steps=12,
        K=16,
        n_views=4,
        train=GSTrainCfg(K=16, tile_h=8, tile_w=16),
    )
    (res_d, rec_d, *_), (res_c, rec_c, *_) = (
        run_recorded_pipeline(cfg, dev) for dev in (device, "cpu")
    )
    loss_err = max(
        float(np.max(np.abs(np.subtract(a["losses"], b["losses"])) / b["losses"]))
        for a, b in zip(rec_d, rec_c)
    )
    psnr_err = abs(res_d.psnr - res_c.psnr)
    ssim_err = abs(res_d.ssim - res_c.ssim)
    log(
        f"small pipeline, card vs CPU: losses max rel diff {loss_err:.3e}, PSNR "
        f"{res_d.psnr:.5f} vs {res_c.psnr:.5f} dB ({psnr_err:.3e}), SSIM "
        f"{res_d.ssim:.6f} vs {res_c.ssim:.6f} ({ssim_err:.3e})"
    )
    if not (
        loss_err <= SMALL_LOSS_RTOL
        and psnr_err <= SMALL_PSNR_ATOL
        and ssim_err <= SMALL_SSIM_ATOL
    ):
        raise AssertionError("the small pipeline differs between card and CPU")


def step_inputs(rec):
    """Partition 0's step-0 inputs -> (its initial model, view 0, the grid,
    the ladder, the first probe's caps, the assignment knobs the trainer
    resolved)."""
    g, cams, grid = rec["g0"], rec["cams"], rec["grid"]
    cam = select(cams, torch.arange(1, device=g.means.device))
    impl, budget = resolve_assignment(g, cams, grid)
    assign = {"assign_impl": impl, "assign_budget": budget}
    return g, cam, grid, rec["k_tiers"], rec["probes"][0], assign


def step_tables(splats, grid, k_tiers, caps, assign):
    """One step's tier tables from its splats -> (per-tier feats, origins,
    flat ids, plan)."""
    idx, score, _ = _assign_views(splats, grid, K=k_tiers[-1], block=4096, **assign)
    return tier_tables(
        splat_features(splats), idx, score, grid, k_tiers=k_tiers, tier_caps=caps
    )


def train_timing_phase(rec, issue, reps=15, plain_reps=5, save_dir=None):
    """Both kernels vs their plain versions on one train step's own tier
    tables, at each tier's K, each tier with its own bound and issue-rate
    ceiling (``issue``: {kernel: hot loop}; the SM clock is sampled under
    the top tier) -> {"fwd": {K: stats}, "bwd": {K: stats}}."""
    g, cam, grid, k_tiers, caps, assign = step_inputs(rec)
    th, tw = grid.tile_h, grid.tile_w
    with torch.no_grad():
        splats = project(g, cam)
        feats, origins, _, plan = step_tables(splats, grid, k_tiers, caps, assign)
    log(
        f"step tables: ladder {k_tiers}, caps {caps}, tiles placed "
        f"{plan.counts[0].tolist()}, assignment {assign}"
    )
    tiers = [t for t in zip(k_tiers, feats, origins) if t[1].shape[0]]
    gen = torch.Generator(device=tiers[0][1].device).manual_seed(0)
    planes = []
    for k, tf, og in tiers:
        out = rasterize.rasterize_fwd(tf, og, tile_h=th, tile_w=tw)
        gout = torch.randn(tuple(out.shape), generator=gen, device=tf.device)
        planes.append((k, tf, og, out, gout))
    if save_dir is not None:
        torch.save({"tiers": planes, "tile": (th, tw)}, Path(save_dir) / "train.pt")
    return time_tiers(planes, th, tw, issue, "train", reps, plain_reps)


def time_tiers(planes, th, tw, issue, label, reps=15, plain_reps=5):
    """Both kernels vs their plain versions on one step's tier tables
    (``planes``: [(K, feats, origins, out, gout)] at tiles th x tw), each
    tier held at TOL / BWD_TOL and timed with its own bound and issue-rate
    ceiling (the SM clock sampled under the top tier) -> {"fwd": {K:
    stats}, "bwd": {K: stats}}."""
    _, tf, og, out, gout = planes[-1]
    top = dict(tile_h=th, tile_w=tw)
    clocks = {
        "fwd": sm_clock_mhz(lambda: rasterize.rasterize_fwd(tf, og, **top)),
        "bwd": sm_clock_mhz(lambda: rasterize.rasterize_bwd(tf, og, out, gout, **top)),
    }
    clocks = {name: median for name, (median, _) in clocks.items()}
    log(f"{label}: SM clock (MHz) under the top tier: {clocks}")
    result = {"fwd": {}, "bwd": {}}
    for k, tf, og, out, gout in planes:
        T = tf.shape[0]
        n = T * k * th * tw
        args = (tf, og, out, gout)

        def kernel_fwd():
            return rasterize.rasterize_fwd(tf, og, tile_h=th, tile_w=tw)

        def plain_fwd():
            return ref.rasterize_tiles_ref(tf, og, tile_h=th, tile_w=tw)

        def kernel_bwd():
            return rasterize.rasterize_bwd(*args, tile_h=th, tile_w=tw)

        def plain_bwd():
            return ref.rasterize_bwd_ref(*args, tile_h=th, tile_w=tw)

        err = (kernel_fwd() - plain_fwd()).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"{label} tier K={k}: forward err {err}")
        got, want = kernel_bwd(), plain_bwd()
        bwd_err = (got - want).abs().max().item()
        gate = bwd_gate(got, want, BWD_TOL)
        if not gate <= 1.0:
            raise AssertionError(
                f"{label} tier K={k}: backward disagrees, gate {gate}")
        fwd_bytes = 4 * (tf.numel() + og.numel() + out.numel())
        bwd_bytes = 4 * (2 * tf.numel() + og.numel() + out.numel() + gout.numel())
        for name, kern, plain, ops_per, n_bytes, e in (
            ("fwd", kernel_fwd, plain_fwd, OPS_PER_SPLAT_PIXEL, fwd_bytes, err),
            ("bwd", kernel_bwd, plain_bwd, BWD_OPS_PER_SPLAT_PIXEL, bwd_bytes, bwd_err),
        ):
            stats = time_against_plain(kern, plain, reps, plain_reps)
            stats.update(bound(n, ops_per, n_bytes))
            stats.update(
                tiles=T,
                max_abs_err=e,
                clock_mhz=clocks[name],
                ceiling_ms=issue_ceiling_ms(
                    issue[f"rasterize_{name}"], T, k, th, tw, clocks[name]
                ),
            )
            if name == "bwd":
                stats["gate"] = gate
            result[name][k] = stats
            log(f"{label} {name} tier K={k}: {json.dumps(stats)}")
    return result


def train_breakdown_phase(rec):
    """Host-clock time of each stage of one train step on partition 0's
    step-0 inputs (each stage between two device synchronisations, second
    of two runs), and of the whole step -> {stage: ms}.  The bwd launches
    run inside 'backward'; they are also timed on their own."""
    g, cam, grid, k_tiers, caps, assign = step_inputs(rec)
    cfg, gt0, mask0 = rec["cfg"], rec["gt0"], rec["mask0"]
    th, tw = grid.tile_h, grid.tile_w
    lrs = group_lrs(cfg, rec["extent"])
    opt = init_opt(g)
    step = train_mod.make_train_step(cfg, grid, rec["extent"], tier_caps=caps, **assign)
    stages = {}

    def stage(name, fn):
        sync(cam.view.device)
        t0 = time.perf_counter()
        out = fn()
        sync(cam.view.device)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    def loss_fn():
        rgb = _composite(untile_image(tiles, grid), cfg.bg).rgb
        mask = None if mask0 is None else mask0[0]
        return gs_loss(rgb, gt0[0], mask, lambda_dssim=cfg.lambda_dssim)

    def bwd_launches(planes):
        for f, o, out in planes:
            gout = torch.ones_like(out)
            rasterize.rasterize_bwd(f, o, out, gout, tile_h=th, tile_w=tw)

    for _ in range(2):
        tr = {k: p.detach().requires_grad_(True) for k, p in g.trainable().items()}
        gg = g.with_trainable(tr)
        splats = stage("project", lambda: project(gg, cam))
        idx, score, _ = stage(
            "assign",
            lambda: _assign_views(splats, grid, K=k_tiers[-1], block=4096, **assign),
        )
        stage(
            "occupancy_binning",
            lambda: bin_tiles_by_occupancy(tile_occupancy(score), k_tiers, caps),
        )
        feat = splat_features(splats)
        tiers = {"k_tiers": k_tiers, "tier_caps": caps}
        feats, origins, ids, _ = stage(
            "gather_with_binning", lambda: tier_tables(feat, idx, score, grid, **tiers)
        )
        tiles = stage(
            "rasterize_fwd_launches",
            lambda: rasterize_tiles_tiered(
                feats, origins, ids, grid.n_tiles, tile_h=th, tile_w=tw
            ),
        )
        loss = stage("untile_loss", loss_fn)
        grads = stage("backward", lambda: torch.autograd.grad(loss, list(tr.values())))
        grads = dict(zip(tr, grads))
        stage("adam", lambda: adam_update(cfg, lrs, g.trainable(), grads, opt))
        detached = [(f.detach(), o) for f, o in zip(feats, origins) if f.shape[0]]
        planes = [
            (f, o, rasterize.rasterize_fwd(f, o, tile_h=th, tile_w=tw))
            for f, o in detached
        ]
        stage("rasterize_bwd_launches_alone", lambda: bwd_launches(planes))
        stage("whole_step", lambda: step(g, opt, cam, gt0, mask0))
    log(
        "breakdown of one train step (ms) "
        + json.dumps({k: round(v, 3) for k, v in stages.items()})
    )
    return stages


def train_profile_phase(rec, steps=3, top=12):
    """Device time by kernel name over ``steps`` train steps on partition
    0's step-0 inputs (``torch.profiler``, device activity only, after one
    warm-up step), and the share of the window's wall time in which the
    device ran anything -> (rows, busy share, window ms per step)."""
    g, cam, grid, _, caps, assign = step_inputs(rec)
    cfg, gt0, mask0 = rec["cfg"], rec["gt0"], rec["mask0"]
    dev = cam.view.device
    step = train_mod.make_train_step(cfg, grid, rec["extent"], tier_caps=caps, **assign)
    opt = init_opt(g)
    step(g, opt, cam, gt0, mask0)
    rows, share, wall_us, n_spans = device_profile(
        lambda: step(g, opt, cam, gt0, mask0), steps, dev)
    log(
        f"profile of {steps} train steps: {wall_us / steps / 1e3:.3f} ms per step "
        f"(traced), device busy {100 * share:.1f}% of the window, "
        f"{n_spans} device events, {len(rows)} names"
    )
    for name, (n, t) in rows[:top]:
        log(f"  {t / steps / 1e3:8.3f} ms/step  x{n // steps:<4d} {name[:90]}")
    return rows, share, wall_us / steps / 1e3


def gs_bound_phase(rec, profile):
    """10c: one step of phase 6's 16x16 ``fit_partition`` step on its own
    inputs, on the card under ``cost_analysis.analyze`` -> record; gates:
    each kernel in ``per_op`` as many times as its launch counter rose,
    and ``bound_s`` <= the device-busy time of a step of phase 6's profile
    (``profile``: ``train_profile_phase``'s rows, busy share, ms a step)."""
    g, cam, grid, _, caps, assign = step_inputs(rec)
    cfg, gt0, mask0 = rec["cfg"], rec["gt0"], rec["mask0"]
    step = train_mod.make_train_step(cfg, grid, rec["extent"], tier_caps=caps, **assign)
    opt = init_opt(g)
    c0 = launch_counts()
    t0 = time.perf_counter()
    hlo = analyze(step, g, opt, cam, gt0, mask0)
    sync(cam.view.device)
    seconds = time.perf_counter() - t0
    since = launches_since(c0)
    launched = {"rasterize_fwd": since["fwd"], "rasterize_bwd": since["bwd"],
                "project_fwd": since["project_fwd"],
                "project_bwd": since["project_bwd"]}
    seen = {k: hlo["per_op"].get(k, {}).get("count", 0) for k in launched}
    if seen != launched or 0 in launched.values():
        raise AssertionError(f"kernel launches {launched}, per_op {seen}")
    _, share, step_ms = profile
    return bound_against_card("10c GS step", hlo, share * step_ms / 1e3, launched=launched,
                              kernel_ops={k: hlo["per_op"][k]["flops"] for k in launched},
                              seconds=seconds)


def bound_against_card(label, hlo, busy_s, **extra):
    """``analyze``'s counts of a step (``hlo``) against the device-busy
    seconds its profile measured -> record, logged; gate: ``bound_s`` (the
    FLOPs at the bf16 peak or the compulsory bytes at the HBM rate) <=
    ``busy_s``.  The eager byte count at the HBM rate is logged beside it,
    ungated (it is no bound: the L2 serves re-reads)."""
    out = {"bound_s": dryrun.bound_s(hlo), "busy_s": busy_s, "flops": hlo["flops"],
           "matmul_flops": hlo["matmul_flops"], "compulsory_bytes": hlo["compulsory_bytes"],
           "hbm_bytes": hlo["hbm_bytes"], **extra}
    out["share"] = out["bound_s"] / busy_s
    out["eager_bytes_share"] = hlo["hbm_bytes"] / dryrun.HBM_BW / busy_s
    log(f"{label} bound vs the card: {json.dumps(out)}")
    if not out["bound_s"] <= busy_s:
        raise AssertionError(f"{label}: bound {out['bound_s']} s above the device's "
                             f"{busy_s} s")
    return out


# ---------------------------------------------------------------------------
# Checkpoints: resume, and serving from a checkpoint
# ---------------------------------------------------------------------------


def dir_bytes(path):
    """Bytes of every file under ``path``."""
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


@contextlib.contextmanager
def timed_checkpoint_io(device):
    """Record every ``CheckpointManager.save`` (device-to-host copy +
    ``np.save``) and ``restore`` (``np.load`` + host-to-device copy) made
    inside, as (op, seconds, bytes of the step directory)."""
    io = []
    save, restore = CheckpointManager.save, CheckpointManager.restore

    def timed_save(self, step, tree, **kw):
        sync(device)
        t0 = time.perf_counter()
        d = save(self, step, tree, **kw)
        io.append(("save", time.perf_counter() - t0, dir_bytes(d)))
        return d

    def timed_restore(self, step, like, **kw):
        t0 = time.perf_counter()
        out = restore(self, step, like, **kw)
        sync(device)
        d = self._step_dir(step, kw.get("partition"))
        io.append(("restore", time.perf_counter() - t0, dir_bytes(d)))
        return out

    with patched(CheckpointManager, "save", timed_save):
        with patched(CheckpointManager, "restore", timed_restore):
            yield io


def trees_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.device == y.device and torch.equal(x, y) for x, y in zip(la, lb)
    )


def resume_phase(rec, device, tmp, *, steps=20, every=10):
    """Partition 0 of the train phase, trained ``steps`` steps saving every
    ``every`` (a densify event after each save's step), uninterrupted and
    then interrupted at ``every`` and resumed -> the resumed run's kernel
    launches (both counts set to 0 just before it and read just after)."""
    g0, cams, cfg = rec["g0"], rec["cams"], rec["cfg"]
    kw = dict(extent=rec["extent"], grid=rec["grid"], densify_every=every)
    kw.update(densify_from=0, ckpt_every=every)
    log(
        f"resume: partition 0, capacity {g0.capacity}, {int(g0.active.sum())} "
        f"live, {steps} steps saving every {every}, ladder "
        f"{cfg.resolved_k_tiers()}"
    )

    def fit(root, n, sched):
        gen = torch.Generator(device=device).manual_seed(7)
        ckpt = CheckpointManager(str(root))
        args = (g0, cams, rec["gts"], rec["masks"], cfg)
        return train_mod.fit_partition(
            *args, steps=n, schedule=sched, generator=gen, ckpt=ckpt, **kw
        )

    probes = []
    real_probe = train_mod.occupancy_probe

    def counted_probe(*a, **k):
        probes.append(1)
        return real_probe(*a, **k)

    with timed_checkpoint_io(device) as io:
        _, _, full = fit(tmp / "full", steps, cfg.tier_schedule())
        sched_a = cfg.tier_schedule()
        g_a, opt_a, _ = fit(tmp / "ab", every, sched_a)
        saved, extra = CheckpointManager(str(tmp / "ab")).restore(
            every, (g0, init_opt(g0)), device=device
        )
        equal = trees_equal(saved, (g_a, opt_a))
        caps = TierSchedule.from_state(extra["schedule"]).tier_caps
        del saved, g_a, opt_a
        zero_launches()
        with patched(train_mod, "occupancy_probe", counted_probe):
            _, _, tail = fit(tmp / "ab", steps, cfg.tier_schedule())
        launches = launch_counts()
    shutil.rmtree(tmp)
    gap = np.abs(np.subtract(tail, full[every:])) / np.asarray(full[every:])
    for op, dt, n in io:
        log(f"checkpoint {op}: {n} bytes in {dt:.3f} s ({n / dt / 1e9:.3f} GB/s)")
    log(
        f"resume: restored state equal {equal}, caps {caps} (saved "
        f"{sched_a.tier_caps}), probes {len(probes)}, launches {launches}, "
        f"tail losses max rel gap {gap.max():.3e} (uninterrupted "
        f"{[round(x, 6) for x in full[every:]]}, resumed "
        f"{[round(x, 6) for x in tail]})"
    )
    if not equal or caps != sched_a.tier_caps:
        raise AssertionError("the restored checkpoint differs from the saved state")
    n_events = sum(1 for i in range(every, steps) if (i + 1) % every == 0)
    if len(probes) != n_events or len(tail) != steps - every:
        raise AssertionError(f"resumed run: {len(probes)} probes, {len(tail)} steps")
    on_card = torch.device(device).type == "cuda"
    if on_card and not launches["bwd"] == launches["fwd"] >= steps - every:
        raise AssertionError(f"resumed run launches {launches}")
    if on_card:
        check_projected("resumed run", launches, steps - every)
    if not gap.max() <= SMALL_LOSS_RTOL:
        raise AssertionError(f"resumed losses {gap.max()} from the uninterrupted run")
    return launches


@contextlib.contextmanager
def kernel_calls(calls):
    """Both kernel wrappers with each call's tensors appended to ``calls``
    as ("fwd", (feats, origins), tile) or ("bwd", (feats, origins, out,
    gout), tile); the calls themselves run and count as before."""
    real_fwd, real_bwd = rasterize.rasterize_fwd, rasterize.rasterize_bwd

    def fwd(feats, origins, *, tile_h, tile_w):
        calls.append(("fwd", (feats, origins), (tile_h, tile_w)))
        return real_fwd(feats, origins, tile_h=tile_h, tile_w=tile_w)

    def bwd(feats, origins, out, gout, *, tile_h, tile_w):
        calls.append(("bwd", (feats, origins, out, gout), (tile_h, tile_w)))
        return real_bwd(feats, origins, out, gout, tile_h=tile_h, tile_w=tile_w)

    with patched(rasterize, "rasterize_fwd", fwd):
        with patched(rasterize, "rasterize_bwd", bwd):
            yield calls


def serve_ckpt_phase(roots, merged, device, tmp, *, views=4, max_batch=8):
    """The merged checkpoints the training CLI wrote (``roots``: float32 and
    int8 cold attributes, each a ``--ckpt-dir`` holding ``merged/``) served
    by ``serve_gs.main``; the float32 checkpoint's images against a server
    built in memory on ``merged`` (the CLI's final state merged here) ->
    every kernel's launches over the two serving runs (the counts set to 0
    just before each and read just after), and the forward kernel's error against
    its plain version and both their times on the float32 run's first
    (cold) dispatch, None where the kernel did not serve it)."""
    served, calls, dispatches, cold = {}, [], [], None
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    real_serve = GSRenderServer.serve

    def recording_serve(self, rig):
        out = real_serve(self, rig)
        calls.append((self, rig, out))
        return out

    with timed_checkpoint_io(device) as io:
        for name in ("f32", "int8"):
            argv = ["--ckpt-dir", str(roots[name]), "--views", str(views)]
            argv += ["--max-batch", str(max_batch), "--passes", "2"]
            argv += ["--telemetry-json", str(tmp / f"{name}.json")]
            argv += ["--device", device]
            zero_launches()
            with patched(GSRenderServer, "serve", recording_serve):
                with kernel_calls(dispatches):
                    rc = serve_gs.main(argv)
            for k, n in launch_counts().items():
                launches[k] += n
            launched = [d[1:] for d in dispatches if d[1][0].shape[0]]
            if name == "f32" and launched:
                cold = launched[0]  # (feats, origins), tile
            dispatches.clear()
            if rc != 0:
                raise AssertionError(f"serve_gs exited {rc}")
            served[name] = calls[0]  # the server, its rig, the cold pass
            calls.clear()
    stats = {}
    for name in ("f32", "int8"):
        with open(tmp / f"{name}.json") as f:
            passes = json.load(f)["passes"]
        stats[name] = {
            "bytes": dir_bytes(Path(roots[name]) / "merged"),
            "req_per_s": [p["req_per_s"] for p in passes],
            "hits": [p["hits"] for p in passes],
        }
        if passes[1]["hits"] != views or passes[0]["rungs"] != [0, 1]:
            raise AssertionError(f"{name} checkpoint: passes {passes}")
    for op, dt, n in io:
        log(f"merged checkpoint {op}: {n} bytes in {dt:.3f} s")
    cold_stats = None
    if cold is not None:  # on the card: the kernel served it
        (feats, origins), (th, tw) = cold
        T, K = feats.shape[:2]

        def kernel():
            return rasterize.rasterize_fwd(feats, origins, tile_h=th, tile_w=tw)

        def plain_version():
            return ref.rasterize_tiles_ref(feats, origins, tile_h=th, tile_w=tw)

        err = (kernel() - plain_version()).abs().max().item()
        label = f"first cold dispatch (f32 ckpt), {T} tiles {th}x{tw} K={K}"
        log(f"{label}: forward max abs err {err:.3e}")
        if not err <= TOL:
            raise AssertionError(f"{label}: forward err {err} > {TOL}")
        cold_stats = time_against_plain(kernel, plain_version)
        n_bytes = 4 * (feats.numel() + origins.numel() + T * 4 * th * tw)
        cold_stats.update(bound(T * K * th * tw, OPS_PER_SPLAT_PIXEL, n_bytes))
        cold_stats.update(tiles=T, K=K, max_abs_err=err)
        log(f"{label} fwd: {json.dumps(cold_stats)}")
        del feats, origins
    del cold
    log(f"served from checkpoints: {json.dumps(stats)}")

    # the float32 checkpoint serves what the in-memory model serves
    server, rig, cold = served["f32"]
    mgr = CheckpointManager(str(Path(roots["f32"]) / "merged"))
    scene = mgr.manifest_extra(mgr.latest_step())["scene"]
    center, radius = np.asarray(scene["center"]), float(scene["radius"])
    memory = GSRenderServer(
        merged, server.grid, server.cfg, center=center, radius=radius
    )
    same = all(
        np.array_equal(a.rgb, b.rgb) and np.array_equal(a.coverage, b.coverage)
        for a, b in zip(cold, memory.serve(rig))
    )
    del memory
    # the int8 checkpoint within the reference's quantization bound, on every
    # rung that serves the same splats as the float32 one (a rung is chosen
    # by an impact rank that the quantized opacity may reorder)
    qserver, _, qcold = served["int8"]
    errs = {}
    for r, (a, b) in enumerate(zip(server.ladder, qserver.ladder)):
        imgs = [(x.rgb, y.rgb) for x, y in zip(cold, qcold) if x.rung == r]
        err = np.abs(np.stack([x for x, _ in imgs]) - np.stack([y for _, y in imgs]))
        errs[r] = {
            "same_splats": bool(torch.equal(a.means, b.means)),
            "worst": float(err.max()),
            "mean": float(err.mean()),
        }
    log(f"int8 vs float32 checkpoint images by rung: {json.dumps(errs)}")
    ratio = stats["int8"]["bytes"] / stats["f32"]["bytes"]
    log(f"checkpoint bytes int8 / float32 {ratio:.4f}; in-memory images equal {same}")
    if not same:
        raise AssertionError("the checkpoint's server differs from the in-memory one")
    if not ratio < 0.9:
        raise AssertionError(f"int8 checkpoint at {ratio} of the float32 one")
    if not errs[0]["same_splats"]:
        raise AssertionError("the full-model rung differs between the checkpoints")
    for r, e in errs.items():
        if e["same_splats"] and not (e["worst"] <= 0.02 and e["mean"] <= 0.005):
            raise AssertionError(f"int8 images on rung {r}: {e}")
    return launches, cold_stats


# ---------------------------------------------------------------------------
# The training CLI: the paper's distributed trainer, as a user runs it
# ---------------------------------------------------------------------------


def partition_losses(fwd, g, batch, T, lam, win):
    """Each partition's share of one step's loss: the step's own forward
    (``fwd`` returns its tiles) on the step's input state and batch, the
    masked L1 + per-tile D-SSIM taken over each partition's tiles alone and
    averaged over the batch's views -> [loss of partition p]."""
    with torch.no_grad():
        _, tiles = fwd(g, batch["cam"], batch["gt_tiles"], batch["mask_tiles"])
    out = np.zeros(g.means.shape[0])
    for v in range(tiles.shape[0]):
        for p in range(out.shape[0]):
            sl = slice(p * T, (p + 1) * T)
            l1n, l1d, sn, sd = dist_mod._loss_partials(
                tiles[v, sl, :3], batch["gt_tiles"][v, sl],
                batch["mask_tiles"][v, sl], win_size=win,
            ).tolist()
            out[p] += (1 - lam) * l1n / max(l1d, 1.0) + lam * (
                1.0 - sn / max(sd, 1.0)
            ) / 2.0
    return list(out / tiles.shape[0])


@contextlib.contextmanager
def observed_fit_partitions(device, rec):
    """``distributed.fit_partitions`` as ``launch/train.py`` calls it, with
    its inputs and result, each step's wall time, overflow counters and
    per-partition loss, both kernels' launches inside it, and the tensors
    of every kernel call of the latest step (``rec["step_calls"]``)
    recorded in ``rec``.  The per-partition losses come from a second
    forward of each step (the step's own schedule and assignment, outside
    the timed call) with the launch counts put back afterwards: those
    launches are not the CLI's."""
    real_fit = dist_mod.fit_partitions
    real_make = dist_mod.make_gs_train_step
    rec.update(step_ms=[], overflow=[], part_losses=[])

    def make(mesh, cfg, grid, extent, **kw):
        step = real_make(mesh, cfg, grid, extent, **kw)
        fwd = dist_mod.make_gs_forward(
            mesh, grid, K=cfg.assign_K, impl=kw["impl"], views=kw["views"],
            lambda_dssim=cfg.lambda_dssim, k_tiers=kw["k_tiers"],
            tier_caps=kw["tier_caps"], win_size=kw["win_size"],
            assign_impl=kw["assign_impl"], assign_budget=kw["assign_budget"],
            return_tiles=True,
        )

        def timed(g, opt, batch):
            counts = launch_counts()
            rec["part_losses"].append(partition_losses(
                fwd, g, batch, grid.n_tiles, cfg.lambda_dssim, kw["win_size"]
            ))
            set_launches(counts)
            calls = []
            sync(device)
            t0 = time.perf_counter()
            with kernel_calls(calls):
                out = step(g, opt, batch)
            sync(device)
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["step_calls"] = calls
            ov = out[3]
            rec["overflow"].append((int(ov["tiles"]), int(ov["assign"])))
            return out

        return timed

    def fit(g, cams, gts, masks, cfg, *, mesh, **kw):
        c0 = launch_counts()
        out = real_fit(g, cams, gts, masks, cfg, mesh=mesh, **kw)
        rec["fit_launches"] = launches_since(c0)
        rec.update(
            g0=g, g1=out[0], losses=out[2], cams=cams, gts=gts, masks=masks,
            cfg=cfg, grid=kw["grid"], extent=kw["extent"], mesh=str(mesh),
            schedule=kw["schedule"], densify_every=kw["densify_every"],
            densify_from=kw["densify_from"],
        )
        return out

    with patched(dist_mod, "fit_partitions", fit):
        with patched(dist_mod, "make_gs_train_step", make):
            yield rec


def run_cli(argv):
    """``launch.train.main(argv)`` with its standard output kept (and
    echoed) -> the output's lines."""
    buf = io_mod.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"cli | {line}")
    if rc != 0:
        raise AssertionError(f"launch.train exited {rc}")
    return text


def cli_argv(root, device, *, dataset, full, parts, resolution, views, steps,
             densify_every, densify_from, ckpt_every):
    argv = ["--gs", "--dataset", dataset] + (["--full"] if full else [])
    argv += ["--parts", str(parts), "--resolution", str(resolution)]
    argv += ["--views", str(views), "--steps", str(steps)]
    argv += ["--densify-every", str(densify_every), "--densify-from"]
    argv += [str(densify_from), "--ckpt-every", str(ckpt_every)]
    return argv + ["--ckpt-dir", str(root), "--device", device]


def single_partition_steps(rec):
    """``fit_partition`` on partition 0 of the CLI's initial state, with the
    CLI's cfg, view batch, step count and densify events -> each step's
    wall time (ms)."""
    times = []
    real_make = train_mod.make_train_step
    dev = rec["g0"].means.device

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def timed(*sa, **sk):
            sync(dev)
            t0 = time.perf_counter()
            out = step(*sa, **sk)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    g0 = type(rec["g0"])(*(f[0] for f in rec["g0"]))
    masks = None if rec["masks"] is None else rec["masks"][0]
    with patched(train_mod, "make_train_step", make):
        train_mod.fit_partition(
            g0, rec["cams"], rec["gts"][0], masks, rec["cfg"],
            steps=len(rec["step_ms"]), extent=rec["extent"], grid=rec["grid"],
            densify_every=rec["densify_every"], densify_from=rec["densify_from"],
        )
    return times


def train_cli_phase(
    device,
    tmp,
    issue,
    *,
    dataset="kingsnake",
    full=True,
    parts=2,
    resolution=1024,
    views=16,
    steps=80,
    densify_every=10,
    densify_from=60,
    ckpt_every=40,
):
    """``python -m repro_torch.launch.train --gs ...`` as a user runs it (the
    defaults: the full-size kingsnake scene), in-process on a world-1
    process group (NCCL on the card), then again with ``--ckpt-quantize
    int8`` on a copy of its last checkpoint (no step to run: it merges and
    writes the int8 merged checkpoint) -> (the float32 and int8 roots, the
    final state merged in memory, the launches of the first run: both counts
    set to 0 just before it and read just after, both kernels' stats on the
    last step's tier tables, the record of its ``fit_partitions`` call:
    initial state, rig, images, cfg, grid).  Checked: bwd launches == fwd launches > 0
    inside ``fit_partitions``, each partition's loss falls
    (the mean of its first 10 steps against its last 10), the last step's
    overflow counters 0, merged metrics finite, and both kernels within
    TOL / BWD_TOL of their plain versions on the last step's tier tables
    (``issue``: {kernel: hot loop}, as ``time_tiers`` takes it)."""
    root, qroot = tmp / "cli", tmp / "cli_int8"
    kw = dict(dataset=dataset, full=full, parts=parts, resolution=resolution)
    kw.update(views=views, steps=steps, densify_every=densify_every)
    kw.update(densify_from=densify_from, ckpt_every=ckpt_every)
    argv = cli_argv(root, device, **kw)
    log(f"train CLI: python -m repro_torch.launch.train {' '.join(argv)}")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rec = {}
    t0 = time.perf_counter()
    with observed_fit_partitions(device, rec):
        zero_launches()
        text = run_cli(argv)
        launches = launch_counts()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    losses = np.asarray(rec["losses"])
    metrics = re.search(r"PSNR ([0-9.]+)\s+SSIM ([0-9.]+)", text)
    psnr, ssim = (float(x) for x in metrics.groups())
    step_ms = statistics.median(rec["step_ms"])
    fit = rec["fit_launches"]
    part = np.asarray(rec["part_losses"])                    # (steps, P)
    first, last = part[:10].mean(0), part[-10:].mean(0)
    log(
        f"train CLI: {len(losses)} steps on mesh {rec['mesh']}, loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; per partition, mean of the "
        f"first/last 10 steps {[round(float(x), 6) for x in first]} -> "
        f"{[round(float(x), 6) for x in last]}; median step {step_ms:.3f} ms (min "
        f"{min(rec['step_ms']):.3f}, max {max(rec['step_ms']):.3f}); launches in "
        f"fit_partitions {fit}, in the whole run {launches}; last overflow "
        f"(tiles, assign) {rec['overflow'][-1]}; schedule {rec['schedule']}; "
        f"peak device memory {peak:.2f} GiB; merged PSNR {psnr} SSIM {ssim}; "
        f"phase {seconds:.3f} s"
    )
    log(f"train CLI losses {[round(float(x), 6) for x in losses]}")
    for p in range(part.shape[1]):
        log(f"train CLI partition {p} losses {part[:, p].round(6).tolist()}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"train CLI losses {losses}")
    if on_card and not fit["bwd"] == fit["fwd"] > 0:
        raise AssertionError(f"fit_partitions launches {fit}")
    if on_card:
        check_projected("train CLI fit_partitions", fit, steps)
    for p, (a, b) in enumerate(zip(first, last)):
        if not b < a:
            raise AssertionError(f"partition {p}: loss did not fall {a} -> {b}")
    if rec["overflow"][-1] != (0, 0):
        raise AssertionError(f"overflow at the last step {rec['overflow'][-1]}")
    if not (math.isfinite(psnr) and math.isfinite(ssim)):
        raise AssertionError(f"merged metrics {psnr} {ssim}")

    # both kernels held against their plain versions, and timed, on the
    # tier tables of the CLI's last fit_partitions step (its own 8x16
    # tiles, ladder and caps, and the loss's own cotangent)
    th, tw = rec["grid"].tile_h, rec["grid"].tile_w
    calls = rec.pop("step_calls")
    planes = sorted(
        (
            (a[0].shape[1],) + a
            for kind, a, _ in calls
            if kind == "bwd" and a[0].shape[0]
        ),
        key=lambda x: x[0],
    )
    n_fwd = sum(kind == "fwd" and a[0].shape[0] > 0 for kind, a, _ in calls)
    del calls
    tiers = {"fwd": {}, "bwd": {}}
    if on_card or planes:  # on the CPU the step runs the plain versions
        if not (planes and n_fwd == len(planes)):
            raise AssertionError(f"last step: {n_fwd} fwd calls, {len(planes)} bwd")
        shapes = [(p[0], p[1].shape[0]) for p in planes]
        log(f"train CLI last step: (K, tiles) {shapes} at {th}x{tw}")
        tiers = time_tiers(planes, th, tw, issue, "train CLI")
    del planes

    # the batched two-partition step next to fit_partition's one-partition
    # step, same card, cfg, scene, step count and densify events; medians
    # over all steps and over the same steady window
    single = single_partition_steps(rec)
    stop = min(STEADY[1], rec["densify_from"], len(single))
    window = slice(min(STEADY[0], stop - 1), stop)
    both = {"fit_partitions": rec["step_ms"], "fit_partition": single}
    med = {k: statistics.median(v) for k, v in both.items()}
    steady = {k: statistics.median(v[window]) for k, v in both.items()}
    log(
        f"step time: fit_partitions ({parts} partitions in one step) vs "
        f"fit_partition (partition 0 alone), {len(single)} steps each: median "
        f"over all steps {med}, over steps [{window.start}, {window.stop}) "
        f"{steady}, ratio {steady['fit_partitions'] / steady['fit_partition']:.4f}"
    )
    log(f"fit_partition step ms {[round(x, 3) for x in single]}")
    log(f"fit_partitions step ms {[round(x, 3) for x in rec['step_ms']]}")

    # the same CLI again on a copy of its last checkpoint, with int8 cold
    # attributes: it resumes at the last step, trains none, merges, writes
    shutil.copytree(root / f"step_{steps:09d}", qroot / f"step_{steps:09d}")
    qtext = run_cli(cli_argv(qroot, device, **kw) + ["--ckpt-quantize", "int8"])
    if "skipping to merge" not in qtext or "quantized" not in qtext:
        raise AssertionError("the int8 re-merge did not run as expected")
    g1 = rec["g1"]
    merged = merge_partitions(
        [type(g1)(*(f[p] for f in g1)) for p in range(parts)], range(parts)
    )
    return {"f32": root, "int8": qroot}, merged, launches, tiers, rec


def mesh_axes_phase(rec, device, *, budgets=(1.0, 0.9), reps=3):
    """The distributed step on the four-axis mesh: a world-1 ("pod", "part",
    "model", "view") 1x1x1x1 group (NCCL on the card) and one train step
    of the CLI's initial state (both partitions, its cfg and 8x16 grid,
    view 0), probed as ``fit_partitions`` probes, once per strip budget.
    At 1x1x1x1 the strip is the whole grid and 0.9 of a partition's slots
    exceeds its live splats, so every budget must give the same forward
    loss and tiles and the same step loss within 1e-6.  -> both kernels'
    launches in the steps (counts set to 0 just before, read just after);
    each must be > 0."""
    from repro_torch.launch import mesh as mesh_mod

    g, cfg, grid = rec["g0"], rec["cfg"], rec["grid"]
    Pn = g.means.shape[0]
    gt_t, mask_t = dist_mod._tile_view_batches(rec["gts"], rec["masks"], grid)
    vi = torch.arange(1, device=g.means.device)
    opt = init_opt(g)
    mesh_mod.init_distributed(device)
    try:
        mesh = mesh_mod.make_mesh((1, 1, 1, 1), ("pod", "part", "model", "view"))
        batch = dist_mod.gs_shard_batch(
            {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
             "cam": select(rec["cams"], vi)}, mesh, 1, n_parts=Pn)
        del gt_t, mask_t
        impl, budget = dist_mod.resolve_assignment_global(
            mesh, g, rec["cams"], grid, assign_impl=cfg.assign_impl,
            assign_budget=cfg.assign_budget)
        sched = cfg.tier_schedule()
        dist_mod.probe_gs_schedule(sched, mesh, grid, g, batch["cam"], views=1,
                                   assign_impl=impl, assign_budget=budget)
        kw = dict(views=1, k_tiers=sched.k_tiers, tier_caps=sched.tier_caps,
                  assign_impl=impl, assign_budget=budget, return_overflow=True)
        out = {}
        zero_launches()
        for sb in budgets:
            c = dataclasses.replace(cfg, strip_budget=sb)
            step = dist_mod.make_gs_train_step(mesh, c, grid, rec["extent"], **kw)
            times = []
            for _ in range(reps):
                sync(device)
                t0 = time.perf_counter()
                _, _, loss, ov = step(g, opt, batch)
                sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            out[sb] = {"step_loss": float(loss), "step_ms": times,
                       "overflow": (int(ov["tiles"]), int(ov["assign"]))}
        launches = launch_counts()
        counts = launch_counts()
        for sb in budgets:
            fwd = dist_mod.make_gs_forward(
                mesh, grid, K=cfg.assign_K, lambda_dssim=cfg.lambda_dssim,
                strip_budget=sb, return_tiles=True, **kw)
            with torch.no_grad():
                loss, tiles, _ = fwd(g, batch["cam"], batch["gt_tiles"],
                                     batch["mask_tiles"])
            out[sb].update(loss=float(loss), tiles=tiles)
        set_launches(counts)
    finally:
        mesh_mod.destroy_distributed()
    a, b = (out[sb] for sb in budgets)
    tile_err = float((a["tiles"] - b["tiles"]).abs().max())
    n = g.means.shape[1]
    for sb in budgets:
        kept = dist_mod.strip_rows(n, sb) if sb < 1.0 else n
        log(f"mesh axes: {mesh}, strip_budget {sb} ({kept} of {n} rows "
            f"kept): forward loss {out[sb]['loss']:.9f}, "
            f"step loss {out[sb]['step_loss']:.9f}, overflow "
            f"{out[sb]['overflow']}, step ms "
            f"{[round(x, 3) for x in out[sb]['step_ms']]}")
    log(f"mesh axes: schedule {sched}, assignment {impl} budget {budget}; "
        f"max |tiles 1.0 - tiles {budgets[1]}| {tile_err:.3g}; launches in "
        f"the steps {launches}")
    if not (abs(a["loss"] - b["loss"]) <= 1e-6 and tile_err <= 1e-6
            and abs(a["step_loss"] - b["step_loss"]) <= 1e-6):
        raise AssertionError(f"strip_budget {budgets[1]} differs from 1.0")
    if torch.device(device).type == "cuda" and not (
        launches["bwd"] == launches["fwd"] > 0
    ):
        raise AssertionError(f"mesh axes launches {launches}")
    if torch.device(device).type == "cuda":
        check_projected("mesh axes", launches, reps * len(budgets))
    return launches


#: the wire phase's variants: (name, cfg fields)
WIRE_VARIANTS = (
    ("f32", {}),
    ("bf16", dict(dtype_policy="bf16")),
    ("split", dict(gather_mode="split")),
    ("split+bf16", dict(gather_mode="split", dtype_policy="bf16")),
    ("compress bf16", dict(grad_compress="bf16")),
    ("compress int8", dict(grad_compress="int8")),
)


def plain_compress(grads, mode):
    """The reference's quantise -> dequantise of ``optim/compress.py`` from
    a zero residual, written out plainly: "bf16" rounds through bfloat16;
    "int8" scales each whole tensor by max(max |g|, 1e-12) / 127, rounds
    half to even, clips to [-127, 127] -> (dequantised, residual)."""
    if mode == "bf16":
        return {k: g.to(torch.bfloat16).to(torch.float32)
                for k, g in grads.items()}, None
    deq, res = {}, {}
    for k, g in grads.items():
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq[k] = q.to(torch.float32) * scale
        res[k] = g - deq[k]
    return deq, res


def check_compressed_step(mode, seen, m_c, m_f32, b1):
    """The first compressed step of ``mode`` from the initial state: its
    summed gradients are the f32 step's (from its first Adam moments m =
    (1 - b1) grad, within 1e-3 of their largest, the card gate of PERF.md
    section 2), ``compress_grads`` turned them into ``plain_compress`` of
    them and its residual, bit for bit, and Adam took exactly those (m ==
    (1 - b1) * compressed)."""
    grads, got, err = seen
    want, want_err = plain_compress(grads, mode)
    gap, flips = 0.0, 0
    for k, g in grads.items():
        ref = m_f32[k]
        gap = max(gap, float(((1 - b1) * g - ref).abs().max()
                             / max(float(ref.abs().max()), 1e-30)))
        flips += int((got[k] != want[k]).sum())
        if want_err is not None:
            flips += int((err[k] != want_err[k]).sum())
        flips += int((m_c[k] != (1 - b1) * got[k]).sum())
    log(f"wire compress {mode}: first step's gradients vs the f32 step's "
        f"{gap:.4g} of the largest (gate 1e-3); compressed gradients, "
        f"residual and Adam moments vs plain_compress: {flips} differ")
    if not gap <= 1e-3 or flips:
        raise AssertionError(f"wire compress {mode}: gradient gap {gap}, "
                             f"{flips} entries differ from plain_compress")


def wire_phase(rec, device, *, steps=3):
    """The distributed step's wire options on a world-1 ("pod", "part",
    "model", "view") mesh (NCCL on the card): the CLI's initial state, its
    cfg and 8x16 grid, view 0, the schedule probed on views 0 and 1 as
    ``fit_partitions`` probes a one-view batch.  For each of WIRE_VARIANTS,
    ``steps`` chained train steps from the initial state (both kernels'
    counts set to 0 just before and read just after; each variant must
    launch both, bwd == fwd >= steps) and the forward on the initial state
    (its launches not counted).  -> the steps' launches.  Checked: every
    loss finite, the compress variants' forward loss within 1e-7 of f32's,
    split's mean tile gap against f32 <= 2e-3, and each compress
    variant's first step (``check_compressed_step``)."""
    from repro_torch.launch import mesh as mesh_mod

    g, cfg, grid = rec["g0"], rec["cfg"], rec["grid"]
    Pn = g.means.shape[0]
    gt_t, mask_t = dist_mod._tile_view_batches(rec["gts"], rec["masks"], grid)
    vi = torch.arange(1, device=g.means.device)
    on_card = torch.device(device).type == "cuda"
    mesh_mod.init_distributed(device)
    try:
        mesh = mesh_mod.make_mesh((1, 1, 1, 1), ("pod", "part", "model", "view"))
        batch = dist_mod.gs_shard_batch(
            {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
             "cam": select(rec["cams"], vi)}, mesh, 1, n_parts=Pn)
        del gt_t, mask_t
        impl, budget = dist_mod.resolve_assignment_global(
            mesh, g, rec["cams"], grid, assign_impl=cfg.assign_impl,
            assign_budget=cfg.assign_budget)
        sched = cfg.tier_schedule()
        probe = [select(rec["cams"], torch.tensor([v], device=vi.device))
                 for v in (0, 1)]
        dist_mod.probe_gs_schedule(sched, mesh, grid, g, probe, views=1,
                                   assign_impl=impl, assign_budget=budget)
        kw = dict(views=1, k_tiers=sched.k_tiers, tier_caps=sched.tier_caps,
                  assign_impl=impl, assign_budget=budget, return_overflow=True)
        out = {}
        total = dict.fromkeys(LAUNCH_KEYS, 0)
        # each variant's first-step Adam first moments, and each compress
        # mode's first call: (summed gradients in, compressed out)
        first_m, seen = {}, {}
        real_compress = dist_mod.compress_grads

        def spy(grads, mode, err=None, **kw):
            res = real_compress(grads, mode, err, **kw)
            if mode not in seen:
                seen[mode] = ({k: v.clone() for k, v in grads.items()},
                              res[0], res[1])
            return res

        with patched(dist_mod, "compress_grads", spy):
            for name, opts in WIRE_VARIANTS:
                c = dataclasses.replace(cfg, **opts)
                step = dist_mod.make_gs_train_step(mesh, c, grid, rec["extent"], **kw)
                gg, oo = g, init_opt(g)
                err = dist_mod.zero_err(g, c.grad_compress)
                times, losses = [], []
                zero_launches()
                for _ in range(steps):
                    sync(device)
                    t0 = time.perf_counter()
                    if c.grad_compress == "none":
                        gg, oo, loss, ov = step(gg, oo, batch)
                    else:
                        gg, oo, err, loss, ov = step(gg, oo, err, batch)
                    sync(device)
                    times.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(loss))
                    if len(losses) == 1 and name.startswith(("f32", "compress")):
                        first_m[name] = {k: m.clone() for k, m in oo.m.items()}
                launches = launch_counts()
                for k in total:
                    total[k] += launches[k]
                del gg, oo
                fwd = dist_mod.make_gs_forward(
                    mesh, grid, K=cfg.assign_K, lambda_dssim=cfg.lambda_dssim,
                    return_tiles=True, gather_mode=c.gather_mode,
                    dtype_policy=c.dtype_policy, **kw)
                counts = launch_counts()
                with torch.no_grad():
                    floss, tiles, _ = fwd(g, batch["cam"], batch["gt_tiles"],
                                          batch["mask_tiles"])
                set_launches(counts)
                res = max((float(e.abs().max()) for e in err.values()), default=0.0) \
                    if err else None
                out[name] = {"step_ms": times, "losses": losses, "launches": launches,
                             "loss": float(floss), "tiles": tiles, "err": res,
                             "overflow": (int(ov["tiles"]), int(ov["assign"]))}
        # where split's extra step time goes: one step of each under the
        # profiler (launches not counted)
        counts = launch_counts()
        prof = {}
        for name in ("f32", "split"):
            c = dataclasses.replace(cfg, **dict(WIRE_VARIANTS)[name])
            step = dist_mod.make_gs_train_step(mesh, c, grid, rec["extent"], **kw)
            opt0 = init_opt(g)
            rows, share, wall, _ = device_profile(
                lambda: step(g, opt0, batch), 1, g.means.device)
            prof[name] = ({k: t for k, (_, t) in rows}, share, wall)
        set_launches(counts)
        # the wire bytes of each table layout, from the tables themselves
        p0 = type(g)(*(f[0, :128] for f in g))
        splats = project(p0, select(rec["cams"], 0))
        wire = {
            f"{mode}/{pol}": dist_mod.wire_bytes_per_splat(cast_tables(
                dist_mod.wire_tables(splats, mode), pol))
            for mode in ("f32", "split") for pol in ("f32", "bf16")}
    finally:
        mesh_mod.destroy_distributed()
    for mode in ("bf16", "int8"):
        check_compressed_step(mode, seen[mode], first_m[f"compress {mode}"],
                              first_m["f32"], cfg.b1)
    del seen, first_m
    base = out["f32"]["tiles"][..., :3, :, :]
    n_rows = 2 * g.means.shape[1]
    log(f"wire: {mesh}, schedule {sched}, assignment {impl} budget {budget}; "
        f"wire bytes a splat (gather_mode/dtype_policy) {wire}; the all-gather "
        f"moves {n_rows} rows a step ({n_rows * wire['f32/f32'] / 1e6:.1f} MB at "
        f"f32, {n_rows * wire['split/bf16'] / 1e6:.1f} MB split + bf16; world 1: "
        f"no collective runs)")
    for name, _ in WIRE_VARIANTS:
        o = out[name]
        gap = (o["tiles"][..., :3, :, :] - base).abs()
        o["gap"] = (float(gap.max()), float(gap.mean()))
        log(f"wire {name}: step ms {[round(x, 3) for x in o['step_ms']]} "
            f"(median {statistics.median(o['step_ms']):.3f}), step losses "
            f"{[round(x, 9) for x in o['losses']]}, forward loss {o['loss']:.9f} "
            f"(f32 {out['f32']['loss']:.9f}), tile gap to f32 max "
            f"{o['gap'][0]:.4g} mean {o['gap'][1]:.4g}, overflow {o['overflow']}, "
            f"launches {o['launches']}"
            + (f", int8 residual max |e| {o['err']:.4g}" if o["err"] is not None
               else ""))
    for name, o in out.items():
        if not all(math.isfinite(x) for x in o["losses"] + [o["loss"]]):
            raise AssertionError(f"wire {name}: losses {o['losses']} {o['loss']}")
        la = o["launches"]
        if on_card and not la["bwd"] == la["fwd"] >= steps:
            raise AssertionError(f"wire {name}: launches {la}")
        if on_card:
            check_projected(f"wire {name}", la, steps)
    for name in ("compress bf16", "compress int8"):
        if abs(out[name]["loss"] - out["f32"]["loss"]) > 1e-7:
            raise AssertionError(f"wire {name}: forward loss {out[name]['loss']} "
                                 f"vs f32 {out['f32']['loss']}")
    (a, sa, wa), (b, sb, wb) = prof["f32"], prof["split"]
    log(f"wire profile, one step: f32 {wa / 1e3:.3f} ms (device busy "
        f"{100 * sa:.1f}%, {sum(a.values()) / 1e3:.3f} ms of device time), split "
        f"{wb / 1e3:.3f} ms (busy {100 * sb:.1f}%, {sum(b.values()) / 1e3:.3f} ms); "
        "the kernels whose device time moved most (split - f32, ms):")
    moved = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, 0) - a.get(k, 0)))
    for k in moved[:8]:
        log(f"  {(b.get(k, 0) - a.get(k, 0)) / 1e3:+8.3f}  f32 {a.get(k, 0) / 1e3:8.3f}"
            f"  split {b.get(k, 0) / 1e3:8.3f}  {k[:90]}")
    split_gap = out["split"]["gap"]
    log(f"wire: split tile gap max {split_gap[0]:.4g} (the reference's gate 5e-2: "
        f"{'held' if split_gap[0] < 5e-2 else 'NOT held'}), mean "
        f"{split_gap[1]:.4g} (gate 2e-3)")
    if not split_gap[1] <= 2e-3:
        raise AssertionError(f"wire split: mean tile gap {split_gap[1]}")
    if wire != {"f32/f32": 76, "f32/bf16": 38, "split/f32": 32, "split/bf16": 24}:
        raise AssertionError(f"wire bytes {wire}")
    return total


#: the exchange phase's variants: (name, cfg fields, budget: None, "probe"
#: (the probed scalar), "matrix" (a 1x1 matrix of it) or "gather")
EXCHANGE_VARIANTS = (
    ("gather", {}, "gather"),
    ("exchange, no budget", dict(exchange=True), None),
    ("exchange, probed", dict(exchange=True), "probe"),
    ("exchange, 1x1 matrix", dict(exchange=True), "matrix"),
    ("gather int8", dict(grad_compress="int8"), "gather"),
    ("exchange int8", dict(exchange=True, grad_compress="int8"), "probe"),
)


def exchange_phase(rec, device, *, steps=3, fit_steps=4):
    """The sparse-overlap exchange on the wire phase's world-1 ("pod",
    "part", "model", "view") mesh, state, view and probed tier schedule:
    ``steps`` chained train steps from the initial state for each of
    EXCHANGE_VARIANTS (both kernels' counts set to 0 just before each
    variant's steps and read just after); at world 1 the sub-window is the
    whole strip, so each loss must equal its gather twin's within 1e-6
    relative with every counter 0.  Then one forward at a quarter of the
    probed demand must fire the counter with a finite loss, and
    ``fit_partitions`` from that starved, pinned budget must grow it past
    the demand in ``fit_steps`` steps (view 0 every step; its launches
    counted too).  Printed: each variant's median step ms, the
    rows each table carries, the packing's own ms (CUDA events on the
    card).  -> the launches of the steps and of the fit."""
    from repro_torch.launch import mesh as mesh_mod

    g, cfg, grid = rec["g0"], rec["cfg"], rec["grid"]
    Pn, N = g.means.shape[:2]
    gt_t, mask_t = dist_mod._tile_view_batches(rec["gts"], rec["masks"], grid)
    vi = torch.arange(1, device=g.means.device)
    on_card = torch.device(device).type == "cuda"
    mesh_mod.init_distributed(device)
    try:
        mesh = mesh_mod.make_mesh((1, 1, 1, 1), ("pod", "part", "model", "view"))
        batch = dist_mod.gs_shard_batch(
            {"gt_tiles": gt_t[vi], "mask_tiles": mask_t[vi],
             "cam": select(rec["cams"], vi)}, mesh, 1, n_parts=Pn)
        del gt_t, mask_t
        impl, budget = dist_mod.resolve_assignment_global(
            mesh, g, rec["cams"], grid, assign_impl=cfg.assign_impl,
            assign_budget=cfg.assign_budget)
        sched = cfg.tier_schedule()
        probe = [select(rec["cams"], torch.tensor([v], device=vi.device))
                 for v in (0, 1)]
        dist_mod.probe_gs_schedule(sched, mesh, grid, g, probe, views=1,
                                   assign_impl=impl, assign_budget=budget,
                                   exchange=True)
        demand = dist_mod.make_gs_exchange_probe(mesh, grid, views=1)(
            g, batch["cam"])
        E = dist_mod.probe_gs_exchange(dist_mod.ExchangeSchedule(), mesh, grid,
                                       g, batch["cam"], views=1)
        budgets = {None: None, "probe": E, "matrix": np.array([[E]]),
                   "gather": None}
        kw = dict(views=1, k_tiers=sched.k_tiers, tier_caps=sched.tier_caps,
                  assign_impl=impl, assign_budget=budget, return_overflow=True)
        out = {}
        total = dict.fromkeys(LAUNCH_KEYS, 0)
        for name, opts, which in EXCHANGE_VARIANTS:
            c = dataclasses.replace(cfg, **opts)
            step = dist_mod.make_gs_train_step(
                mesh, c, grid, rec["extent"], exchange_budget=budgets[which],
                **kw)
            gg, oo = g, init_opt(g)
            err = dist_mod.zero_err(g, c.grad_compress)
            times, losses, ovs = [], [], []
            zero_launches()
            for _ in range(steps):
                sync(device)
                t0 = time.perf_counter()
                if c.grad_compress == "none":
                    gg, oo, loss, ov = step(gg, oo, batch)
                else:
                    gg, oo, err, loss, ov = step(gg, oo, err, batch)
                sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                ovs.append({k: v.tolist() for k, v in ov.items()})
            launches = launch_counts()
            for k in total:
                total[k] += launches[k]
            del gg, oo, err
            out[name] = {"step_ms": times, "losses": losses, "overflow": ovs,
                         "launches": launches}
        # the packing alone (overlap, row choice, the rows taken) on the
        # initial state's tables (no kernel runs)
        with torch.no_grad():
            splats = dist_mod._project_rows(g, batch["cam"], True)
            tabs = [x.reshape((-1,) + tuple(x.shape[2:]))
                    for x in dist_mod.wire_tables(splats, "f32")]
            del splats

            def pack():
                first = tabs[0]
                hit = dist_mod._exchange_hits(
                    (first[..., 0], first[..., 1], tabs[1][..., 0],
                     tabs[1][..., 2] > 0.5), grid, 0, grid.n_tiles,
                    grid.n_tiles, 1)
                move = dist_mod._pack_exchange(hit, None, 0, E, None)[0]
                return [move(x) for x in tabs]

            moved = pack()
            rows = {"gather": int(tabs[0].shape[0] * tabs[0].shape[1]),
                    "exchange": int(moved[0].shape[0] * moved[0].shape[1])}
            del moved
            pack_ms = (cuda_time_ms(pack, 5) if on_card else None)
            del tabs
        # a starved budget: a quarter of the demand fires the counter
        quarter = max(1, demand // 4)
        fwd = dist_mod.make_gs_forward(
            mesh, grid, K=cfg.assign_K, lambda_dssim=cfg.lambda_dssim,
            exchange=True, exchange_budget=quarter, **kw)
        counts = launch_counts()
        with torch.no_grad():
            s_loss, s_ov = fwd(g, batch["cam"], batch["gt_tiles"],
                               batch["mask_tiles"])
        set_launches(counts)
        starved = {"loss": float(s_loss), "exchange": int(s_ov["exchange"])}
        # ... and fit_partitions grows it off the counter
        esched = dist_mod.ExchangeSchedule(budget=quarter)
        before = esched.budget
        c = dataclasses.replace(cfg, exchange=True, exchange_budget=quarter)
        zero_launches()
        _, _, fit_losses = dist_mod.fit_partitions(
            g, select(rec["cams"], vi), rec["gts"][:, :1], rec["masks"][:, :1],
            c, mesh=mesh,
            steps=fit_steps, extent=rec["extent"], grid=grid, schedule=sched,
            exchange_schedule=esched)
        fit_launches = launch_counts()
        for k in total:
            total[k] += fit_launches[k]
    finally:
        mesh_mod.destroy_distributed()
    log(f"exchange: {mesh}, schedule {sched}, assignment {impl} budget "
        f"{budget}; probed demand {demand} of {N} rows a partition, scalar "
        f"budget {E}; rows a step: all-gather table {rows['gather']}, "
        f"exchange table {rows['exchange']} (world 1: no collective runs); "
        f"packing alone {pack_ms if pack_ms is None else round(pack_ms, 3)} ms")
    base = {"gather": out["gather"]["losses"],
            "int8": out["gather int8"]["losses"]}
    for name, _, which in EXCHANGE_VARIANTS:
        o = out[name]
        ref = base["int8" if "int8" in name else "gather"]
        gap = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(o["losses"], ref))
        log(f"exchange {name}: step ms {[round(x, 3) for x in o['step_ms']]} "
            f"(median {statistics.median(o['step_ms']):.3f}), losses "
            f"{[round(x, 9) for x in o['losses']]}, relative gap to its gather "
            f"twin {gap:.3g}, last overflow {o['overflow'][-1]}, launches "
            f"{o['launches']}")
        if not gap <= 1e-6 or not all(math.isfinite(x) for x in o["losses"]):
            raise AssertionError(f"exchange {name}: losses {o['losses']} vs {ref}")
        if any(v for ov in o["overflow"] for v in np.ravel(ov["exchange"])):
            raise AssertionError(f"exchange {name}: counter {o['overflow']}")
        la = o["launches"]
        if on_card and not la["bwd"] == la["fwd"] >= steps:
            raise AssertionError(f"exchange {name}: launches {la}")
        if on_card:
            check_projected(f"exchange {name}", la, steps)
    log(f"exchange starved: budget {quarter} (a quarter of the demand {demand}): "
        f"counter {starved['exchange']}, loss {starved['loss']:.9f}; "
        f"fit_partitions {fit_steps} steps from it: budget {before} -> "
        f"{esched.budget}, losses {[round(x, 9) for x in fit_losses]}, "
        f"launches {fit_launches}")
    if not (starved["exchange"] > 0 and math.isfinite(starved["loss"])):
        raise AssertionError(f"exchange starved: {starved}")
    if not (esched.budget >= demand > before
            and all(math.isfinite(x) for x in fit_losses)) or (
            on_card and not fit_launches["bwd"] == fit_launches["fwd"] >= fit_steps):
        raise AssertionError(f"exchange growth: {before} -> {esched.budget}, "
                             f"demand {demand}, losses {fit_losses}")
    if on_card:
        check_projected("exchange fit_partitions", fit_launches, fit_steps)
    return total


@contextlib.contextmanager
def observed_timeseries(device, rec):
    """``launch.train --timeseries`` with, in ``rec``: each
    ``fit_partitions`` call's events in order ("probe": a tier probe,
    "step" with its wall ms, "densify" with each partition's live splats
    before and after) and losses, the ``warm_start`` it was given; the tree
    each ``save`` / ``save_delta`` of the chain committed; each timestep's
    prep seconds inside the worker (its stream synchronised) and the
    seconds the main thread waited in ``TimestepPrefetcher.get``."""
    from repro_torch.core import pipeline as pl

    rec.update(fits=[], committed={}, prep=[], wait=[])
    real_fit, real_make = dist_mod.fit_partitions, dist_mod.make_gs_train_step
    real_densify = dist_mod.densify_and_prune
    real_probe = TierSchedule.probe_counts
    real_prep, real_get = train_cli._prep, pl.TimestepPrefetcher.get
    real_save, real_delta = CheckpointManager.save, CheckpointManager.save_delta

    def events():
        return rec["fits"][-1]["events"] if rec["fits"] else []

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def timed(*sa):
            sync(device)
            t0 = time.perf_counter()
            out = step(*sa)
            sync(device)
            events().append(("step", (time.perf_counter() - t0) * 1e3))
            return out

        return timed

    def densify(g, opt, *a, **kw):
        out = real_densify(g, opt, *a, **kw)
        live = (int(g.active.sum()), int(out[0].active.sum()))
        events().append(("densify",) + live)
        return out

    def probe(self, *a, **kw):
        events().append(("probe",))
        return real_probe(self, *a, **kw)

    def fit(*a, **kw):
        rec["fits"].append({"events": [], "warm": kw.get("warm_start")})
        out = real_fit(*a, **kw)
        rec["fits"][-1]["losses"] = list(out[2])
        return out

    def prep(args, cfg, fr, t_idx, dev):
        t0 = time.perf_counter()
        td = real_prep(args, cfg, fr, t_idx, dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        rec["prep"].append((t_idx, time.perf_counter() - t0))
        return td

    def get(self):
        t0 = time.perf_counter()
        out = real_get(self)
        rec["wait"].append(time.perf_counter() - t0)
        return out

    def save(self, step, tree, **kw):
        if self.root.endswith("timeseries"):
            rec["committed"][step] = tree
        return real_save(self, step, tree, **kw)

    def save_delta(self, step, tree, **kw):
        rec["committed"][step] = tree
        return real_delta(self, step, tree, **kw)

    with contextlib.ExitStack() as stack:
        for owner, name, fn in (
            (dist_mod, "fit_partitions", fit),
            (dist_mod, "make_gs_train_step", make),
            (dist_mod, "densify_and_prune", densify),
            (TierSchedule, "probe_counts", probe),
            (train_cli, "_prep", prep),
            (pl.TimestepPrefetcher, "get", get),
            (CheckpointManager, "save", save),
            (CheckpointManager, "save_delta", save_delta),
        ):
            stack.enter_context(patched(owner, name, fn))
        yield rec


def timeseries_phase(
    device,
    tmp,
    cap,
    *,
    dataset="kingsnake",
    full=True,
    parts=2,
    resolution=1024,
    views=16,
    timesteps=2,
    dt=0.1,
    steps=30,
    densify_every=10,
    densify_from=20,
):
    """``python -m repro_torch.launch.train --gs --timeseries ...`` (the
    defaults: the full-size kingsnake scene, 2 timesteps of 30 steps,
    ``--densify-cap cap``) in-process on a world-1 process group, then a
    restart with one more timestep in the same directory -> (the launches of
    both runs: both counts set to 0 just before the first and read just
    after the second; the series for phase 11: argv without
    ``--timesteps``, timesteps committed, steps a timestep, directory).
    Gates: timestep 0 cold, every later timestep warm with no tier probe
    before its first step; the restart's warm tree equal to the first
    run's committed tree, leaf by leaf; every loss finite; live splats <=
    max(cap, live before) at every densify, and a densify event in every
    timestep; both kernels launched; the delta manifests carry their base
    step and its digest."""
    root = tmp / "timeseries"
    argv = ["--gs", "--timeseries", "--dataset", dataset]
    argv += ["--full"] if full else []
    argv += ["--parts", str(parts), "--resolution", str(resolution)]
    argv += ["--views", str(views), "--dt", str(dt), "--steps", str(steps)]
    argv += ["--densify-every", str(densify_every), "--densify-from"]
    argv += [str(densify_from), "--densify-cap", str(cap)]
    argv += ["--ckpt-dir", str(root), "--device", device]
    log(
        f"timeseries: python -m repro_torch.launch.train {' '.join(argv)} "
        f"--timesteps {timesteps}, then --timesteps {timesteps + 1} (a restart)"
    )
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    runs = []
    zero_launches()
    for T in (timesteps, timesteps + 1):
        rec = {}
        t0 = time.perf_counter()
        with observed_timeseries(device, rec):
            rec["text"] = run_cli(argv + ["--timesteps", str(T)])
        rec["seconds"] = time.perf_counter() - t0
        runs.append(rec)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    first, restart = runs
    fits = first["fits"] + restart["fits"]
    if len(fits) != timesteps + 1:
        raise AssertionError(f"{len(fits)} timesteps trained, want {timesteps + 1}")
    densify_events = []
    for t, fit in enumerate(fits):
        ev = fit["events"]
        before = ev[: next(i for i, e in enumerate(ev) if e[0] == "step")]
        probes = sum(e[0] == "probe" for e in before)
        warm = fit["warm"] is not None
        if (t == 0) == warm or (warm and probes) or (not warm and not probes):
            raise AssertionError(f"timestep {t}: warm {warm}, {probes} first probes")
        losses = np.asarray(fit["losses"])
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"timestep {t}: losses {losses}")
        for e in ev:
            if e[0] == "densify":
                densify_events.append((t,) + e[1:])
                if e[2] > max(cap, e[1]):
                    raise AssertionError(f"timestep {t}: densify {e[1:]} past {cap}")
    if not any(b >= cap or a == cap for _, b, a in densify_events):
        log(f"timeseries: the cap {cap} held no partition back: {densify_events}")
    # every timestep densifies, so timestep 1 warm-starts from a densified
    # state and the restart skips the split noise of the earlier events
    if {t for t, *_ in densify_events} != set(range(timesteps + 1)):
        raise AssertionError(f"a timestep without a densify event: {densify_events}")
    skipped = [i for i in range(timesteps * steps)
               if i >= densify_from and (i + 1) % densify_every == 0]
    log(f"timeseries: the restart skipped the split noise of the densify events "
        f"at steps {skipped}")
    # the restart's warm seed is the first run's last commit, leaf by leaf
    warm_tree = fits[timesteps]["warm"][0]
    want = first["committed"][timesteps * steps]
    if not trees_equal(tuple(warm_tree), tuple(want)):
        raise AssertionError("the restart's warm tree differs from the committed one")
    if on_card and not (launches["fwd"] > 0 and launches["bwd"] > 0):
        raise AssertionError(f"timeseries launches {launches}")
    if on_card:
        check_projected("timeseries", launches,
                        sum(len(fit["losses"]) for fit in fits))
    chain = root / "timeseries"
    sizes, deltas = {}, {}
    for d in sorted(chain.glob("step_*")):
        step = int(d.name[5:])
        sizes[step] = dir_bytes(d)
        man = json.loads((d / "manifest.json").read_text())
        if step == steps:
            if "delta" in man:
                raise AssertionError("the chain head is a delta")
            continue
        base = man["delta"]["base_step"]
        digest = CheckpointManager(str(chain), keep=0)._manifest_digest(base)
        if base != step - steps or man["delta"]["base_digest"] != digest:
            raise AssertionError(f"step {step}: delta {man['delta']} ({digest})")
        deltas[step] = sum(m["delta"] == "rows" for m in man["leaves"])
    steps_ms = [[e[1] for e in f["events"] if e[0] == "step"] for f in fits]
    med = [round(statistics.median(s), 3) for s in steps_ms]
    pattern = r"timestep (\d+) PSNR ([0-9.]+)\s+SSIM ([0-9.]+)"
    metrics = re.findall(pattern, restart["text"])
    log(
        f"timeseries: {timesteps + 1} timesteps x {steps} steps, cap {cap}; median "
        f"step ms per timestep {med}; first-step loss t=0 cold "
        f"{fits[0]['losses'][0]:.6f}, t=1 warm {fits[1]['losses'][0]:.6f}; last "
        f"losses {[round(f['losses'][-1], 6) for f in fits]}; densify (timestep, "
        f"live before, after) {densify_events}; launches {launches}; peak device "
        f"memory {peak:.2f} GiB; runs {first['seconds']:.3f} s + "
        f"{restart['seconds']:.3f} s; final merged {metrics}"
    )
    prep = [[(t, round(s, 3)) for t, s in r["prep"]] for r in runs]
    wait = [[round(s, 3) for s in r["wait"]] for r in runs]
    log(
        f"timeseries ingest: prep s in the worker (timestep, s) first run "
        f"{prep[0]}, restart {prep[1]}; main thread waited in get() "
        f"{wait[0]} / {wait[1]} s"
    )
    log(
        f"timeseries checkpoints: bytes by step {sizes} (full at {steps}); leaves "
        f"stored as row diffs {deltas} of {len(tree_flatten(want)[0])}"
    )
    for t, (s, fit) in enumerate(zip(steps_ms, fits)):
        log(f"timeseries timestep {t} step ms {[round(x, 3) for x in s]}")
        log(f"timeseries timestep {t} losses {[round(x, 6) for x in fit['losses']]}")
    series = {"argv": argv, "timesteps": timesteps + 1, "steps": steps, "root": root}
    return launches, series


#: the ``torchrun`` phase: the GS CLI's steps (no densify event before step
#: 60, so they are the train-CLI phase's first steps), the serve's views
TORCHRUN_STEPS = 8
TORCHRUN_SERVE_VIEWS = 2
TORCHRUN_LOSS_RTOL = 1e-3
TORCHRUN_TIMEOUT_S = 600


def run_child(argv, label):
    """``argv`` as a child process with this checkout's ``src`` on its path
    (``launch.torchrun.Child``: stopped with all it started past
    TORCHRUN_TIMEOUT_S), its output echoed -> its standard output; a
    non-zero exit raises."""
    log(f"{label}: {' '.join(argv)}")
    out = torchrun_mod.Child(argv, env=torchrun_mod.child_env(str(ROOT / "src")),
                             timeout=TORCHRUN_TIMEOUT_S).wait()
    for line in out.splitlines():
        log(f"{label} | {line}")
    return out


def torchrun(n, argv, label):
    """``python -m torch.distributed.run --standalone --nproc-per-node n -m
    repro_torch.launch.train argv``: the CLI as users launch it, one process
    per card -> its standard output."""
    entry = ["-m", "repro_torch.launch.train"] + list(argv)
    return run_child(torchrun_mod.torchrun_argv(n, entry), label)


def log_record(label, rec):
    for line in train_cli.record_lines(rec):
        log(f"{label} {line}")


def rank_launches(label, recs, least):
    """Every kernel's launches summed over every rank of the records' runs
    (``launch_counts``' keys); each rank of each run must have launched
    each >= ``least``."""
    total = dict.fromkeys(LAUNCH_KEYS, 0)
    for rec in recs:
        for r in rec["ranks"]:
            counts = dict(zip(LAUNCH_KEYS, r["launches"] + r["project_launches"]))
            if min(counts.values()) < least:
                raise AssertionError(f"{label}: rank {r['rank']} launched {counts}")
            for k, n in counts.items():
                total[k] += n
    return total


def chain_files(chain):
    """Every committed step of a delta chain -> {step: {file: bytes}}."""
    return {
        int(d.name[5:]): {f.name: f.read_bytes() for f in sorted(d.iterdir())}
        for d in sorted(chain.glob("step_*"))
    }


def torchrun_phase(tmp, cli_losses, series, *, device="cuda", n=None,
                   dataset="kingsnake", full=True, resolution=1024, views=16):
    """11. The paper's launch: the CLI under ``torchrun`` on N = min(4,
    cards) cards (``n``), one process a card, each joining over ``env://``:
    the GS CLI (phase 8's arguments, TORCHRUN_STEPS steps), then a restart
    of phase 9d's timeseries (``series``: its argv, committed timesteps and
    steps a timestep) with one more timestep, then ``serve_gs`` of what that
    merged -> the launches of every rank of both runs and of the serve (each
    process's counts start at 0).  ``device="cpu"`` rehearses it on gloo
    ranks, where nothing launches."""
    on_card = device == "cuda"
    n = n or min(4, torch.cuda.device_count())
    kw = dict(dataset=dataset, full=full, parts=2, resolution=resolution, views=views)
    root = tmp / "torchrun"
    argv = cli_argv(root / "gs", device, steps=TORCHRUN_STEPS, densify_every=10,
                    densify_from=60, ckpt_every=0, **kw)
    t0 = time.perf_counter()
    text = torchrun(n, argv, "torchrun gs")
    gs_s = time.perf_counter() - t0
    group = "nccl on cuda" if on_card else "gloo on cpu"
    if f"({n} ranks, {group})" not in text:
        raise AssertionError("the torchrun ranks did not join one NCCL group")
    rec = train_cli.read_record(text, "[train-gs]")
    log_record("torchrun gs", rec)
    losses = np.asarray(rec["losses"])
    want = np.asarray(cli_losses[:TORCHRUN_STEPS])
    gap = float(np.max(np.abs(losses - want) / np.abs(want)))
    log(
        f"torchrun gs: {n} ranks, {len(losses)} steps, largest relative gap to "
        f"the train-CLI phase's first steps {gap:.3e} (gate {TORCHRUN_LOSS_RTOL})"
    )
    if len(losses) != TORCHRUN_STEPS or not gap <= TORCHRUN_LOSS_RTOL:
        raise AssertionError(f"torchrun losses {losses} against {want}")
    if not (math.isfinite(rec["psnr"]) and math.isfinite(rec["ssim"])):
        raise AssertionError(f"torchrun merged metrics {rec['psnr']} {rec['ssim']}")

    # --timeseries: phase 9d's chain (world 1, in-process) restarted on N
    # ranks with one more timestep; its commits must stay as they were
    T, S, ts_root = series["timesteps"], series["steps"], series["root"]
    chain = ts_root / "timeseries"
    before = chain_files(chain)
    t0 = time.perf_counter()
    text = torchrun(n, series["argv"] + ["--timesteps", str(T + 1)], "torchrun ts")
    ts_s = time.perf_counter() - t0
    restart = train_cli.read_record(text, "[train-gs-ts]")
    log_record("torchrun timeseries restart", restart)
    if restart["t_start"] != T or len(restart["losses"]) != 1:
        raise AssertionError(f"restart at {restart['t_start']}: {restart['losses']}")
    if len(restart["losses"][0]) != S or not np.isfinite(restart["losses"][0]).all():
        raise AssertionError(f"torchrun timeseries losses {restart['losses']}")
    if f"restarting at timestep {T} (chain committed through step {T * S})" not in text:
        raise AssertionError("the restart did not resume from the committed chain")
    after = chain_files(chain)
    if {k: after[k] for k in before} != before or sorted(after) != sorted(before) + [
        (T + 1) * S
    ]:
        raise AssertionError(f"the restart's chain {sorted(after)}: an earlier commit changed")
    man = json.loads(after[(T + 1) * S]["manifest.json"])
    if man["delta"]["base_step"] != T * S:
        raise AssertionError(f"the restart's delta {man['delta']}")
    del before, after

    # serve what the restart merged, on one card
    tel = root / "serve.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_gs", "--ckpt-dir"]
    cmd += [str(ts_root), "--views", str(TORCHRUN_SERVE_VIEWS), "--passes", "2"]
    cmd += ["--device", device, "--telemetry-json", str(tel)]
    t0 = time.perf_counter()
    run_child(cmd, "serve_gs")
    serve_s = time.perf_counter() - t0
    served = json.loads(tel.read_text())
    cold, warm = served["passes"]
    log(
        f"serve_gs of the torchrun timeseries' merged checkpoint: restore "
        f"{served['restore_s']:.3f} s, cold {cold['req_per_s']:.3f} req/s "
        f"({cold['wall_s']:.3f} s), warm {warm['req_per_s']:.3f} req/s, "
        f"forward launches {served['kernel_launches']}"
    )
    if warm["hits"] != warm["requests"] or (on_card and served["kernel_launches"] <= 0):
        raise AssertionError(f"serve_gs passes {served['passes']}")
    fwd, bwd = served["project_launches"]
    if on_card:
        check_projected("serve_gs", {"project_fwd": fwd, "project_bwd": bwd})
    launches = rank_launches("torchrun", [rec, restart], int(on_card))
    launches["fwd"] += served["kernel_launches"]
    launches["project_fwd"] += fwd
    log(
        f"torchrun phase: {gs_s + ts_s + serve_s:.3f} s (gs {gs_s:.3f}, timeseries "
        f"restart {ts_s:.3f}, serve_gs {serve_s:.3f}); launches (every rank, and "
        f"the serve) {launches}"
    )
    return launches


def coarse_phase(rec, device, *, sb=4, steps=3, reps=2, iso_tier="full"):
    """The coarse superblock pre-cull on partition 0 of the train phase's
    full-size scene (its initial state, view 0, 16x16 tiles, assignment
    depth 64): the exact superblock occupancy counted with a budget of N;
    ``assign_tiles(coarse=sb)`` at that budget must equal the dense sweep
    bit for bit on live slots with the counter 0; the auto budget's value
    and counter recorded; the dense sweep, the pre-cull at both budgets and
    the sorted assignment timed in turns.  Then ``fit_partition`` for
    ``steps`` steps with ``GSTrainCfg(coarse=sb, assign_impl="dense")`` and
    without ``coarse``: losses equal within 1e-6 whenever the counter stayed
    0, both kernels launched.  Then ``extract_isosurface`` on the card on
    the kingsnake field at t = 0.1 at the resolution ``point_cloud_for``
    picks for the ``iso_tier`` dataset: its count equals the host's
    crossings and its points equal theirs, in order, within 1e-7.  -> the
    fits' launches (counts set to 0 just before them and read just
    after)."""
    from repro_torch.core.tiling import NEG, _coarse_budget, assign_tiles
    from repro_torch.core.tiling import coarse_candidates
    from repro_torch.data import isosurface, volumes

    g0, cams, grid, cfg = rec["g0"], rec["cams"], rec["grid"], rec["cfg"]
    K = max(cfg.resolved_k_tiers() or (cfg.assign_K,))
    N = g0.capacity
    S = (-(-grid.nx // sb)) * (-(-grid.ny // sb))
    cam0 = select(cams, torch.arange(1, device=cams.view.device))
    with torch.no_grad():
        splats = project(g0, cam0)
        splats = type(splats)(*(f[0] for f in splats))
        cand, ov = coarse_candidates(
            splats.mean2d, splats.radius, splats.valid, grid, sb=sb, budget=N
        )
        occ = (cand < N).sum(1)
        del cand
        B = int(occ.max())
        auto = _coarse_budget(N, S, K, None)
        impl, budget = resolve_assignment(g0, cam0, grid, assign_impl="sorted")
        # each variant timed in turns with the others, the fastest call kept
        variants = {
            "dense": {},
            "coarse at max": dict(coarse=sb, coarse_budget=B),
            "coarse auto": dict(coarse=sb),
            "sorted": dict(impl=impl, tile_budget=budget),
        }
        outs, ms = {}, {k: [] for k in variants}
        for _ in range(reps):
            for label, kw in variants.items():
                sync(device)
                t0 = time.perf_counter()
                outs[label] = assign_tiles(
                    splats, grid, K=K, return_overflow=True, **kw
                )
                sync(device)
                ms[label].append((time.perf_counter() - t0) * 1e3)
        (di, ds, _), (ci, cs, cov) = outs["dense"], outs["coarse at max"]
        aov, sov = outs["coarse auto"][2], outs["sorted"][2]
        dense_ms, coarse_ms, auto_ms, sorted_ms = (min(ms[k]) for k in variants)
        del outs
        live = ds > NEG / 2
        exact = int(cov) == 0 and torch.equal(cs, ds)
        exact = exact and torch.equal(ci[live], di[live])
    log(
        f"coarse: partition 0 view 0, N {N} ({int(g0.active.sum())} live), T "
        f"{grid.n_tiles} ({grid.tile_h}x{grid.tile_w}), sb {sb} -> S {S}, K {K}; "
        f"superblock occupancy max {B} mean {float(occ.float().mean()):.1f} "
        f"(occupied {int((occ > 0).sum())}); budget at the max resolves to "
        f"{_coarse_budget(N, S, K, B)}; auto budget {auto} overflow {int(aov)}; "
        f"ms (fastest of {reps}, in turns): dense {dense_ms:.3f}, coarse at max "
        f"{coarse_ms:.3f}, coarse auto {auto_ms:.3f}, sorted (budget {budget}, "
        f"overflow {int(sov)}) {sorted_ms:.3f}; all runs {ms}"
    )
    if int(ov) != 0 or not exact:
        raise AssertionError(f"coarse at budget {B}: overflow {int(cov)}, {exact}")
    del di, ds, ci, cs, live, splats

    # fit_partition with and without the pre-cull, dense assignment
    fits = {}
    real_make = train_mod.make_train_step
    gts, masks = rec["gts"], rec["masks"]
    zero_launches()
    for label, coarse in (("coarse", sb), ("dense", None)):
        counters = []

        def make(*a, **kw):
            step = real_make(*a, **kw)

            def counted(*sa, **sk):
                out = step(*sa, **sk)
                counters.append(int(out[3]["assign"]))
                return out

            return counted

        fcfg = dataclasses.replace(cfg, coarse=coarse, assign_impl="dense")
        c0 = launch_counts()
        sync(device)
        t0 = time.perf_counter()
        with patched(train_mod, "make_train_step", make):
            _, _, losses = train_mod.fit_partition(
                g0, cams, gts, masks, fcfg, steps=steps, extent=rec["extent"],
                grid=grid,
            )
        sync(device)
        fits[label] = dict(
            losses=losses,
            counters=counters,
            s=time.perf_counter() - t0,
            **launches_since(c0),
        )
    launches = launch_counts()
    log(f"coarse fit_partition ({steps} steps, assign_impl dense): {fits}")
    c, d = fits["coarse"], fits["dense"]
    if not all(np.isfinite(c["losses"] + d["losses"])):
        raise AssertionError(f"coarse fit losses {fits}")
    on_card = torch.device(device).type == "cuda"
    if on_card and not all(f["fwd"] > 0 and f["bwd"] > 0 for f in fits.values()):
        raise AssertionError(f"coarse fit launches {fits}")
    for label, f in fits.items():
        if on_card:
            check_projected(f"coarse fit {label}", f, steps)
    gap = max(abs(a - b) for a, b in zip(c["losses"], d["losses"]))
    if not any(c["counters"]):
        if gap > 1e-6:
            raise AssertionError(f"coarse fit losses differ by {gap}, counter 0")
        log(f"coarse fit: counter 0 every step, largest loss gap {gap:.3e}")
    else:
        log(
            f"coarse fit: the auto budget dropped candidates {c['counters']} (no "
            f"loss gate); largest loss gap {gap:.3e}"
        )

    # extract_isosurface on the card against the host extraction
    ds_iso = get_gs_dataset("kingsnake", iso_tier)
    R = isosurface.resolution_for(ds_iso.volume, ds_iso.n_points)
    t0 = time.perf_counter()
    field, iso = volumes.make_volume(ds_iso.volume, R, t=0.1)
    host = isosurface.crossing_points(field, iso)
    host_s = time.perf_counter() - t0
    dev_field = torch.from_numpy(field).to(device)
    del field
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        pts, count = isosurface.extract_isosurface(
            dev_field, iso, max_points=len(host) + 1000
        )
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    err = float((pts[: len(host)].cpu() - torch.from_numpy(host)).abs().max())
    padded = bool((pts[len(host) :] == pts[0]).all())
    log(
        f"extract_isosurface: kingsnake R {R} t 0.1 on {device}: count "
        f"{int(count)}, host crossings {len(host)}, max |point - host| "
        f"{err:.3e}, {min(times):.3f} ms (host make_volume + extraction "
        f"{host_s:.3f} s)"
    )
    if int(count) != len(host) or err > 1e-7 or not padded:
        raise AssertionError(f"extract_isosurface: {int(count)} vs {len(host)}, {err}")
    return launches


# ---------------------------------------------------------------------------
# The LM serving path: published SPECs through the serve CLI, consistency
# of prefill and decode at full width, the SMOKE archs card vs CPU
# ---------------------------------------------------------------------------

#: the card's serving request: four 512-token prompts, 64 new tokens each
LM_SERVE = dict(batch=4, prompt_len=512, gen=64)
#: f32 prefill logits at the last prompt position against the replay through
#: a zero cache, relative to the largest |logit|
LM_CONSISTENCY_TOL = 1e-3
#: mamba2-780m's SSD blocks held alone (prefill against recurrence on the
#: same input): every twelfth of the 48 and the last.  Its whole stack is
#: not held at LM_CONSISTENCY_TOL: at init_params' dt * A (decays that are
#: exp of sums reaching thousands) each layer amplifies the rounding of its
#: input, so a gap that one block keeps within ~6e-6 of its recurrence
#: grows to ~1.6e-3 of the largest logit over 48 layers (``layer_gaps``
#: prints the growth; PERF.md section 6)
LM_SSD_LAYERS = (0, 12, 24, 36, 47)
#: the SMOKE archs on the card against the same port code on the CPU, f32,
#: relative to the largest magnitude of the CPU's tensor
LM_SMOKE_TOL = 1e-4
LM_SMOKE_SHAPE = dict(batch=2, seq=64, kv_chunk=32, cache=32, steps=3)


def lm_serve_run(arch, device, *, batch, prompt_len, gen):
    """``launch.serve.main`` at ``arch``'s published SPEC -> its record:
    prefill ms, decode ms a step, tokens/s, peak memory; gates: every
    logit finite (each ``lm_logits`` call's output checked on the device,
    read after the run), every generated id < vocab."""
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len),
            "--gen", str(gen), "--device", device]
    rec, finite = {}, []
    real_run, real_logits = serve_lm.run, lm_dec.lm_logits

    def run(args):
        rec.update(real_run(args))
        return rec

    def logits(spec, params, x):
        out = real_logits(spec, params, x)
        finite.append(torch.isfinite(out).all())
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(serve_lm, "run", run), patched(lm_dec, "lm_logits", logits):
        rc = serve_lm.main(argv)
    wall = time.perf_counter() - t0
    spec, gen_ids = rec["spec"], rec["gen"]
    t_gen = rec["t_decode"] - rec["t_replay"]
    out = {
        "arch": spec.name,
        "params": spec.param_count(),
        "prefill_ms": rec["t_prefill"] * 1e3,
        "decode_ms_per_step": rec["t_decode"] / rec["steps"] * 1e3,
        "decode_steps": rec["steps"],
        "gen_tokens_per_s": batch * gen / t_gen,
        "replay_tokens_per_s": batch * prompt_len / rec["t_replay"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "logits_calls": len(finite),
        "wall_s": wall,
    }
    log(f"LM serve {json.dumps(out)}")
    if rc != 0:
        raise AssertionError(f"serve exited {rc}")
    if len(finite) != 1 + rec["steps"] or not bool(torch.stack(finite).all()):
        raise AssertionError(f"{arch}: a non-finite logit ({len(finite)} calls)")
    if gen_ids.shape != (batch, gen) or int(gen_ids.max()) >= spec.vocab:
        raise AssertionError(f"{arch}: generated ids {gen_ids.shape}, max {gen_ids.max()}")
    return out


def lm_consistency(arch, device, *, batch, prompt_len, ssd_layers=()):
    """f32 at the published width and depth: prefill's logits at the last
    prompt position against ``decoder_decode`` + ``lm_logits`` after the
    prompt is replayed token by token through a zero cache -> {the gap
    relative to the largest |logit|, the same gap of each superblock's
    output at the last position (how it grows with depth), and for each
    superblock in ``ssd_layers`` its SSD block alone on the prefill's own
    input: the chunked ``mamba2_block`` against ``mamba2_decode_block``
    stepped from a zero state over the same S tokens}."""
    spec = get_spec(arch)
    params = init_params(spec, torch.Generator(device=device).manual_seed(0),
                         dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, spec.vocab, (batch, prompt_len), generator=gen,
                           dtype=torch.int32).to(device)
    pre, dec, inputs = [], [], {}
    real_train, real_decode = lm_dec._apply_slot_train, lm_dec._apply_slot_decode

    def slot_train(spec_, slot, x, sp, *a, **kw):
        if len(pre) in ssd_layers:
            inputs[len(pre)] = (x, sp)
        out = real_train(spec_, slot, x, sp, *a, **kw)
        pre.append(out[0][:, -1])
        return out

    def slot_decode(*a, **kw):
        out = real_decode(*a, **kw)
        dec.append(out[:, -1])
        return out

    t0 = time.perf_counter()
    with patched(lm_dec, "_apply_slot_train", slot_train):
        logits, _ = make_prefill_step(spec, kv_chunk=min(prompt_len, 128))(
            params, {"tokens": tokens})
    caches = zeros_caches(spec, batch, prompt_len, device=device, dtype=torch.float32)
    with torch.inference_mode(), patched(lm_dec, "_apply_slot_decode", slot_decode):
        for i in range(prompt_len):
            dec.clear()
            pos = torch.full((1,), i, device=device)
            x = lm_dec.embed_tokens(spec, params, tokens[:, i:i + 1], pos)
            h, caches = lm_dec.decoder_decode(spec, params, x, caches, i)
        replay = lm_dec.lm_logits(spec, params, h)

    def gap(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    blocks = {}
    with torch.inference_mode():
        for layer, (x, sp) in inputs.items():
            h = lm_layers.apply_norm(spec, x, sp["ln_ssm"])
            want, _ = lm_layers.mamba2_block(spec, h, sp["ssm"])
            state = {k: v[0] for k, v in zeros_caches(
                spec, batch, 1, device=device, dtype=torch.float32)["slot0"].items()}
            steps = []
            for t in range(prompt_len):
                o, state = lm_layers.mamba2_decode_block(spec, h[:, t:t + 1],
                                                         sp["ssm"], state)
                steps.append(o)
            blocks[layer] = gap(torch.cat(steps, 1), want)
    sync(device)
    out = {"arch": spec.name, "batch": batch, "prompt_len": prompt_len,
           "max_abs_logit": float(logits.abs().max()), "gap": gap(replay, logits),
           "layer_gaps": [gap(d, p) for d, p in zip(dec, pre)],
           "ssd_block_gaps": blocks, "seconds": time.perf_counter() - t0}
    log(f"LM prefill vs decode replay, f32: {json.dumps(out)}")
    return out


def lm_trace(spec, params, device):
    """Prefill and ``LM_SMOKE_SHAPE["steps"]`` decode steps from zero f32
    caches (the prompt's first tokens fed) -> {name: tensor on the host}."""
    sh = LM_SMOKE_SHAPE
    batch = serve_lm.make_batch(spec, sh["batch"], sh["seq"],
                                torch.Generator().manual_seed(1), device)
    logits, pcaches = make_prefill_step(spec, kv_chunk=sh["kv_chunk"])(params, batch)
    out = {"prefill_logits": logits}
    out.update({f"prefill_{s}_{n}": t for s, c in pcaches.items() for n, t in c.items()})
    caches = zeros_caches(spec, sh["batch"], sh["cache"], device=device,
                          dtype=torch.float32)
    tokens = batch["tokens"]
    with torch.inference_mode():
        for i in range(sh["steps"]):
            pos = torch.full((1,), i, device=device)
            x = lm_dec.embed_tokens(spec, params, tokens[:, i:i + 1], pos)
            h, caches = lm_dec.decoder_decode(spec, params, x, caches, i)
            out[f"step{i}_hidden"] = h
            out[f"step{i}_logits"] = lm_dec.lm_logits(spec, params, h)
            out.update({f"step{i}_{s}_{n}": t.clone()
                        for s, c in caches.items() for n, t in c.items()})
    return {k: v.float().cpu() for k, v in out.items()}


def lm_smoke_vs_cpu(device):
    """Every SMOKE arch in f32 from ``init_params`` (a CPU generator, seed
    0): ``lm_trace`` on the card against the same on the CPU -> the largest
    relative error of each arch (gate ``LM_SMOKE_TOL``)."""
    errs = {}
    for arch in all_arch_ids():
        spec = get_smoke(arch)
        host = init_params(spec, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
        card = tree_to(host, device)
        want, got = lm_trace(spec, host, "cpu"), lm_trace(spec, card, device)
        errs[arch] = max(
            float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, w in want.items())
    log(f"LM SMOKE archs, card vs CPU (f32, max relative error): {json.dumps(errs)}")
    bad = {a: e for a, e in errs.items() if not e <= LM_SMOKE_TOL}
    if bad:
        raise AssertionError(f"SMOKE archs differ between card and CPU: {bad}")
    return errs


def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def attention_yardstick(device, *, batch=4, seq=512, heads=32, hd=128, kv_chunk=128):
    """Not on the path: the port's ``flash_attention`` against
    ``F.scaled_dot_product_attention`` on the qwen prefill shape (bf16,
    causal), CUDA-event ms in turns (sdpa, flash, flash, sdpa)."""
    gen = torch.Generator(device=device).manual_seed(2)
    q, k, v = (torch.randn((batch, seq, heads, hd), generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def flash():
        return lm_layers.flash_attention(q, k, v, causal=True, kv_chunk=kv_chunk)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                 is_causal=True)

    s1, f1, f2, s2 = (cuda_time_ms(fn, 10) for fn in (sdpa, flash, flash, sdpa))
    err = float((flash().float() - sdpa().transpose(1, 2).float()).abs().max())
    out = {"shape": [batch, seq, heads, hd], "kv_chunk": kv_chunk,
           "flash_ms": statistics.median([f1, f2]), "flash_ms_runs": [f1, f2],
           "sdpa_ms": statistics.median([s1, s2]), "sdpa_ms_runs": [s1, s2],
           "max_abs_diff": err}
    log(f"attention yardstick (bf16, causal): {json.dumps(out)}")
    return out


def lm_serve_phase(device):
    """The LM serving path: qwen1.5-4b and mamba2-780m at their published
    SPECs through ``launch.serve.main``, the f32 prefill / replay
    consistency of both at full width, the ten SMOKE archs card vs CPU, the
    attention yardstick -> {records, "launches": both kernels' counts over
    the phase (set to 0 just before it)}."""
    zero_launches()
    t0 = time.perf_counter()
    out = {"serve": [lm_serve_run(a, device, **LM_SERVE)
                     for a in ("qwen1.5-4b", "mamba2-780m")]}
    torch.cuda.empty_cache()
    qwen = lm_consistency("qwen1.5-4b", device, batch=2, prompt_len=192)
    mamba = lm_consistency("mamba2-780m", device, batch=1, prompt_len=512,
                           ssd_layers=LM_SSD_LAYERS)
    out["consistency"] = [qwen, mamba]
    # the attention stack end to end; the SSD stack block by block (see
    # LM_SSD_LAYERS: its full-stack gap is printed, not gated)
    bad = [qwen["gap"]] + list(mamba["ssd_block_gaps"].values())
    if not max(bad) <= LM_CONSISTENCY_TOL:
        raise AssertionError(f"prefill vs decode: qwen {qwen['gap']}, SSD blocks "
                             f"{mamba['ssd_block_gaps']}")
    torch.cuda.empty_cache()
    out["smoke_vs_cpu"] = lm_smoke_vs_cpu(device)
    out["yardstick"] = attention_yardstick(device)
    out["launches"] = launch_counts()
    log(f"LM serve phase {time.perf_counter() - t0:.3f} s, kernel launches "
        f"{out['launches']} (the LM path renders nothing)")
    if any(out["launches"].values()):
        raise AssertionError(f"a splat kernel launched on the LM path: "
                             f"{out['launches']}")
    return out


# ---------------------------------------------------------------------------
# The LM training path: a published SPEC through the training CLI, the flash
# backward at full width, the SMOKE archs card vs CPU, resume
# ---------------------------------------------------------------------------

#: the card's training request: minicpm-2b's SPEC, B 8 x 512, 4 steps
LM_TRAIN = dict(arch="minicpm-2b", batch=8, seq=512, kv_chunk=128, steps=4)
#: the reference's own bounds on vjp against scan (tests/test_flash_vjp.py):
#: a train step's loss and grad norm, and one attention's output and grads
LM_VJP_LOSS_TOL, LM_VJP_GNORM_TOL = 1e-4, 2e-3
ATTN_FWD_TOL, ATTN_GRAD_TOL = 2e-5, 5e-4
#: the SMOKE archs' two train steps, card vs CPU (f32, relative to each
#: leaf's largest magnitude), and the resumed CLI's tail losses
LM_TRAIN_SMOKE = dict(batch=2, seq=64, kv_chunk=32, total_steps=10)
LM_RESUME_TOL = 1e-3


def lm_train_cli(device, tmp):
    """``launch.train.main`` at minicpm-2b's SPEC (``LM_TRAIN``; bf16, WSD,
    remat, the flash VJP), 4 steps and the final save into ``tmp`` ->
    record; gates: every loss and grad norm finite, step 1's loss within 2
    of ln(vocab), grad norm > 0, lr_scale 0 at step 1 and > 0 after, every
    parameter leaf changed from its initial value (a sample of each leaf,
    kept when ``init_params`` returns)."""
    a = LM_TRAIN
    argv = ["--arch", a["arch"], "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--kv-chunk", str(a["kv_chunk"]), "--steps", str(a["steps"]),
            "--log-every", "1", "--ckpt-dir", str(tmp), "--device", device]
    rec, first = {}, {}
    real_run, real_init = train_cli.run_lm, train_cli.init_params

    def run(args):
        rec.update(real_run(args))
        return rec

    def init(*args, **kw):
        out = real_init(*args, **kw)
        first.update({i: p.reshape(-1)[:1 << 20].clone()
                      for i, p in enumerate(tree_flatten(out)[0])})
        return out

    free = shutil.disk_usage(tmp).free
    log(f"LM train CLI: {free / 2**30:.1f} GiB free under the checkpoint dir")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(train_cli, "run_lm", run), patched(train_cli, "init_params", init), \
            timed_checkpoint_io(device) as io:
        rc = train_cli.main(argv)
    wall = time.perf_counter() - t0
    spec, params = rec["spec"], tree_flatten(rec["params"])[0]
    changed = [float((p.reshape(-1)[:1 << 20] != first[i]).float().mean())
               for i, p in enumerate(params)]
    steady = rec["step_s"][1:]
    out = {
        "arch": spec.name, "params": spec.param_count(), "leaves": len(params),
        "largest_leaf": max(p.numel() for p in params),
        "batch": a["batch"], "seq": a["seq"], "loss": rec["loss"],
        "grad_norm": rec["grad_norm"], "lr_scale": rec["lr_scale"],
        "step_ms": [t * 1e3 for t in rec["step_s"]],
        "median_step_ms_2_4": statistics.median(steady) * 1e3,
        "tokens_per_s": a["batch"] * a["seq"] / statistics.median(steady),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "save_s": rec["save_s"], "save_bytes": [b for op, _, b in io if op == "save"],
        "changed_share": changed, "wall_s": wall,
    }
    del rec, params, first
    log(f"LM train CLI {json.dumps(out)}")
    ln_v = math.log(spec.vocab)
    if rc != 0:
        raise AssertionError(f"train exited {rc}")
    if not all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]):
        raise AssertionError(f"non-finite loss or grad norm: {out}")
    if not abs(out["loss"][0] - ln_v) <= 2 or not min(out["grad_norm"]) > 0:
        raise AssertionError(f"step 1 loss {out['loss'][0]} vs ln(V) {ln_v}")
    if out["lr_scale"][0] != 0 or not min(out["lr_scale"][1:]) > 0:
        raise AssertionError(f"lr_scale {out['lr_scale']}")
    if not min(changed) > 0:
        raise AssertionError(f"a parameter leaf did not move: {changed}")
    return out


def lm_train_step_once(spec, cfg, batch, device, impl):
    """One train step of ``spec`` from ``init_params`` (seed 0, on the card)
    under flash ``impl`` -> {loss, grad_norm, ms, peak GiB}."""
    params = init_params(spec, torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt = init_opt_state(spec, params, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_layers.set_flash_impl(impl)
    try:
        t0 = time.perf_counter()
        _, _, metrics = make_train_step(spec, cfg)(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        lm_layers.set_flash_impl("vjp")
    return {"impl": impl, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "ms": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


#: kernel-name classes of a train step's device time
LM_KERNEL_CLASSES = (
    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "sgemm")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("copy / cat / index", ("copy", "cat", "index", "gather", "scatter", "embedding")),
)


def lm_step_profile(spec, cfg, batch, device, top=15):
    """One train step (flash vjp) of ``spec`` under ``torch.profiler`` ->
    device ms by kernel class (``LM_KERNEL_CLASSES``) and the top kernels,
    the device's busy share of the step's wall time."""
    params = init_params(spec, torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt = init_opt_state(spec, params, cfg)
    step = make_train_step(spec, cfg)
    rows, busy, wall_us, n = device_profile(lambda: step(params, opt, batch), 1,
                                            torch.device(device))
    classes = {}
    for name, (_, us) in rows:
        low = name.lower()
        cls = next((c for c, keys in LM_KERNEL_CLASSES if any(k in low for k in keys)),
                   "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
    out = {"wall_ms": wall_us / 1e3, "busy_share": busy, "device_events": n,
           "device_ms_by_class": classes,
           "top": [(name[:90], calls, us / 1e3) for name, (calls, us) in rows[:top]]}
    log(f"LM train step profile (vjp): {json.dumps(out)}")
    return out


def lm_vjp_vs_scan(device):
    """One train step at the CLI's SPEC and request under each flash impl
    (vjp, then scan, each from the same initial state) -> (records, the
    vjp step's ``lm_step_profile``); gates:
    loss within ``LM_VJP_LOSS_TOL`` and grad norm within
    ``LM_VJP_GNORM_TOL``, relative."""
    a = LM_TRAIN
    spec = get_spec(a["arch"])
    cfg = TrainCfg(total_steps=a["steps"], schedule=spec.lr_schedule,
                   kv_chunk=a["kv_chunk"])
    batch = SyntheticTokens(vocab=spec.vocab, seq=a["seq"], global_batch=a["batch"],
                            seed=0).batch(0, device=device)
    out = []
    for impl in ("vjp", "scan"):
        out.append(lm_train_step_once(spec, cfg, batch, device, impl))
        torch.cuda.empty_cache()
    log(f"LM train step, flash vjp vs scan: {json.dumps(out)}")
    profile = lm_step_profile(spec, cfg, batch, device)
    v, s = out
    loss_ok = abs(v["loss"] - s["loss"]) <= LM_VJP_LOSS_TOL * abs(s["loss"])
    gnorm_gap = abs(v["grad_norm"] - s["grad_norm"])
    if not (loss_ok and gnorm_gap <= LM_VJP_GNORM_TOL * s["grad_norm"]):
        raise AssertionError(f"vjp vs scan: {out}")
    return out, profile


def attention_train_yardstick(device, *, batch=8, seq=512, heads=48, hd=64,
                              kv_chunk=128):
    """At the CLI's attention shape (bf16, causal): forward + backward of
    the port's vjp and scan and of ``F.scaled_dot_product_attention``,
    CUDA-event ms in turns and each one's peak memory above its inputs;
    then in f32 vjp against scan (``ATTN_FWD_TOL``, ``ATTN_GRAD_TOL``)."""
    gen = torch.Generator(device=device).manual_seed(3)
    shape = (batch, seq, heads, hd)
    base = [torch.randn(shape, generator=gen, device=device) for _ in range(4)]

    def fns(dtype):
        q, k, v, g = (t.to(dtype).requires_grad_(i < 3) for i, t in enumerate(base))

        def flash(impl):
            def fn():
                out = lm_layers.flash_attention(q, k, v, causal=True,
                                                kv_chunk=kv_chunk, impl=impl)
                return (out,) + torch.autograd.grad(out, (q, k, v), g)
            return fn

        def sdpa():
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True).transpose(1, 2)
            return (out,) + torch.autograd.grad(out, (q, k, v), g)
        return {"vjp": flash("vjp"), "scan": flash("scan"), "sdpa": sdpa}

    bf = fns(torch.bfloat16)
    order = ("sdpa", "vjp", "scan", "scan", "vjp", "sdpa")
    times = {name: [] for name in bf}
    for name in order:
        times[name].append(cuda_time_ms(bf[name], 5))
    peak = {}
    for name, fn in bf.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - before) / 2**30
    f32 = fns(torch.float32)
    (ov, *dv), (os_, *ds) = (
        [t.detach() for t in f32[impl]()] for impl in ("vjp", "scan"))

    def gap(a, b, tol):  # the largest |a - b| - tol * |b|, <= 0 when held
        return float(((a - b).abs() - tol * b.abs()).max())

    errs = {"out": gap(ov, os_, ATTN_FWD_TOL)}
    errs.update({f"d{n}": gap(a, b, ATTN_GRAD_TOL) for n, a, b in zip("qkv", dv, ds)})
    out = {"shape": list(shape), "kv_chunk": kv_chunk,
           "ms": {k: statistics.median(v) for k, v in times.items()},
           "ms_runs": times, "peak_gib": peak,
           "f32_vjp_vs_scan_max_abs": {
               "out": float((ov - os_).abs().max()),
               **{f"d{n}": float((a - b).abs().max())
                  for n, a, b in zip("qkv", dv, ds)}}}
    log(f"attention fwd+bwd yardstick (bf16, causal): {json.dumps(out)}")
    bad = {k: e for k, e in errs.items() if not e <= (ATTN_FWD_TOL if k == "out"
                                                        else ATTN_GRAD_TOL)}
    if bad:
        raise AssertionError(f"f32 vjp vs scan beyond the reference's bounds: {bad}")
    return out


def lm_train_batch(spec, seed, device):
    """Seeded tokens and labels (+ frames / patches), B 2 x S 64."""
    sh = LM_TRAIN_SMOKE
    gen = torch.Generator().manual_seed(seed)
    batch = serve_lm.make_batch(spec, sh["batch"], sh["seq"], gen, "cpu")
    batch = {k: (v.float() if v.is_floating_point() else v) for k, v in batch.items()}
    batch["labels"] = torch.randint(0, spec.vocab, batch["tokens"].shape,
                                    generator=gen, dtype=torch.int32)
    return {k: v.to(device) for k, v in batch.items()}


def lm_train_trace(spec, params, device):
    """Two train steps in f32 from ``params`` (updated in place) ->
    {name: host tensor}: each step's metrics, then m, v and the
    parameters."""
    sh = LM_TRAIN_SMOKE
    cfg = TrainCfg(total_steps=sh["total_steps"], kv_chunk=sh["kv_chunk"])
    step, opt, out = make_train_step(spec, cfg), init_opt_state(spec, params, cfg), {}
    for i in range(2):
        params, opt, metrics = step(params, opt, lm_train_batch(spec, 10 + i, device))
        out.update({f"step{i}_{k}": v for k, v in metrics.items()})
    for name, tree in (("m", opt["adam"]["m"]), ("v", opt["adam"]["v"]),
                       ("param", params)):
        out.update({f"{name}{j}": t for j, t in enumerate(tree_flatten(tree)[0])})
    return {k: v.float().cpu() for k, v in out.items()}


def lm_train_smoke_vs_cpu(device):
    """Every SMOKE arch in f32 from ``init_params`` (a CPU generator, seed
    0): ``lm_train_trace`` on the card against the same on the CPU -> per
    arch the largest relative error of the metrics, m and v, and of the
    parameters beyond ``lr_slack``.  Gate ``LM_SMOKE_TOL``; a parameter
    may also differ by 2 * lr * lr_scale(step 1): Adam moves an element by
    about +-lr * lr_scale whatever its gradient's size, and a gradient
    that is rounding noise on both devices (qwen's key bias: softmax does
    not see it) may take either sign (``tests/_torch_lm.py`` bounds the
    reference comparison the same way)."""
    errs = {}
    for arch in all_arch_ids():
        spec = get_smoke(arch)
        host = init_params(spec, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
        card = tree_map(lambda t: t.clone().to(device), host)  # both updated in place
        want = lm_train_trace(spec, host, "cpu")
        got = lm_train_trace(spec, card, device)
        slack = 2 * AdamWConfig().lr * float(want["step1_lr_scale"])
        rel = {"state": 0.0, "params": 0.0}
        for k, w in want.items():
            kind = "params" if k.startswith("param") else "state"
            err = float((got[k] - w).abs().max()) - (slack if kind == "params" else 0)
            rel[kind] = max(rel[kind], err / max(float(w.abs().max()), 1e-30))
        errs[arch] = rel
    log(f"LM SMOKE archs, two train steps, card vs CPU (f32, max relative "
        f"error; the parameters' beyond the Adam slack): {json.dumps(errs)}")
    bad = {a: e for a, e in errs.items() if not max(e.values()) <= LM_SMOKE_TOL}
    if bad:
        raise AssertionError(f"SMOKE train steps differ between card and CPU: {bad}")
    return errs


def lm_resume(device, tmp):
    """The CLI at minicpm-2b's SMOKE (B 2 x 16): 4 steps in one run, and 2
    steps then a second call to 4 -> record; gates: the tree the second
    call restores equals the one the first saved bit for bit (bf16 leaves
    included), and its steps 3-4 losses are within ``LM_RESUME_TOL`` of the
    uninterrupted run's (CUDA's embedding backward accumulates
    atomically)."""
    base = ["--arch", "minicpm-2b", "--smoke", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--device", device]
    recs, saved, restored = [], {}, []
    real_run = train_cli.run_lm
    save, restore_latest = CheckpointManager.save, CheckpointManager.restore_latest

    def run(args):
        recs.append(real_run(args))
        return recs[-1]

    def keep_save(self, step, tree, **kw):
        saved[(self.root, step)] = [t.cpu().clone() for t in tree_flatten(tree)[0]]
        return save(self, step, tree, **kw)

    def keep_restore(self, like, **kw):
        out = restore_latest(self, like, **kw)
        restored.append([t.cpu().clone() for t in tree_flatten(out[0])[0]])
        return out

    with patched(train_cli, "run_lm", run), \
            patched(CheckpointManager, "save", keep_save), \
            patched(CheckpointManager, "restore_latest", keep_restore):
        for root, steps in ((tmp / "whole", 4), (tmp / "split", 2), (tmp / "split", 4)):
            if train_cli.main(base + ["--steps", str(steps), "--ckpt-dir", str(root)]):
                raise AssertionError("train exited nonzero")
    whole, first, second = recs
    want = saved[(str(tmp / "split"), 2)]
    got = restored[2]
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    tail = [abs(a - b) / abs(b) for a, b in zip(second["loss"], whole["loss"][2:])]
    out = {"start": second["start"], "restored_equal": same,
           "bf16_leaves": sum(t.dtype == torch.bfloat16 for t in got),
           "loss_whole": whole["loss"], "loss_resumed": first["loss"] + second["loss"],
           "tail_rel": tail}
    log(f"LM resume on the card: {json.dumps(out)}")
    if second["start"] != 2 or not same or not max(tail) <= LM_RESUME_TOL:
        raise AssertionError(f"LM resume: {out}")
    return out


def lm_train_phase(device, tmp):
    """The LM training path: minicpm-2b's SPEC through the training CLI,
    vjp against scan at full width, the attention yardstick, the ten SMOKE
    archs' train steps card vs CPU, the CLI's resume -> {records,
    "launches": both kernels' counts over the phase (set to 0 just before
    it)}."""
    torch.cuda.empty_cache()
    log(f"LM train phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        "allocated at its start")
    zero_launches()
    t0 = time.perf_counter()
    ckpt = tmp / "lm_train"
    ckpt.mkdir(parents=True, exist_ok=True)
    try:
        out = {"cli": lm_train_cli(device, ckpt)}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"LM train phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated after the CLI")
    out["vjp_vs_scan"], out["profile"] = lm_vjp_vs_scan(device)
    out["yardstick"] = attention_train_yardstick(device)
    torch.cuda.empty_cache()
    out["smoke_vs_cpu"] = lm_train_smoke_vs_cpu(device)
    resume = tmp / "lm_resume"
    try:
        out["resume"] = lm_resume(device, resume)
    finally:
        shutil.rmtree(resume, ignore_errors=True)
    out["launches"] = launch_counts()
    out["seconds"] = time.perf_counter() - t0
    log(f"LM train phase {out['seconds']:.3f} s, kernel launches "
        f"{out['launches']} (the LM path renders nothing)")
    if any(out["launches"].values()):
        raise AssertionError(f"a splat kernel launched on the LM path: "
                             f"{out['launches']}")
    return out


#: phase 10a's dry-run cells: two SPEC archs at their train, prefill and
#: decode shapes, and the dense kingsnake GS cell
DRYRUN_ARCHS = ("minicpm-2b", "qwen1.5-4b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_GS = "gs-kingsnake"


def dryrun_phase(tmp):
    """10a: ``launch.dryrun.main`` in-process on ``DRYRUN_ARCHS`` x
    ``DRYRUN_SHAPES`` and ``DRYRUN_GS`` (``meta`` tensors, the host alone)
    -> {cell: record}; gate: every record ``ok``."""
    t0 = time.perf_counter()
    out = tmp / "dryrun"
    rc = dryrun.main(["--arch", ",".join(DRYRUN_ARCHS), "--shape",
                      ",".join(DRYRUN_SHAPES), "--out", str(out)])
    rc |= dryrun.main(["--gs", "--arch", DRYRUN_GS, "--out", str(out)])
    recs = {p.stem: json.loads(p.read_text()) for p in sorted((out / "card").glob("*.json"))}
    for name, rec in recs.items():
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {name}: {rec.get('traceback', rec)}")
        r = rec["roofline"]
        log(f"10a {name}: compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms, collective {r['collective_s'] * 1e3:.3f} ms "
            f"-> {rec['bottleneck']}; bound_s {rec['bound_s'] * 1e3:.3f} ms; flops "
            f"{rec['hlo']['flops']:.6g} (matmul {rec['hlo']['matmul_flops']:.6g}), "
            f"compulsory bytes {rec['hlo']['compulsory_bytes']:.6g}, useful "
            f"{rec['useful_flops_ratio']:.4f}, trace {rec['trace_s']} s")
    want = len(DRYRUN_ARCHS) * len(DRYRUN_SHAPES) + 1
    if rc or len(recs) != want:
        raise AssertionError(f"dry run: exit {rc}, {len(recs)} of {want} records")
    log(f"10a dry run {time.perf_counter() - t0:.3f} s")
    return recs


def lm_bound_phase(profile):
    """10b: phase 9g's step (``LM_TRAIN``: minicpm-2b SPEC, B 8 x 512,
    kv_chunk 128, flash vjp) under ``cost_analysis.analyze`` on ``meta``
    tensors -> record; gate: ``bound_s`` <= the device-busy time of the step
    9g profiled (``profile``: ``lm_step_profile``'s record)."""
    a = LM_TRAIN
    spec = get_spec(a["arch"])
    cfg = TrainCfg(total_steps=a["steps"], schedule=spec.lr_schedule,
                   kv_chunk=a["kv_chunk"])
    batch = {k: torch.empty((a["batch"], a["seq"]), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    hlo = analyze(make_train_step(spec, cfg), param_specs(spec),
                  opt_state_specs(spec, cfg), batch)
    return bound_against_card("10b LM step", hlo,
                              profile["busy_share"] * profile["wall_ms"] / 1e3,
                              seconds=time.perf_counter() - t0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument(
        "--save-inputs",
        metavar="DIR",
        help="also save the timed kernels' inputs to DIR (serve.pt, train.pt)",
    )
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    save_dir = args.save_inputs
    if save_dir is not None:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is still enabled")
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind} x{torch.cuda.device_count()}, torch {torch.__version__}")

    # 2. build: both kernels, in parallel
    t0 = time.perf_counter()
    libs = rasterize.build(verbose=True)
    log(f"built {[p.name for p in libs.values()]} in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against the plain versions; their inner loops from SASS
    sweep_err = kernel_phase(device)
    bwd_sweep_err = bwd_kernel_phase(device)
    issue = {
        name: rasterize.hot_loop(rasterize.sass(name), f"{name}_kernelILb1E")
        for name in ("rasterize_fwd", "rasterize_bwd")
    }
    log(f"inner loops from SASS (the one-column build): {json.dumps(issue)}")
    # 3b. the projection pair at the main path's shapes
    proj = project_phase(device)

    # 4. serve at paper scale; the launch count covers the two passes only
    torch.cuda.reset_peak_memory_stats()
    server, rig, passes, times, info = serve_phase(device)
    serve_launches = info["launches"]
    n_views = rig.view.shape[0]
    tel, cov = check_passes(server, passes, n_views)
    log(f"model {info}")
    log("times " + json.dumps({k: round(v, 4) for k, v in times.items()}))
    log(f"telemetry {tel}")
    log(f"coverage per request {[round(c, 3) for c in cov]}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve: peak device memory {peak_gib:.2f} GiB")
    if serve_launches != tel["batches"] or serve_launches == 0:
        raise AssertionError(f"{serve_launches} launches, {tel['batches']} dispatches")
    # every dispatch renders, and renders what it projected
    check_projected("serve", info["counts"])
    if info["counts"]["project_fwd"] < serve_launches:
        raise AssertionError(f"serve: {info['counts']} for {serve_launches} dispatches")
    small_scene_check(device)
    # the forward kernel's time on the first dispatch's own features
    near = [v for v in range(n_views) if passes[0][v].rung == 0]
    near = near[: server.cfg.max_batch]
    stats = timing_phase(
        server, rig, passes[0], near, issue["rasterize_fwd"], save_dir=save_dir
    )
    assign = (info["assign_impl"], info["assign_budget"])
    breakdown_phase(server, rig, passes[0], near, assign)
    del server, rig, passes
    torch.cuda.empty_cache()

    # 5. train at paper scale; the counts cover the whole run_pipeline
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result, records, train_launches = train_phase(device)
    log(
        f"train: phase {time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    small_pipeline_check(device)

    # 6. kernel times on one train step's own tier tables, and its stages
    tiers = train_timing_phase(records[0], issue, save_dir=save_dir)
    bwd_stats = tiers["bwd"][max(tiers["bwd"])]  # the top tier
    train_breakdown_phase(records[0])
    profile = train_profile_phase(records[0])
    # 10c. the counted bound of the same step against the card
    gs_bound = gs_bound_phase(records[0], profile)

    # 7. checkpoints: resume a partition (counts zeroed inside the phase)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        torch.cuda.reset_peak_memory_stats()
        resume_launches = resume_phase(records[0], device, tmp / "resume")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"resume: peak device memory {peak:.2f} GiB")
        part0 = records[0]  # the coarse phase's state
        del records, result
        torch.cuda.empty_cache()

        # 8. the training CLI: the distributed trainer on a world-1 NCCL
        # group (counts zeroed just before it), then 9h. serving the merged
        # checkpoints it wrote
        roots, merged, cli_launches, cli_tiers, cli_rec = train_cli_phase(
            device, tmp, issue
        )
        # 9. the four-axis mesh and the strip prefilter on the CLI's state
        axes_launches = mesh_axes_phase(cli_rec, device)
        # 9b. the wire options on the same mesh and state
        wire_launches = wire_phase(cli_rec, device)
        # 9c. the sparse-overlap exchange on the same mesh and state
        ex_launches = exchange_phase(cli_rec, device)
        # the densify cap: 256 splats over the smaller partition's live
        # count at t = 0, so it holds both partitions back
        cap = int(cli_rec["g0"].active.sum(1).min()) + 256
        cli_losses = list(cli_rec["losses"])
        del cli_rec
        torch.cuda.empty_cache()
        # 9d. the timeseries driver through the CLI, and a restart
        ts_launches, series = timeseries_phase(device, tmp, cap)
        torch.cuda.empty_cache()
        # 11. the CLI under torchrun, one process a card: the GS CLI, a
        # restart of 9d's chain, and serve_gs of what it merged (child
        # processes: their counts start at 0)
        tr_launches = torchrun_phase(tmp, cli_losses, series)
        # 9e. the coarse pre-cull and extract_isosurface
        coarse_launches = coarse_phase(part0, device)
        del part0
        torch.cuda.empty_cache()
        # 9f. the LM serving path (renders nothing: both counts stay 0)
        lm = lm_serve_phase(device)
        # 9g. the LM training path (renders nothing: both counts stay 0)
        lm_train = lm_train_phase(device, tmp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ckpt_serve_launches, cold = serve_ckpt_phase(roots, merged, device, tmp)
        check_projected("serve from checkpoint", ckpt_serve_launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"serve from checkpoint: peak device memory {peak:.2f} GiB")
        # 10. the tooling: the dry run, and the LM step's counted bound
        # against the card (10c ran after phase 6)
        dryrun_phase(tmp)
        lm_bound = lm_bound_phase(lm_train["profile"])
        log(f"10. counted bound / device-busy time: LM step {lm_bound['share']:.4f}, "
            f"GS step {gs_bound['share']:.4f}; eager bytes / HBM rate against the "
            f"same time: {lm_bound['eager_bytes_share']:.4f}, "
            f"{gs_bound['eager_bytes_share']:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)

    fwd_errs = [sweep_err, stats["max_abs_err"]]
    fwd_errs += [t["max_abs_err"] for t in tiers["fwd"].values()]
    fwd_errs += [t["max_abs_err"] for t in cli_tiers["fwd"].values()]
    fwd_errs += [cold["max_abs_err"]]
    bwd_errs = [bwd_sweep_err] + [t["max_abs_err"] for t in tiers["bwd"].values()]
    bwd_errs += [t["max_abs_err"] for t in cli_tiers["bwd"].values()]
    gs_paths = {
        "serve": info["counts"],
        "train": train_launches,
        "resume": resume_launches,
        "train CLI": cli_launches,
        "mesh axes": axes_launches,
        "wire": wire_launches,
        "exchange": ex_launches,
        "timeseries": ts_launches,
        "coarse": coarse_launches,
        "serve from checkpoint": ckpt_serve_launches,
        "torchrun (every rank, and its serve)": tr_launches,
    }
    lm_paths = {"LM serve": lm["launches"], "LM train": lm_train["launches"]}
    log(
        "launches on the main paths: "
        + "; ".join(f"{path} {counts}" for path, counts in {**gs_paths, **lm_paths}.items())
    )
    launches = {k: sum(c[k] for c in gs_paths.values()) for k in LAUNCH_KEYS}
    kernels = [
        {
            "name": "rasterize_fwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rasterize_fwd.cu",
            "replaces": "src/repro/kernels/rasterize.py:96",
            "launches": launches["fwd"],
            "max_abs_err": max(fwd_errs),
            "ms": stats["ms"],
            "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"],
            "library_ms": None,
            "lm_serve_launches": lm["launches"]["fwd"],
            "lm_train_launches": lm_train["launches"]["fwd"],
        },
        {
            "name": "rasterize_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rasterize_bwd.cu",
            "replaces": "src/repro/kernels/rasterize.py:169",
            "launches": launches["bwd"],
            "max_abs_err": max(bwd_errs),
            "ms": bwd_stats["ms"],
            "plain_ms": bwd_stats["plain_ms"],
            "bound_ms": bwd_stats["bound_ms"],
            "bound_by": bwd_stats["bound_by"],
            "library_ms": None,
            "lm_serve_launches": lm["launches"]["bwd"],
            "lm_train_launches": lm_train["launches"]["bwd"],
        },
    ]
    timed = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    for part, err in (
        ("fwd", max(row["max_rel_err"] for row in proj.values())),
        ("bwd", max(max(row["grad_gates"].values()) for row in proj.values())),
    ):
        name = f"project_{part}"
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": None,
                "launches": launches[name],
                # forward: the largest error over its field's magnitude;
                # backward: the largest gradient gate (<= 1)
                "max_err": err,
                "shapes": {
                    label: {k: row[part][k] for k in timed}
                    for label, row in proj.items()
                },
                "library_ms": None,
                "lm_serve_launches": lm["launches"][name],
                "lm_train_launches": lm_train["launches"][name],
            }
        )
    log(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    device_info = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

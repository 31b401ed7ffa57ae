// Forward tile compositor of the 3D-GS rasterizer, CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel rasterize_fwd (body _fwd_kernel, helpers
// _pixel_grids / _alpha_terms) in src/repro/kernels/rasterize.py.
//
// What it computes.  For each tile t and each pixel centre (origin + 0.5 +
// offset), front to back over the tile's K depth-sorted splat rows
// f = [mx, my, A, B, C, r, g, b, opacity, pad...]:
//     sigma = 0.5 * (A dx^2 + C dy^2) + B dx dy
//     alpha = min(opacity * exp(-max(sigma, 0)), 0.99), 0 below 1/255
//     rgb  += T * alpha * rgb_k ;  T *= 1 - alpha
// with no early termination; out[t] = [r, g, b, 1 - T] as (4, th, tw).
//
// What bounds it on an H100: instruction issue.  The arithmetic is 27
// operations per splat-pixel counted from the algorithm (sigma: 2
// subtractions, 7 multiplications, 2 additions; alpha: max, negate, the
// opacity product, min, compare, select; w = T * alpha, 1 - alpha and the T
// update; colour: 3 multiplications and 3 additions; expf as one): at the
// serving shape (V = 8 views, 1024 x 1024, 16 x 16 tiles, K = 64, 536,870,912
// splat-pixels) 14.5 GFLOP, 0.216 ms at the 67 TFLOP/s f32 peak, against
// 268.7 MB of feature table and output (0.080 ms at 3.35 TB/s).  That peak
// counts a fused multiply-add as two operations; the kernel is built with
// -fmad=false (below), so each operation is one issue slot of its own and
// half that rate is the most this arithmetic can reach.  The real ceiling
// is the issue rate: 4 warp instructions per clock per SM.
//
// Design for Hopper.
//   * One block per tile, kPix = 4 pixels per thread (tile_layout.cuh): a
//     16 x 16 tile runs on 64 threads, an 8 x 128 tile on 256.  A
//     view-batched dispatch is one flat grid of V * T blocks, one launch.
//   * The tile's rows pass through dynamic shared memory in chunks of
//     kChunk = 128 rows, 12 floats each (6 KB), staged with 16-byte loads;
//     each thread reads a row back as three broadcasts and runs it against
//     its four pixels, so the row loads and the loop's own instructions
//     are shared by four splat-pixels instead of one.
//   * When a thread's four pixels share a column (threads a multiple of
//     tw: every tile the port uses), px - mx and the dx products of
//     alpha_terms are formed once per row for the four of them.
//   * Each pixel's loop over k is operation for operation the one-thread-
//     per-pixel kernel's (and the plain version's), and no sum crosses
//     threads: the output is bit-identical to it.
//   * The alpha arithmetic lives in alpha_terms.cuh, shared with the
//     backward kernel (rasterize_bwd.cu), so both see the same live set.
//   * Built without --use_fast_math, with expf (not __expf) and -fmad=false
//     (no fused multiply-add contraction), so every operation rounds as the
//     plain PyTorch version's separate element-wise ops do: the kernel holds
//     the reference's 1e-5 forward gate, and no alpha lands on the other side
//     of the 1/255 cut-off through a different rounding.
//
// What the built kernel issues (nvcc 12.8; cuobjdump -sass of the library,
// its k loop, counted by rasterize.hot_loop; chip_smoke.py prints it): 130
// instructions per row for four splat-pixels, 32.5 per splat-pixel against
// about 46 with one pixel per thread -- 47 FMUL, 33 FADD, 16 FFMA and 4
// MUFU.EX2 of expf, 8 FMNMX, 4 FSETP, 4 FSEL, 3 LDS for the row (two of 16
// bytes), 11 of loop and constants; 35.5 when a thread's pixels lie in
// different columns.  Issue-rate ceiling, at 4 warp instructions per clock
// per SM on 132 SMs: at the serving shape 536,870,912 splat-pixels / 32
// lanes x 32.5 = 545 M warp instructions, 0.522 ms at the card's 1,980 MHz maximum (more
// at the clock it holds under load, which chip_smoke.py samples), beside
// 0.216 ms for the 67 TFLOP/s bound.  ptxas (-Xptxas -v): 39 registers (44
// for the other build), no stack, no spills, no static shared memory (the
// rows are 6,144 bytes of dynamic shared memory a block).
//
// What a later change could do about it: stop a pixel's loop once T is
// exactly 0 (it can no longer change the output); use __expf under a looser,
// stated gate; let -fmad=true contract the multiply-adds once the parity
// gate is restated for it.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"
#include "tile_layout.cuh"

namespace {

using repro_torch::kLive;
using repro_torch::kPix;
using repro_torch::kRowFloats;

constexpr int kChunk = 128;   // feature rows staged per shared-memory pass

template <bool kOneColumn>
__global__ void __launch_bounds__(repro_torch::kMaxThreads)
rasterize_fwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ origins,
                     float* __restrict__ out, int K, int F, int th, int tw,
                     bool vec) {
  extern __shared__ float4 rows4[];   // kChunk rows x 3 float4
  const long long tile = blockIdx.x;
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  const int npix = th * tw;
  const float ox = origins[2 * tile];
  const float oy = origins[2 * tile + 1];
  float px[kPix], py[kPix];
  float trans[kPix], r[kPix], g[kPix], b[kPix];
#pragma unroll
  for (int s = 0; s < kPix; ++s) {
    const int p = s * threads + t;
    const int iy = p / tw;
    const int ix = p - iy * tw;
    px[s] = ox + (static_cast<float>(ix) + 0.5f);
    py[s] = oy + (static_cast<float>(iy) + 0.5f);
    trans[s] = 1.0f;
    r[s] = 0.0f;
    g[s] = 0.0f;
    b[s] = 0.0f;
  }
  const float* tf = feats + tile * static_cast<long long>(K) * F;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk is no longer read
    repro_torch::stage_rows(rows4, tf + static_cast<long long>(k0) * F, n, n,
                            F, vec);
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      float f[kLive];
      repro_torch::load_row(rows4, k, f);
#pragma unroll
      for (int s = 0; s < kPix; ++s) {
        const float x = kOneColumn ? px[0] : px[s];
        const float alpha = repro_torch::alpha_terms(f, x, py[s]).alpha;
        const float w = trans[s] * alpha;
        trans[s] = trans[s] * (1.0f - alpha);
        r[s] = r[s] + w * f[5];
        g[s] = g[s] + w * f[6];
        b[s] = b[s] + w * f[7];
      }
    }
  }
  float* o = out + tile * 4LL * npix;
#pragma unroll
  for (int s = 0; s < kPix; ++s) {
    const int p = s * threads + t;
    if (p < npix) {
      o[p] = r[s];
      o[npix + p] = g[s];
      o[2 * npix + p] = b[s];
      o[3 * npix + p] = 1.0f - trans[s];
    }
  }
}

}  // namespace

// feats (T, K, F) f32 contiguous, F >= 9; origins (T, 2) f32; out (T, 4, th,
// tw) f32.  threads / pixels_per_thread / smem_bytes are the wrapper's
// launch_geometry(th, tw); any other layout returns cudaErrorInvalidValue.
// Launches on `stream` and returns cudaGetLastError() as an int
// (0 == cudaSuccess); the caller raises on anything else.
extern "C" int rasterize_fwd_launch(const void* feats, const void* origins,
                                    void* out, int T, int K, int F, int th,
                                    int tw, int threads,
                                    int pixels_per_thread, int smem_bytes,
                                    void* stream) {
  if (pixels_per_thread != kPix || threads != repro_torch::tile_threads(th, tw)
      || smem_bytes < kChunk * kRowFloats * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T > 0) {
    const bool vec = F % 4 == 0 && repro_torch::is_aligned16(feats);
    auto kernel = threads % tw == 0 ? &rasterize_fwd_kernel<true>
                                    : &rasterize_fwd_kernel<false>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<T, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const float*>(origins),
        static_cast<float*>(out), K, F, th, tw, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

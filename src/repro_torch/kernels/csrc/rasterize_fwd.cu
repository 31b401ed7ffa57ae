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
// Design (right and simple first).
//   * One thread block per tile, one thread per pixel: blockDim = th * tw
//     <= 1024 (the wrapper raises on a larger tile).  A view-batched
//     dispatch is one flat grid of V * T blocks, one launch.
//   * The block stages the tile's feature rows (columns 0-8 only) in shared
//     memory in chunks of kChunk = 256 rows (9 KB), so K is not capped by
//     shared memory; every thread then reads the same row (a broadcast).
//   * Each thread runs the reference loop in f32 registers and writes its 4
//     channels (coalesced: neighbouring threads, neighbouring pixels).
//   * The alpha arithmetic lives in alpha_terms.cuh, shared with the
//     backward kernel (rasterize_bwd.cu), so both see the same live set.
//   * Built without --use_fast_math, with expf (not __expf) and -fmad=false
//     (no fused multiply-add contraction), so every operation rounds as the
//     plain PyTorch version's separate element-wise ops do: the kernel holds
//     the reference's 1e-5 forward gate, and no alpha lands on the other side
//     of the 1/255 cut-off through a different rounding.
//
// What bounds it on an H100.  Per splat-pixel the loop does 26 f32
// operations (sigma: 2 subtractions, 7 multiplications, 2 additions; alpha:
// max, negate, the opacity product, min, compare, select; w = T * alpha,
// 1 - alpha and the T update; colour: 3 multiplications and 3 additions)
// plus one expf: 27 operations counted, expf as one.  At
// the serving shape (V = 8 views, 1024 x 1024, 16 x 16 tiles, K = 64) that
// is 8 * 4096 * 256 * 64 = 536,870,912 splat-pixels, 14.5 GFLOP, 0.216 ms at
// the 67 TFLOP/s f32 (non-tensor-core) peak; the bytes are the (32768, 64,
// 16) f32 feature table read once (134 MB), the origins (0.26 MB) and the
// (32768, 4, 16, 16) f32 output written once (134 MB): 268.7 MB, 0.080 ms at
// 3.35 TB/s.  So it is bound by operations (f32 CUDA-core arithmetic and the
// expf sequence), not by memory.
//
// What a later change could do about it: stop a pixel's loop once T is
// exactly 0 (it can no longer change the output); use __expf under a looser,
// stated gate; give each thread several pixels so the row loads from shared
// memory and the loop overhead are shared; let -fmad=true contract the
// multiply-adds once the parity gate is restated for it.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace {

using repro_torch::kLive;

constexpr int kChunk = 256;   // feature rows staged per shared-memory pass

__global__ void __launch_bounds__(1024)
rasterize_fwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ origins,
                     float* __restrict__ out, int K, int F, int th, int tw) {
  __shared__ float rows[kChunk * kLive];
  const long long tile = blockIdx.x;
  const int p = threadIdx.x;
  const int npix = th * tw;
  const int iy = p / tw;
  const int ix = p - iy * tw;
  const float px = origins[2 * tile] + (static_cast<float>(ix) + 0.5f);
  const float py = origins[2 * tile + 1] + (static_cast<float>(iy) + 0.5f);
  const float* tf = feats + tile * static_cast<long long>(K) * F;

  float trans = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = p; e < n * kLive; e += blockDim.x) {
      const int row = e / kLive;
      rows[e] = tf[static_cast<long long>(k0 + row) * F + (e - row * kLive)];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* f = rows + k * kLive;
      const float alpha = repro_torch::alpha_terms(f, px, py).alpha;
      const float w = trans * alpha;
      trans = trans * (1.0f - alpha);
      r = r + w * f[5];
      g = g + w * f[6];
      b = b + w * f[7];
    }
  }
  if (p < npix) {
    float* o = out + tile * 4LL * npix + p;
    o[0] = r;
    o[npix] = g;
    o[2 * npix] = b;
    o[3 * npix] = 1.0f - trans;
  }
}

}  // namespace

// feats (T, K, F) f32 contiguous, F >= 9; origins (T, 2) f32; out (T, 4, th,
// tw) f32.  Launches on `stream` and returns cudaGetLastError() as an int
// (0 == cudaSuccess); the caller raises on anything else.
extern "C" int rasterize_fwd_launch(const void* feats, const void* origins,
                                    void* out, int T, int K, int F, int th,
                                    int tw, void* stream) {
  if (T > 0) {
    rasterize_fwd_kernel<<<T, th * tw, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const float*>(origins),
        static_cast<float*>(out), K, F, th, tw);
  }
  return static_cast<int>(cudaGetLastError());
}

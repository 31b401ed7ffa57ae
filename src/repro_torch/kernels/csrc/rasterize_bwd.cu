// Backward tile compositor of the 3D-GS rasterizer, CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel rasterize_bwd (body _bwd_kernel) in
// src/repro/kernels/rasterize.py.
//
// What it computes.  The gradients of the 9 live feature columns of every
// tile's K splat rows (mean x/y, conic A/B/C, r/g/b, opacity), each summed
// over the tile's pixels, given the forward output out = [C_r, C_g, C_b,
// 1 - T_final] and its cotangent gout.  Columns 9.. of gfeats are 0.  Like
// the reference it makes ONE forward sweep per pixel and recovers each
// suffix sum as C - prefix_k:
//     d out / d alpha_k = sum_c g_c (T_k rgb_c - (C_c - prefix_c) / (1 - alpha_k))
//                         + g_cov T_final / (1 - alpha_k)
// masked to live splats with opacity * g < 0.99; the sigma gradient flows
// only where sigma > 0.
//
// Design (right and simple first).
//   * One thread block per tile, one thread per pixel; blockDim is th * tw
//     rounded up to whole warps (<= 1024), the surplus lanes carry a zero
//     cotangent, so every term they form is 0.
//   * The tile's feature rows (columns 0-8) pass through shared memory in
//     chunks of kChunk = 32 rows, so K is not capped.
//   * Each thread walks k = 0..K-1 with its running T and prefix colours and
//     its pixel's saved C / T_final / gout, and forms the 9 per-pixel terms.
//   * Per k, each warp sums the 9 terms with shuffles (a fixed tree) into one
//     slot of shared memory per (warp, k, column); at the end of a chunk the
//     block sums the warps' slots in warp order and writes gfeats rows k.
//     No atomics: every sum is taken in one fixed order, so the gradients
//     are the same from run to run.
//   * Each block owns its tile's rows of gfeats; nothing crosses blocks.  The
//     scatter-add of those rows into the (N, 16) feature table is autograd's
//     transpose of the gather, outside this kernel.
//   * The alpha arithmetic is alpha_terms.cuh, shared with the forward and
//     built with the same flags (expf, -fmad=false), so the live mask matches
//     the forward's bit for bit.
//
// What bounds it on an H100.  Per splat-pixel the loop does 85 f32
// operations counted from this source (the alpha terms 18, with expf as
// one; w and the three prefixes 7; 1 - alpha 1; d/d alpha 20, three of them
// divisions; the two masks 7; the nine terms 22; the T update 1; the warp
// sums 9).  Bytes: feats and gfeats (T, K, 16) f32 once each, out and gout
// (T, 4, th, tw) f32 once each, origins.  At a training tier of T = 3000
// tiles, 16 x 16 pixels, K = 64 that is 4.18 GFLOP (0.062 ms at the 67
// TFLOP/s f32 peak) against 49 MB (0.015 ms at 3.35 TB/s): bound by
// operations.
//
// Prediction, written before the kernel first ran: about 0.5 ms at that
// shape, some 8x its bound -- further from it than the forward (27%) -- since
// each splat costs every warp 45 dependent shuffles, a shared-memory store
// and three full-precision divisions.  What a later change could do about
// it: reduce in registers over several k before touching shared memory,
// give each thread several pixels, and replace the three divisions by one
// reciprocal under a restated gate.

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace {

using repro_torch::kAlphaMax;
using repro_torch::kLive;

constexpr int kChunk = 32;      // feature rows staged per shared-memory pass
constexpr int kMaxWarps = 32;   // 1024 threads

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // lane 0 holds the warp's sum
}

__global__ void __launch_bounds__(1024)
rasterize_bwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ origins,
                     const float* __restrict__ out,
                     const float* __restrict__ gout,
                     float* __restrict__ gfeats, int K, int F, int th,
                     int tw) {
  __shared__ float rows[kChunk * kLive];
  __shared__ float partial[kMaxWarps * kChunk * kLive];   // 36 KB
  const long long tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = blockDim.x >> 5;
  const int npix = th * tw;
  const bool on = p < npix;
  const int iy = p / tw;
  const int ix = p - iy * tw;
  const float px = origins[2 * tile] + (static_cast<float>(ix) + 0.5f);
  const float py = origins[2 * tile + 1] + (static_cast<float>(iy) + 0.5f);
  const float* tf = feats + tile * static_cast<long long>(K) * F;
  float* gf = gfeats + tile * static_cast<long long>(K) * F;

  // the pixel's forward result and cotangent; surplus lanes keep 0
  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f, t_final = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_cov = 0.0f;
  if (on) {
    const float* o = out + tile * 4LL * npix + p;
    const float* go = gout + tile * 4LL * npix + p;
    c_r = o[0];
    c_g = o[npix];
    c_b = o[2 * npix];
    t_final = 1.0f - o[3 * npix];
    g_r = go[0];
    g_g = go[npix];
    g_b = go[2 * npix];
    g_cov = go[3 * npix];
  }

  float trans = 1.0f, pr = 0.0f, pg = 0.0f, pb = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk's rows and partial sums are read
    for (int e = p; e < n * kLive; e += blockDim.x) {
      const int row = e / kLive;
      rows[e] = tf[static_cast<long long>(k0 + row) * F + (e - row * kLive)];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* f = rows + k * kLive;
      const repro_torch::AlphaTerms a = repro_torch::alpha_terms(f, px, py);
      const float w = trans * a.alpha;
      pr = pr + w * f[5];
      pg = pg + w * f[6];
      pb = pb + w * f[7];
      const float denom = 1.0f - a.alpha;   // >= 1 - 0.99
      const float g_alpha = g_r * (trans * f[5] - (c_r - pr) / denom)
          + g_g * (trans * f[6] - (c_g - pg) / denom)
          + g_b * (trans * f[7] - (c_b - pb) / denom)
          + g_cov * (t_final / denom);
      const float g_ag = (a.live && a.a_g < kAlphaMax) ? g_alpha : 0.0f;
      const float g_sigma = a.sigma > 0.0f ? -a.a_g * g_ag : 0.0f;
      float t[kLive];
      t[0] = -(f[2] * a.dx + f[3] * a.dy) * g_sigma;   // d/d mean x
      t[1] = -(f[4] * a.dy + f[3] * a.dx) * g_sigma;   // d/d mean y
      t[2] = 0.5f * a.dx * a.dx * g_sigma;             // d/d conic A
      t[3] = a.dx * a.dy * g_sigma;                    // d/d conic B
      t[4] = 0.5f * a.dy * a.dy * g_sigma;             // d/d conic C
      t[5] = g_r * w;                                  // d/d r
      t[6] = g_g * w;                                  // d/d g
      t[7] = g_b * w;                                  // d/d b
      t[8] = g_ag * a.g;                               // d/d opacity
#pragma unroll
      for (int c = 0; c < kLive; ++c) {
        const float s = warp_sum(t[c]);
        if (lane == 0) partial[(warp * kChunk + k) * kLive + c] = s;
      }
      trans = trans * denom;
    }
    __syncthreads();
    // sum the warps in warp order; columns past the live ones are 0
    for (int e = p; e < n * F; e += blockDim.x) {
      const int row = e / F;
      const int c = e - row * F;
      float s = 0.0f;
      if (c < kLive) {
        for (int w = 0; w < nwarps; ++w) {
          s += partial[(w * kChunk + row) * kLive + c];
        }
      }
      gf[static_cast<long long>(k0 + row) * F + c] = s;
    }
  }
}

}  // namespace

// feats (T, K, F) f32 contiguous, F >= 9; origins (T, 2) f32; out and gout
// (T, 4, th, tw) f32; gfeats (T, K, F) f32.  Launches on `stream` and
// returns cudaGetLastError() as an int (0 == cudaSuccess); the caller raises
// on anything else.
extern "C" int rasterize_bwd_launch(const void* feats, const void* origins,
                                    const void* out, const void* gout,
                                    void* gfeats, int T, int K, int F, int th,
                                    int tw, void* stream) {
  if (T > 0 && K > 0) {
    const int threads = (th * tw + 31) / 32 * 32;
    rasterize_bwd_kernel<<<T, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const float*>(origins),
        static_cast<const float*>(out), static_cast<const float*>(gout),
        static_cast<float*>(gfeats), K, F, th, tw);
  }
  return static_cast<int>(cudaGetLastError());
}

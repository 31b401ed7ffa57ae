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
// What bounds it on an H100: instruction issue.  The algorithm does 85 f32
// operations per splat-pixel (the alpha terms 18, with expf as one; w and
// the three prefixes 7; 1 - alpha 1; d/d alpha 20, three of them divisions;
// the two masks 7; the nine terms 22; the T update 1; the sums over pixels
// 9).  At a training tier of 4096 tiles, 16 x 16 pixels, K = 64 that is
// 5.70 GFLOP (0.085 ms at the 67 TFLOP/s f32 peak) against 67 MB (0.020 ms
// at 3.35 TB/s).  The one-thread-per-pixel kernel ran at 7% of that: per
// splat every warp ran nine shuffle trees (45 shuffles, which issue at a
// quarter of the f32 rate) and three IEEE divisions per pixel.
//
// Design for Hopper.
//   * One block per tile, kPix = 4 pixels per thread (tile_layout.cuh): a
//     16 x 16 tile runs on 64 threads (2 warps), an 8 x 128 tile on 256.
//     Each pixel's forward sweep is as before: running T and prefix
//     colours, the saved C / T_final / gout; idle slots carry a zero
//     cotangent, so every term they form is 0.
//   * The alpha arithmetic is alpha_terms.cuh, shared with the forward and
//     built with the same flags (expf, -fmad=false), so the masks (live,
//     opacity * g < 0.99, sigma > 0) match the forward's bit for bit.  When
//     a thread's pixels share a column, its dx products are formed once per
//     row, as in the forward.
//   * After alpha_terms: one reciprocal of 1 - alpha per splat-pixel
//     (rcp.approx, relative error about 2^-23; 1 - alpha lies in [0.01, 1])
//     instead of three divisions, and the gradient algebra written with
//     explicit fused multiply-adds:
//         g_alpha = T (g . rgb) - (g . (C - prefix) - g_cov T_final) / (1 - alpha)
//     The sums run in another order than the emulation's, so the gradients
//     differ from the one-thread-per-pixel kernel's in the last bits; the
//     gates (5e-4 against autograd of the plain forward, 2e-4 against the
//     emulation) are unchanged.
//   * Each thread sums its four pixels' nine terms in registers, in slot
//     order, for kGroup = 3 consecutive rows: 27 values, padded to 32.
//     One transposing reduce-scatter then sums them over the warp: at each
//     of 5 stages a lane keeps half its values and trades the other half
//     with the lane `offset` away, so lane j ends with the warp's sum of
//     value j: 31 shuffles for 27 sums, against 135 for 27 separate trees.
//     Lane j writes its own slot of shared memory (no lane-0 branch).
//     That is why this design and not one tree per row: shuffles issue at
//     a quarter of the f32 rate, and the trees would cost as many issue
//     cycles as the gradient arithmetic itself.
//   * The rows pass through dynamic shared memory in chunks of kChunk = 96
//     (32 groups) with 16-byte loads, so K is not capped; the per-warp
//     slots are sized by the block's warps (8 KB for a 16 x 16 tile, 32 KB
//     for 8 x 128).  At the end of a chunk the block sums the warps' slots
//     in warp order and writes gfeats rows k (16-byte stores).  No atomics:
//     every sum is taken in one fixed order, so the gradients are the same
//     from run to run.
//   * Each block owns its tile's rows of gfeats; nothing crosses blocks.  The
//     scatter-add of those rows into the (N, 16) feature table is autograd's
//     transpose of the gather, outside this kernel.
//
// What the built kernel issues (nvcc 12.8; cuobjdump -sass of the library,
// the loop over row groups, counted by rasterize.hot_loop; chip_smoke.py
// prints it): 888 instructions per group of 3 rows for four pixels, 74.0
// per splat-pixel -- 240 FFMA, 219 FMUL, 178 FADD, 24 MUFU (one EX2 and
// one RCP a splat-pixel), 31 SHFL, 9 LDS, and 187 others (the reduce-
// scatter's 62 selects, the masks' compares and selects, the loop); 78.5
// when a thread's pixels lie in different columns.  Issue-rate ceiling, at
// 4 warp instructions per clock per SM on 132 SMs: at the top train tier
// (4096 tiles x K = 64, 16 x 16) 67,108,864 splat-pixels / 32 lanes x 74
// = 155 M warp instructions, 0.148 ms at the card's 1,980 MHz maximum (more at the
// clock it holds under load, which chip_smoke.py samples), beside 0.085 ms
// for the 67 TFLOP/s bound.  ptxas (-Xptxas -v): 123 registers (127 for
// the other build), no stack, no spills, no static shared memory (12,800
// bytes of dynamic shared memory a 16 x 16 block, 37,376 for 8 x 128).

#include <cuda_runtime.h>

#include "alpha_terms.cuh"
#include "tile_layout.cuh"

namespace {

using repro_torch::kAlphaMax;
using repro_torch::kLive;
using repro_torch::kPix;
using repro_torch::kRowFloats;

constexpr int kGroup = 3;          // rows whose sums are reduced together
constexpr int kValues = 32;        // kGroup * kLive = 27 sums, 5 zero
constexpr int kChunk = 96;         // feature rows staged per pass
constexpr int kGroupsPerChunk = kChunk / kGroup;

static_assert(kGroup * kLive <= kValues, "a group's sums fit one warp");
static_assert(kChunk % kGroup == 0, "a chunk holds whole groups");

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One stage of the reduce-scatter: lane l pairs with l ^ O; the lane whose
// bit O is clear keeps v[0..O) and sends v[O..2O), its partner keeps
// v[O..2O) and sends v[0..O); each adds what it receives to what it keeps.
template <int O>
__device__ __forceinline__ void reduce_stage(float (&v)[kValues], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[0..31] in every lane -> lane j returns the sum over the warp's lanes of
// v[j], in a fixed order: 16 + 8 + 4 + 2 + 1 = 31 shuffles.
__device__ __forceinline__ float reduce_scatter(float (&v)[kValues],
                                                int lane) {
  reduce_stage<16>(v, lane);
  reduce_stage<8>(v, lane);
  reduce_stage<4>(v, lane);
  reduce_stage<2>(v, lane);
  reduce_stage<1>(v, lane);
  return v[0];
}

template <bool kOneColumn>
__global__ void __launch_bounds__(repro_torch::kMaxThreads)
rasterize_bwd_kernel(const float* __restrict__ feats,
                     const float* __restrict__ origins,
                     const float* __restrict__ out,
                     const float* __restrict__ gout,
                     float* __restrict__ gfeats, int K, int F, int th,
                     int tw, bool vec) {
  extern __shared__ float4 smem4[];
  float4* rows4 = smem4;                                   // kChunk x 3
  float* partial = reinterpret_cast<float*>(smem4 + kChunk * 3);
  const long long tile = blockIdx.x;
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = threads >> 5;
  const int npix = th * tw;
  const float ox = origins[2 * tile];
  const float oy = origins[2 * tile + 1];
  const float* tf = feats + tile * static_cast<long long>(K) * F;
  float* gf = gfeats + tile * static_cast<long long>(K) * F;

  // each slot's pixel centre, forward result and cotangent (0 when idle);
  // ngct = -g_cov * T_final, the coverage term of d out / d alpha
  float px[kPix], py[kPix], c_r[kPix], c_g[kPix], c_b[kPix], ngct[kPix];
  float g_r[kPix], g_g[kPix], g_b[kPix];
  float trans[kPix], pr[kPix], pg[kPix], pb[kPix];
#pragma unroll
  for (int s = 0; s < kPix; ++s) {
    const int p = s * threads + t;
    const int iy = p / tw;
    const int ix = p - iy * tw;
    px[s] = ox + (static_cast<float>(ix) + 0.5f);
    py[s] = oy + (static_cast<float>(iy) + 0.5f);
    c_r[s] = c_g[s] = c_b[s] = ngct[s] = 0.0f;
    g_r[s] = g_g[s] = g_b[s] = 0.0f;
    if (p < npix) {
      const float* o = out + tile * 4LL * npix + p;
      const float* go = gout + tile * 4LL * npix + p;
      c_r[s] = o[0];
      c_g[s] = o[npix];
      c_b[s] = o[2 * npix];
      g_r[s] = go[0];
      g_g[s] = go[npix];
      g_b[s] = go[2 * npix];
      ngct[s] = -(go[3 * npix] * (1.0f - o[3 * npix]));
    }
    trans[s] = 1.0f;
    pr[s] = pg[s] = pb[s] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    const int groups = (n + kGroup - 1) / kGroup;
    __syncthreads();  // the previous chunk's rows and partial sums are read
    repro_torch::stage_rows(rows4, tf + static_cast<long long>(k0) * F, n,
                            groups * kGroup, F, vec);
    __syncthreads();
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      float v[kValues];
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk) {
        float f[kLive];
        repro_torch::load_row(rows4, gi * kGroup + kk, f);
        float acc[kLive];
#pragma unroll
        for (int c = 0; c < kLive; ++c) acc[c] = 0.0f;
#pragma unroll
        for (int s = 0; s < kPix; ++s) {
          const float x = kOneColumn ? px[0] : px[s];
          const repro_torch::AlphaTerms a =
              repro_torch::alpha_terms(f, x, py[s]);
          // the pixel's forward sweep, as the forward kernel runs it
          const float w = trans[s] * a.alpha;
          pr[s] = pr[s] + w * f[5];
          pg[s] = pg[s] + w * f[6];
          pb[s] = pb[s] + w * f[7];
          const float denom = 1.0f - a.alpha;   // >= 1 - 0.99
          const float inv = rcp_approx(denom);
          const float dot_rgb = __fmaf_rn(
              g_b[s], f[7], __fmaf_rn(g_g[s], f[6], g_r[s] * f[5]));
          const float suffix = __fmaf_rn(
              g_b[s], c_b[s] - pb[s],
              __fmaf_rn(g_g[s], c_g[s] - pg[s],
                        __fmaf_rn(g_r[s], c_r[s] - pr[s], ngct[s])));
          const float g_alpha = __fmaf_rn(trans[s], dot_rgb, -(suffix * inv));
          const float g_ag = (a.live && a.a_g < kAlphaMax) ? g_alpha : 0.0f;
          const float g_sigma = a.sigma > 0.0f ? -a.a_g * g_ag : 0.0f;
          // the nine terms, summed over the thread's pixels in slot order
          acc[0] = __fmaf_rn(-__fmaf_rn(f[3], a.dy, f[2] * a.dx), g_sigma,
                             acc[0]);                        // d/d mean x
          acc[1] = __fmaf_rn(-(f[4] * a.dy + f[3] * a.dx), g_sigma,
                             acc[1]);                        // d/d mean y
          acc[2] = __fmaf_rn(0.5f * a.dx * a.dx, g_sigma, acc[2]);  // conic A
          acc[3] = __fmaf_rn(a.dx * a.dy, g_sigma, acc[3]);         // conic B
          acc[4] = __fmaf_rn(0.5f * a.dy * a.dy, g_sigma, acc[4]);  // conic C
          acc[5] = __fmaf_rn(g_r[s], w, acc[5]);                    // r
          acc[6] = __fmaf_rn(g_g[s], w, acc[6]);                    // g
          acc[7] = __fmaf_rn(g_b[s], w, acc[7]);                    // b
          acc[8] = __fmaf_rn(g_ag, a.g, acc[8]);                    // opacity
          trans[s] = trans[s] * denom;
        }
#pragma unroll
        for (int c = 0; c < kLive; ++c) v[kk * kLive + c] = acc[c];
      }
#pragma unroll
      for (int i = kGroup * kLive; i < kValues; ++i) v[i] = 0.0f;
      partial[(warp * kGroupsPerChunk + gi) * kValues + lane] =
          reduce_scatter(v, lane);
    }
    __syncthreads();
    // rows k0.. of gfeats: column c < 9 of row `row` is the warps' slots
    // (group row / 3, value (row % 3) * 9 + c) summed in warp order; the
    // columns past the live ones are 0
    auto column = [&](int row, int c) {
      float sum = 0.0f;
      if (c < kLive) {
        const int at = (row / kGroup) * kValues + (row % kGroup) * kLive + c;
        for (int w = 0; w < nwarps; ++w) {
          sum += partial[w * kGroupsPerChunk * kValues + at];
        }
      }
      return sum;
    };
    float* dst = gf + static_cast<long long>(k0) * F;
    if (vec) {
      const int f4 = F >> 2;
      for (int e = t; e < n * f4; e += threads) {
        const int row = e / f4;
        const int c = 4 * (e - row * f4);
        reinterpret_cast<float4*>(dst)[e] = make_float4(
            column(row, c), column(row, c + 1), column(row, c + 2),
            column(row, c + 3));
      }
    } else {
      for (int e = t; e < n * F; e += threads) {
        const int row = e / F;
        dst[e] = column(row, e - row * F);
      }
    }
  }
}

}  // namespace

// feats (T, K, F) f32 contiguous, F >= 9; origins (T, 2) f32; out and gout
// (T, 4, th, tw) f32; gfeats (T, K, F) f32.  threads / pixels_per_thread /
// smem_bytes are the wrapper's launch_geometry(th, tw, backward=True); any
// other layout returns cudaErrorInvalidValue.  Launches on `stream` and
// returns cudaGetLastError() as an int (0 == cudaSuccess); the caller
// raises on anything else.
extern "C" int rasterize_bwd_launch(const void* feats, const void* origins,
                                    const void* out, const void* gout,
                                    void* gfeats, int T, int K, int F, int th,
                                    int tw, int threads,
                                    int pixels_per_thread, int smem_bytes,
                                    void* stream) {
  const int need = (kChunk * kRowFloats
                    + (threads / 32) * kGroupsPerChunk * kValues) * 4;
  if (pixels_per_thread != kPix || threads != repro_torch::tile_threads(th, tw)
      || smem_bytes < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T > 0 && K > 0) {
    const bool vec = F % 4 == 0 && repro_torch::is_aligned16(feats)
        && repro_torch::is_aligned16(gfeats);
    auto kernel = threads % tw == 0 ? &rasterize_bwd_kernel<true>
                                    : &rasterize_bwd_kernel<false>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<T, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const float*>(origins),
        static_cast<const float*>(out), static_cast<const float*>(gout),
        static_cast<float*>(gfeats), K, F, th, tw, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

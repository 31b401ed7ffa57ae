// Launch layout shared by the forward and backward tile compositors
// (rasterize_fwd.cu, rasterize_bwd.cu): which pixels a thread carries, and
// how a tile's feature rows are staged in shared memory.
//
// Pixels.  A block of `threads` (whole warps, <= kMaxThreads) carries the
// th * tw pixels of one tile, kPix per thread: thread t, slot s holds the
// row-major pixel p = s * threads + t, and is idle where p >= th * tw.
// When threads is a multiple of tw, every slot of a thread lies in one
// column, so the thread's pixels share px: the kernels are then built with
// kOneColumn and the compiler forms px - mx and the products of dx that
// alpha_terms computes once per row for all four pixels (the same values,
// so each pixel's arithmetic is unchanged).  The wrapper's
// launch_geometry (kernels/rasterize.py) computes the same numbers, and
// the entry points refuse any other.
//
// Rows.  A row [mx, my, A, B, C, r, g, b, opacity] is staged as kRowFloats
// = 12 floats (16-byte aligned), so a thread reads it back as two 16-byte
// broadcasts and one 4-byte one instead of nine scalar loads.  Staging
// copies columns 0-11 with 16-byte loads when the table allows it (F a
// multiple of 4, the pointer 16-byte aligned), else columns 0-8 one float
// at a time.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "alpha_terms.cuh"

namespace repro_torch {

constexpr int kPix = 4;            // pixels per thread
constexpr int kMaxThreads = 256;   // 1024 pixels / kPix
constexpr int kRowFloats = 12;     // a staged row: 9 live columns + 3 pad

// threads the launch layout gives a th x tw tile (the wrapper's rule)
__host__ __device__ constexpr int tile_threads(int th, int tw) {
  return ((th * tw + kPix - 1) / kPix + 31) / 32 * 32;
}

__host__ inline bool is_aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// Rows [0, n) of a (rows, F) table at `src` into `rows4`, kRowFloats floats
// each; rows [n, n_pad) are zero (a zero row has alpha 0 and adds nothing).
__device__ __forceinline__ void stage_rows(float4* rows4,
                                           const float* __restrict__ src,
                                           int n, int n_pad, int F,
                                           bool vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int f4 = F >> 2;
    for (int e = threadIdx.x; e < n_pad * 3; e += blockDim.x) {
      const int row = e / 3;
      rows4[e] = row < n ? __ldg(s4 + static_cast<long long>(row) * f4
                                 + (e - row * 3))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    float* rows = reinterpret_cast<float*>(rows4);
    for (int e = threadIdx.x; e < n_pad * kRowFloats; e += blockDim.x) {
      const int row = e / kRowFloats;
      const int c = e - row * kRowFloats;
      rows[e] = (row < n && c < kLive)
          ? __ldg(src + static_cast<long long>(row) * F + c) : 0.0f;
    }
  }
}

// Staged row k -> f[0..8].
__device__ __forceinline__ void load_row(const float4* rows4, int k,
                                         float (&f)[kLive]) {
  const float4 a = rows4[3 * k];
  const float4 b = rows4[3 * k + 1];
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = b.w;
  f[8] = reinterpret_cast<const float*>(rows4)[kRowFloats * k + 8];
}

}  // namespace repro_torch

// Per-splat alpha arithmetic shared by the forward and backward tile
// compositors (rasterize_fwd.cu, rasterize_bwd.cu).
//
// Counterpart of _alpha_terms in src/repro/kernels/rasterize.py.  Both
// kernels include this one definition and are built with the same flags
// (no fast math, expf, -fmad=false), so a splat's alpha rounds identically
// in both: a splat at alpha ~ 1/255 or opacity * g ~ 0.99 is live in the
// backward exactly when it was live in the forward.

#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kLive = 9;      // live feature columns: mx my A B C r g b op
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;

struct AlphaTerms {
  float dx, dy;      // pixel centre minus splat mean
  float sigma;       // 0.5 (A dx^2 + C dy^2) + B dx dy
  float g;           // exp(-max(sigma, 0))
  float a_g;         // opacity * g, before the clamp
  float alpha;       // min(a_g, 0.99), 0 when below 1/255
  bool live;         // min(a_g, 0.99) >= 1/255
};

// f: one feature row [mx, my, A, B, C, r, g, b, opacity]; (px, py): the
// pixel centre.  Operation for operation the plain PyTorch version's
// element-wise ops (kernels/ref.py _splat_alpha).
__device__ __forceinline__ AlphaTerms alpha_terms(const float* f, float px,
                                                  float py) {
  AlphaTerms a;
  a.dx = px - f[0];
  a.dy = py - f[1];
  a.sigma = 0.5f * (f[2] * a.dx * a.dx + f[4] * a.dy * a.dy)
      + f[3] * a.dx * a.dy;
  a.g = expf(-fmaxf(a.sigma, 0.0f));
  a.a_g = f[8] * a.g;
  const float clamped = fminf(a.a_g, kAlphaMax);
  a.live = clamped >= kAlphaMin;
  a.alpha = a.live ? clamped : 0.0f;
  return a;
}

}  // namespace repro_torch

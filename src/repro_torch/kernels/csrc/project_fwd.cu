// EWA projection of 3D Gaussians to screen space, forward, CUDA C++ for
// sm_90a.
//
// Replaces no Pallas kernel: the JAX package writes the projection
// (src/repro/core/projection.py) as plain jnp and leaves it to XLA's
// fusion.  Eager PyTorch runs the same function as some forty element-wise
// launches and cuBLAS's batched 2x3 / 3x3 GEMMs (32x32 tiles, nearly all
// of each tile idle), writing every intermediate to device memory.  This
// kernel is the plain version (core/projection.project_ref) in one pass.
//
// What it computes.  For every splat n and view v of a (V, 4, 4) batch:
//     p = Rc mean + t,  zc = max(z, near),  u = fx x / zc + cx, v likewise
//     J = [[fx/zc, 0, -fx x/zc^2], [0, fy/zc, -fy y/zc^2]],  T = J Rc
//     cov2 = T (R S S^T R^T) T^T, dilated by 0.3 px on the diagonal
//     radius = ceil(3 sqrt(max(lam1, 1e-9))) from the larger eigenvalue
//     valid = z > near, the radius box meets the image, active,
//             alpha > alpha_min, det > 1e-12
// writing mean2d (V, N, 2), cov2d (V, N, 3) [a, b, c], depth (V, N),
// radius (V, N) and valid (V, N) (one byte).  rgb and alpha stay the
// caller's N-sized sigmoids, broadcast over the views.
//
// What bounds it on an H100: bytes.  A splat reads 45 bytes once (mean 12,
// log-scales 12, quaternion 16, alpha 4, active 1) and writes 29 bytes a
// view (mean2d 8, cov2d 12, depth 4, radius 4, valid 1).  About 280 f32
// operations a splat and view (bench/gsbench/counts.py) is ~4 operations a
// byte at V = 1 and ~8 at V = 8, under the card's 20 (67 TFLOP/s over
// 3.35 TB/s).  At the training shape (2 x 2.88M slots, V = 1) that is
// 0.43 GB, 0.13 ms at 3.35 TB/s; at the serving shape (~4M splats, V = 8)
// 1.1 GB, 0.33 ms.
//
// Design for Hopper.
//   * One thread per splat.  It reads the splat's inputs once, builds the
//     3x3 covariance once in registers (project_math.cuh), then loops over
//     the views; no intermediate leaves the registers.
//   * The cameras are read with uniform loads (every lane the same
//     address: one broadcast, served by L1), so V is not capped.
//   * For a fixed view, neighbouring threads write neighbouring splats: the
//     stores of a warp cover contiguous runs of each output plane.
//   * Every operation is the plain version's, in its order, in float32:
//     built without --use_fast_math and with -fmad=false, so division and
//     sqrt are IEEE and no element-wise operation contracts; the matrix
//     products are written as the fused multiply-add chains cuBLAS's f32
//     GEMMs run (project_math.cuh).  The kernel agrees with the plain
//     version to rounding, and radius and valid agree exactly wherever the
//     pre-ceil radius lies away from an integer.

#include <cuda_runtime.h>

#include "project_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ quats,
                   const float* __restrict__ alpha,
                   const bool* __restrict__ active,
                   const float* __restrict__ view,
                   const float* __restrict__ fx, const float* __restrict__ fy,
                   float* __restrict__ mean2d, float* __restrict__ cov2d,
                   float* __restrict__ depth, float* __restrict__ radius,
                   bool* __restrict__ valid, long long N, int V, float width,
                   float height, float near, float alpha_min) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (n >= N) return;
  float mean[3], ls[3], quat[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mean[i] = means[3 * n + i];
    ls[i] = log_scales[3 * n + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = quats[4 * n + i];
  const bool keep = active[n] && alpha[n] > alpha_min;
  repro_torch::SplatCov s;
  repro_torch::splat_cov(ls, quat, s);
  const float cx = width / 2.0f;
  const float cy = height / 2.0f;

  for (int vi = 0; vi < V; ++vi) {
    repro_torch::ViewCam c;
    repro_torch::load_view(view, fx, fy, vi, c);
    repro_torch::ViewProj p;
    repro_torch::project_view(mean, s, c, near, cx, cy, p);
    const float mid = 0.5f * (p.a + p.c);
    const float lam1 =
        mid + sqrtf(repro_torch::clamp_min(mid * mid - p.det, 1e-9f));
    const float r = ceilf(3.0f * sqrtf(repro_torch::clamp_min(lam1, 1e-9f)));
    const bool inside = p.z > near && p.u + r > 0.0f && p.u - r < width
                        && p.v + r > 0.0f && p.v - r < height;
    const long long o = static_cast<long long>(vi) * N + n;
    mean2d[2 * o] = p.u;
    mean2d[2 * o + 1] = p.v;
    cov2d[3 * o] = p.a;
    cov2d[3 * o + 1] = p.b;
    cov2d[3 * o + 2] = p.c;
    depth[o] = p.z;
    radius[o] = r;
    valid[o] = inside && keep && p.det > 1e-12f;
  }
}

}  // namespace

// means, log_scales (N, 3), quats (N, 4), alpha (N,) f32, active (N,) bool,
// view (V, 4, 4), fx, fy (V,) f32, all contiguous on one device; outputs
// mean2d (V, N, 2), cov2d (V, N, 3), depth, radius (V, N) f32 and valid
// (V, N) bool, allocated by the caller.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 == cudaSuccess).
extern "C" int project_fwd_launch(const void* means, const void* log_scales,
                                  const void* quats, const void* alpha,
                                  const void* active, const void* view,
                                  const void* fx, const void* fy,
                                  void* mean2d, void* cov2d, void* depth,
                                  void* radius, void* valid, long long N,
                                  int V, float width, float height,
                                  float near, float alpha_min, void* stream) {
  if (N < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0 && V > 0) {
    const long long blocks = (N + kThreads - 1) / kThreads;
    if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    project_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(means),
        static_cast<const float*>(log_scales),
        static_cast<const float*>(quats), static_cast<const float*>(alpha),
        static_cast<const bool*>(active), static_cast<const float*>(view),
        static_cast<const float*>(fx), static_cast<const float*>(fy),
        static_cast<float*>(mean2d), static_cast<float*>(cov2d),
        static_cast<float*>(depth), static_cast<float*>(radius),
        static_cast<bool*>(valid), N, V, width, height, near, alpha_min);
  }
  return static_cast<int>(cudaGetLastError());
}

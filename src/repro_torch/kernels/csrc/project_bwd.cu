// EWA projection of 3D Gaussians to screen space, backward, CUDA C++ for
// sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves the projection and its
// gradient to XLA (jax.grad of src/repro/core/projection.py).  Eager
// PyTorch's autograd of the plain version runs the transposes of cuBLAS's
// 2x3 / 3x3 GEMMs and some forty element-wise backward launches, over
// intermediates it saved in device memory.  This kernel is that gradient
// in one pass, with nothing saved but the inputs.
//
// What it computes.  Given the cotangents of project_fwd's mean2d (V, N, 2),
// cov2d (V, N, 3) and depth (V, N), the gradients of means (N, 3),
// log_scales (N, 3) and quats (N, 4), summed over the V views.  It follows
// autograd of the plain version branch for branch: the clamp of z at the
// near plane passes the gradient where z >= near; only cov2[0, 1] is read
// for b, so cov2[1, 0] gets none; the quaternion's norm clamp at 1e-12
// passes it where |q| >= 1e-12; radius and valid carry none.
//
// What bounds it on an H100: bytes.  A splat reads its 40 bytes of means,
// log-scales and quaternion once and 24 bytes of cotangent a view, and
// writes 40 bytes of gradient once.  At the training shape (2 x 2.88M
// slots, V = 1) that is 0.6 GB, 0.18 ms at 3.35 TB/s; about twice the
// forward's 280 operations a splat and view is ~5 operations a byte, under
// the card's 20.
//
// Design for Hopper.
//   * One thread per splat.  It recomputes the splat's covariance and each
//     view's projection from the inputs with the forward's own functions
//     (project_math.cuh), so the backward sees the forward's values bit for
//     bit and nothing else need be kept.
//   * It sums the gradients of the covariance and the mean over the views
//     in registers and writes each splat's gradient once: no atomics, no
//     second pass, the same bits on every run.
//   * float32 throughout, built with the forward's flags (IEEE division and
//     sqrt, -fmad=false).  The sums run in another order than autograd's
//     GEMMs and reductions, so the gradients agree with autograd of the
//     plain version to rounding, not bit for bit.

#include <cuda_runtime.h>

#include "project_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ quats,
                   const float* __restrict__ view,
                   const float* __restrict__ fx, const float* __restrict__ fy,
                   const float* __restrict__ g_mean2d,
                   const float* __restrict__ g_cov2d,
                   const float* __restrict__ g_depth,
                   float* __restrict__ d_means,
                   float* __restrict__ d_log_scales,
                   float* __restrict__ d_quats, long long N, int V,
                   float near) {
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
  repro_torch::SplatCov s;
  repro_torch::splat_cov(ls, quat, s);

  float dcov[3][3], dm[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dm[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) dcov[i][k] = 0.0f;
  }

  for (int vi = 0; vi < V; ++vi) {
    repro_torch::ViewCam c;
    repro_torch::load_view(view, fx, fy, vi, c);
    repro_torch::ViewProj p;
    // cx, cy shift u and v only: their gradient does not depend on them
    repro_torch::project_view(mean, s, c, near, 0.0f, 0.0f, p);
    const long long o = static_cast<long long>(vi) * N + n;
    const float gu = g_mean2d[2 * o], gv = g_mean2d[2 * o + 1];
    const float ga = g_cov2d[3 * o], gb = g_cov2d[3 * o + 1];
    const float gc = g_cov2d[3 * o + 2];
    const float gz = g_depth[o];

    // cov2 = M T^T with dcov2 = [[ga, gb], [0, gc]]
    float dM[2][3], dT[2][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dM[0][k] = ga * p.T[0][k] + gb * p.T[1][k];
      dM[1][k] = gc * p.T[1][k];
      dT[0][k] = p.M[0][k] * ga;
      dT[1][k] = p.M[0][k] * gb + p.M[1][k] * gc;
    }
    // M = T cov: dT += dM cov^T, dcov += T^T dM
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dT[a][j] = dT[a][j] + ((dM[a][0] * s.cov[j][0]
                                + dM[a][1] * s.cov[j][1])
                               + dM[a][2] * s.cov[j][2]);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dcov[j][k] = dcov[j][k] + (p.T[0][j] * dM[0][k]
                                   + p.T[1][j] * dM[1][k]);
    // T = J Rc: dJ = dT Rc^T, at the Jacobian's four non-zero entries
    const float dj00 = (dT[0][0] * c.Rc[0][0] + dT[0][1] * c.Rc[0][1])
                       + dT[0][2] * c.Rc[0][2];
    const float dj02 = (dT[0][0] * c.Rc[2][0] + dT[0][1] * c.Rc[2][1])
                       + dT[0][2] * c.Rc[2][2];
    const float dj11 = (dT[1][0] * c.Rc[1][0] + dT[1][1] * c.Rc[1][1])
                       + dT[1][2] * c.Rc[1][2];
    const float dj12 = (dT[1][0] * c.Rc[2][0] + dT[1][1] * c.Rc[2][1])
                       + dT[1][2] * c.Rc[2][2];
    // u = fx x / zc + cx, v = fy y / zc + cy
    float dx = (gu / p.zc) * c.fx;
    float dy = (gv / p.zc) * c.fy;
    float dzc = -gu * ((p.fxx / p.zc) / p.zc);
    dzc = dzc + -gv * ((p.fyy / p.zc) / p.zc);
    // j00 = fx / zc, j11 = fy / zc
    dzc = dzc + -dj00 * (p.j00 / p.zc);
    dzc = dzc + -dj11 * (p.j11 / p.zc);
    // j02 = (-fx x) / zz, j12 = (-fy y) / zz, zz = zc zc
    dx = dx + (dj02 / p.zz) * -c.fx;
    dy = dy + (dj12 / p.zz) * -c.fy;
    const float dzz = -dj02 * (p.j02 / p.zz) + -dj12 * (p.j12 / p.zz);
    dzc = dzc + (dzz * p.zc + dzz * p.zc);
    // zc = max(z, near) passes where z >= near; depth = z
    const float dz = (p.z >= near ? dzc : 0.0f) + gz;
    // p = Rc mean + t
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dm[j] = dm[j] + ((dx * c.Rc[0][j] + dy * c.Rc[1][j]) + dz * c.Rc[2][j]);
  }

  // cov = RS RS^T: dRS = dcov RS + dcov^T RS
  float dR[3][3], dS[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dS[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float drs =
          ((dcov[i][0] * s.RS[0][j] + dcov[i][1] * s.RS[1][j])
           + dcov[i][2] * s.RS[2][j])
          + ((dcov[0][i] * s.RS[0][j] + dcov[1][i] * s.RS[1][j])
             + dcov[2][i] * s.RS[2][j]);
      // RS = R * S[j]
      dR[i][j] = drs * s.S[j];
      dS[j] = dS[j] + drs * s.R[i][j];
    }
  // S = exp(log_scales)
#pragma unroll
  for (int j = 0; j < 3; ++j) d_log_scales[3 * n + j] = dS[j] * s.S[j];

  // R of the normalised quaternion (w, x, y, z)
  const float w = s.qn[0], x = s.qn[1], y = s.qn[2], z = s.qn[3];
  float dqn[4];
  dqn[0] = 2.0f * ((((-z * dR[0][1] + y * dR[0][2]) + z * dR[1][0])
                    + (-x * dR[1][2] + -y * dR[2][0])) + x * dR[2][1]);
  dqn[1] = 2.0f * ((((y * dR[0][1] + z * dR[0][2]) + y * dR[1][0])
                    + (-w * dR[1][2] + z * dR[2][0])) + w * dR[2][1])
           + -4.0f * (x * dR[1][1] + x * dR[2][2]);
  dqn[2] = 2.0f * ((((x * dR[0][1] + w * dR[0][2]) + x * dR[1][0])
                    + (z * dR[1][2] + -w * dR[2][0])) + z * dR[2][1])
           + -4.0f * (y * dR[0][0] + y * dR[2][2]);
  dqn[3] = 2.0f * ((((-w * dR[0][1] + x * dR[0][2]) + w * dR[1][0])
                    + (y * dR[1][2] + x * dR[2][0])) + y * dR[2][1])
           + -4.0f * (z * dR[0][0] + z * dR[1][1]);
  // qn = q / max(|q|, 1e-12)
  const float nc = repro_torch::clamp_min(s.norm, 1e-12f);
  float dnc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dnc = dnc + -dqn[i] * ((s.q[i] / nc) / nc);
  const float dn = s.norm >= 1e-12f ? dnc : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float dq = dqn[i] / nc;
    if (s.norm >= 1e-12f) dq = dq + s.q[i] * (dn / s.norm);
    d_quats[4 * n + i] = dq;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) d_means[3 * n + j] = dm[j];
}

}  // namespace

// means, log_scales (N, 3), quats (N, 4), view (V, 4, 4), fx, fy (V,), the
// cotangents g_mean2d (V, N, 2), g_cov2d (V, N, 3), g_depth (V, N), all f32
// and contiguous on one device; outputs d_means, d_log_scales (N, 3),
// d_quats (N, 4), allocated by the caller.  Launches on `stream` and
// returns cudaGetLastError() as an int (0 == cudaSuccess).
extern "C" int project_bwd_launch(const void* means, const void* log_scales,
                                  const void* quats, const void* view,
                                  const void* fx, const void* fy,
                                  const void* g_mean2d, const void* g_cov2d,
                                  const void* g_depth, void* d_means,
                                  void* d_log_scales, void* d_quats,
                                  long long N, int V, float near,
                                  void* stream) {
  if (N < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) {
    const long long blocks = (N + kThreads - 1) / kThreads;
    if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    project_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(means),
        static_cast<const float*>(log_scales),
        static_cast<const float*>(quats), static_cast<const float*>(view),
        static_cast<const float*>(fx), static_cast<const float*>(fy),
        static_cast<const float*>(g_mean2d),
        static_cast<const float*>(g_cov2d),
        static_cast<const float*>(g_depth), static_cast<float*>(d_means),
        static_cast<float*>(d_log_scales), static_cast<float*>(d_quats), N,
        V, near);
  }
  return static_cast<int>(cudaGetLastError());
}

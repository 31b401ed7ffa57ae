// EWA projection arithmetic shared by the projection kernels
// (project_fwd.cu, project_bwd.cu): the splat's 3D covariance from its
// scales and quaternion, and one view's projection of it.  The backward
// recomputes the forward from the inputs with these same functions, so both
// kernels see the same values bit for bit.
//
// Every operation is the plain version's (src/repro_torch/core/projection.py
// and core/gaussians.py), in its order, in float32: IEEE division and sqrt,
// every clamp and term kept.  The element-wise operations round one by one
// (the library is built with -fmad=false), as eager PyTorch's one kernel an
// operation does.  A matrix product of the plain version (torch.matmul,
// einsum) runs on the card as cuBLAS's f32 GEMM, which sums each entry as a
// chain of fused multiply-adds over j = 0, 1, 2: `dot3` writes that chain
// out with fmaf, so the kernel rounds where the plain version does.  The
// clamps are written `x < lo ? lo : x`, so a NaN passes through as
// torch.clamp lets it.

#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr float kCovDilate = 0.3f;   // COV2D_DILATE: 0.3 px anti-aliasing

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// a0 b0 + a1 b1 + a2 b2 as a GEMM's fused multiply-add chain, j ascending
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// One splat's 3D covariance and the pieces its gradient needs.
struct SplatCov {
  float q[4];       // the quaternion as read (w, x, y, z)
  float norm;       // |q|, before the 1e-12 clamp
  float qn[4];      // q / max(|q|, 1e-12)
  float R[3][3];    // rotation of qn
  float S[3];       // exp(log_scales)
  float RS[3][3];   // R * S (column j scaled by S[j])
  float cov[3][3];  // RS RS^T (symmetric)
};

// quat_to_rotmat and covariance3d of core/gaussians.py
__device__ __forceinline__ void splat_cov(const float* ls, const float* quat,
                                          SplatCov& s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s.q[i] = quat[i];
  s.norm = sqrtf(((s.q[0] * s.q[0] + s.q[1] * s.q[1]) + s.q[2] * s.q[2])
                 + s.q[3] * s.q[3]);
  const float nc = clamp_min(s.norm, 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) s.qn[i] = s.q[i] / nc;
  const float w = s.qn[0], x = s.qn[1], y = s.qn[2], z = s.qn[3];
  s.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  s.R[0][1] = 2.0f * (x * y - w * z);
  s.R[0][2] = 2.0f * (x * z + w * y);
  s.R[1][0] = 2.0f * (x * y + w * z);
  s.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  s.R[1][2] = 2.0f * (y * z - w * x);
  s.R[2][0] = 2.0f * (x * z - w * y);
  s.R[2][1] = 2.0f * (y * z + w * x);
  s.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int j = 0; j < 3; ++j) s.S[j] = expf(ls[j]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s.RS[i][j] = s.R[i][j] * s.S[j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = i; k < 3; ++k) {
      const float c = dot3(s.RS[i][0], s.RS[k][0], s.RS[i][1], s.RS[k][1],
                           s.RS[i][2], s.RS[k][2]);
      s.cov[i][k] = c;
      s.cov[k][i] = c;
    }
}

// One view: world -> camera rotation Rc and translation tc, focal lengths.
struct ViewCam {
  float Rc[3][3];
  float tc[3];
  float fx, fy;
};

// view (V, 4, 4) row-major world -> camera matrices; fx, fy (V,)
__device__ __forceinline__ void load_view(const float* __restrict__ view,
                                          const float* __restrict__ fx,
                                          const float* __restrict__ fy, int v,
                                          ViewCam& c) {
  const float* m = view + 16 * v;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.Rc[i][j] = __ldg(m + 4 * i + j);
    c.tc[i] = __ldg(m + 4 * i + 3);
  }
  c.fx = __ldg(fx + v);
  c.fy = __ldg(fy + v);
}

// Everything one view's projection of one splat computes.
struct ViewProj {
  float x, y, z;       // camera-space centre
  float zc;            // max(z, near)
  float fxx, fyy;      // fx * x, fy * y
  float u, v;          // pixel centre
  float zz;            // zc * zc
  float j00, j02, j11, j12;   // the Jacobian's non-zero entries
  float T[2][3];       // J Rc
  float M[2][3];       // T cov
  float a, b, c;       // packed 2D covariance, dilated
  float det;
};

// The body of core/projection.project for one splat and one view, up to
// the 2D covariance and its determinant.
__device__ __forceinline__ void project_view(const float* mean,
                                             const SplatCov& s,
                                             const ViewCam& c, float near,
                                             float cx, float cy,
                                             ViewProj& p) {
  float pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = dot3(mean[0], c.Rc[i][0], mean[1], c.Rc[i][1], mean[2],
                 c.Rc[i][2]) + c.tc[i];
  p.x = pc[0];
  p.y = pc[1];
  p.z = pc[2];
  p.zc = clamp_min(p.z, near);
  p.fxx = c.fx * p.x;
  p.fyy = c.fy * p.y;
  p.u = p.fxx / p.zc + cx;
  p.v = p.fyy / p.zc + cy;
  p.zz = p.zc * p.zc;
  p.j00 = c.fx / p.zc;
  p.j02 = (-c.fx * p.x) / p.zz;
  p.j11 = c.fy / p.zc;
  p.j12 = (-c.fy * p.y) / p.zz;
  // T = J Rc; each of the Jacobian's zero entries adds an exact zero to
  // its chain, left out
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.T[0][k] = fmaf(p.j02, c.Rc[2][k], p.j00 * c.Rc[0][k]);
    p.T[1][k] = fmaf(p.j12, c.Rc[2][k], p.j11 * c.Rc[1][k]);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p.M[a][k] = dot3(p.T[a][0], s.cov[0][k], p.T[a][1], s.cov[1][k],
                       p.T[a][2], s.cov[2][k]);
  const float c00 = dot3(p.M[0][0], p.T[0][0], p.M[0][1], p.T[0][1],
                         p.M[0][2], p.T[0][2]);
  const float c01 = dot3(p.M[0][0], p.T[1][0], p.M[0][1], p.T[1][1],
                         p.M[0][2], p.T[1][2]);
  const float c11 = dot3(p.M[1][0], p.T[1][0], p.M[1][1], p.T[1][1],
                         p.M[1][2], p.T[1][2]);
  p.a = c00 + kCovDilate;
  p.b = c01;
  p.c = c11 + kCovDilate;
  p.det = p.a * p.c - p.b * p.b;
}

}  // namespace repro_torch

// Two-view DLT triangulation for Hopper (sm_90a): the null vector of each
// correspondence's 4x4 DLT system, one thread a correspondence, one launch
// a keyframe pair.
//
// Replaces no Pallas kernel: the JAX package's triangulation
// (refactored_orb_slam2_tpu/geometry/triangulation.py::triangulate_dlt)
// calls jnp.linalg.svd, which XLA runs on the TPU inside the jitted
// mapping step.  The port's plain version calls torch.linalg.svd, and on
// CUDA that synchronizes the host with the card once a batch, so local
// mapping's triangulation could not be captured in a CUDA graph.  This
// kernel computes the same smallest right singular vector with no host
// involvement.
//
// Contract (float32 throughout, as the plain version): for row i, with
// (u1, v1) = x1[i], (u2, v2) = x2[i], the rows of A are
//   u1 P1[2] - P1[0],  v1 P1[2] - P1[1],  u2 P2[2] - P2[0],  v2 P2[2] - P2[1]
// (each product and difference rounded on its own, as PyTorch's separate
// multiply and subtract); v is A's right singular vector of the smallest
// singular value; out[i] = v[0:3] / w with w = v[3], or 1e-12 where
// |v[3]| < 1e-12.  The sign of v is free, as the plain version's, and
// cancels in the division.
//
// The method: one-sided (Hestenes) Jacobi on A's four columns, the same
// family as cuSOLVER's gesvdj that the plain version runs on the card:
// cyclic sweeps over the six column pairs, each pair rotated to
// orthogonality (and the rotation applied to V, which starts as I), every
// rotation unrolled over the 4x4 in registers.  The sweeps stop when no
// pair's |a_p . a_q| exceeds FLT_EPSILON * |a_p| |a_q|, or after kMaxSweeps.
// The singular values are then the columns' norms; the column of V with the
// smallest is the null vector.  Plain IEEE float32 (no fast-math).
//
// What bounds it: latency.  A row reads 16 B and writes 12 B (34 KB at the
// 1200 rows of the stereo preset, about 10 ns of the card's memory rate),
// and a sweep is about 400 float operations a row, so a call is a few
// microseconds of one launch, a few warps' work.  The design keeps each
// row's 32 matrix entries in one thread's registers and launches enough
// 128-thread blocks to give every row a thread.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 16;

__device__ __forceinline__ float dlt_entry(float x, float p_row2, float p_row) {
  return __fsub_rn(__fmul_rn(x, p_row2), p_row);
}

__global__ void __launch_bounds__(kThreads)
dlt_nullvec_kernel(const float* __restrict__ P1, const float* __restrict__ P2,
                   const float* __restrict__ x1, const float* __restrict__ x2,
                   float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float u1 = x1[2 * i], v1 = x1[2 * i + 1];
  const float u2 = x2[2 * i], v2 = x2[2 * i + 1];
  float a[4][4], v[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[0][c] = dlt_entry(u1, P1[8 + c], P1[c]);
    a[1][c] = dlt_entry(v1, P1[8 + c], P1[4 + c]);
    a[2][c] = dlt_entry(u2, P2[8 + c], P2[c]);
    a[3][c] = dlt_entry(v2, P2[8 + c], P2[4 + c]);
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r][c] = r == c ? 1.0f : 0.0f;
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int q = p + 1; q < 4; ++q) {
      float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        alpha += a[r][p] * a[r][p];
        beta += a[r][q] * a[r][q];
        gamma += a[r][p] * a[r][q];
      }
      if (!(fabsf(gamma) > FLT_EPSILON * sqrtf(alpha) * sqrtf(beta))) continue;
      rotated = true;
      // the rotation that zeroes a_p . a_q (Golub and Van Loan 8.4, the
      // smaller of the two angles)
      const float zeta = (beta - alpha) / (2.0f * gamma);
      const float root = fabsf(zeta) < 1e18f ? sqrtf(1.0f + zeta * zeta) : fabsf(zeta);
      const float t = copysignf(1.0f, zeta) / (fabsf(zeta) + root);
      const float c = 1.0f / sqrtf(1.0f + t * t);
      const float s = c * t;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ap = a[r][p], aq = a[r][q];
        a[r][p] = c * ap - s * aq;
        a[r][q] = s * ap + c * aq;
        const float vp = v[r][p], vq = v[r][q];
        v[r][p] = c * vp - s * vq;
        v[r][q] = s * vp + c * vq;
      }
    }
    }
    if (!rotated) break;
  }
  // the column of least norm (the first of equals)
  float least = 0.0f, w = 0.0f, h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float norm2 = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) norm2 += a[r][c] * a[r][c];
    if (c == 0 || norm2 < least) {
      least = norm2;
      h0 = v[0][c];
      h1 = v[1][c];
      h2 = v[2][c];
      w = v[3][c];
    }
  }
  if (fabsf(w) < 1e-12f) w = 1e-12f;
  out[3 * i] = h0 / w;
  out[3 * i + 1] = h1 / w;
  out[3 * i + 2] = h2 / w;
}

}  // namespace

// P1, P2: (3, 4) float32; x1, x2: (n, 2) float32; out: (n, 3) float32; all
// contiguous on the card.  Returns the launch's cudaError_t.
extern "C" int dlt_nullvec_launch(const void* P1, const void* P2, const void* x1,
                                  const void* x2, void* out, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dlt_nullvec_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P1), static_cast<const float*>(P2),
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

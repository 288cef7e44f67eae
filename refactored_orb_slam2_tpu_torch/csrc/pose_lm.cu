// Pose-only Levenberg-Marquardt for Hopper (sm_90a): the whole solve of
// optim/pose_opt.py::optimize_pose_reference (Optimizer::PoseOptimization)
// in one thread block, one launch a call.
//
// Replaces no Pallas kernel: the JAX package's pose optimization
// (refactored_orb_slam2_tpu/optim/pose_opt.py) is plain JAX, which XLA
// fuses on the TPU.  It was added because the port's plain version runs as
// 8,209 separate PyTorch kernels a call (two calls in every tracked frame's
// CUDA graph, 84% of its nodes), each a few microseconds of launch for a
// few nanoseconds of work.
//
// Contract (float32 throughout, as the plain version):
//   4 rounds x 10 LM iterations; Huber (IRLS weight sqrt(th / max(chi2,
//   1e-12)) above th) in rounds 0-1, th 5.991 mono / 7.815 stereo; edge
//   information inv_sigma2; an edge with camera depth <= 1e-3 at a build's
//   pose drops out of that build; a mono edge's uR row has weight 0; the
//   step solves (H + lam diag(H) + 1e-9 I) dx = -g by LU with partial
//   pivoting and T <- Exp(dx) T; accept iff err_new < err, lam x0.5 on
//   accept and x4 on reject, clamped to [1e-10, 1e6], 1e-4 at each round's
//   start; after each round the edges are reclassified against `valid`
//   (chi2 <= th and depth > 1e-3); outputs the final pose, the inlier
//   mask, its count and every edge's chi2 at the final pose.
//
// What bounds it: latency.  A call reads ~30 B an edge once (35 KB at 1000
// edges, about 10 ns of the card's memory rate) and does ~12 MFLOP over 49
// normal-equation builds (about 0.2 us at the float32 rate), but the 49
// builds and 40 damped solves form one chain: each build needs the pose
// the previous solve gave.  So the design keeps every step of that chain
// on one SM and short:
//
// - one block of kThreads threads; each thread keeps up to kCached edges'
//   inputs and inlier flags in registers, loaded once for all builds
//   (2048 edges; edges past that are read again from memory each build,
//   their inlier flag kept in the output mask), so any N works;
// - a build reduces 28 sums (H's upper triangle, g, the error): each warp
//   by a recursive halving over shuffles (31 shuffles for 32 values), then
//   the warps' partials in shared memory in warp order.  A fixed order and
//   no atomics, so two launches, and a graph replay against an eager call,
//   agree bit for bit;
// - lane 0 of warp 0 solves the 6x6 system in registers, applies Exp, takes
//   the accept/reject and puts the next pose in shared memory; two block
//   barriers a build;
// - the reclassification at a round's end shares the next round's first
//   build (both at the same pose), and the final chi2 is the last
//   reclassification's: 45 passes over the edges where the plain version
//   makes 49 builds.
// Plain float32 arithmetic (fused multiply-adds, no fast-math, no tensor
// cores), so results differ from the plain version's only by sum order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCached = 4;               // edges a thread holds in registers
constexpr int kRounds = 4;
constexpr int kIters = 10;
constexpr int kSums = 28;                // 21 of H, 6 of g, the error
constexpr float kChi2Mono = 5.991f;      // optim/residuals.py CHI2_MONO
constexpr float kChi2Stereo = 7.815f;    // CHI2_STEREO

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Edge {
  float px, py, pz, u, v, ur, is2;
  bool valid, stereo;
};

// The edges' inputs and the per-edge outputs, as the wrapper passes them.
struct Edges {
  const float* pw;        // (n, 3)
  const float* obs;       // (n, 3): u, v, uR
  const float* is2;       // (n,)
  const uint8_t* valid;   // (n,) bool
  const uint8_t* stereo;  // (n,) bool
  int n;
  Cam cam;
  float* chi2_out;        // (n,)
  uint8_t* inlier_out;    // (n,) bool; the inlier flags of edges past the cached ones

  __device__ __forceinline__ Edge load(int e) const {
    Edge d;
    d.px = pw[3 * e];
    d.py = pw[3 * e + 1];
    d.pz = pw[3 * e + 2];
    d.u = obs[3 * e];
    d.v = obs[3 * e + 1];
    d.ur = obs[3 * e + 2];
    d.is2 = is2[e];
    d.valid = valid[e] != 0;
    d.stereo = stereo[e] != 0;
    return d;
  }
};

enum Pass { kBuild, kReclassifyBuild, kFinal };

// H (upper triangle, row-major) += J^T (w J), g += (w J) r for one residual row
__device__ __forceinline__ void add_row(float (&acc)[32], const float (&J)[6], float w,
                                        float r) {
  float wj[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) wj[k] = w * J[k];
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) acc[idx++] += J[j] * wj[k];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[21 + k] += wj[k] * r;
}

// One edge at the pose T (4x4 row-major, shared memory): the residual
// (optim/residuals.py::stereo_residual), its chi2 and depth test; in a
// reclassifying pass the inlier flag first; in a build pass its terms of
// H, g and the error (pose_opt.py::_build_normal_eqs).  The final pass
// stores chi2 and the flag.
template <Pass kPass>
__device__ __forceinline__ void visit(const Edge& d, bool& inlier, const float* T,
                                      const Edges& in, bool huber, float (&acc)[32], int e) {
  const Cam& c = in.cam;
  const float x = T[0] * d.px + T[1] * d.py + T[2] * d.pz + T[3];
  const float y = T[4] * d.px + T[5] * d.py + T[6] * d.pz + T[7];
  const float z = T[8] * d.px + T[9] * d.py + T[10] * d.pz + T[11];
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;          // _safe_z
  const float u = c.fx * x / zs + c.cx;
  const float v = c.fy * y / zs + c.cy;
  const float ur = u - c.bf / zs;
  const float r0 = d.u - u, r1 = d.v - v, r2 = d.ur - ur;
  const float s2 = r0 * r0 + r1 * r1;
  const float chi2 = (d.stereo ? s2 + r2 * r2 : s2) * d.is2;
  const bool pos = z > 1e-3f;
  const float th = d.stereo ? kChi2Stereo : kChi2Mono;
  if (kPass != kBuild) inlier = d.valid && chi2 <= th && pos;
  if (kPass == kFinal) {
    in.chi2_out[e] = chi2;
    in.inlier_out[e] = inlier;
    return;
  }
  const bool act = inlier && pos;
  float wh = 1.0f;
  if (huber) {
    const float ec = chi2 < 1e-12f ? 1e-12f : chi2;
    wh = chi2 <= th ? 1.0f : sqrtf(th / ec);
  }
  const float we = act ? wh * d.is2 : 0.0f;
  const float w2 = we * (d.stereo ? 1.0f : 0.0f);

  // J = -d(u, v, uR)/d pc [I | -hat(pc)] (stereo_jacobian_pc, pc_jacobian_twist)
  const float iz = 1.0f / zs;
  const float iz2 = iz * iz;
  const float a0 = c.fx * iz, a2 = -c.fx * x * iz2;       // row u:  (a0, 0, a2)
  const float b1 = c.fy * iz, b2 = -c.fy * y * iz2;       // row v:  (0, b1, b2)
  const float c2 = -c.fx * x * iz2 + c.bf * iz2;           // row uR: (a0, 0, c2)
  const float Ju[6] = {-a0, 0.0f, -a2, -a2 * y, a2 * x - a0 * z, a0 * y};
  const float Jv[6] = {0.0f, -b1, -b2, b1 * z - b2 * y, b2 * x, -b1 * x};
  const float Jr[6] = {-a0, 0.0f, -c2, -c2 * y, c2 * x - a0 * z, a0 * y};
  add_row(acc, Ju, we, r0);
  add_row(acc, Jv, we, r1);
  add_row(acc, Jr, w2, r2);
  acc[27] += act ? wh * chi2 : 0.0f;
}

// Recursive halving over the warp: after the step of width h, a lane with
// bit h keeps the upper half of its values, and adds its partner's.  At the
// end slot 0 of lane L holds the warp's sum of value L.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Solve A x = b in place (x in b) by LU with partial pivoting: the first
// row of largest magnitude in the column is the pivot, as getrf takes it.
__device__ __forceinline__ void lu_solve6(float (&A)[6][6], float (&b)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float a = fabsf(A[i][k]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (p == i) {            // columns left of k hold no longer needed values
#pragma unroll
        for (int j = k; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float s = b[k];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) s -= A[k][j] * b[j];
    b[k] = s / A[k][k];
  }
}

// Tn = Exp(xi) T (geometry/se3.py::exp with its small-angle branches)
__device__ __forceinline__ void exp_times(const float (&xi)[6], const float (&T)[16],
                                          float (&Tn)[16]) {
  const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(fmaxf(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  float s, co;
  sincosf(theta, &s, &co);
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - co) / theta2;
  const float cc = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - s) / (theta2 * theta);
  const float P[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float PP[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) PP[i][j] = P[i][0] * P[0][j] + P[i][1] * P[1][j] + P[i][2] * P[2][j];
  }
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[4 * i + j] = eye + a * P[i][j] + b * PP[i][j];
      t += (eye + b * P[i][j] + cc * PP[i][j]) * xi[j];     // J_l(phi) rho
    }
    E[4 * i + 3] = t;
  }
  E[12] = E[13] = E[14] = 0.0f;
  E[15] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tn[4 * i + j] = E[4 * i] * T[j] + E[4 * i + 1] * T[4 + j] + E[4 * i + 2] * T[8 + j] +
                      E[4 * i + 3] * T[12 + j];
    }
  }
}

// The solver's state, in shared memory; only lane 0 of warp 0 touches it.
struct Solver {
  float H[21], g[6], err, lam;
  float T[16], Ttry[16];

  // Ttry = Exp(dx) T, dx = -(H + lam diag(H) + 1e-9 I)^-1 g
  __device__ __forceinline__ void step() {
    float A[6][6], x[6], Tr[16], Tn[16];
    int idx = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int k = j; k < 6; ++k) {
        A[j][k] = A[k][j] = H[idx];
        ++idx;
      }
    }
    const float l = lam;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      A[j][j] = A[j][j] + l * A[j][j] + 1e-9f;
      x[j] = g[j];
    }
    lu_solve6(A, x);
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = -x[j];
#pragma unroll
    for (int i = 0; i < 16; ++i) Tr[i] = T[i];
    exp_times(x, Tr, Tn);
#pragma unroll
    for (int i = 0; i < 16; ++i) Ttry[i] = Tn[i];
  }

  // a build's sums at the round's start pose
  __device__ __forceinline__ void start(const float* sums) {
#pragma unroll
    for (int i = 0; i < 21; ++i) H[i] = sums[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) g[i] = sums[21 + i];
    err = sums[27];
    lam = 1e-4f;
  }

  // a build's sums at Ttry: accept or reject the step
  __device__ __forceinline__ void judge(const float* sums) {
    const bool accept = sums[27] < err;
    if (accept) {
#pragma unroll
      for (int i = 0; i < 21; ++i) H[i] = sums[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) g[i] = sums[21 + i];
      err = sums[27];
#pragma unroll
      for (int i = 0; i < 16; ++i) T[i] = Ttry[i];
    }
    lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-10f), 1e6f);
  }
};

struct Shared {
  float pose[16];                 // the pose every thread builds at
  float part[kWarps][kSums];      // each warp's sums
  float sums[kSums];              // the block's
  int count[kWarps];
  Solver sv;
};

// One pass over every edge at sh.pose.  A build pass leaves the block's
// sums in sh.sums for lane 0 of warp 0 (the last barrier is the caller's).
template <Pass kPass>
__device__ __forceinline__ void pass(const Edges& in, Edge (&edges)[kCached],
                                     bool (&inl)[kCached], Shared& sh, bool huber) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int e = tid + k * kThreads;
    if (e < in.n) visit<kPass>(edges[k], inl[k], sh.pose, in, huber, acc, e);
  }
  for (int e = tid + kCached * kThreads; e < in.n; e += kThreads) {
    const Edge d = in.load(e);
    bool f = in.inlier_out[e] != 0;
    visit<kPass>(d, f, sh.pose, in, huber, acc, e);
    in.inlier_out[e] = f;
  }
  if (kPass == kFinal) return;
  halve<16>(acc, lane);
  halve<8>(acc, lane);
  halve<4>(acc, lane);
  halve<2>(acc, lane);
  halve<1>(acc, lane);
  if (lane < kSums) sh.part[warp][lane] = acc[0];
  __syncthreads();
  if (warp == 0) {
    if (lane < kSums) {
      float s = sh.part[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += sh.part[w][lane];
      sh.sums[lane] = s;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pose_lm_kernel(const float* __restrict__ T0, Edges in, float* __restrict__ T_out,
               int32_t* __restrict__ n_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  Edge edges[kCached];
  bool inl[kCached];
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int e = tid + k * kThreads;
    if (e < in.n) {
      edges[k] = in.load(e);
      inl[k] = edges[k].valid;
    } else {
      inl[k] = false;
    }
  }
  for (int e = tid + kCached * kThreads; e < in.n; e += kThreads)
    in.inlier_out[e] = in.valid[e];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.pose[i] = sh.sv.T[i] = T0[i];
  }
  __syncthreads();

  for (int rnd = 0; rnd < kRounds; ++rnd) {
    const bool huber = rnd < 2;
    // the round's first build; from round 1 on, after the reclassification
    // at the same pose
    if (rnd == 0) pass<kBuild>(in, edges, inl, sh, huber);
    else pass<kReclassifyBuild>(in, edges, inl, sh, huber);
    if (tid == 0) {
      sh.sv.start(sh.sums);
      sh.sv.step();
#pragma unroll
      for (int i = 0; i < 16; ++i) sh.pose[i] = sh.sv.Ttry[i];
    }
    __syncthreads();
    for (int it = 0; it < kIters; ++it) {
      pass<kBuild>(in, edges, inl, sh, huber);
      if (tid == 0) {
        sh.sv.judge(sh.sums);
        if (it + 1 < kIters) sh.sv.step();
        const float* next = it + 1 < kIters ? sh.sv.Ttry : sh.sv.T;
#pragma unroll
        for (int i = 0; i < 16; ++i) sh.pose[i] = next[i];
      }
      __syncthreads();
    }
  }
  // the last round's reclassification, at the final pose
  pass<kFinal>(in, edges, inl, sh, false);
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kCached; ++k) mine += (tid + k * kThreads < in.n) && inl[k];
  for (int e = tid + kCached * kThreads; e < in.n; e += kThreads) mine += in.inlier_out[e];
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) sh.count[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sh.count[w];
    *n_out = total;
#pragma unroll
    for (int i = 0; i < 16; ++i) T_out[i] = sh.pose[i];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues one block on `stream`,
// does not synchronise, allocates nothing; returns the launch's CUDA error,
// 0 if none.  T0 and T_out (4, 4) float32; pw, obs (n, 3) float32; is2
// (n,) float32; valid, stereo, inlier_out (n,) bool; n_out () int32;
// chi2_out (n,) float32; all contiguous.
extern "C" int pose_lm_launch(const void* T0, const void* pw, const void* obs,
                              const void* is2, const void* valid, const void* stereo,
                              void* T_out, void* inlier_out, void* n_out, void* chi2_out,
                              int n, float fx, float fy, float cx, float cy, float bf,
                              void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Edges in{static_cast<const float*>(pw), static_cast<const float*>(obs),
                 static_cast<const float*>(is2), static_cast<const uint8_t*>(valid),
                 static_cast<const uint8_t*>(stereo), n, Cam{fx, fy, cx, cy, bf},
                 static_cast<float*>(chi2_out), static_cast<uint8_t*>(inlier_out)};
  pose_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T0), in, static_cast<float*>(T_out),
      static_cast<int32_t*>(n_out));
  return static_cast<int>(cudaGetLastError());
}

// Fused window matcher for Hopper (sm_90a): Hamming distance + in-kernel
// geometric mask + running top-2, with the (N1, N2) distance matrix never
// stored.
//
// Replaces refactored_orb_slam2_tpu/ops/pallas_hamming.py::window_match_pallas
// (kernel body _match_kernel).  Same contract, on packed descriptors:
//   d(q, t) = sum over 8 words of popc(q ^ t)             (exact)
//   candidate iff valid_q && valid_t && |du| <= r && |dv| <= r
//                 && lo <= oct_t - oct_q <= hi
//   per row: d1 = best, i1 = its column (lowest column wins a tie: strict <),
//            d2 = second best (= d1 when two columns tie at the best);
//   a row with no candidate gets d1 = d2 = BIG = 2^20, i1 = 0.
//
// What bounds it: integer ALU.  Each candidate costs 8 XOR + 8 POPC + adds,
// each column a handful of float compares; the inputs are ~40 B per row and
// per column, so device-memory traffic is negligible at the tracking
// shapes (N1 = 4096 local points, N2 = 1000 features).  Design: one thread
// per query row keeps its descriptor in registers; a block stages the
// target bank through shared memory in tiles of TILE columns (32 B
// descriptor + 8 B uv + octave + valid each), so every column is read from
// device memory once per block and broadcast to all threads of a warp.
// The window test runs before the popcounts, so columns outside a row's
// window cost only the compares.  The ragged edges of N1 and N2 are masked
// here, so callers pad nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kRows = 64;     // threads per block, one query row each
constexpr int kTile = 256;    // target columns staged per pass

__global__ void __launch_bounds__(kRows)
window_match_kernel(const int32_t* __restrict__ desc_q,   // (n1, 8)
                    const int32_t* __restrict__ desc_t,   // (n2, 8)
                    const float* __restrict__ uv_q,       // (n1, 2)
                    const float* __restrict__ uv_t,       // (n2, 2)
                    const float* __restrict__ radius,     // (n1,)
                    const int32_t* __restrict__ oct_q,    // (n1,)
                    const int32_t* __restrict__ oct_t,    // (n2,)
                    const uint8_t* __restrict__ valid_q,  // (n1,) 0/1
                    const uint8_t* __restrict__ valid_t,  // (n2,) 0/1
                    int n1, int n2, int lo, int hi,
                    int32_t* __restrict__ d1_out,
                    int32_t* __restrict__ i1_out,
                    int32_t* __restrict__ d2_out) {
  __shared__ uint4 s_desc[kTile][2];
  __shared__ float2 s_uv[kTile];
  __shared__ int s_oct[kTile];
  __shared__ int s_valid[kTile];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < n1;

  uint32_t q[8];
  float qu = 0.f, qv = 0.f, r = -1.f;
  int oq = 0;
  bool vq = false;
  if (active) {
    const uint4* qp = reinterpret_cast<const uint4*>(desc_q + 8 * row);
    const uint4 a = qp[0], b = qp[1];
    q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
    q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
    qu = uv_q[2 * row];
    qv = uv_q[2 * row + 1];
    r = radius[row];
    oq = oct_q[row];
    vq = valid_q[row] != 0;
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) q[w] = 0u;
  }

  int d1 = kBig, i1 = 0, d2 = kBig;
  for (int base = 0; base < n2; base += kTile) {
    const int n = min(kTile, n2 - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < n; k += kRows) {
      const int c = base + k;
      const uint4* tp = reinterpret_cast<const uint4*>(desc_t + 8 * c);
      s_desc[k][0] = tp[0];
      s_desc[k][1] = tp[1];
      s_uv[k] = make_float2(uv_t[2 * c], uv_t[2 * c + 1]);
      s_oct[k] = oct_t[c];
      s_valid[k] = valid_t[c];
    }
    __syncthreads();
    if (!vq) continue;
    for (int k = 0; k < n; ++k) {
      const float2 tuv = s_uv[k];
      const int doct = s_oct[k] - oq;
      if (!s_valid[k] || !(fabsf(qu - tuv.x) <= r) || !(fabsf(qv - tuv.y) <= r) ||
          doct < lo || doct > hi) {
        continue;
      }
      const uint4 a = s_desc[k][0], b = s_desc[k][1];
      const int d = __popc(q[0] ^ a.x) + __popc(q[1] ^ a.y) + __popc(q[2] ^ a.z) +
                    __popc(q[3] ^ a.w) + __popc(q[4] ^ b.x) + __popc(q[5] ^ b.y) +
                    __popc(q[6] ^ b.z) + __popc(q[7] ^ b.w);
      if (d < d1) {
        d2 = d1;
        d1 = d;
        i1 = base + k;
      } else if (d < d2) {
        d2 = d;
      }
    }
  }
  if (active) {
    d1_out[row] = d1;
    i1_out[row] = i1;
    d2_out[row] = d2;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch.
extern "C" int window_match_launch(const void* desc_q, const void* desc_t,
                                   const void* uv_q, const void* uv_t,
                                   const void* radius, const void* oct_q,
                                   const void* oct_t, const void* valid_q,
                                   const void* valid_t, int n1, int n2, int lo,
                                   int hi, void* d1, void* i1, void* d2,
                                   void* stream) {
  if (n1 <= 0) return 0;
  const dim3 grid((n1 + kRows - 1) / kRows);
  window_match_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(desc_q), static_cast<const int32_t*>(desc_t),
      static_cast<const float*>(uv_q), static_cast<const float*>(uv_t),
      static_cast<const float*>(radius), static_cast<const int32_t*>(oct_q),
      static_cast<const int32_t*>(oct_t), static_cast<const uint8_t*>(valid_q),
      static_cast<const uint8_t*>(valid_t), n1, n2, lo, hi,
      static_cast<int32_t*>(d1), static_cast<int32_t*>(i1),
      static_cast<int32_t*>(d2));
  return static_cast<int>(cudaGetLastError());
}

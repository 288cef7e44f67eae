// Masked best-2 Hamming matcher for Hopper (sm_90a): Hamming distance +
// a precomputed (N1, N2) bool mask + running top-2, with the distance
// matrix never stored.
//
// Replaces refactored_orb_slam2_tpu/ops/pallas_hamming.py::hamming_best2_pallas
// (kernel body _kernel).  Same contract as ops/matching.py::masked_best2 on
// packed descriptors:
//   d(a, b) = sum over 8 words of popc(a ^ b)             (exact)
//   candidate iff mask[a, b]
//   per row: d1 = best, i1 = its column (lowest column wins a tie),
//            d2 = second best (= d1 when two columns tie at the best);
//   a row with no candidate gets d1 = d2 = BIG = 2^20, i1 = 0.
//
// What bounds it: the mask.  It is N1 x N2 bytes (2 MB at the fuse shape
// 2048 x 1000), read once, against 32 B of descriptor per row and column;
// each candidate then costs 8 XOR + 8 POPC.  Design: one warp per query
// row, so the 32 lanes read 32 neighbouring mask bytes of that row at a
// time (one-thread-per-row would read them N2 bytes apart).  A block of
// kWarps rows stages the target bank through shared memory in tiles of
// kTile columns, read contiguously and shared by its warps.  Each lane
// keeps its own (d1, i1, d2) over the columns lane, lane + 32, ... (in
// rising order, so strict < keeps the lowest column), and the warp merges
// the 32 partial results by shuffles with the same tie rule.  The mask is
// tested before the popcounts.  The ragged edges of N1 and N2 are masked
// here, so callers pad nothing.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kWarps = 8;               // query rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 256;              // target columns staged per pass

// (d1, i1, d2) <- the best-2 of the union of two column sets, each given
// by its own best-2.  A tie at the best goes to the lower column, and then
// the second best equals the best.
__device__ __forceinline__ void merge(int& d1, int& i1, int& d2, int e1, int j1,
                                      int e2) {
  const bool take = e1 < d1 || (e1 == d1 && j1 < i1);
  d2 = min(max(d1, e1), min(d2, e2));
  d1 = min(d1, e1);
  if (take) i1 = j1;
}

__global__ void __launch_bounds__(kThreads)
masked_best2_kernel(const int32_t* __restrict__ desc_a,  // (n1, 8)
                    const int32_t* __restrict__ desc_b,  // (n2, 8)
                    const uint8_t* __restrict__ mask,    // (n1, n2) 0/1
                    int n1, int n2,
                    int32_t* __restrict__ d1_out,
                    int32_t* __restrict__ i1_out,
                    int32_t* __restrict__ d2_out) {
  __shared__ uint4 s_desc[kTile][2];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < n1;

  uint32_t q[8];
  if (active) {
    const uint4* ap = reinterpret_cast<const uint4*>(desc_a + 8 * (size_t)row);
    const uint4 a = ap[0], b = ap[1];
    q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
    q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) q[w] = 0u;
  }
  const uint8_t* mrow = mask + (size_t)(active ? row : 0) * (size_t)n2;

  int d1 = kBig, i1 = INT_MAX, d2 = kBig;
  for (int base = 0; base < n2; base += kTile) {
    const int n = min(kTile, n2 - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const uint4* bp = reinterpret_cast<const uint4*>(desc_b + 8 * (size_t)(base + k));
      s_desc[k][0] = bp[0];
      s_desc[k][1] = bp[1];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = lane; k < n; k += 32) {
      if (!mrow[base + k]) continue;
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
  // butterfly merge: every lane ends with the row's best-2
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int e1 = __shfl_xor_sync(0xffffffffu, d1, off);
    const int j1 = __shfl_xor_sync(0xffffffffu, i1, off);
    const int e2 = __shfl_xor_sync(0xffffffffu, d2, off);
    merge(d1, i1, d2, e1, j1, e2);
  }
  if (active && lane == 0) {
    d1_out[row] = d1;
    i1_out[row] = d1 < kBig ? i1 : 0;
    d2_out[row] = d2;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch.
extern "C" int masked_best2_launch(const void* desc_a, const void* desc_b,
                                   const void* mask, int n1, int n2, void* d1,
                                   void* i1, void* d2, void* stream) {
  if (n1 <= 0) return 0;
  const dim3 grid((n1 + kWarps - 1) / kWarps);
  masked_best2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(desc_a), static_cast<const int32_t*>(desc_b),
      static_cast<const uint8_t*>(mask), n1, n2, static_cast<int32_t*>(d1),
      static_cast<int32_t*>(i1), static_cast<int32_t*>(d2));
  return static_cast<int>(cudaGetLastError());
}

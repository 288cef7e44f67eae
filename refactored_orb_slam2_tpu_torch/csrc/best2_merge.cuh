// What both Hamming matchers share: the best-2 state of a row as two keys,
// the 256-bit Hamming distance, the warp's candidate queue, and the shape of
// a launch that fills the card.
//
// The best-2 of a row is (d1, i1, d2): best distance, its column (lowest
// column wins a tie), second-best distance (= d1 when two columns tie at
// the best).  A row with no candidate has d1 = d2 = kBig and i1 = 0.
//
// Inside the kernels a candidate is one 32-bit key, distance << 20 | column
// (distance <= 256, column < 2^20), so the smaller key is the better
// candidate and a tie at the distance goes to the lower column by itself.
// A row's state is its two smallest keys (k1, k2): d1 and i1 are the two
// fields of k1, d2 the distance of k2.  Keys of different columns differ,
// so the order in which candidates arrive does not matter, and 32 lanes'
// states merge with two warp-wide minima.
#pragma once

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace best2 {

constexpr int kBig = 1 << 20;
constexpr int kColBits = 20;     // columns below 2^20: the launch refuses more
constexpr int kNone = INT_MAX;   // no candidate: above every key
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxWarps = 32;    // warps per block at most (1024 threads)
constexpr int kMinWarps = 4;
constexpr int kGroup = 1024;     // bank columns a warp gathers candidates from
                                 // at a time; its queue holds as many entries

__device__ __forceinline__ int make_key(int d, int col) { return (d << kColBits) | col; }

// One more candidate, in any order.
__device__ __forceinline__ void push(int& k1, int& k2, int key) {
  k2 = min(k2, max(k1, key));
  k1 = min(k1, key);
}

// The two smallest keys of the union of two sets, each given by its own.
__device__ __forceinline__ void merge(int& k1, int& k2, int e1, int e2) {
  k2 = min(max(k1, e1), min(k2, e2));
  k1 = min(k1, e1);
}

// Every lane ends with the two smallest keys of the 32 lanes' sets: the
// smallest k1, then the smallest of what is left (the winning lane's k2,
// the other lanes' k1).
__device__ __forceinline__ void warp_merge(int& k1, int& k2) {
  const int m1 = __reduce_min_sync(kFullWarp, k1);
  k2 = __reduce_min_sync(kFullWarp, k1 == m1 ? k2 : k1);
  k1 = m1;
}

// A query row's 8 descriptor words (every lane of the warp reads the same
// 32 bytes, one broadcast).
__device__ __forceinline__ void load_query(const int32_t* __restrict__ desc,
                                           int row, uint32_t (&q)[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(desc + 8 * (size_t)row);
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
}

__device__ __forceinline__ int hamming256(const uint32_t (&q)[8], const uint4 a,
                                          const uint4 b) {
  return __popc(q[0] ^ a.x) + __popc(q[1] ^ a.y) + __popc(q[2] ^ a.z) +
         __popc(q[3] ^ a.w) + __popc(q[4] ^ b.x) + __popc(q[5] ^ b.y) +
         __popc(q[6] ^ b.z) + __popc(q[7] ^ b.w);
}

// The warp's candidate queue.  Every lane holds a set of candidates as the
// bits of `mine`; base + offset_of(bit) is the candidate's column, with the
// offset below kGroup.  A warp scan gives each lane its place in the queue
// (shared memory, kGroup entries a warp), the lanes write their offsets
// there, and then lane t takes the entries t, t + 32, ...: all 32 lanes run
// their popcounts at once, whether the candidates were spread over the lanes
// or all in one.  The descriptors of the candidates, and only those, are
// read from the bank in device memory: the card's caches keep a bank of this
// size (32 KB at 1000 columns) near every SM that asks again, while a copy
// of the whole bank into every block's shared memory took most of the
// kernel's time when it was tried.
template <typename OffsetOf>
__device__ __forceinline__ void queue_and_match(unsigned mine, OffsetOf offset_of,
                                                int base, uint16_t* queue, int lane,
                                                const uint32_t (&q)[8],
                                                const int32_t* __restrict__ bank,
                                                int& k1, int& k2) {
  const int cnt = __popc(mine);
  if (__ballot_sync(kFullWarp, cnt != 0) == 0u) return;   // the whole warp leaves
  int upto = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int below = __shfl_up_sync(kFullWarp, upto, off);
    if (lane >= off) upto += below;
  }
  const int total = __shfl_sync(kFullWarp, upto, 31);
  int slot = upto - cnt;
  while (mine) {
    queue[slot++] = static_cast<uint16_t>(offset_of(__ffs(mine) - 1));
    mine &= mine - 1u;
  }
  __syncwarp();                              // the queue's writes are visible
  for (int k = lane; k < total; k += 32) {
    const int col = base + queue[k];
    const uint4* p = reinterpret_cast<const uint4*>(bank + 8 * (size_t)col);
    push(k1, k2, make_key(hamming256(q, __ldg(p), __ldg(p + 1)), col));
  }
  __syncwarp();                              // all reads done before the next writes
}

// Write a row's result.  Where the columns are worked on in several parts,
// the first part writes and a later part folds in what the same lane wrote
// before.
__device__ __forceinline__ void store_row(int32_t* __restrict__ out, int n1, int row,
                                          bool first_part, int k1, int k2) {
  int32_t* o1 = out + row;
  int32_t* oi = out + (size_t)n1 + row;
  int32_t* o2 = out + 2 * (size_t)n1 + row;
  if (!first_part) {
    // the earlier second best has lost its column: any column does, only
    // its distance is ever read from the merged k2
    merge(k1, k2, *o1 < kBig ? make_key(*o1, *oi) : kNone,
          *o2 < kBig ? make_key(*o2, 0) : kNone);
  }
  *o1 = k1 == kNone ? kBig : k1 >> kColBits;
  *oi = k1 == kNone ? 0 : k1 & ((1 << kColBits) - 1);
  *o2 = k2 == kNone ? kBig : k2 >> kColBits;
}

// ---- host side ------------------------------------------------------------

// A launch that fills the card with one warp per row: as many warps a block
// as spread the rows over all SMs (between kMinWarps and kMaxWarps), and no
// more blocks than the card holds at once; the blocks walk over the rows.
// `kernel` gets its dynamic shared memory raised to what that takes.  What
// the runtime was asked is kept for the next launch of the same shape from
// the same thread, so a repeated launch pays for the launch alone.
template <typename Kernel, typename SmemOfWarps>
inline cudaError_t launch_shape(Kernel kernel, int n1, SmemOfWarps smem_of_warps,
                                int* warps, int* grid, size_t* smem) {
  struct Asked {
    int dev = -1, sms = 0, warps = 0, per_sm = 0;
    size_t smem = 0;
  };
  thread_local Asked last;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last.dev) {
    last = Asked();
    err = cudaDeviceGetAttribute(&last.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    last.dev = dev;
  }
  *warps = std::min(kMaxWarps, std::max(kMinWarps, (n1 + last.sms - 1) / last.sms));
  *smem = smem_of_warps(*warps);
  if (*warps != last.warps || *smem != last.smem) {
    last.warps = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last.per_sm, kernel,
                                                        32 * *warps, *smem);
    if (err != cudaSuccess) return err;
    if (last.per_sm < 1) return cudaErrorLaunchOutOfResources;
    last.warps = *warps;
    last.smem = *smem;
  }
  *grid = std::min((n1 + *warps - 1) / *warps, last.sms * last.per_sm);
  return cudaSuccess;
}

}  // namespace best2

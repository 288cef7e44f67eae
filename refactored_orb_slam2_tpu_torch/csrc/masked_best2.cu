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
// What bounds it: bytes.  The mask is N1 x N2 bytes (2 MB at the fuse shape
// 2048 x 1000), read once, against 32 B of descriptor per row and column and
// 16 operations per set mask byte.  At 2 MB the card's memory rate makes
// that well under a microsecond, so what a launch really pays is latency:
// the launch itself, a round trip to memory for the row's mask bytes, one
// for the candidates' descriptors, and the row's chain of dependent
// instructions.  The design keeps each of them short:
//
// - 16-byte mask loads: a lane loads 16 mask bytes at once, so a warp covers
//   512 columns per load instruction, and a lane asks for kBatch loads (1024
//   columns) before it looks at any; the next 1024 columns, or the next
//   row's first, are requested before these are worked on.  A row starts
//   wherever row * N2 falls, so its first load is aligned down to 16 bytes
//   and the bytes before the row's first and after its last column are
//   masked off; only 16-byte words that hold a byte of the row are read;
// - one warp per query row.  The non-zero bytes of a lane's words become a
//   bit set, and the lanes' bit sets go through the warp's candidate queue
//   (best2_merge.cuh): the popcounts run on all 32 lanes at once, so a dense
//   mask, a sparse one and a band all keep the lanes equally busy, and only
//   the candidates' descriptors are read from the bank;
// - no block-wide barrier and no staging of the bank: warps never wait for
//   each other;
// - a lane's best-2 is two keys (distance << 20 | column), so the tie rule
//   is a plain minimum and the 32 lanes merge with two warp-wide minima;
// - as many warps a block as spread the rows over all SMs, and a grid no
//   larger than the card holds at once; the blocks walk over the rows.
// The ragged edges of N1 and N2 are masked here, so callers pad nothing.
#include "best2_merge.cuh"

namespace {

using namespace best2;

constexpr int kBatch = 2;        // 16-byte mask words a lane holds at once
static_assert(32 * 16 * kBatch == kGroup, "a batch of words is one queue group");

// bit b set iff byte b of the 16-byte word is not zero
__device__ __forceinline__ unsigned nonzero4(unsigned v) {
  // the top bit of every byte that is not zero, then those 4 bits together
  const unsigned top = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return ((top >> 7) * 0x01020408u) >> 24;
}
__device__ __forceinline__ unsigned nonzero_bytes(const uint4 w) {
  return nonzero4(w.x) | (nonzero4(w.y) << 4) | (nonzero4(w.z) << 8) |
         (nonzero4(w.w) << 12);
}

// bit b set iff column p0 + b lies in [0, n)
__device__ __forceinline__ unsigned valid_bytes(int p0, int n) {
  const int lo = min(max(-p0, 0), 16), hi = min(max(n - p0, 0), 16);
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

// A row's mask bytes start at mask + row * n2; its 16-byte words start
// `head` bytes before that, so byte b of word idx is column 16 idx + b - head.
struct RowWords {
  const uint4* words;
  int head, n_words;
};
__device__ __forceinline__ RowWords row_words(const uint8_t* __restrict__ mask, int row,
                                              int n2) {
  const uint8_t* first = mask + (size_t)row * (size_t)n2;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15u);
  return {reinterpret_cast<const uint4*>(first - head), head, (head + n2 + 15) >> 4};
}

// the lane's kBatch words from word g on; words past the row's last are
// zero.  The mask is read once, so it passes the caches by.
__device__ __forceinline__ void load_words(const RowWords& r, int g, int lane,
                                           uint4 (&w)[kBatch]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int idx = g + 32 * j + lane;
    w[j] = idx < r.n_words ? __ldcs(r.words + idx) : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
masked_best2_kernel(const int32_t* __restrict__ desc_a,  // (n1, 8)
                    const int32_t* __restrict__ desc_b,  // (n2, 8)
                    const uint8_t* __restrict__ mask,    // (n1, n2), 0 = no
                    int n1, int n2,
                    int32_t* __restrict__ out) {         // (3, n1): d1, i1, d2
  extern __shared__ uint16_t s_queue[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  uint16_t* queue = s_queue + warp * kGroup;

  // w always holds the mask words that are worked on next
  int row = blockIdx.x * warps + warp;
  uint4 w[kBatch];
  if (row < n1) load_words(row_words(mask, row, n2), 0, lane, w);

  for (; row < n1; row += stride) {
    uint32_t q[8];
    load_query(desc_a, row, q);
    const RowWords r = row_words(mask, row, n2);
    int k1 = kNone, k2 = kNone;
    for (int g = 0; g < r.n_words; g += 32 * kBatch) {
      // bit 16 j + b of `mine`: byte b of the lane's word j, which is column
      // base + 512 j + 16 lane + b
      const int base = 16 * g - r.head;
      unsigned mine = 0u;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        mine |= (nonzero_bytes(w[j]) & valid_bytes(base + 512 * j + 16 * lane, n2))
                << (16 * j);
      }
      // what is worked on next travels while the queue is worked on
      if (g + 32 * kBatch < r.n_words) {
        load_words(r, g + 32 * kBatch, lane, w);
      } else if (row + stride < n1) {
        load_words(row_words(mask, row + stride, n2), 0, lane, w);
      }
      queue_and_match(
          mine, [&](int bit) { return 512 * (bit >> 4) + 16 * lane + (bit & 15); }, base,
          queue, lane, q, desc_b, k1, k2);
    }
    warp_merge(k1, k2);
    if (lane == 0) store_row(out, n1, row, true, k1, k2);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues on `stream`, does not
// synchronise, allocates nothing; returns the first CUDA error of the
// set-up or of the launch, 0 if none.  `out` is (3, n1) int32.
extern "C" int masked_best2_launch(const void* desc_a, const void* desc_b,
                                   const void* mask, int n1, int n2, void* out,
                                   void* stream) {
  if (n1 <= 0) return 0;
  if (n2 > (1 << best2::kColBits)) return static_cast<int>(cudaErrorInvalidValue);
  int warps = 0, grid = 0;
  size_t smem = 0;
  cudaError_t err = best2::launch_shape(
      masked_best2_kernel, n1,
      [](int w) { return (size_t)w * best2::kGroup * sizeof(uint16_t); }, &warps, &grid,
      &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_best2_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(desc_a), static_cast<const int32_t*>(desc_b),
      static_cast<const uint8_t*>(mask), n1, n2, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

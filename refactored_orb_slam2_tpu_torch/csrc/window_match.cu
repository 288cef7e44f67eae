// Fused window matcher for Hopper (sm_90a): Hamming distance + in-kernel
// geometric mask + running top-2, with the (N1, N2) distance matrix never
// stored.
//
// Replaces refactored_orb_slam2_tpu/ops/pallas_hamming.py::window_match_pallas
// (kernel body _match_kernel).  Same contract, on packed descriptors:
//   d(q, t) = sum over 8 words of popc(q ^ t)             (exact)
//   candidate iff valid_q && valid_t && |du| <= r && |dv| <= r
//                 && lo <= oct_t - oct_q <= hi
//   per row: d1 = best, i1 = its column (lowest column wins a tie),
//            d2 = second best (= d1 when two columns tie at the best);
//   a row with no candidate gets d1 = d2 = BIG = 2^20, i1 = 0.
//
// What bounds it: operations, not bytes.  The inputs are 49 B per row and
// 45 B per column (0.3 MB at the tracking shape, 4096 local points x 1000
// features), but every (row, column) pair costs a window test of about 8
// plain 32-bit operations, and every candidate 8 XOR + 8 POPC.  At these
// sizes the fixed costs (the launch, one pass over the bank, one memory
// round trip for the row) and the length of a row's chain of dependent
// instructions weigh more than the arithmetic, so the design spreads the
// work over the whole card and keeps every chain short:
//
// - what every row needs of every column lives in shared memory: uv and
//   octave, 12 B a column (up to kMaxBank columns, larger banks in equal
//   parts inside the same kernel), loaded once per block while its warps
//   read their first query rows.  An invalid column gets u = NaN, which
//   fails every window test, so validity costs nothing.  The descriptors
//   stay in device memory: only a candidate's is read;
// - one warp per query row, lanes across columns: a step tests 32
//   neighbouring columns, so a row is N2 / 32 steps, not N2.  The steps do
//   not depend on each other: a lane only sets one bit per hit, with no
//   branch, so their loads and compares overlap;
// - after 32 steps (1024 columns) the lanes' bit sets go through the warp's
//   candidate queue (best2_merge.cuh): the popcounts run on all 32 lanes at
//   once, and not at all for a row whose window is empty;
// - a lane's best-2 is two keys (distance << 20 | column), so the tie rule
//   is a plain minimum and the 32 lanes merge with two warp-wide minima;
// - as many warps a block as spread the rows over all SMs, and a grid no
//   larger than the card holds at once; the blocks walk over the rows.
// The ragged edges of N1 and N2 are masked here, so callers pad nothing.
#include "best2_merge.cuh"

#include <cmath>

namespace {

using namespace best2;

constexpr int kMaxBank = 8192;   // columns whose uv and octave a block holds at a time

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Bank columns per pass: the whole bank when it fits, else equal parts.
inline void bank_split(int n2, int* n_banks, int* bank_cols) {
  *n_banks = n2 > kMaxBank ? (n2 + kMaxBank - 1) / kMaxBank : 1;
  *bank_cols = (n2 + *n_banks - 1) / *n_banks;
}

// dynamic shared memory for a bank of `cols` columns and `warps` warps
inline size_t smem_bytes(int cols, int warps) {
  return (size_t)round32(cols) * (sizeof(float2) + sizeof(int)) +
         (size_t)warps * kGroup * sizeof(uint16_t);
}

// what the kernel keeps of a query row besides its descriptor
struct Query {
  float u, v, r;
  int oct_lo;      // oct_q + lo: a target octave o passes iff o - oct_lo <= hi - lo
  bool valid;
};

__global__ void __launch_bounds__(32 * kMaxWarps)
window_match_kernel(const int32_t* __restrict__ desc_q,   // (n1, 8)
                    const int32_t* __restrict__ desc_t,   // (n2, 8)
                    const float* __restrict__ uv_q,       // (n1, 2)
                    const float* __restrict__ uv_t,       // (n2, 2)
                    const float* __restrict__ radius,     // (n1,)
                    const int32_t* __restrict__ oct_q,    // (n1,)
                    const int32_t* __restrict__ oct_t,    // (n2,)
                    const uint8_t* __restrict__ valid_q,  // (n1,) 0/1
                    const uint8_t* __restrict__ valid_t,  // (n2,) 0/1
                    int n1, int n2, int lo, int hi, int n_banks, int bank_cols,
                    int32_t* __restrict__ out) {          // (3, n1): d1, i1, d2
  extern __shared__ float2 s_uv[];
  const int cap = round32(bank_cols);
  int* s_oct = reinterpret_cast<int*>(s_uv + cap);
  uint16_t* s_queue = reinterpret_cast<uint16_t*>(s_oct + cap);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int row0 = blockIdx.x * warps + warp, stride = gridDim.x * warps;
  uint16_t* queue = s_queue + warp * kGroup;
  const unsigned span = static_cast<unsigned>(hi - lo);   // hi >= lo: see the launch

  auto load_row = [&](int row, uint32_t (&q)[8]) {
    Query x;
    x.valid = valid_q[row] != 0;
    load_query(desc_q, row, q);
    x.u = uv_q[2 * row];
    x.v = uv_q[2 * row + 1];
    x.r = radius[row];
    x.oct_lo = oct_q[row] + lo;
    return x;
  };

  for (int bank = 0; bank < n_banks; ++bank) {
    const int c0 = bank * bank_cols;
    const int n = min(bank_cols, n2 - c0), n32 = round32(n);
    if (bank > 0) __syncthreads();           // the previous bank is no longer read
    for (int k = threadIdx.x; k < n32; k += blockDim.x) {
      const int c = c0 + min(k, n - 1);      // the padding repeats the last column
      const float u = uv_t[2 * c], v = uv_t[2 * c + 1];
      const bool ok = k < n && valid_t[c] != 0;
      s_oct[k] = oct_t[c];
      s_uv[k] = make_float2(ok ? u : nanf(""), v);
    }

    // the first row's data travels with the bank's
    int row = row0;
    uint32_t q[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    Query x = {0.f, 0.f, -1.f, 0, false};
    if (row < n1) x = load_row(row, q);
    __syncthreads();

    for (; row < n1; row += stride) {
      if (row != row0) x = load_row(row, q);
      int k1 = kNone, k2 = kNone;
      if (x.valid) {
        for (int g = 0; g < n32; g += kGroup) {
          const int steps = min(kGroup, n32 - g) >> 5;
          unsigned mine = 0u;                // bit s: column g + 32 s + lane is a hit
#pragma unroll 8
          for (int s = 0; s < steps; ++s) {
            const int k = g + 32 * s + lane;
            const float2 t = s_uv[k];
            const bool hit = fabsf(x.u - t.x) <= x.r && fabsf(x.v - t.y) <= x.r &&
                             static_cast<unsigned>(s_oct[k] - x.oct_lo) <= span;
            mine |= static_cast<unsigned>(hit) << s;
          }
          queue_and_match(mine, [&](int s) { return 32 * s + lane; }, c0 + g, queue,
                          lane, q, desc_t, k1, k2);
        }
        warp_merge(k1, k2);
      }
      if (lane == 0) store_row(out, n1, row, bank == 0, k1, k2);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues on `stream`, does not
// synchronise, allocates nothing; returns the first CUDA error of the
// set-up or of the launch, 0 if none.  `out` is (3, n1) int32.
extern "C" int window_match_launch(const void* desc_q, const void* desc_t,
                                   const void* uv_q, const void* uv_t,
                                   const void* radius, const void* oct_q,
                                   const void* oct_t, const void* valid_q,
                                   const void* valid_t, int n1, int n2, int lo,
                                   int hi, void* out, void* stream) {
  if (n1 <= 0) return 0;
  if (n2 > (1 << best2::kColBits)) return static_cast<int>(cudaErrorInvalidValue);
  if (hi < lo) n2 = 0;                       // an empty band: no row has a candidate
  int n_banks = 1, bank_cols = 0, warps = 0, grid = 0;
  size_t smem = 0;
  bank_split(n2, &n_banks, &bank_cols);
  cudaError_t err = best2::launch_shape(
      window_match_kernel, n1, [&](int w) { return smem_bytes(bank_cols, w); },
      &warps, &grid, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_match_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(desc_q), static_cast<const int32_t*>(desc_t),
      static_cast<const float*>(uv_q), static_cast<const float*>(uv_t),
      static_cast<const float*>(radius), static_cast<const int32_t*>(oct_q),
      static_cast<const int32_t*>(oct_t), static_cast<const uint8_t*>(valid_q),
      static_cast<const uint8_t*>(valid_t), n1, n2, lo, hi, n_banks, bank_cols,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

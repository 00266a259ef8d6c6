// point_scan and point_reduce: the scan form of K2.  Inclusive prefix sums,
// and row sums, of rows of projective G1 points, each row on its own.
// point_scan_affine and point_reduce_affine: the same over rows of AFFINE
// points, a scan form of K5.
//
// Replace the use the port made of the TPU kernel fused_point_add
// (halo2_zkcert_tpu/ops/pallas_limbs.py:372) under its scans: a log-depth
// sweep of one K2 launch a level, n log n additions, every level through
// device memory in canonical form (9 conversions an addition).  Here a scan
// is two launches whatever n is, about 4 additions and 9 conversions a
// point:
//   1. k_point_reduce: the total of each block's span of the row;
//   2. k_point_scan over the row, each block starting from the sum of the
//      totals of the blocks before it, which it adds up itself (a row has at
//      most some thousand blocks).
// A row short enough for one block is launch 2 alone.  A row sum is launch 1
// and, where a row has several blocks, launch 1 again over their totals.
//
// The affine forms replace the use the port made of fused_point_add_mixed
// (RCB16 Alg. 8, pallas_limbs.py:393) under a scan: level 1 of the
// log-depth sweep of the ragged fixed-base MSM, whose later levels were K2.
// The variable-base MSM scanned its sorted points projectively though each
// enters with Z = 1.  Here the points arrive as canonical (x, y) pairs, 64 B
// where a projective point is 96, (0, 0) read as the identity, and each
// thread's run and each block's span is summed by mixed additions (bn254.cuh
// scan_run_local_affine, point_sum_strided_affine: 11 products and 2
// conversions a point where a full addition takes 12 and 3); the run totals
// and the block totals go on projectively, as above.
//
// k_point_scan: a block brings a tile of 128 threads x 8 points into shared
// memory with 16-byte asynchronous copies that neighbouring threads start
// for neighbouring addresses.  Each thread scans its run of 8 consecutive
// points in registers (bn254.cuh scan_run_local: one conversion in a point,
// the prefixes written back in Montgomery form), the run totals are scanned
// across the warp with shuffles of the 24 words and across the four warps
// through shared memory, each thread adds what precedes its run to its
// prefixes (scan_run_apply: one conversion out a point), and the tile leaves
// in whole 16-byte pieces.  A run is 8 * 96 B + 16 B apart from the next, so
// the threads of a quarter warp read different banks.  The tile is 100 352 B
// of dynamic shared memory, above the 48 KB a launch gets unasked, hence the
// cudaFuncSetAttribute in the entry.  `reverse` scans from the row's end:
// the tile is mirrored by index arithmetic on its way in and out, nothing is
// copied.  A block whose span is several tiles walks them in order and
// carries the running sum.  An affine point lands in the first 64 B of its
// 96-byte slot, where its prefix is written.
//
// Bound on the H100: integer operations (n - 1 additions a row of 12
// products each, or 11 for a mixed one, against 192 B or 160 B a point).
// Sums are taken in another order than a sequential scan takes them, so a
// result equals the plain version's as a group element, not as a projective
// triple.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#define H2T_MONT_MUL_CALL   // five sites of 12 to 18 inlined products each
#include "bn254.cuh"

using namespace bn254;

constexpr int PS_THREADS = 128;
constexpr int PS_PPT = 8;
constexpr int PS_TILE = PS_THREADS * PS_PPT;
constexpr int PS_RUN_WORDS = PS_PPT * 24 + 4;
constexpr int PS_SMEM_BYTES = PS_THREADS * PS_RUN_WORDS * 4;

__device__ __forceinline__ Fe shfl_fe(const Fe& v, int delta, bool up) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.w[i] = up ? __shfl_up_sync(0xffffffffu, v.w[i], delta)
                : __shfl_down_sync(0xffffffffu, v.w[i], delta);
  return r;
}

__device__ __forceinline__ Pt shfl_pt(const Pt& v, int delta, bool up) {
  Pt r;
  r.x = shfl_fe(v.x, delta, up);
  r.y = shfl_fe(v.y, delta, up);
  r.z = shfl_fe(v.z, delta, up);
  return r;
}

// Word offset in the tile of the tile's l-th point in scan order.
__device__ __forceinline__ int tile_word(int l) {
  return (l / PS_PPT) * PS_RUN_WORDS + (l % PS_PPT) * 24;
}

// The 16-byte piece f of the tile's `cnt` points of `words` words each as
// they lie in device memory, and where it lives in the tile.
__device__ __forceinline__ int tile_piece(int f, int cnt, bool reverse,
                                          int words) {
  int q = f / (words / 4), part = f - (words / 4) * q;
  return tile_word(reverse ? cnt - 1 - q : q) + 4 * part;
}

// The sum of every thread's `acc` (Montgomery form), returned to all of
// them: shuffles within a warp, then the warps' totals through `warp_tot`.
__device__ __forceinline__ Pt block_sum(Pt acc, uint4 (*warp_tot)[6]) {
#pragma unroll 1
  for (int d = 16; d >= 1; d >>= 1)
    acc = point_add_mont(acc, shfl_pt(acc, d, false));
  if ((threadIdx.x & 31) == 0)
    store_pt_v(reinterpret_cast<uint32_t*>(warp_tot[threadIdx.x >> 5]), acc);
  __syncthreads();
  acc = load_pt_v(reinterpret_cast<const uint32_t*>(warp_tot[0]));
#pragma unroll 1
  for (int w = 1; w < PS_THREADS / 32; ++w)
    acc = point_add_mont(
        acc, load_pt_v(reinterpret_cast<const uint32_t*>(warp_tot[w])));
  __syncthreads();
  return acc;
}

// in: B rows of n points, row b at in + b * row_words.  out: (B, n, 24).
// Block blockIdx.x = b * nblk + j scans points [j * span, (j + 1) * span) of
// row b in scan order, starting from totals[b, 0] + ... + totals[b, j - 1]
// (k_point_reduce's output for the same span) where totals is given.
template <bool AFFINE>
__global__ void __launch_bounds__(PS_THREADS)
k_point_scan(const uint32_t* __restrict__ in, long long row_words,
             uint32_t* __restrict__ out, const uint32_t* __restrict__ totals,
             long long n, long long span, long long nblk, int reverse) {
  extern __shared__ uint4 tile4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  __shared__ uint4 warp_tot4[PS_THREADS / 32][6];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x / nblk, j = blockIdx.x % nblk;
  const uint32_t* row_in = in + b * row_words;
  uint32_t* row_out = out + b * n * 24;
  const long long s0 = j * span, e0 = min(n, s0 + span);

  Pt run_carry = pt_identity_mont();
  if (totals != nullptr && j > 0)
    run_carry = block_sum(
        point_sum_strided(totals + (b * nblk + tid) * 24, 24LL * PS_THREADS,
                          (j - tid + PS_THREADS - 1) / PS_THREADS),
        warp_tot4);
  for (long long s = s0; s < e0; s += PS_TILE) {
    const int cnt = (int)min((long long)PS_TILE, e0 - s);
    const long long first = reverse ? n - (s + cnt) : s;   // in memory
    constexpr int W = AFFINE ? 16 : 24;   // words a point on the way in
    for (int f = tid; f < W / 4 * cnt; f += PS_THREADS)
      __pipeline_memcpy_async(tile + tile_piece(f, cnt, reverse, W),
                              row_in + first * W + 4 * (long long)f, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    uint32_t* mine = tile + tid * PS_RUN_WORDS;
    const int my_cnt = max(0, min(PS_PPT, cnt - tid * PS_PPT));
    Pt inc = AFFINE ? scan_run_local_affine(mine, my_cnt)
                    : scan_run_local(mine, my_cnt);
    // inclusive scan of the run totals across the warp
#pragma unroll 1
    for (int d = 1; d < 32; d <<= 1) {
      Pt sum = point_add_mont(shfl_pt(inc, d, true), inc);
      if (lane >= d) inc = sum;
    }
    Pt before = shfl_pt(inc, 1, true);
    if (lane == 0) before = pt_identity_mont();
    if (lane == 31)
      store_pt_v(reinterpret_cast<uint32_t*>(warp_tot4[warp]), inc);
    __syncthreads();
    Pt off = run_carry;
#pragma unroll 1
    for (int w = 0; w < warp; ++w)
      off = point_add_mont(
          off, load_pt_v(reinterpret_cast<const uint32_t*>(warp_tot4[w])));
    off = point_add_mont(off, before);
    scan_run_apply(mine, my_cnt, off);
    __syncthreads();

    for (int f = tid; f < 6 * cnt; f += PS_THREADS)
      *reinterpret_cast<uint4*>(row_out + first * 24 + 4 * (long long)f) =
          *reinterpret_cast<const uint4*>(
              tile + tile_piece(f, cnt, reverse, 24));
    if (s + PS_TILE < e0)   // the tile's last prefix carries into the next
      run_carry = pt_to_mont(load_pt_v(tile + tile_word(cnt - 1)));
    __syncthreads();
  }
}

// out[b, j] = the sum of points [j * span, (j + 1) * span) of row b in scan
// order, canonical projective.  Thread t adds the points t, t + 128, ... of
// the span, so a warp's loads are neighbours; the totals meet by shuffles
// and through shared memory.
template <bool AFFINE>
__global__ void __launch_bounds__(PS_THREADS)
k_point_reduce(const uint32_t* __restrict__ in, long long row_words,
               uint32_t* __restrict__ out, long long n, long long span,
               long long nblk, int reverse) {
  __shared__ uint4 warp_tot4[PS_THREADS / 32][6];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / nblk, j = blockIdx.x % nblk;
  const long long s0 = j * span, e0 = min(n, s0 + span);
  const long long first = (reverse ? n - e0 : s0) + tid;    // in memory
  const long long mine = (e0 - s0 - tid + PS_THREADS - 1) / PS_THREADS;
  constexpr int W = AFFINE ? 16 : 24;   // words a point on the way in
  const uint32_t* p = in + b * row_words + first * W;
  Pt acc = block_sum(
      AFFINE ? point_sum_strided_affine(p, (long long)W * PS_THREADS, mine)
             : point_sum_strided(p, (long long)W * PS_THREADS, mine),
      warp_tot4);
  if (tid == 0)
    store_pt_v(out + (long long)blockIdx.x * 24, pt_from_mont(acc));
}

template <bool AFFINE>
static int launch_scan(const void* in, long long row_words, void* out,
                       const void* totals, long long B, long long n,
                       long long span, int reverse, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (span <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k_point_scan<AFFINE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PS_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  long long nblk = (n + span - 1) / span;
  k_point_scan<AFFINE><<<(unsigned)(B * nblk), PS_THREADS, PS_SMEM_BYTES,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)in, row_words, (uint32_t*)out, (const uint32_t*)totals,
      n, span, nblk, reverse);
  return (int)cudaGetLastError();
}

template <bool AFFINE>
static int launch_reduce(const void* in, long long row_words, void* out,
                         long long B, long long n, long long span, int reverse,
                         void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (span <= 0) return (int)cudaErrorInvalidValue;
  long long nblk = (n + span - 1) / span;
  k_point_reduce<AFFINE><<<(unsigned)(B * nblk), PS_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)in, row_words, (uint32_t*)out, n, span, nblk, reverse);
  return (int)cudaGetLastError();
}

extern "C" int h2t_point_scan(const void* in, long long row_words, void* out,
                              const void* totals, long long B, long long n,
                              long long span, int reverse, void* stream) {
  return launch_scan<false>(in, row_words, out, totals, B, n, span, reverse,
                            stream);
}

extern "C" int h2t_point_reduce(const void* in, long long row_words, void* out,
                                long long B, long long n, long long span,
                                int reverse, void* stream) {
  return launch_reduce<false>(in, row_words, out, B, n, span, reverse, stream);
}

// The affine forms: `in` holds (x, y) pairs, 16 words a point; `out` and
// `totals` are projective as above.
extern "C" int h2t_point_scan_affine(const void* in, long long row_words,
                                     void* out, const void* totals,
                                     long long B, long long n, long long span,
                                     int reverse, void* stream) {
  return launch_scan<true>(in, row_words, out, totals, B, n, span, reverse,
                           stream);
}

extern "C" int h2t_point_reduce_affine(const void* in, long long row_words,
                                       void* out, long long B, long long n,
                                       long long span, int reverse,
                                       void* stream) {
  return launch_reduce<true>(in, row_words, out, B, n, span, reverse, stream);
}

// field_scan and field_reduce: inclusive scans, and row totals, of rows of
// Fr or Fq elements under a product, a sum or the composition of affine
// maps, each row on its own.
//
// Replace the use the port made of the TPU kernels fused_mul / fused_add
// (halo2_zkcert_tpu/ops/pallas_limbs.py:435, :441) under its scans of field
// elements: a log-depth sweep of one K1 launch and three copies a level,
// n log n canonical products of two Montgomery products each.  Here a scan
// is two launches whatever n is and about three products an element (four
// for the affine maps), built as the blocked scan of points is
// (point_scan.cu):
//   1. k_field_reduce: the total of each block's span of the row;
//   2. k_field_scan over the row, each block starting from the combination
//      of the totals of the blocks before it, which it works out itself.
// A row short enough for one block is launch 2 alone.  A row total is launch
// 1 and, where a row has several blocks, launch 1 again over their totals.
//
// A block brings a tile of 128 threads x 8 elements into shared memory with
// 16-byte asynchronous copies that neighbouring threads start for
// neighbouring addresses.  Each thread scans its run of 8 consecutive
// elements (bn254.cuh fs_run_local: one conversion in an element, prefixes
// written back in the inside form), the run totals are scanned across the
// warp with shuffles of their 8 or 16 words and across the four warps
// through shared memory, and each thread folds what precedes its run into
// its prefixes (fs_run_apply: for a product the offset is taken out of
// Montgomery form once a thread, so applying it and converting out are one
// product an element).  The composition of maps does not commute, so every
// combination here keeps the row's order: runs are consecutive elements,
// the shuffles combine earlier with later, warps and blocks are taken in
// order.  `reverse` scans from the row's end: the tile is mirrored by index
// arithmetic on its way in and out.  A run is 8 * 32 B + 16 B apart from the
// next, so the threads of a quarter warp read different banks.
//
// Bound on the H100: integer operations for a product or a map (n - 1
// products a row against 64 B an element), bytes for a sum.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include "bn254.cuh"   // the product inlined: called, a scan is 12-17 % slower

using namespace bn254;

constexpr int FS_THREADS = 128;
constexpr int FS_PPT = 8;
constexpr int FS_TILE = FS_THREADS * FS_PPT;
constexpr int FS_RUN_WORDS = FS_PPT * 8 + 4;
constexpr int FS_PLANE_WORDS = FS_THREADS * FS_RUN_WORDS;
constexpr int FS_WARPS = FS_THREADS / 32;

template <int OP>
__device__ __forceinline__ FsEl<OP> shfl_el(const FsEl<OP>& v, int delta,
                                            bool up) {
  FsEl<OP> r;
#pragma unroll
  for (int j = 0; j < FsEl<OP>::NV; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.v[j].w[i] = up ? __shfl_up_sync(0xffffffffu, v.v[j].w[i], delta)
                       : __shfl_down_sync(0xffffffffu, v.v[j].w[i], delta);
  return r;
}

template <int OP>
__device__ __forceinline__ FsEl<OP> ld_el(const uint4* p) {
  FsEl<OP> r;
#pragma unroll
  for (int j = 0; j < FsEl<OP>::NV; ++j)
    r.v[j] = load_fe_v(reinterpret_cast<const uint32_t*>(p + 2 * j));
  return r;
}

template <int OP>
__device__ __forceinline__ void st_el(uint4* p, const FsEl<OP>& v) {
#pragma unroll
  for (int j = 0; j < FsEl<OP>::NV; ++j)
    store_fe_v(reinterpret_cast<uint32_t*>(p + 2 * j), v.v[j]);
}

// Word offset in a plane of the tile's l-th element in scan order.
__device__ __forceinline__ int tile_word(int l) {
  return (l / FS_PPT) * FS_RUN_WORDS + (l % FS_PPT) * 8;
}

// The 16-byte piece f of the tile's `cnt` elements as they lie in device
// memory, and where it lives in a plane.
__device__ __forceinline__ int tile_piece(int f, int cnt, bool reverse) {
  int q = f >> 1;
  return tile_word(reverse ? cnt - 1 - q : q) + 4 * (f & 1);
}

// Elements [first, first + cnt) of the rows at a (and b) into the planes.
template <int OP>
__device__ __forceinline__ void tile_in(uint32_t* tile, const uint32_t* a,
                                        const uint32_t* b, long long first,
                                        int cnt, bool reverse) {
  for (int f = threadIdx.x; f < 2 * cnt; f += FS_THREADS) {
    const int w = tile_piece(f, cnt, reverse);
    __pipeline_memcpy_async(tile + w, a + first * 8 + 4 * (long long)f, 16);
    if (OP == FS_AFFINE)
      __pipeline_memcpy_async(tile + FS_PLANE_WORDS + w,
                              b + first * 8 + 4 * (long long)f, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The combination, in thread order, of every thread's `acc`, returned to all
// of them: shuffles within a warp, then the warps' totals through `warp_tot`.
template <int F, int OP>
__device__ __forceinline__ FsEl<OP> block_total(
    FsEl<OP> acc, uint4 (*warp_tot)[2 * FsEl<OP>::NV]) {
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1)
    acc = fs_combine<F, OP>(acc, shfl_el<OP>(acc, d, false));
  if ((threadIdx.x & 31) == 0) st_el<OP>(warp_tot[threadIdx.x >> 5], acc);
  __syncthreads();
  acc = ld_el<OP>(warp_tot[0]);
#pragma unroll 1
  for (int w = 1; w < FS_WARPS; ++w)
    acc = fs_combine<F, OP>(acc, ld_el<OP>(warp_tot[w]));
  __syncthreads();
  return acc;
}

// a, b: B rows of n canonical elements (b only for FS_AFFINE).  out:
// (B, n, 8).  Block blockIdx.x = r * nblk + j scans elements
// [j * span, (j + 1) * span) of row r in scan order, starting from the
// combination of tot[r, 0 .. j - 1] (k_field_reduce's output for the same
// span) where the totals are given.
template <int F, int OP>
__global__ void __launch_bounds__(FS_THREADS)
k_field_scan(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, const uint32_t* __restrict__ tot_a,
             const uint32_t* __restrict__ tot_b, long long n, long long span,
             long long nblk, int reverse) {
  typedef FsEl<OP> El;
  extern __shared__ uint4 tile4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  __shared__ uint4 warp_tot4[FS_WARPS][2 * El::NV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = blockIdx.x / nblk, j = blockIdx.x % nblk;
  const uint32_t* row_a = a + r * n * 8;
  const uint32_t* row_b = b + r * n * 8;
  uint32_t* row_out = out + r * n * 8;
  const long long s0 = j * span, e0 = min(n, s0 + span);

  El carry = fs_identity<F, OP>();
  if (tot_a != nullptr && j > 0) {
    // thread t takes totals [t * chunk, (t + 1) * chunk) below j
    const long long chunk = (j + FS_THREADS - 1) / FS_THREADS;
    const long long lo = min(j, tid * chunk), hi = min(j, lo + chunk);
    carry = block_total<F, OP>(
        fs_run_total<F, OP>(tot_a + (r * nblk + lo) * 8,
                            tot_b + (r * nblk + lo) * 8, 8, hi - lo),
        warp_tot4);
  }
  for (long long s = s0; s < e0; s += FS_TILE) {
    const int cnt = (int)min((long long)FS_TILE, e0 - s);
    const long long first = reverse ? n - (s + cnt) : s;   // in memory
    tile_in<OP>(tile, row_a, row_b, first, cnt, reverse);

    uint32_t* mine = tile + tid * FS_RUN_WORDS;
    const int my_cnt = max(0, min(FS_PPT, cnt - tid * FS_PPT));
    El inc = fs_run_local<F, OP>(mine, mine + FS_PLANE_WORDS, my_cnt);
    // inclusive scan of the run totals across the warp
#pragma unroll 1
    for (int d = 1; d < 32; d <<= 1) {
      El sum = fs_combine<F, OP>(shfl_el<OP>(inc, d, true), inc);
      if (lane >= d) inc = sum;
    }
    El before = shfl_el<OP>(inc, 1, true);
    if (lane == 0) before = fs_identity<F, OP>();
    if (lane == 31) st_el<OP>(warp_tot4[warp], inc);
    __syncthreads();
    El off = carry;
#pragma unroll 1
    for (int w = 0; w < FS_WARPS; ++w) {
      if (w == warp) off = fs_combine<F, OP>(carry, before);
      carry = fs_combine<F, OP>(carry, ld_el<OP>(warp_tot4[w]));
    }
    fs_run_apply<F, OP>(mine, mine + FS_PLANE_WORDS, my_cnt,
                        fs_offset<F, OP>(off));
    __syncthreads();

    for (int f = tid; f < 2 * cnt; f += FS_THREADS)
      *reinterpret_cast<uint4*>(row_out + first * 8 + 4 * (long long)f) =
          *reinterpret_cast<const uint4*>(tile + tile_piece(f, cnt, reverse));
    __syncthreads();
  }
}

// tot[r, j] = the combination of elements [j * span, (j + 1) * span) of row
// r in scan order, canonical (for FS_AFFINE the map's m in tot_a and b in
// tot_b).
template <int F, int OP>
__global__ void __launch_bounds__(FS_THREADS)
k_field_reduce(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ tot_a, uint32_t* __restrict__ tot_b,
               long long n, long long span, long long nblk, int reverse) {
  typedef FsEl<OP> El;
  extern __shared__ uint4 tile4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  __shared__ uint4 warp_tot4[FS_WARPS][2 * El::NV];
  const int tid = threadIdx.x;
  const long long r = blockIdx.x / nblk, j = blockIdx.x % nblk;
  const long long s0 = j * span, e0 = min(n, s0 + span);
  El carry = fs_identity<F, OP>();
  for (long long s = s0; s < e0; s += FS_TILE) {
    const int cnt = (int)min((long long)FS_TILE, e0 - s);
    const long long first = reverse ? n - (s + cnt) : s;   // in memory
    tile_in<OP>(tile, a + r * n * 8, b + r * n * 8, first, cnt, reverse);
    const uint32_t* mine = tile + tid * FS_RUN_WORDS;
    const int my_cnt = max(0, min(FS_PPT, cnt - tid * FS_PPT));
    carry = fs_combine<F, OP>(
        carry, block_total<F, OP>(
                   fs_run_total<F, OP>(mine, mine + FS_PLANE_WORDS, 8, my_cnt),
                   warp_tot4));
  }
  if (tid == 0) {
    if (OP != FS_SUM) carry.v[0] = from_mont<F>(carry.v[0]);
    fs_store<OP>(tot_a + (long long)blockIdx.x * 8,
                 tot_b + (long long)blockIdx.x * 8, carry);
  }
}

constexpr int smem_bytes(int op) {
  return (op == FS_AFFINE ? 2 : 1) * FS_PLANE_WORDS * 4;
}

template <int F, int OP>
static int launch_scan(const void* a, const void* b, void* out,
                       const void* tot_a, const void* tot_b, long long B,
                       long long n, long long span, int reverse,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      k_field_scan<F, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(OP));
  if (err != cudaSuccess) return (int)err;
  long long nblk = (n + span - 1) / span;
  k_field_scan<F, OP><<<(unsigned)(B * nblk), FS_THREADS, smem_bytes(OP), s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
      (const uint32_t*)tot_a, (const uint32_t*)tot_b, n, span, nblk, reverse);
  return (int)cudaGetLastError();
}

template <int F, int OP>
static int launch_reduce(const void* a, const void* b, void* tot_a,
                         void* tot_b, long long B, long long n, long long span,
                         int reverse, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      k_field_reduce<F, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(OP));
  if (err != cudaSuccess) return (int)err;
  long long nblk = (n + span - 1) / span;
  k_field_reduce<F, OP><<<(unsigned)(B * nblk), FS_THREADS, smem_bytes(OP),
                          s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)tot_a,
      (uint32_t*)tot_b, n, span, nblk, reverse);
  return (int)cudaGetLastError();
}

#define FS_DISPATCH(CALL)                                         \
  if (field == FR) {                                              \
    if (op == FS_PROD) return CALL(FR, FS_PROD);                  \
    if (op == FS_SUM) return CALL(FR, FS_SUM);                    \
    if (op == FS_AFFINE) return CALL(FR, FS_AFFINE);              \
  } else if (field == FQ) {                                       \
    if (op == FS_PROD) return CALL(FQ, FS_PROD);                  \
    if (op == FS_SUM) return CALL(FQ, FS_SUM);                    \
    if (op == FS_AFFINE) return CALL(FQ, FS_AFFINE);              \
  }                                                               \
  return (int)cudaErrorInvalidValue;

// b, tot_a and tot_b may be null: b and tot_b unless op is FS_AFFINE, the
// totals where a row is one block.  span is a multiple of the 1024-element
// tile.
extern "C" int h2t_field_scan(int field, int op, const void* a, const void* b,
                              void* out, const void* tot_a, const void* tot_b,
                              long long B, long long n, long long span,
                              int reverse, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (span <= 0 || span % FS_TILE) return (int)cudaErrorInvalidValue;
#define FS_SCAN(F, OP) \
  launch_scan<F, OP>(a, b, out, tot_a, tot_b, B, n, span, reverse, \
                     (cudaStream_t)stream)
  FS_DISPATCH(FS_SCAN)
}

extern "C" int h2t_field_reduce(int field, int op, const void* a,
                                const void* b, void* tot_a, void* tot_b,
                                long long B, long long n, long long span,
                                int reverse, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (span <= 0 || span % FS_TILE) return (int)cudaErrorInvalidValue;
#define FS_REDUCE(F, OP) \
  launch_reduce<F, OP>(a, b, tot_a, tot_b, B, n, span, reverse, \
                       (cudaStream_t)stream)
  FS_DISPATCH(FS_REDUCE)
}

// dft_s8: one base DFT of the four-step transform (ops/ntt_mxu.py) on the
// int8 tensor cores: Y[k, col] = sum_j W[k, j] X[j, col] mod p for radix
// r = 2^r_log over m columns, canonical words in and out.
//
// Replaces the base DFT of halo2_zkcert_tpu/ops/ntt_mxu.py `_dft_base`
// (:184, the s8 x s8 -> s32 `dot_general` at :193 on the TPU's MXU), which
// expanded the data into a digit tensor in device memory and took the
// (64 r, m) int32 product back out to device memory for its carries.  Here:
// - Prologue: a block reads the 32 bytes of each input element of its
//   columns and stores them as s8 digits d - 128 (one XOR) in shared memory;
//   no digit tensor exists in device memory.
// - Product: the constant matrix lhs (64 r rows (k, l), output-major and
//   limb-minor, x 32 r columns (j, l2)) times those digits on the tensor
//   cores, WMMA 16 x 16 x 16 signed char fragments, s32 accumulators; a block
//   tile is 128 rows (two output elements) x 128 columns, 8 warps of 64 x 32,
//   64 bytes of depth a step.  wgmma, TMA and a pipeline are later work.
// - Epilogue: the accumulators go to shared memory, and one thread takes the
//   64 limbs of one (output element, column): adds the correction row (the
//   data's offset and a multiple of p), carries, reduces mod p in chunks of
//   253 bits (bn254.cuh dft_limbs_to_fe: two Montgomery products) and writes
//   8 canonical words.  The product never leaves the block.
// Input element j of column col is read at dft_addr(col, j, r, cin), output
// k written at dft_addr(col, k, r, cout): the recursion's transpose between
// levels rides on these addresses.
//
// Bound on the H100: operations.  A level needs 2 * 33 * 32 * r int8
// operations an element (1979 T/s dense): of each 64 x 32 block (k, j) of
// lhs only the band of 33 digits a column is nonzero.  This kernel
// multiplies the whole block, 2 * 64 * 32 * r (1.94 times as many; 2 of its
// 8 16 x 16 tiles are all zero).  Besides, two 256-bit Montgomery products
// an element (about 36.9 G/s measured for bare products), against 64 bytes
// an element moved; at r = 64 the tensor-core time and the reduction's are
// of one order.
#include <cuda_runtime.h>
#include <mma.h>
#include "bn254.cuh"

using namespace bn254;
using namespace nvcuda;

constexpr int DFT_BM = 128;        // rows of a block tile: two output elements
constexpr int DFT_BN = 128;        // columns of a block tile
constexpr int DFT_BK = 64;         // depth of a step: two input elements
constexpr int DFT_THREADS = 256;   // 8 warps, 2 x 4 over the tile
constexpr int DFT_WM = 64, DFT_WN = 32;
constexpr int DFT_LDC = DFT_BN + 4;                 // epilogue tile row stride
constexpr int DFT_SMEM = DFT_BM * DFT_LDC * 4;      // operand tiles alias it
static_assert(DFT_THREADS == 2 * DFT_BN, "a thread an (element, column)");
static_assert(DFT_BM * DFT_BK + DFT_BN * DFT_BK <= DFT_SMEM, "operand tiles");

// Block blockIdx.x = column tile * row tiles + row tile.  Operand tiles are
// stored as DFT_BK / 16 slabs of 16 bytes a row (A) or a column (B), so every
// fragment starts 32-byte aligned with a leading dimension of 16.
__global__ void __launch_bounds__(DFT_THREADS)
k_dft_s8(const int8_t* __restrict__ lhs, const int32_t* __restrict__ corr,
         const uint32_t* __restrict__ fold, const uint32_t* __restrict__ in,
         uint32_t* __restrict__ out, long long m, int r_log, long long cin,
         long long cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + DFT_BM * DFT_BK;
  int32_t* Cs = reinterpret_cast<int32_t*>(smem);

  const int r = 1 << r_log;
  const long long K = (long long)DFT_BYTES * r;
  const int row_tiles = r * DFT_LIMBS / DFT_BM;
  const long long row0 = (long long)(blockIdx.x % row_tiles) * DFT_BM;
  const long long col0 = (long long)(blockIdx.x / row_tiles) * DFT_BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  constexpr int SLABS = DFT_BK / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

#pragma unroll 1
  for (long long k0 = 0; k0 < K; k0 += DFT_BK) {
    for (int idx = tid; idx < DFT_BM * SLABS; idx += DFT_THREADS) {
      const int row = idx / SLABS, s = idx % SLABS;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          lhs + (row0 + row) * K + k0 + 16 * s));
      *reinterpret_cast<uint4*>(As + (s * DFT_BM + row) * 16) = v;
    }
    for (int idx = tid; idx < DFT_BN * SLABS; idx += DFT_THREADS) {
      const int c = idx / SLABS, s = idx % SLABS;
      const long long col = col0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (col < m) {
        const long long j = k0 / DFT_BYTES + (s >> 1);
        v = __ldg(reinterpret_cast<const uint4*>(
                in + dft_addr(col, j, r, cin) * 8) + (s & 1));
        v.x ^= 0x80808080u;  // byte d -> s8 digit d - 128
        v.y ^= 0x80808080u;
        v.z ^= 0x80808080u;
        v.w ^= 0x80808080u;
      }
      *reinterpret_cast<uint4*>(Bs + (s * DFT_BN + c) * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            fa[i], As + (s * DFT_BM + wm * DFT_WM + 16 * i) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], Bs + (s * DFT_BN + wn * DFT_WN + 16 * j) * 16, 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * DFT_WM + 16 * i) * DFT_LDC + wn * DFT_WN + 16 * j,
          acc[i][j], DFT_LDC, wmma::mem_row_major);
  __syncthreads();

  const int e = tid / DFT_BN, c = tid % DFT_BN;
  const long long col = col0 + c;
  if (col >= m) return;
  const long long k = row0 / DFT_LIMBS + e;
  const Fe x = dft_limbs_to_fe(Cs + e * DFT_LIMBS * DFT_LDC + c, DFT_LDC,
                               corr + k * DFT_LIMBS, load_fe(fold),
                               load_fe(fold + 8));
  store_fe_v(out + dft_addr(col, k, r, cout) * 8, x);
}

// One base DFT: lhs (64 r, 32 r) s8, corr (r, 64) s32, fold the two words
// 2^253 R and 2^506 R mod p, `in` and `out` m * r canonical elements in the
// layouts of column strides cin and cout.
extern "C" int h2t_dft_s8(const void* lhs, const void* corr, const void* fold,
                          const void* in, void* out, long long m, int r_log,
                          long long cin, long long cout, void* stream) {
  if (m <= 0) return 0;
  if (r_log < 1 || r_log > 8 || cin <= 0 || cout <= 0 || m % cin || m % cout)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k_dft_s8, cudaFuncAttributeMaxDynamicSharedMemorySize, DFT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (1LL << r_log) * DFT_LIMBS / DFT_BM;
  const long long col_tiles = (m + DFT_BN - 1) / DFT_BN;
  k_dft_s8<<<(unsigned)(row_tiles * col_tiles), DFT_THREADS, DFT_SMEM,
             (cudaStream_t)stream>>>(
      (const int8_t*)lhs, (const int32_t*)corr, (const uint32_t*)fold,
      (const uint32_t*)in, (uint32_t*)out, m, r_log, cin, cout);
  return (int)cudaGetLastError();
}

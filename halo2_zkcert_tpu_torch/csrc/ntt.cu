// ntt_pass: the number-theoretic transform over Fr in passes over shared
// memory, a batch of columns at once.
//
// Replaces the use the port made of the TPU kernels fused_mul / fused_add /
// fused_sub (halo2_zkcert_tpu/ops/pallas_limbs.py:435, :441, :446) under its
// transforms: one K1 mul, add and sub launch a stage, a gather for the bit
// reversal, launches for the coset scaling and 1/n, every stage through
// device memory.  (The reference's own transform,
// halo2_zkcert_tpu/ops/ntt.py:127-173, is an XLA program of the same shape.)
// Here a block owns a tile of up to 2^NTT_LOG_TILE elements of one column,
// does up to NTT_LOG_TILE butterfly stages on it in shared memory and writes
// it back: a transform of length 2^17 or 2^19 is two launches.
//
// - No gather and no transpose: an Fr element is one 32-byte sector, so a
//   pass that reads elements at a stride moves no more sectors than a
//   contiguous one.  The bit reversal is index arithmetic on the first
//   pass's loads (bn254.cuh ntt_load), an index at or past the input's
//   length reads as zero (the zero padding of the extended domain), and the
//   coset powers, 1/n and the conversion to or from Montgomery form are one
//   product on the first pass's loads or the last pass's stores.
// - Twiddles are stored times 2^256, so a butterfly is one Montgomery product
//   on the data as it is: k / 2 products an element and transform.  A stage's
//   twiddles come from one table of w^j, j < 2^(k-1), through the caches:
//   the first pass reads its first 2^t entries' worth of strides, a later
//   pass 2^t - 1 entries a tile, shared by the columns of the batch, which
//   are neighbours in the grid.
// - The tile is two planes of 16-byte halves, so the threads of a quarter
//   warp read different banks at every stage but the first three.
//
// Bound on the H100: integer operations (k / 2 products an element against
// 64 B an element).
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

constexpr int NTT_LOG_TILE = 10;
constexpr int NTT_THREADS = 256;
constexpr int NTT_SMEM_BYTES = 32 << NTT_LOG_TILE;

// Block blockIdx.x = tile * B + column.
__global__ void __launch_bounds__(NTT_THREADS)
k_ntt_pass(const uint32_t* __restrict__ in, long long n_in,
           uint32_t* __restrict__ out, long long B, NttPass ps,
           const uint32_t* __restrict__ tw,
           const uint32_t* __restrict__ in_scale, long long in_period,
           const uint32_t* __restrict__ out_scale, long long out_period) {
  extern __shared__ uint4 tile4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  const int tid = threadIdx.x, cap = 1 << (ps.t + ps.a);
  const long long col = blockIdx.x % B, tile_idx = blockIdx.x / B;
  const uint32_t* col_in = in + col * n_in * 8;
  uint32_t* col_out = out + (col << ps.k) * 8;

  for (int i = tid; i < cap; i += NTT_THREADS)
    tile_st(tile, cap, i, ntt_load(ps, tile_idx, i, col_in, n_in, col_out,
                                   in_scale, in_period));
  __syncthreads();
#pragma unroll 1
  for (int sl = 0; sl < ps.t; ++sl) {
    ntt_tile_stage(tile, cap, ps, tile_idx, sl, tw, tid, NTT_THREADS);
    __syncthreads();
  }
  for (int i = tid; i < cap; i += NTT_THREADS)
    ntt_store(ps, tile_idx, i, tile_ld(tile, cap, i), col_out, out_scale,
              out_period);
}

// One pass over B columns: stages s0 .. s0 + t - 1 of a length-2^k
// transform, 2^a neighbouring groups a tile.  `in` (B, n_in, 8) is read by
// the first pass only; `out` is (B, 2^k, 8).
extern "C" int h2t_ntt_pass(const void* in, long long n_in, void* out,
                            long long B, int k, int s0, int t, int a,
                            const void* tw, const void* in_scale,
                            long long in_period, const void* out_scale,
                            long long out_period, void* stream) {
  if (B <= 0) return 0;
  if (t < 0 || a < 0 || t + a > NTT_LOG_TILE || a > s0 || s0 + t > k || k > 30)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k_ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, NTT_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  NttPass ps = {k, s0, t, a};
  long long tiles = 1LL << (k - t - a);
  k_ntt_pass<<<(unsigned)(tiles * B), NTT_THREADS, 32 << (t + a),
               (cudaStream_t)stream>>>(
      (const uint32_t*)in, n_in, (uint32_t*)out, B, ps, (const uint32_t*)tw,
      (const uint32_t*)in_scale, in_period, (const uint32_t*)out_scale,
      out_period);
  return (int)cudaGetLastError();
}

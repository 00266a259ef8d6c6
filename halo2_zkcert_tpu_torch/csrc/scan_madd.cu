// K6 scan_madd: per row, the inclusive prefix scan of C affine points under
// the mixed group law.
//
// Replaces the TPU kernel fused_scan_madd
// (halo2_zkcert_tpu/ops/pallas_limbs.py:533, body _scan_madd_kernel): the
// level-1 pass of the fixed-base MSM's bucket scan over digit-sorted table
// points.  Input (R, C, 2, 8) canonical affine points, never the identity;
// output (R, C, 3, 8) canonical projective prefixes, prefix 0 = (x, y, 1).
// With the sorted digits (R, C) a prefix is written only where the row's
// next pair has another digit, and at the row's end, which is all that the
// bucket extraction and the scan of the row totals read; the other slots
// stay unwritten.
//
// One thread a row: the running sum stays in registers in Montgomery form
// across the C - 1 sequential mixed additions (RCB16 Alg. 8, 11 products);
// each incoming point costs 2 conversions, each stored prefix 3
// (bn254.cuh madd_run_*).  C is a launch argument and the caller's lever for
// parallelism: rows = pairs / C threads, so the caller shortens the rows
// until they fill the card and scans the row totals with point_scan.
//
// A block is 128 rows.  Their points arrive through shared memory in stages
// of one point a row: 16-byte asynchronous copies, four neighbouring threads
// on the 64 contiguous bytes of one row, the next stage in flight while the
// current one is added (two buffers, 20 480 B; two points a stage measured
// 3 % slower).  A row's slice is 64 B + 16 B apart from the next, so the
// threads of a quarter warp read different banks.  A thread reads its next
// digit before the addition that precedes its use.  Stored prefixes go from
// registers to device memory, 96 contiguous bytes a prefix: three whole
// sectors.
//
// Bound on the H100: integer operations (11 products a pair, 13 to 16 with
// the conversions, against 64 B read and at most 96 B written).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#define H2T_MONT_MUL_CALL   // 16 products a pair inlined are 100 KB of code
#include "bn254.cuh"

using namespace bn254;

constexpr int SM_ROWS = 128;             // rows, and threads, a block
constexpr int SM_STAGE = 1;              // points a row a stage
constexpr int SM_ROW_WORDS = SM_STAGE * 16 + 4;

// Start the copies of stage s (points [s * SM_STAGE, (s + 1) * SM_STAGE) of
// each of the block's `rows` rows) into `buf`.
__device__ __forceinline__ void start_stage(uint32_t* buf,
                                            const uint32_t* block_xy, int rows,
                                            int C, int s) {
  const int j0 = s * SM_STAGE;
  const int pieces = 4 * min(SM_STAGE, C - j0);
  for (int f = threadIdx.x; f < rows * 4 * SM_STAGE; f += SM_ROWS) {
    int row = f / (4 * SM_STAGE), part = f % (4 * SM_STAGE);
    if (part < pieces)
      __pipeline_memcpy_async(
          buf + row * SM_ROW_WORDS + 4 * part,
          block_xy + ((long long)row * C + j0) * 16 + 4 * part, 16);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(SM_ROWS, 4)
k_scan_madd(const uint32_t* __restrict__ xy,
            const int32_t* __restrict__ digits, uint32_t* __restrict__ out,
            long long R, int C) {
  __shared__ uint4 stage4[2][SM_ROWS * SM_ROW_WORDS / 4];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * SM_ROWS;
  const int rows = (int)min((long long)SM_ROWS, R - r0);
  const uint32_t* block_xy = xy + r0 * C * 16;
  const bool live = tid < rows, dense = digits == nullptr;
  const int32_t* my_digits = dense ? nullptr : digits + (r0 + tid) * C;
  uint32_t* my_out = out + (r0 + tid) * C * 24;
  const int stages = (C + SM_STAGE - 1) / SM_STAGE;

  MaddRun run;
  int32_t next_digit = (live && !dense) ? my_digits[0] : 0;
  start_stage(reinterpret_cast<uint32_t*>(stage4[0]), block_xy, rows, C, 0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      start_stage(reinterpret_cast<uint32_t*>(stage4[(s + 1) & 1]), block_xy,
                  rows, C, s + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (live) {
      const uint32_t* mine = tid * SM_ROW_WORDS +
          reinterpret_cast<const uint32_t*>(stage4[s & 1]);
#pragma unroll 1
      for (int jj = 0; jj < SM_STAGE; ++jj) {
        const int j = s * SM_STAGE + jj;
        if (j >= C) break;
        const int32_t digit = next_digit;
        if (!dense && j + 1 < C) next_digit = my_digits[j + 1];
        if (j == 0)
          run = madd_run_begin(mine, digit);
        else
          madd_run_step(run, mine + 16 * jj, digit, dense,
                        my_out + 24 * (j - 1));
      }
    }
    __syncthreads();   // the buffer is refilled two stages on
  }
  if (live) madd_run_end(run, my_out + 24 * (long long)(C - 1));
}

// digits may be null: every prefix is written.
extern "C" int h2t_scan_madd(const void* xy, const void* digits, void* out,
                             long long R, int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  long long blocks = (R + SM_ROWS - 1) / SM_ROWS;
  k_scan_madd<<<(unsigned)blocks, SM_ROWS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xy, (const int32_t*)digits, (uint32_t*)out, R, C);
  return (int)cudaGetLastError();
}

// K6 scan_madd: per row, the inclusive prefix scan of C affine points under
// the mixed group law.
//
// Replaces the TPU kernel fused_scan_madd
// (halo2_zkcert_tpu/ops/pallas_limbs.py:533, body _scan_madd_kernel): the
// level-1 pass of the fixed-base MSM's bucket scan over digit-sorted table
// points.  Input (R, C, 2, 8) canonical affine points, never the identity;
// output (R, C, 3, 8) canonical projective prefixes, prefix 0 = (x, y, 1).
//
// One thread a row: the running sum stays in registers in Montgomery form
// across the C - 1 sequential mixed additions (RCB16 Alg. 8, 11 products);
// each incoming point costs 2 conversions, each stored prefix 3.  C is a
// launch argument.  Bound on the H100: integer operations (16 CIOS products
// a pair against 64 B read and 96 B written).  A thread reads its row's 64 B
// points one after another, so a warp's loads lie C * 64 B apart but fill
// whole 32 B sectors; rows / 128 blocks fill the card only when there are
// many rows (a full column group), a single bounded column leaves most SMs
// idle.  A warp a row segment staged through shared memory is later work.
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

__global__ void k_scan_madd(const uint32_t* __restrict__ xy,
                            uint32_t* __restrict__ out, long long R, int C) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  scan_madd_row(xy + r * C * 16, out + r * C * 24, C);
}

extern "C" int h2t_scan_madd(const void* xy, void* out, long long R, int C,
                             void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const int threads = 128;
  long long blocks = (R + threads - 1) / threads;
  k_scan_madd<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xy, (uint32_t*)out, R, C);
  return (int)cudaGetLastError();
}

// K1 field_binop: batched BN254 Fr/Fq modular mul, add or sub.
//
// Replaces the TPU kernels fused_mul / fused_add / fused_sub
// (halo2_zkcert_tpu/ops/pallas_limbs.py:435, :441, :446), which worked on
// lazy 33 x 8-bit f32 limb planes because the TPU has no fast integer
// multiply.  Here one thread owns one element: canonical 8 x 32-bit words in,
// canonical out, Montgomery CIOS inside (bn254.cuh).
//
// Bound on the H100: memory.  A mul reads 64 B and writes 32 B per element
// for about 2 x 200 integer operations; at 2^19 elements that is 50 MB,
// about 15 us at 3.35 TB/s.  The design keeps each element's words in
// registers, loads them as two 16-byte vectors per operand and writes the
// result once.  The second operand may repeat with a period (`nb`), so a
// scalar or a per-row twiddle is read from cache instead of being expanded
// in device memory.
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

__device__ __forceinline__ Fe ld(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

__device__ __forceinline__ void st(uint32_t* p, const Fe& v) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  q[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

template <int F, int OP>
__global__ void k_field_binop(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, long long n,
                              long long nb) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = ld(a + i * 8);
  Fe y = ld(b + (i % nb) * 8);
  st(out + i * 8, binop_canon<F, OP>(x, y));
}

template <int F, int OP>
static void launch(const void* a, const void* b, void* out, long long n,
                   long long nb, cudaStream_t s) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_field_binop<F, OP><<<(unsigned)blocks, threads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, nb);
}

extern "C" int h2t_field_binop(int field, int op, const void* a, const void* b,
                               void* out, long long n, long long nb,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (field == FR) {
    if (op == OP_MUL) launch<FR, OP_MUL>(a, b, out, n, nb, s);
    else if (op == OP_ADD) launch<FR, OP_ADD>(a, b, out, n, nb, s);
    else launch<FR, OP_SUB>(a, b, out, n, nb, s);
  } else {
    if (op == OP_MUL) launch<FQ, OP_MUL>(a, b, out, n, nb, s);
    else if (op == OP_ADD) launch<FQ, OP_ADD>(a, b, out, n, nb, s);
    else launch<FQ, OP_SUB>(a, b, out, n, nb, s);
  }
  return (int)cudaGetLastError();
}

// K2 point_add, K3 point_double and K5 point_add_mixed: batched complete G1
// group law.
//
// Replace the TPU kernels fused_point_add (RCB16 Alg. 7,
// halo2_zkcert_tpu/ops/pallas_limbs.py:372), fused_point_double (RCB16
// Alg. 9, pallas_limbs.py:451) and fused_point_add_mixed (RCB16 Alg. 8,
// pallas_limbs.py:393: projective + affine, Z2 = 1).  One thread per point;
// the 12 (add), 8 (double) or 11 (mixed add) Fq products and every
// intermediate stay in registers, in Montgomery form, between one conversion
// in and one conversion out.
//
// Bound on the H100: integer operations.  An add is about 21 CIOS products
// (12 of the formula plus 9 conversions) of about 200 32-bit multiply-adds
// each, against 192 B read and 96 B written.  The design spends nothing on
// memory beyond one read and one write per coordinate; the conversions are
// the price of canonical values at the boundary and the first thing to cut
// once points stay in Montgomery form between launches.
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

__device__ __forceinline__ Pt ldp(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  Pt r;
  uint32_t* w[3] = {r.x.w, r.y.w, r.z.w};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint4 lo = q[2 * c], hi = q[2 * c + 1];
    w[c][0] = lo.x; w[c][1] = lo.y; w[c][2] = lo.z; w[c][3] = lo.w;
    w[c][4] = hi.x; w[c][5] = hi.y; w[c][6] = hi.z; w[c][7] = hi.w;
  }
  return r;
}

__device__ __forceinline__ void lda(const uint32_t* p, Fe& x, Fe& y) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint32_t* w[2] = {x.w, y.w};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    uint4 lo = q[2 * c], hi = q[2 * c + 1];
    w[c][0] = lo.x; w[c][1] = lo.y; w[c][2] = lo.z; w[c][3] = lo.w;
    w[c][4] = hi.x; w[c][5] = hi.y; w[c][6] = hi.z; w[c][7] = hi.w;
  }
}

__device__ __forceinline__ void stp(uint32_t* p, const Pt& v) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint32_t* w[3] = {v.x.w, v.y.w, v.z.w};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[2 * c] = make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
    q[2 * c + 1] = make_uint4(w[c][4], w[c][5], w[c][6], w[c][7]);
  }
}

__global__ void k_point_add(const uint32_t* __restrict__ P,
                            const uint32_t* __restrict__ Q,
                            uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  stp(out + i * 24, point_add_canon(ldp(P + i * 24), ldp(Q + i * 24)));
}

__global__ void k_point_double(const uint32_t* __restrict__ P,
                               uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  stp(out + i * 24, point_double_canon(ldp(P + i * 24)));
}

// P: (n, 3, 8) projective, Q: (n, 2, 8) affine and never the identity.
__global__ void k_point_add_mixed(const uint32_t* __restrict__ P,
                                  const uint32_t* __restrict__ Q,
                                  uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x2, y2;
  lda(Q + i * 16, x2, y2);
  stp(out + i * 24, point_madd_canon(ldp(P + i * 24), x2, y2));
}

extern "C" int h2t_point_add(const void* P, const void* Q, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  k_point_add<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int h2t_point_double(const void* P, void* out, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  k_point_double<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int h2t_point_add_mixed(const void* P, const void* Q, void* out,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  k_point_add_mixed<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

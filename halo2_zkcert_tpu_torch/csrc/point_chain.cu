// point_windows and point_horner, the chain forms of K3 point_double, and
// point_fixed_mul, a chain form of K5 point_add_mixed: long chains of the
// G1 group law, one thread a chain, every intermediate in registers in
// Montgomery form from the first load to the last store.
//
// Replace the use the port made of the TPU kernels fused_point_double (RCB16
// Alg. 9, halo2_zkcert_tpu/ops/pallas_limbs.py:451) and
// fused_point_add_mixed (RCB16 Alg. 8, pallas_limbs.py:393): one launch a
// doubling or an addition, each converting its points into Montgomery form
// and out again (9 products on 8 or 11), issued one by one from Python:
//   - the window tables of the fixed-base MSM, 2^(16 w) P_i for 16 windows:
//     240 doublings a point, 240 launches a basis (ops/msm_fb.py);
//   - the Horner step of the variable-base MSM, 8 doublings and one addition
//     a window, 31 windows: 279 launches a call over 4 points at most
//     (ops/msm.py);
//   - the SRS, s_i G for 2^(k+1) scalars: 256 double-and-add steps, some 770
//     launches (plonk/kzg.py).
// Here each is one launch:
//   k_point_windows    out[w, i] = 2^(c w) P_i, one thread a point, the c
//                      doublings of a window in registers, one conversion in
//                      and one out a window stored (bn254.cuh
//                      point_windows_chain);
//   k_point_horner     sum_w 2^(c w) W_w, one thread a column, the same
//                      doublings and additions in the same order as the
//                      plain version, so the projective words are equal
//                      (point_horner_chain);
//   k_point_fixed_mul  s_i G as in the JAX package's fixed_base_msm
//                      (plonk/kzg.py:87): 32 mixed additions at most from a
//                      table of 32 x 256 affine multiples of G kept in
//                      Montgomery form (512 KB, resident in L2), a zero byte
//                      skipped (point_fixed_mul_chain).
//
// Bound on the H100: integer operations for k_point_windows and
// k_point_fixed_mul (about 1950 and 350 products a thread against 96 + 1536
// and 32 + 96 bytes); k_point_horner has a few threads and is bound by the
// latency of its chain of 248 x 8 + 32 x 12 dependent products, which no
// design of one chain a thread shortens.  The Montgomery product is called,
// not inlined: all three kernels ran 1.3 times faster so (tools/
// torch_kernel_variants.py point_chain, PERF.md).
#include <cuda_runtime.h>
#define H2T_MONT_MUL_CALL
#include "bn254.cuh"

using namespace bn254;

constexpr int PC_THREADS = 128;

// P: (n, 3, 8) canonical; out: (nwin, n, 3, 8).
__global__ void __launch_bounds__(PC_THREADS)
k_point_windows(const uint32_t* __restrict__ P, uint32_t* __restrict__ out,
                long long n, int c, int nwin) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  point_windows_chain(P + i * 24, c, nwin, out + i * 24, 24 * n);
}

// W: (m, nwin, 3, 8) canonical; out: (m, 3, 8).
__global__ void k_point_horner(const uint32_t* __restrict__ W,
                               uint32_t* __restrict__ out, long long m, int c,
                               int nwin) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  store_pt_v(out + j * 24,
             pt_from_mont(point_horner_chain(W + j * nwin * 24, 24, c, nwin)));
}

// table: (32, 256, 2, 8) in Montgomery form; s: (n, 8) canonical; out:
// (n, 3, 8).
__global__ void __launch_bounds__(PC_THREADS)
k_point_fixed_mul(const uint32_t* __restrict__ table,
                  const uint32_t* __restrict__ s, uint32_t* __restrict__ out,
                  long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_pt_v(out + i * 24,
             pt_from_mont(point_fixed_mul_chain(table, s + i * 8)));
}

static unsigned blocks_for(long long n) {
  return (unsigned)((n + PC_THREADS - 1) / PC_THREADS);
}

extern "C" int h2t_point_windows(const void* P, void* out, long long n, int c,
                                 int nwin, void* stream) {
  if (n <= 0 || nwin <= 0) return 0;
  if (c < 0) return (int)cudaErrorInvalidValue;
  k_point_windows<<<blocks_for(n), PC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (uint32_t*)out, n, c, nwin);
  return (int)cudaGetLastError();
}

extern "C" int h2t_point_horner(const void* W, void* out, long long m, int c,
                                int nwin, void* stream) {
  if (m <= 0) return 0;
  if (c < 0 || nwin <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  k_point_horner<<<(unsigned)((m + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>((const uint32_t*)W, (uint32_t*)out,
                                           m, c, nwin);
  return (int)cudaGetLastError();
}

extern "C" int h2t_point_fixed_mul(const void* table, const void* s, void* out,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  k_point_fixed_mul<<<blocks_for(n), PC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)s, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

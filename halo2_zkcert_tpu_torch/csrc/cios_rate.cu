// Measurement only, on no proving path: the rate at which the card does
// the CIOS Montgomery product of bn254.cuh (mont_mul<FQ>) when nothing else
// is in the way.  Each thread carries `chains` independent chains of
// dependent products in registers for `iters` steps and writes one word, so
// neither memory nor a single chain's latency limits it.  The operation
// bounds of the other kernels count such a product at the float32 rate; this
// says how far 32-bit integer multiply-adds fall below that.
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

template <int CHAINS>
__global__ void k_cios_rate(const uint32_t* __restrict__ seed,
                            uint32_t* __restrict__ out, int iters) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Fe b = load_fe(seed);
  Fe a[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    a[c] = load_fe(seed + 8);
    a[c].w[0] ^= (uint32_t)i + c;
  }
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) a[c] = mont_mul<FQ>(a[c], b);
  }
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc ^= a[c].w[0] ^ a[c].w[7];
  out[i] = acc;
}

// seed: 16 words (two field elements below p); out: blocks * threads words.
extern "C" int h2t_cios_rate(const void* seed, void* out, int blocks,
                             int threads, int chains, int iters,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* in = (const uint32_t*)seed;
  uint32_t* o = (uint32_t*)out;
  if (chains == 1)
    k_cios_rate<1><<<blocks, threads, 0, s>>>(in, o, iters);
  else if (chains == 2)
    k_cios_rate<2><<<blocks, threads, 0, s>>>(in, o, iters);
  else if (chains == 4)
    k_cios_rate<4><<<blocks, threads, 0, s>>>(in, o, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

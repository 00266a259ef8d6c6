// K4 quotient_forest: the whole gate, permutation and lookup constraint
// forest of one proving key, folded by y and multiplied by 1/Z_H, evaluated
// pointwise over the extended coset.
//
// Replaces the per-pk Pallas kernel of
// halo2_zkcert_tpu/plonk/quotient_pallas.py:315 (QuotientPallas._build_jfn,
// body from make_kernel :127), which was generated and compiled per pk.  Here
// the forest is lowered once per pk into a TAPE (plonk/quotient.py) that one
// fixed kernel interprets: every thread runs the same instructions on its own
// row, so there is no divergence and nothing is compiled per pk.  Rotations
// stay outside the arithmetic: a rotated leaf is a row offset read with
// wrap-around.
//
// Bound on the H100: integer operations.  For the RSA k=17 pk each row runs
// on the order of a hundred Montgomery products, against one 32-byte read
// per leaf column and one 32-byte write.  Slots live in local memory (L1);
// the tape is read by all threads of a warp at the same address, a broadcast.
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

__global__ void k_quotient_forest(const uint32_t* __restrict__ leaves,
                                  long long n_rows,
                                  const uint32_t* __restrict__ consts,
                                  const int32_t* __restrict__ tape, int T,
                                  int out_slot, uint32_t* __restrict__ out) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  Fe slots[TAPE_MAX_SLOTS];
  Fe h = tape_eval_row(row, n_rows, leaves, consts, tape, T, out_slot, slots);
  store_fe(out + row * 8, h);
}

extern "C" int h2t_quotient_forest(const void* leaves, long long n_rows,
                                   const void* consts, const void* tape, int T,
                                   int out_slot, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const int threads = 128;
  long long blocks = (n_rows + threads - 1) / threads;
  k_quotient_forest<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)leaves, n_rows, (const uint32_t*)consts,
      (const int32_t*)tape, T, out_slot, (uint32_t*)out);
  return (int)cudaGetLastError();
}

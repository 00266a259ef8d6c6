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
// Bound on the H100: integer operations.  Leaves, constants and the result
// are in Montgomery form (the pk's columns are stored so, the fresh columns
// come so out of the coset transform, the result goes so into the inverse
// one), so a row costs the tape's products and nothing else: 74 for the RSA
// k=17 pk, against one 32-byte read a leaf load and one 32-byte write.  The
// block copies the tape into shared memory once; a thread reads a leaf as
// two 16-byte loads.  The kernel is instantiated for a few slot counts
// (8 to TAPE_MAX_SLOTS) and a tape runs on the smallest that holds it.  A
// row's slots are a local array, which the L1 cache holds (17 slots of 128
// rows are 68 KB).  The SHA-256 k=12 tape (6785 instructions, 108.6 KB of
// shared memory, 80 slots once its leaves are rematerialized) runs on 96
// slots, 384 KB a block, which spill from L1 to L2.  With
// H2T_TAPE_SLOTS_SHARED the slots are in shared memory instead, one word of
// one slot of the block's 128 rows side by side, so no two threads of a warp
// meet in a bank: measured slower on the H100, 1.395 against 1.255 ms for
// the RSA tape, and it refuses the SHA-256 tape, whose slots do not fit; so
// is the product as a called function (H2T_MONT_MUL_CALL: 2.077 ms for the
// RSA tape, 3.152 against 2.585 ms for the SHA-256 tape;
// tools/torch_kernel_variants.py quotient_forest).
#include <cuda_runtime.h>
#include "bn254.cuh"

using namespace bn254;

constexpr int QF_THREADS = 128;

template <int SLOTS> struct LocalSlots {
  Fe s[SLOTS];
  __device__ __forceinline__ Fe get(int i) const { return s[i]; }
  __device__ __forceinline__ void set(int i, const Fe& v) { s[i] = v; }
};

// base[(slot * 8 + word) * QF_THREADS] for this thread
struct SharedSlots {
  uint32_t* base;
  __device__ __forceinline__ Fe get(int i) const {
    Fe r;
#pragma unroll
    for (int w = 0; w < 8; ++w) r.w[w] = base[(i * 8 + w) * QF_THREADS];
    return r;
  }
  __device__ __forceinline__ void set(int i, const Fe& v) {
#pragma unroll
    for (int w = 0; w < 8; ++w) base[(i * 8 + w) * QF_THREADS] = v.w[w];
  }
};

template <int SLOTS>
__global__ void __launch_bounds__(QF_THREADS)
k_quotient_forest(const uint32_t* __restrict__ leaves, long long n_rows,
                  const uint32_t* __restrict__ consts,
                  const int32_t* __restrict__ tape, int T, int out_slot,
                  uint32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  for (int t = threadIdx.x; t < T; t += QF_THREADS)
    smem4[t] = reinterpret_cast<const int4*>(tape)[t];
  __syncthreads();
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
#if defined(H2T_TAPE_SLOTS_SHARED)
  SharedSlots slots = {reinterpret_cast<uint32_t*>(smem4 + T) + threadIdx.x};
#else
  LocalSlots<SLOTS> slots;
#endif
  Fe h = tape_eval_row(row, n_rows, leaves, consts,
                       reinterpret_cast<const int32_t*>(smem4), T, out_slot,
                       slots);
  store_fe_v(out + row * 8, h);
}

template <int SLOTS>
static int launch(const void* leaves, long long n_rows, const void* consts,
                  const void* tape, int T, int out_slot, void* out,
                  cudaStream_t s) {
  // the tape, and in the shared variant every row's slots, must fit the
  // shared memory a block may have; a tape that does not is an error, never
  // another form of the kernel
  long long smem = (long long)T * 16;
#if defined(H2T_TAPE_SLOTS_SHARED)
  smem += (long long)SLOTS * 32 * QF_THREADS;
#endif
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      k_quotient_forest<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_rows + QF_THREADS - 1) / QF_THREADS;
  k_quotient_forest<SLOTS><<<(unsigned)blocks, QF_THREADS, (size_t)smem, s>>>(
      (const uint32_t*)leaves, n_rows, (const uint32_t*)consts,
      (const int32_t*)tape, T, out_slot, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// num_slots: the slots the tape uses; it runs on the smallest instantiation
// that holds them (plonk/quotient.py SLOT_SIZES names the same sizes).
extern "C" int h2t_quotient_forest(const void* leaves, long long n_rows,
                                   const void* consts, const void* tape, int T,
                                   int num_slots, int out_slot, void* out,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define QF_TRY(N) \
  if (num_slots <= N) \
    return launch<N>(leaves, n_rows, consts, tape, T, out_slot, out, s);
  QF_TRY(8) QF_TRY(12) QF_TRY(17) QF_TRY(24) QF_TRY(32) QF_TRY(48)
  QF_TRY(TAPE_MAX_SLOTS)
  return (int)cudaErrorInvalidValue;
}

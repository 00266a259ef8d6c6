// dft_s8: one base DFT of the four-step transform (ops/ntt_mxu.py) on the
// H100's int8 tensor cores: Y[k, col] = sum_j W[k, j] X[j, col] mod p for
// radix r = 2^r_log over m columns, canonical words in and out.
//
// Replaces the base DFT of halo2_zkcert_tpu/ops/ntt_mxu.py `_dft_base`
// (:184, the s8 x s8 -> s32 `dot_general` at :193 on the TPU's MXU), which
// expanded the data into a digit tensor in device memory and took the
// (64 r, m) int32 product back out to device memory for its carries.  Here
// the product never leaves the block:
//
//   D[col, (k, l)] = sum_(j, l2) X[col, (j, l2)] * lhs[(k, l), (j, l2)]
//
// - Product: `wgmma.mma_async` m64n256k32 .s32.u8.s8.  A is the data, the
//   32 bytes of input element j of 64 columns as they lie in device memory
//   (unsigned, no digit pass), taken from shared memory into registers by
//   ldmatrix; B is the constant matrix lhs (rows (k, l), columns (j, l2),
//   balanced s8 digits) read by wgmma from shared memory, 256 rows = the 64
//   limbs of four output elements, interleaved (ops/ntt_mxu.py
//   `kernel_lhs`) so that lane q of each quad accumulates all 64 limbs of
//   the tile's element q.
// - Tile and pipeline: a tile is 4 output elements x 128 columns (DFT_TE x
//   DFT_TN, bn254.cuh dft_plan), two consumer warpgroups of 64 columns each
//   sharing the lhs tile.  One producer warp keeps DFT_STAGES steps in
//   flight in an mbarrier ring (full: the bytes have landed; empty: both
//   warpgroups' wgmmas that read the stage have retired); a step is 4 input
//   elements: the lhs box (256 rows x 128 bytes, 128-byte swizzle) and
//   the data of 128 columns x 4 x 32 bytes.
// - Loaders: TMA (cp.async.bulk.tensor).  The data's tensor map follows the
//   recursion's layout (m / cin, r, cin) x 32 bytes: one box a j of the
//   tile's columns in 32-byte rows, or, at cin = 1 (a column's elements
//   contiguous), one box a step of 128-byte rows, a column's four j.  The
//   loads set the pace, and the TMA engine's cost goes by rows as much as
//   by bytes: at cin = 1 the 32-byte rows took as long as the lhs's twice
//   the bytes (PERF.md, Findings).  A 128-byte row of four j is no K-major
//   tile that wgmma could read as A, so A goes through registers (ldmatrix,
//   conflict-free under either swizzle), in every layout alike.  Where a
//   box would leave its tensor, cp.async gathers by the producer warp into
//   the 32-byte-row layout with 32-bit index math and zero fill.
// - Epilogue: fused, in registers.  Each lane holds the 64 limbs of two
//   (element, column) pairs and carries each: the correction row (a
//   multiple of p), the carry into 17 words, the reduction in 253-bit chunks
//   (bn254.cuh dft_words_to_fe: one Montgomery reduction) and 8 canonical
//   words written at dft_addr(col, k, r, cout).  Nothing is staged in shared
//   memory, which holds DFT_STAGES steps instead.  The block is persistent
//   (one a SM), so the producer loads the next tile's first steps while the
//   consumers run this tile's epilogue; the tensor cores wait for it.
// Input element j of column col is read at dft_addr(col, j, r, cin), output
// k written at dft_addr(col, k, r, cout): the recursion's transpose between
// levels rides on these addresses.
//
// Bound on the H100: operations.  A level needs 2 * 33 * 32 * r int8
// operations an element (1979 T/s dense): of each 64 x 32 block (k, j) of
// lhs only the band of 33 digits a column is nonzero.  This kernel
// multiplies the whole block, 2 * 64 * 32 * r (1.94 times as many).
// Besides, a 256-bit Montgomery reduction and 80 word products an element,
// against 64 bytes an element moved.  What sets the pace on the card is
// neither: it is the loads of the boxes into shared memory (timed apart
// by tools/torch_kernel_variants.py ntt_mxu; PERF.md, Findings).
#include <cuda.h>
#include <cuda_runtime.h>
#include <string.h>
#include "bn254.cuh"

using namespace bn254;

constexpr int DFT_STAGES = 4;
constexpr int DFT_CONSUMERS = 2;  // warpgroups, then one producer warpgroup
// The register file is split among the SM's four quarters, warp w in
// quarter w % 4: with a whole producer warpgroup that gives its registers
// back (setmaxnreg), each quarter holds two consumer warps at 232 registers
// a thread and one producer warp at 40; without it, 168 for every warp,
// and the consumers spill (a third slower, PERF.md).
constexpr int DFT_THREADS = 128 * (DFT_CONSUMERS + 1);
constexpr int DFT_LHS_BYTES = DFT_TE * DFT_LIMBS * DFT_TJ * DFT_BYTES;  // 32 KB
constexpr int DFT_SLAB_BYTES = DFT_TN * DFT_BYTES;      // one j's data, 4 KB
constexpr int DFT_DATA_BYTES = DFT_TJ * DFT_SLAB_BYTES;
constexpr int DFT_STAGE_BYTES = DFT_LHS_BYTES + DFT_DATA_BYTES;
constexpr int DFT_SMEM = 1024 + DFT_STAGES * DFT_STAGE_BYTES +
                         2 * DFT_STAGES * 8;
static_assert(DFT_SMEM <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, const int c[4]) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c[0]), "r"(c[1]),
      "r"(c[2]), "r"(c[3])
      : "memory");
}

// 16 bytes global -> shared, zero-filled when `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// A wgmma shared-memory descriptor of a K-major operand in 128-byte rows
// under the 128-byte swizzle (layout 1): start address, leading offset 1
// (unused when swizzled), stride between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous product
__device__ __forceinline__ void fence_acc(uint32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// the accumulator of m64n256, 128 registers a lane, as asm operands
#define DFT_D_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"
#define DFT_D_OPERANDS \
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), \
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), \
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), \
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), \
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), \
      "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), \
      "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), \
      "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), \
      "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), \
      "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
      "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), \
      "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), \
      "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), \
      "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), \
      "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), \
      "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), \
      "+r"(d[125]), "+r"(d[126]), "+r"(d[127])

// D (64 columns x 256 limbs, s32) += A (64 x 32 u8, registers) * B (256 x
// 32 s8, shared memory)^T; scale 0 overwrites D
__device__ __forceinline__ void wgmma_rs(uint32_t (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.s8 " DFT_D_LIST
      ", {%128, %129, %130, %131}, %132, p;\n}\n"
      : DFT_D_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

// the tables and tensors; the geometry is bn254.cuh dft_plan(m, r_log, cin)
struct DftArgs {
  const int8_t* lhs;
  const int32_t* corr;
  const uint32_t* fold;
  const uint32_t* in;
  uint32_t* out;
  long long m, cin, cout;
  int r_log;
};

// The producer warp: steps of every tile of this block, in order.
__device__ __forceinline__ void dft_produce(const DftArgs& a,
                                            const CUtensorMap* lmap,
                                            const CUtensorMap* dmap,
                                            unsigned char* stages,
                                            uint64_t* full, uint64_t* empty,
                                            const DftPlan& plan) {
  const int lane = threadIdx.x & 31;
  const uint32_t r = (uint32_t)plan.r;
  const uint32_t K = DFT_BYTES * r;
  long long it = 0;
  for (long long t = blockIdx.x; t < plan.tiles; t += gridDim.x) {
    long long e0, col0;
    dft_tile(plan, t, &e0, &col0);
    for (long long s = 0; s < plan.steps; ++s, ++it) {
      const int st = (int)(it % DFT_STAGES);
      const uint32_t ph = (uint32_t)(it / DFT_STAGES) & 1;
      const uint32_t fb = smem_addr(full + st), eb = smem_addr(empty + st);
      unsigned char* lhs_s = stages + st * DFT_STAGE_BYTES;
      unsigned char* dat_s = lhs_s + DFT_LHS_BYTES;
      mbar_wait(eb, ph ^ 1);
      if (plan.loader != DFT_CP_ASYNC) {
        if (lane == 0) {
          mbar_expect_tx(fb, DFT_STAGE_BYTES);
          int c[4];
          dft_lhs_coord(e0, s, c);
          tma_load_2d(smem_addr(lhs_s), lmap, fb, c[0], c[1]);
          const int boxes = plan.loader == DFT_TMA_J ? 1 : DFT_TJ;
          for (int jj = 0; jj < boxes; ++jj) {
            dft_data_coord(plan, col0, (int)(s * DFT_TJ + jj), c);
            tma_load_4d(smem_addr(dat_s + jj * DFT_SLAB_BYTES), dmap, fb, c);
          }
        }
        continue;
      }
      // cp.async gathers, the same boxes in the same swizzled layouts
      const uint32_t row0 = (uint32_t)e0 * DFT_LIMBS;
      const uint32_t k0 = (uint32_t)s * DFT_TJ * DFT_BYTES;
      for (int idx = lane; idx < DFT_TE * DFT_LIMBS * 8; idx += 32) {
        const uint32_t row = idx >> 3, c = idx & 7, kb = k0 + 16 * c;
        const bool ok = kb < K;  // the kernel's lhs holds whole groups
        cp_async16(smem_addr(lhs_s + row * 128 + ((c ^ (row & 7)) << 4)),
                   ok ? a.lhs + (size_t)(row0 + row) * K + kb : a.lhs, ok);
      }
      const uint32_t m32 = (uint32_t)a.m, cin = (uint32_t)a.cin;
#pragma unroll 1
      for (int jj = 0; jj < DFT_TJ; ++jj) {
        const uint32_t j = (uint32_t)s * DFT_TJ + jj;
        for (int idx = lane; idx < DFT_TN * 2; idx += 32) {
          const uint32_t n = idx >> 1, c = idx & 1;
          const uint32_t col = (uint32_t)col0 + n;
          const bool ok = j < r && col < m32;
          const size_t el =
              ok ? ((size_t)(col / cin) * r + j) * cin + col % cin : 0;
          cp_async16(
              smem_addr(dat_s + dft_data_offset(DFT_CP_ASYNC, n, jj, c)),
              a.in + el * 8 + 4 * c, ok);
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(fb);
    }
  }
}

// A consumer warpgroup: columns [64 wg, 64 wg + 64) of every tile.
__device__ __forceinline__ void dft_consume(const DftArgs& a,
                                            unsigned char* stages,
                                            uint64_t* full, uint64_t* empty,
                                            const DftPlan& plan) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // the column whose row address this lane gives ldmatrix
  const uint32_t arow = 64 * wg + 16 * warp + 8 * ((lane >> 3) & 1) +
                        (lane & 7);
  uint32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  const uint32_t r = (uint32_t)plan.r, cout = (uint32_t)a.cout;
  long long it = 0;
  for (long long t = blockIdx.x; t < plan.tiles; t += gridDim.x) {
    long long e0, col0;
    dft_tile(plan, t, &e0, &col0);
    for (long long s = 0; s < plan.steps; ++s, ++it) {
      const int st = (int)(it % DFT_STAGES);
      mbar_wait(smem_addr(full + st), (uint32_t)(it / DFT_STAGES) & 1);
      __syncwarp();
      const uint32_t lhs_s = smem_addr(stages + st * DFT_STAGE_BYTES);
      const uint32_t dat_s = lhs_s + DFT_LHS_BYTES;
      // A fragments: ldmatrix x4, matrix i = rows 8 (i & 1) .. + 7 of the
      // warp's 16 columns, bytes 16 (i >> 1) .. + 15 of the j
      uint32_t af[DFT_TJ][4];
#pragma unroll
      for (int jj = 0; jj < DFT_TJ; ++jj)
        ldmatrix_x4(af[jj], dat_s + dft_data_offset(plan.loader, arow, jj,
                                                    lane >> 4));
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < DFT_TJ; ++jj)
        wgmma_rs(d, af[jj], wgmma_desc(lhs_s + jj * DFT_BYTES, 1024),
                 (s > 0 || jj > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();  // the fragments' registers are read until then
      fence_acc(d);
#pragma unroll
      for (int jj = 0; jj < DFT_TJ; ++jj) fence_frag(af[jj]);
      if (lane == 0) mbar_arrive(smem_addr(empty + st));
    }

    // epilogue: lane (quad q) holds, of element e0 + q and of column
    // 16 warp + lane / 4 + 8 h, limb 2 i + b in d[4 i + 2 h + b].  Both
    // columns are carried and reduced in one block of straight-line code,
    // so that the two reductions' independent products interleave.
    const uint32_t k = (uint32_t)e0 + (lane & 3);
    if (k < r) {
      const int4* corr =
          reinterpret_cast<const int4*>(a.corr + k * DFT_LIMBS);
      uint32_t v[2][17];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t acc = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {  // limbs 4 i .. 4 i + 3
          const int4 c = __ldg(corr + i);
          acc += (uint64_t)(d[8 * i + 2 * h] + (uint32_t)c.x);
          acc += (uint64_t)(d[8 * i + 2 * h + 1] + (uint32_t)c.y) << 8;
          acc += (uint64_t)(d[8 * i + 4 + 2 * h] + (uint32_t)c.z) << 16;
          acc += (uint64_t)(d[8 * i + 4 + 2 * h + 1] + (uint32_t)c.w) << 24;
          v[h][i] = (uint32_t)acc;
          acc >>= 32;
        }
        v[h][16] = (uint32_t)acc;
      }
      const Fe f253 = load_fe(a.fold), f506 = load_fe(a.fold + 8);
      const Fe x[2] = {dft_words_to_fe(v[0], f253, f506),
                       dft_words_to_fe(v[1], f253, f506)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t col =
            (uint32_t)col0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
        if (col < (uint32_t)a.m)
          store_fe_v(a.out + (((size_t)(col / cout) * r + k) * cout +
                              col % cout) * 8,
                     x[h]);
      }
    }
    __syncwarp();  // the next tile's wgmmas are warp-synchronous
  }
}

__global__ void __launch_bounds__(DFT_THREADS, 1)
k_dft_s8(const __grid_constant__ CUtensorMap lmap,
         const __grid_constant__ CUtensorMap dmap, const DftArgs a) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles start on 1024-byte boundaries of the shared window
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* stages = smem_raw + (((base + 1023) & ~1023u) - base);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + DFT_STAGES * DFT_STAGE_BYTES);
  uint64_t* empty = full + DFT_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DFT_STAGES; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), 4 * DFT_CONSUMERS);  // a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const DftPlan plan = dft_plan(a.m, a.r_log, a.cin);
  if (threadIdx.x >= 128 * DFT_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x < 128 * DFT_CONSUMERS + 32)
      dft_produce(a, &lmap, &dmap, stages, full, empty, plan);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    dft_consume(a, stages, full, empty, plan);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: taken through the runtime's
// entry point, so the library needs no link to libcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the launch geometry, for the log: [loader, element tiles, column tiles,
// tiles, steps a tile, blocks, bytes of the boxes (planned from the tile
// shape), shared bytes]
extern "C" int h2t_dft_s8_plan(long long m, int r_log, long long cin,
                               long long* out) {
  const DftPlan p = dft_plan(m, r_log, cin);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = p.loader;
  out[1] = p.etiles;
  out[2] = p.ctiles;
  out[3] = p.tiles;
  out[4] = p.steps;
  out[5] = p.tiles < sms ? p.tiles : sms;
  out[6] = p.tiles * p.steps * (long long)DFT_STAGE_BYTES;
  out[7] = DFT_SMEM;
  return 0;
}

// One base DFT: lhs (64 r, 32 r) s8, corr (r, 64) s32, fold the two words
// 2^253 R and 2^506 R mod p, `in` and `out` m * r canonical elements in the
// layouts of column strides cin and cout.
extern "C" int h2t_dft_s8(const void* lhs, const void* corr, const void* fold,
                          const void* in, void* out, long long m, int r_log,
                          long long cin, long long cout, void* stream) {
  if (m <= 0) return 0;
  if (r_log < 1 || r_log > 8 || cin <= 0 || cout <= 0 || m % cin ||
      m % cout || m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  static bool configured[64] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !configured[dev]) {
    err = cudaFuncSetAttribute(
        k_dft_s8, cudaFuncAttributeMaxDynamicSharedMemorySize, DFT_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const DftPlan p = dft_plan(m, r_log, cin);
  CUtensorMap lmap, dmap;
  memset(&lmap, 0, sizeof lmap);
  memset(&dmap, 0, sizeof dmap);
  if (p.loader != DFT_CP_ASYNC) {
    EncodeTiled enc = encode_tiled();
    if (!enc) return (int)cudaErrorNotSupported;
    const cuuint32_t one[4] = {1, 1, 1, 1};
    CUresult cr = enc(&lmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                      const_cast<void*>(lhs), p.ldims, &p.lstride, p.lbox, one,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (cr != CUDA_SUCCESS) return 1000 + (int)cr;
    cr = enc(&dmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(in),
             p.ddims, p.dstrides, p.dbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             p.loader == DFT_TMA_J ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (cr != CUDA_SUCCESS) return 2000 + (int)cr;
  }
  DftArgs a;
  a.lhs = (const int8_t*)lhs;
  a.corr = (const int32_t*)corr;
  a.fold = (const uint32_t*)fold;
  a.in = (const uint32_t*)in;
  a.out = (uint32_t*)out;
  a.m = m;
  a.cin = cin;
  a.cout = cout;
  a.r_log = r_log;
  const long long blocks = p.tiles < sms ? p.tiles : sms;
  k_dft_s8<<<(unsigned)blocks, DFT_THREADS, DFT_SMEM, (cudaStream_t)stream>>>(
      lmap, dmap, a);
  return (int)cudaGetLastError();
}

// BN254 field and G1 arithmetic shared by every kernel of the port.
//
// Elements are 8 little-endian 32-bit words.  Values cross a kernel's
// boundary in CANONICAL form (< p); inside a kernel they live in Montgomery
// form (x * 2^256 mod p) and are multiplied with CIOS Montgomery
// multiplication on 32-bit words with 64-bit products.  A PTX carry chain
// (mad.lo.cc / madc.hi) is later work.
//
// Every function is __host__ __device__, so the same code also builds with
// a host C++ compiler (tests/test_torch_csrc_host.py checks it against the
// Python-int oracle without a GPU).
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define H2T_HD __host__ __device__ __forceinline__
#else
#define H2T_HD inline
#endif

// The Montgomery product is some hundreds of instructions.  A kernel that
// inlines a dozen of them at each of several call sites outgrows the SM's
// instruction cache and stalls on fetches; a source that defines
// H2T_MONT_MUL_CALL before including this header gets the product as one
// real function a field instead, called with its operands in registers.
#if defined(__CUDACC__) && defined(H2T_MONT_MUL_CALL)
#define H2T_MUL_HD __host__ __device__ __noinline__
#else
#define H2T_MUL_HD H2T_HD
#endif

namespace bn254 {

enum FieldId { FR = 0, FQ = 1 };
// OP_MULM is the bare Montgomery product a * b * 2^-256: with b stored as
// v * 2^256 (a table, a constant) it is the canonical a * v in one product.
enum BinOp { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_MULM = 3 };

struct Fe {
  uint32_t w[8];
};

// Per-field constants: modulus words, -p^-1 mod 2^32, 2^512 mod p.
template <int F> struct Mod;

template <> struct Mod<FR> {
  H2T_HD static uint32_t p(int i) {
    const uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  H2T_HD static uint32_t r2(int i) {
    const uint32_t v[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                           0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
    return v[i];
  }
  static const uint32_t pinv = 0xefffffffu;
};

template <> struct Mod<FQ> {
  H2T_HD static uint32_t p(int i) {
    const uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  H2T_HD static uint32_t r2(int i) {
    const uint32_t v[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
                           0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};
    return v[i];
  }
  static const uint32_t pinv = 0xe4866389u;
};

H2T_HD Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}

// r = t - p if t >= p (t given as 8 words plus a carry word), else t.
template <int F> H2T_HD Fe cond_sub_p(const uint32_t t[8], uint32_t top) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t diff = (uint64_t)t[i] - Mod<F>::p(i) - borrow;
    d.w[i] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 63);
  }
  bool keep = (top == 0) && borrow;  // t < p
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = keep ? t[i] : d.w[i];
  return r;
}

template <int F> H2T_HD Fe fadd(const Fe& a, const Fe& b) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  return cond_sub_p<F>(t, (uint32_t)c);
}

template <int F> H2T_HD Fe fsub(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t diff = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 63);
  }
  if (borrow) {  // a < b: add p back
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t s = (uint64_t)d.w[i] + Mod<F>::p(i) + c;
      d.w[i] = (uint32_t)s;
      c = s >> 32;
    }
  }
  return d;
}

// CIOS Montgomery product a * b * 2^-256 mod p, for a, b < p.
template <int F> H2T_MUL_HD Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * Mod<F>::pinv;
    s = (uint64_t)m * Mod<F>::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * Mod<F>::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  return cond_sub_p<F>(t, t[8]);
}

template <int F> H2T_HD Fe to_mont(const Fe& a) {
  Fe r2;
#pragma unroll
  for (int i = 0; i < 8; ++i) r2.w[i] = Mod<F>::r2(i);
  return mont_mul<F>(a, r2);
}

template <int F> H2T_HD Fe from_mont(const Fe& a) {
  Fe one = fe_zero();
  one.w[0] = 1;
  return mont_mul<F>(a, one);
}

// Canonical product: (a * b * 2^-256) * 2^512 * 2^-256 = a * b.
template <int F> H2T_HD Fe fmul_canon(const Fe& a, const Fe& b) {
  return to_mont<F>(mont_mul<F>(a, b));
}

template <int F, int OP> H2T_HD Fe binop_canon(const Fe& a, const Fe& b) {
  if (OP == OP_MUL) return fmul_canon<F>(a, b);
  if (OP == OP_MULM) return mont_mul<F>(a, b);
  if (OP == OP_ADD) return fadd<F>(a, b);
  return fsub<F>(a, b);
}

// ---------------------------------------------------------------------------
// G1: y^2 = x^3 + 3 over Fq, homogeneous projective (X, Y, Z), identity
// (0, 1, 0).  Renes-Costello-Batina 2015/1060 complete formulas for a = 0,
// b3 = 3 * b = 9.  The *_mont functions take and return Montgomery form.
// ---------------------------------------------------------------------------

struct Pt {
  Fe x, y, z;
};

H2T_HD Fe fq_times3(const Fe& a) { return fadd<FQ>(fadd<FQ>(a, a), a); }
H2T_HD Fe fq_times9(const Fe& a) { return fq_times3(fq_times3(a)); }

// Algorithm 7: complete addition, 12M.
H2T_HD Pt point_add_mont(const Pt& P, const Pt& Q) {
  Fe t0 = mont_mul<FQ>(P.x, Q.x);
  Fe t1 = mont_mul<FQ>(P.y, Q.y);
  Fe t2 = mont_mul<FQ>(P.z, Q.z);
  Fe t3 = mont_mul<FQ>(fadd<FQ>(P.x, P.y), fadd<FQ>(Q.x, Q.y));
  t3 = fsub<FQ>(t3, fadd<FQ>(t0, t1));
  Fe t4 = mont_mul<FQ>(fadd<FQ>(P.y, P.z), fadd<FQ>(Q.y, Q.z));
  t4 = fsub<FQ>(t4, fadd<FQ>(t1, t2));
  Fe x3 = mont_mul<FQ>(fadd<FQ>(P.x, P.z), fadd<FQ>(Q.x, Q.z));
  Fe y3 = fsub<FQ>(x3, fadd<FQ>(t0, t2));
  t0 = fq_times3(t0);
  t2 = fq_times9(t2);
  Fe z3 = fadd<FQ>(t1, t2);
  t1 = fsub<FQ>(t1, t2);
  y3 = fq_times9(y3);
  Pt R;
  R.x = fsub<FQ>(mont_mul<FQ>(t3, t1), mont_mul<FQ>(t4, y3));
  R.y = fadd<FQ>(mont_mul<FQ>(t1, z3), mont_mul<FQ>(y3, t0));
  R.z = fadd<FQ>(mont_mul<FQ>(z3, t4), mont_mul<FQ>(t0, t3));
  return R;
}

// Algorithm 9: complete doubling, 6M + 2S.
H2T_HD Pt point_double_mont(const Pt& P) {
  Fe t0 = mont_mul<FQ>(P.y, P.y);
  Fe z3 = fadd<FQ>(t0, t0);
  z3 = fadd<FQ>(z3, z3);
  z3 = fadd<FQ>(z3, z3);  // 8 Y^2
  Fe t1 = mont_mul<FQ>(P.y, P.z);
  Fe t2 = fq_times9(mont_mul<FQ>(P.z, P.z));
  Fe x3 = mont_mul<FQ>(t2, z3);
  Fe y3 = fadd<FQ>(t0, t2);
  z3 = mont_mul<FQ>(t1, z3);
  t2 = fq_times3(t2);
  t0 = fsub<FQ>(t0, t2);
  y3 = mont_mul<FQ>(t0, y3);
  y3 = fadd<FQ>(x3, y3);
  t1 = mont_mul<FQ>(P.x, P.y);
  x3 = mont_mul<FQ>(t0, t1);
  Pt R;
  R.x = fadd<FQ>(x3, x3);
  R.y = y3;
  R.z = z3;
  return R;
}

// Algorithm 8: complete mixed addition P + (x2, y2, 1), 11M.  Complete in P
// (identity, doubling and inverse included); (x2, y2) must be a curve point,
// never the (0, 0) that stands for the identity in affine tables.
H2T_HD Pt point_madd_mont(const Pt& P, const Fe& x2, const Fe& y2) {
  Fe t0 = mont_mul<FQ>(P.x, x2);
  Fe t1 = mont_mul<FQ>(P.y, y2);
  Fe t3 = mont_mul<FQ>(fadd<FQ>(P.x, P.y), fadd<FQ>(x2, y2));
  t3 = fsub<FQ>(t3, fadd<FQ>(t0, t1));               // X1 Y2 + X2 Y1
  Fe t4 = fadd<FQ>(mont_mul<FQ>(x2, P.z), P.x);      // X1 Z2 + X2 Z1
  Fe t5 = fadd<FQ>(mont_mul<FQ>(y2, P.z), P.y);      // Y1 Z2 + Y2 Z1
  t0 = fq_times3(t0);
  Fe t2 = fq_times9(P.z);                            // b3 Z1 Z2
  Fe z3 = fadd<FQ>(t1, t2);
  t1 = fsub<FQ>(t1, t2);
  Fe y3 = fq_times9(t4);
  Pt R;
  R.x = fsub<FQ>(mont_mul<FQ>(t3, t1), mont_mul<FQ>(t5, y3));
  R.y = fadd<FQ>(mont_mul<FQ>(t1, z3), mont_mul<FQ>(y3, t0));
  R.z = fadd<FQ>(mont_mul<FQ>(z3, t5), mont_mul<FQ>(t0, t3));
  return R;
}

H2T_HD Pt pt_to_mont(const Pt& P) {
  Pt R;
  R.x = to_mont<FQ>(P.x);
  R.y = to_mont<FQ>(P.y);
  R.z = to_mont<FQ>(P.z);
  return R;
}

H2T_HD Pt pt_from_mont(const Pt& P) {
  Pt R;
  R.x = from_mont<FQ>(P.x);
  R.y = from_mont<FQ>(P.y);
  R.z = from_mont<FQ>(P.z);
  return R;
}

H2T_HD Pt point_add_canon(const Pt& P, const Pt& Q) {
  return pt_from_mont(point_add_mont(pt_to_mont(P), pt_to_mont(Q)));
}

H2T_HD Pt point_double_canon(const Pt& P) {
  return pt_from_mont(point_double_mont(pt_to_mont(P)));
}

H2T_HD Pt point_madd_canon(const Pt& P, const Fe& x2, const Fe& y2) {
  return pt_from_mont(
      point_madd_mont(pt_to_mont(P), to_mont<FQ>(x2), to_mont<FQ>(y2)));
}

// ---------------------------------------------------------------------------
// Quotient tape: a straight-line program over numbered slots, evaluated
// once per extended-domain row.  Each instruction is 4 int32:
//   (TAPE_LOAD, dst, column, row offset)  leaf column read at (row + off) mod n
//   (TAPE_CONST, dst, index, 0)           constant or challenge
//   (TAPE_ADD|TAPE_SUB|TAPE_MUL, dst, a, b)
// Fr only.  Leaves, constants, slots and the result are all in Montgomery
// form: nothing is converted per row, a MUL is one product and the row costs
// exactly the tape's MUL count.  `Slots` is where a row keeps its slots
// (get(i), set(i, v)): an array on the host, local or shared memory in the
// kernel (quotient_forest.cu).
// ---------------------------------------------------------------------------

enum TapeOp { TAPE_LOAD = 0, TAPE_CONST = 1, TAPE_ADD = 2, TAPE_SUB = 3,
              TAPE_MUL = 4 };

// The largest slot count a kernel is built for: quotient_forest.cu
// instantiates 8, 12, 17, 24, 32, 48 and this (plonk/quotient.py
// SLOT_SIZES).  The SHA-256 tape needs 80 slots once its leaves are
// rematerialized: 2.5 KB a row in local memory, which the L1 and L2 caches
// hold; in shared memory 96 slots of 128 rows (384 KB) would not fit a block.
static const int TAPE_MAX_SLOTS = 96;

H2T_HD Fe load_fe(const uint32_t* src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = src[i];
  return r;
}

H2T_HD void store_fe(uint32_t* dst, const Fe& v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = v.w[i];
}

// The *_v forms move 16 bytes at a time in device code (every element a
// kernel addresses starts on a 16-byte boundary, in device memory and in the
// shared-memory tiles); on the host they are word loops.
H2T_HD Fe load_fe_v(const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint4 lo = q[0], hi = q[1];
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
#else
  return load_fe(src);
#endif
}

H2T_HD void store_fe_v(uint32_t* dst, const Fe& v) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(dst);
  q[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  q[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
#else
  store_fe(dst, v);
#endif
}

// leaves: (num_cols, n_rows, 8); consts: (num_consts, 8); tape: (T, 4).
template <class Slots>
H2T_HD Fe tape_eval_row(long long row, long long n_rows, const uint32_t* leaves,
                        const uint32_t* consts, const int32_t* tape, int T,
                        int out_slot, Slots& slots) {
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int32_t op = tape[4 * t], dst = tape[4 * t + 1];
    const int32_t a = tape[4 * t + 2], b = tape[4 * t + 3];
    Fe v;
    if (op == TAPE_LOAD) {
      long long r = (row + b) & (n_rows - 1);
      v = load_fe_v(leaves + ((long long)a * n_rows + r) * 8);
    } else if (op == TAPE_CONST) {
      v = load_fe_v(consts + (long long)a * 8);
    } else if (op == TAPE_ADD) {
      v = fadd<FR>(slots.get(a), slots.get(b));
    } else if (op == TAPE_SUB) {
      v = fsub<FR>(slots.get(a), slots.get(b));
    } else {
      v = mont_mul<FR>(slots.get(a), slots.get(b));
    }
    slots.set(dst, v);
  }
  return slots.get(out_slot);
}

// ---------------------------------------------------------------------------
// Points in memory: 24 canonical words (X, Y, Z), affine table points 16
// (x, y), moved 16 bytes at a time like field elements.
// ---------------------------------------------------------------------------

H2T_HD Pt load_pt_v(const uint32_t* src) {
  Pt r;
  r.x = load_fe_v(src);
  r.y = load_fe_v(src + 8);
  r.z = load_fe_v(src + 16);
  return r;
}

H2T_HD void store_pt_v(uint32_t* dst, const Pt& v) {
  store_fe_v(dst, v.x);
  store_fe_v(dst + 8, v.y);
  store_fe_v(dst + 16, v.z);
}

H2T_HD Fe fq_one_mont() {
  Fe one = fe_zero();
  one.w[0] = 1;
  return to_mont<FQ>(one);
}

// The identity (0, 1, 0) in Montgomery form.
H2T_HD Pt pt_identity_mont() {
  Pt r;
  r.x = fe_zero();
  r.y = fq_one_mont();
  r.z = fe_zero();
  return r;
}

// ---------------------------------------------------------------------------
// The blocked scan of projective points (point_scan.cu): what one thread
// does on its run of `cnt` consecutive points, 24 words each at `p`.
//
// scan_run_local: canonical points -> in place, their inclusive prefixes
// within the run in Montgomery form (one conversion in a point, cnt - 1
// additions); returns the run's total, the identity for an empty run.
// scan_run_apply: prefix k -> canonical off + prefix k (one addition and one
// conversion out a point).  `off`, the sum of everything before the run,
// comes from the totals of the other runs.
// point_sum_strided: the reduce half, the sum of `cnt` canonical points
// `stride` words apart, in Montgomery form.
// ---------------------------------------------------------------------------

H2T_HD Pt scan_run_local(uint32_t* p, int cnt) {
  if (cnt <= 0) return pt_identity_mont();
  Pt acc = pt_to_mont(load_pt_v(p));
  store_pt_v(p, acc);
#pragma unroll 1
  for (int k = 1; k < cnt; ++k) {
    acc = point_add_mont(acc, pt_to_mont(load_pt_v(p + 24 * k)));
    store_pt_v(p + 24 * k, acc);
  }
  return acc;
}

H2T_HD void scan_run_apply(uint32_t* p, int cnt, const Pt& off) {
#pragma unroll 1
  for (int k = 0; k < cnt; ++k)
    store_pt_v(p + 24 * k,
               pt_from_mont(point_add_mont(off, load_pt_v(p + 24 * k))));
}

H2T_HD Pt point_sum_strided(const uint32_t* p, long long stride,
                            long long cnt) {
  if (cnt <= 0) return pt_identity_mont();
  Pt acc = pt_to_mont(load_pt_v(p));
#pragma unroll 1
  for (long long k = 1; k < cnt; ++k)
    acc = point_add_mont(acc, pt_to_mont(load_pt_v(p + stride * k)));
  return acc;
}

// ---------------------------------------------------------------------------
// The blocked scan of AFFINE points (point_scan.cu, k_point_scan_affine and
// k_point_reduce_affine): the same run routines over canonical (x, y) pairs,
// (0, 0) read as the identity, combined by mixed additions (RCB16 Alg. 8).
// scan_run_local_affine reads the pair from the first 16 words of each of
// `cnt` slots of 24 words at `p` and writes the run's prefix there, 24 words
// in Montgomery form, for scan_run_apply; point_sum_strided_affine sums
// `cnt` pairs `stride` words apart.  Run totals and everything after them
// are projective.
// ---------------------------------------------------------------------------

H2T_HD bool affine_is_identity(const Fe& x, const Fe& y) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) any |= x.w[i] | y.w[i];
  return any == 0;
}

// acc + (x, y) for a canonical pair; the pair (0, 0) leaves acc as it is.
H2T_HD Pt point_madd_affine(const Pt& acc, const uint32_t* xy) {
  const Fe x = load_fe_v(xy), y = load_fe_v(xy + 8);
  if (affine_is_identity(x, y)) return acc;
  return point_madd_mont(acc, to_mont<FQ>(x), to_mont<FQ>(y));
}

// A canonical pair as a projective point in Montgomery form, Z = 1.
H2T_HD Pt point_lift_affine(const uint32_t* xy) {
  const Fe x = load_fe_v(xy), y = load_fe_v(xy + 8);
  if (affine_is_identity(x, y)) return pt_identity_mont();
  Pt r;
  r.x = to_mont<FQ>(x);
  r.y = to_mont<FQ>(y);
  r.z = fq_one_mont();
  return r;
}

H2T_HD Pt scan_run_local_affine(uint32_t* p, int cnt) {
  if (cnt <= 0) return pt_identity_mont();
  Pt acc = point_lift_affine(p);
  store_pt_v(p, acc);
#pragma unroll 1
  for (int k = 1; k < cnt; ++k) {
    acc = point_madd_affine(acc, p + 24 * k);
    store_pt_v(p + 24 * k, acc);
  }
  return acc;
}

H2T_HD Pt point_sum_strided_affine(const uint32_t* p, long long stride,
                                   long long cnt) {
  if (cnt <= 0) return pt_identity_mont();
  Pt acc = point_lift_affine(p);
#pragma unroll 1
  for (long long k = 1; k < cnt; ++k)
    acc = point_madd_affine(acc, p + stride * k);
  return acc;
}

// ---------------------------------------------------------------------------
// Chains of the group law kept in registers (point_chain.cu): one thread
// carries one chain in Montgomery form from its first load to its last store.
//
// point_windows_chain: P (canonical, 24 words at p) -> out + w * wstride =
//   2^(c w) P for w < nwin, canonical; window 0 is P as given, each later
//   one c doublings (RCB16 Alg. 9) of the one before.
// point_horner_chain: sum_w 2^(c w) W_w of nwin canonical points, W_w at
//   win + w * wstride, from the top window down: acc = identity, then for
//   w = nwin - 1 .. 0, c doublings (none before the first window) and one
//   addition (RCB16 Alg. 7).  Returned in Montgomery form.
// point_fixed_mul_chain: s * G for a canonical scalar s (8 words at s),
//   sum over its 32 bytes d_w of table[w][d_w], a table of 32 x 256 affine
//   pairs in MONTGOMERY form (table[w][d] = d 2^(8w) G; row 0 unused): one
//   mixed addition a nonzero byte, from window 0 up; a zero byte adds
//   nothing (the formula needs a point that is not the identity).  Returned
//   in Montgomery form.
// ---------------------------------------------------------------------------

H2T_HD Pt point_double_n_mont(Pt acc, int c) {
#pragma unroll 1
  for (int i = 0; i < c; ++i) acc = point_double_mont(acc);
  return acc;
}

H2T_HD void point_windows_chain(const uint32_t* p, int c, int nwin,
                                uint32_t* out, long long wstride) {
  const Pt P = load_pt_v(p);
  store_pt_v(out, P);
  Pt acc = pt_to_mont(P);
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
    acc = point_double_n_mont(acc, c);
    store_pt_v(out + wstride * w, pt_from_mont(acc));
  }
}

H2T_HD Pt point_horner_chain(const uint32_t* win, long long wstride, int c,
                             int nwin) {
  Pt acc = pt_identity_mont();
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; --w) {
    if (w < nwin - 1) acc = point_double_n_mont(acc, c);
    acc = point_add_mont(acc, pt_to_mont(load_pt_v(win + wstride * w)));
  }
  return acc;
}

static const int FIXED_WINDOWS = 32;   // 8-bit digits of a 256-bit scalar

H2T_HD Pt point_fixed_mul_chain(const uint32_t* table, const uint32_t* s) {
  Pt acc = pt_identity_mont();
#pragma unroll 1
  for (int w = 0; w < FIXED_WINDOWS; ++w) {
    const uint32_t d = (s[w >> 2] >> (8 * (w & 3))) & 0xffu;
    if (d == 0) continue;
    const uint32_t* q = table + ((long long)w * 256 + d) * 16;
    acc = point_madd_mont(acc, load_fe_v(q), load_fe_v(q + 8));
  }
  return acc;
}

// ---------------------------------------------------------------------------
// One row of the mixed-add prefix scan (scan_madd.cu): C canonical affine
// points (x, y), 16 words each, -> canonical projective inclusive prefixes,
// 24 words each.  The running sum stays in Montgomery form across all C - 1
// mixed additions; a prefix is converted out only where it is stored.
//
// Without digits every prefix is stored.  With the row's sorted digits a
// prefix is stored only where the next pair of the row has another digit,
// and at the row's end: the slots a bucket extraction reads.  A prefix is
// stored one step late, when the next pair's digit is known.
// ---------------------------------------------------------------------------

struct MaddRun {
  Pt acc;
  int32_t digit;
};

H2T_HD MaddRun madd_run_begin(const uint32_t* xy, int32_t digit) {
  MaddRun run;
  run.acc.x = to_mont<FQ>(load_fe_v(xy));
  run.acc.y = to_mont<FQ>(load_fe_v(xy + 8));
  run.acc.z = fq_one_mont();
  run.digit = digit;
  return run;
}

// Pair j of the row: store prefix j - 1 at `prev_dst` if it is wanted, then
// add the pair's point.
H2T_HD void madd_run_step(MaddRun& run, const uint32_t* xy, int32_t digit,
                          bool dense, uint32_t* prev_dst) {
  if (dense || digit != run.digit) store_pt_v(prev_dst, pt_from_mont(run.acc));
  Fe x = to_mont<FQ>(load_fe_v(xy)), y = to_mont<FQ>(load_fe_v(xy + 8));
  run.acc = point_madd_mont(run.acc, x, y);
  run.digit = digit;
}

H2T_HD void madd_run_end(const MaddRun& run, uint32_t* last_dst) {
  store_pt_v(last_dst, pt_from_mont(run.acc));
}

// `digits` may be null: every prefix is stored.
H2T_HD void scan_madd_row(const uint32_t* src, const int32_t* digits,
                          uint32_t* dst, int C) {
  const bool dense = digits == nullptr;
  MaddRun run = madd_run_begin(src, dense ? 0 : digits[0]);
#pragma unroll 1
  for (int j = 1; j < C; ++j)
    madd_run_step(run, src + 16 * j, dense ? 0 : digits[j], dense,
                  dst + 24 * (j - 1));
  madd_run_end(run, dst + 24 * (C - 1));
}

// ---------------------------------------------------------------------------
// The NTT in passes over a tile (ntt.cu).  A length-2^k transform over Fr is
// k radix-2 decimation-in-time stages on the bit-reversed input; stage s
// pairs positions p and p + 2^s and multiplies the upper one by
// w^((p mod 2^s) << (k - 1 - s)).  A pass does stages s0 .. s0 + t - 1 on
// tiles that hold every position differing only in bits s0 .. s0 + t - 1,
// for 2^a neighbouring values of the bits below s0 (a = 0 in the first
// pass, which has none), so a tile is 2^(t + a) elements:
//   position = high << (s0 + t) | c << s0 | lowblk << a | ls,
//   tile = high << (s0 - a) | lowblk,   element i = c << a | ls.
// The first pass reads position p from in[brev_k(p)], zero at or past the
// input's length, times in_scale[that index mod its period] if given; later
// passes read what the pass before wrote.  The last pass multiplies position
// p by out_scale[p mod its period] if given.  A period is a power of two (1
// for a scalar).  Twiddles and scale tables are
// stored times 2^256, so every product is one mont_mul on the data as it is.
//
// A tile lies in memory as two planes of 16-byte halves, `cap` elements
// each, so that neighbouring threads touch neighbouring banks.
// ---------------------------------------------------------------------------

struct NttPass {
  int k, s0, t, a;
};

H2T_HD long long ntt_tile_pos(const NttPass& ps, long long tile, int i) {
  const long long lowblk = tile & ((1LL << (ps.s0 - ps.a)) - 1);
  const long long high = tile >> (ps.s0 - ps.a);
  const long long c = i >> ps.a, ls = i & ((1 << ps.a) - 1);
  return (high << (ps.s0 + ps.t)) | (c << ps.s0) | (lowblk << ps.a) | ls;
}

H2T_HD long long ntt_bitrev(long long p, int k) {
  long long r = 0;
#if defined(__CUDA_ARCH__)
  r = k ? (long long)(__brev((unsigned)p) >> (32 - k)) : 0;
#else
  for (int b = 0; b < k; ++b) r |= ((p >> b) & 1) << (k - 1 - b);
#endif
  return r;
}

H2T_HD Fe tile_ld(const uint32_t* tile, int cap, int i) {
  Fe r;
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(tile);
  uint4 lo = q[i], hi = q[cap + i];
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
#else
  for (int w = 0; w < 4; ++w) {
    r.w[w] = tile[4 * i + w];
    r.w[4 + w] = tile[4 * (cap + i) + w];
  }
#endif
  return r;
}

H2T_HD void tile_st(uint32_t* tile, int cap, int i, const Fe& v) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(tile);
  q[i] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  q[cap + i] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
#else
  for (int w = 0; w < 4; ++w) {
    tile[4 * i + w] = v.w[w];
    tile[4 * (cap + i) + w] = v.w[4 + w];
  }
#endif
}

// Tile element i on its way in.  `in` is the column's input (first pass),
// `out` the column's 2^k positions.
H2T_HD Fe ntt_load(const NttPass& ps, long long tile, int i,
                   const uint32_t* in, long long n_in, const uint32_t* out,
                   const uint32_t* in_scale, long long in_period) {
  const long long p = ntt_tile_pos(ps, tile, i);
  if (ps.s0 > 0) return load_fe_v(out + p * 8);
  const long long j = ntt_bitrev(p, ps.k);
  if (j >= n_in) return fe_zero();
  Fe x = load_fe_v(in + j * 8);
  if (in_scale != nullptr)
    x = mont_mul<FR>(x, load_fe_v(in_scale + (j & (in_period - 1)) * 8));
  return x;
}

// Tile element i on its way out.
H2T_HD void ntt_store(const NttPass& ps, long long tile, int i, Fe x,
                      uint32_t* out, const uint32_t* out_scale,
                      long long out_period) {
  const long long p = ntt_tile_pos(ps, tile, i);
  if (out_scale != nullptr && ps.s0 + ps.t == ps.k)
    x = mont_mul<FR>(x, load_fe_v(out_scale + (p & (out_period - 1)) * 8));
  store_fe_v(out + p * 8, x);
}

// The butterflies b0, b0 + step, ... of the pass's local stage sl.  `tw`
// holds w^j * 2^256 for j < 2^(k - 1).  Stage 0 of the transform has the
// twiddle 1 throughout and multiplies nothing.
H2T_HD void ntt_tile_stage(uint32_t* tile, int cap, const NttPass& ps,
                           long long tile_idx, int sl, const uint32_t* tw,
                           int b0, int step) {
  const int nb = 1 << (ps.t + ps.a - 1), s = ps.s0 + sl;
  const long long lowblk = tile_idx & ((1LL << (ps.s0 - ps.a)) - 1);
#pragma unroll 1
  for (int b = b0; b < nb; b += step) {
    const int ls = b & ((1 << ps.a) - 1), cb = b >> ps.a;
    const int within = cb & ((1 << sl) - 1);
    const int cl = ((cb >> sl) << (sl + 1)) | within;
    const int i0 = (cl << ps.a) | ls, i1 = i0 + (1 << (sl + ps.a));
    Fe x = tile_ld(tile, cap, i0), y = tile_ld(tile, cap, i1);
    if (s > 0) {
      const long long j =
          ((long long)within << ps.s0) | (lowblk << ps.a) | ls;  // p mod 2^s
      y = mont_mul<FR>(y, load_fe_v(tw + (j << (ps.k - 1 - s)) * 8));
    }
    tile_st(tile, cap, i0, fadd<FR>(x, y));
    tile_st(tile, cap, i1, fsub<FR>(x, y));
  }
}

// ---------------------------------------------------------------------------
// The blocked scan of field elements (field_scan.cu): inclusive scans along
// rows under one of three associative operations, and what one thread does
// on its run of `cnt` consecutive elements.
//   FS_PROD    x * y.  Inside, elements are in Montgomery form.
//   FS_SUM     x + y, canonical throughout.
//   FS_AFFINE  the maps A -> m A + b under composition: (m1, b1) then
//              (m2, b2) is (m2 m1, m2 b1 + b2); the scan's result is the b of
//              each prefix, the recurrence A[i] = m[i] A[i-1] + b[i] from
//              A[-1] = 0.  Inside, m is in Montgomery form and b canonical:
//              a composition is two products and converts nothing.
// An element is FsEl<OP>: v[0] alone, or (m, b) = (v[0], v[1]).
// ---------------------------------------------------------------------------

enum FsOp { FS_PROD = 0, FS_SUM = 1, FS_AFFINE = 2 };

template <int OP> struct FsEl {
  static const int NV = OP == FS_AFFINE ? 2 : 1;
  Fe v[NV];
};

template <int F> H2T_HD Fe fe_one_mont() {
  Fe one = fe_zero();
  one.w[0] = 1;
  return to_mont<F>(one);
}

template <int F, int OP> H2T_HD FsEl<OP> fs_identity() {
  FsEl<OP> r;
  r.v[0] = OP == FS_SUM ? fe_zero() : fe_one_mont<F>();
  if (OP == FS_AFFINE) r.v[FsEl<OP>::NV - 1] = fe_zero();
  return r;
}

// `earlier` then `later`, both in the inside form.
template <int F, int OP>
H2T_HD FsEl<OP> fs_combine(const FsEl<OP>& e, const FsEl<OP>& l) {
  FsEl<OP> r;
  if (OP == FS_SUM) {
    r.v[0] = fadd<F>(e.v[0], l.v[0]);
  } else {
    r.v[0] = mont_mul<F>(l.v[0], e.v[0]);
    if (OP == FS_AFFINE)
      r.v[FsEl<OP>::NV - 1] = fadd<F>(
          mont_mul<F>(l.v[0], e.v[FsEl<OP>::NV - 1]), l.v[FsEl<OP>::NV - 1]);
  }
  return r;
}

// A canonical element from memory (m at `a`, b at `b` for FS_AFFINE) into
// the inside form: one conversion for a product or a map, none for a sum.
template <int F, int OP>
H2T_HD FsEl<OP> fs_load(const uint32_t* a, const uint32_t* b) {
  FsEl<OP> r;
  r.v[0] = load_fe_v(a);
  if (OP != FS_SUM) r.v[0] = to_mont<F>(r.v[0]);
  if (OP == FS_AFFINE) r.v[FsEl<OP>::NV - 1] = load_fe_v(b);
  return r;
}

template <int OP>
H2T_HD void fs_store(uint32_t* a, uint32_t* b, const FsEl<OP>& x) {
  store_fe_v(a, x.v[0]);
  if (OP == FS_AFFINE) store_fe_v(b, x.v[FsEl<OP>::NV - 1]);
}

// What `fs_apply` wants of the combination of everything before a run: the
// canonical product, the sum or the map's b as they are.
template <int F, int OP> H2T_HD Fe fs_offset(const FsEl<OP>& before) {
  if (OP == FS_PROD) return from_mont<F>(before.v[0]);
  return before.v[FsEl<OP>::NV - 1];
}

// The canonical result for an inside-form prefix x of a run whose
// predecessors combine to `off` (fs_offset): one product or none.
template <int F, int OP> H2T_HD Fe fs_apply(const Fe& off, const FsEl<OP>& x) {
  if (OP == FS_SUM) return fadd<F>(off, x.v[0]);
  Fe r = mont_mul<F>(x.v[0], off);
  if (OP == FS_AFFINE) r = fadd<F>(r, x.v[FsEl<OP>::NV - 1]);
  return r;
}

// fs_run_local: canonical elements at a (and b), 8 words each -> in place,
// their inclusive prefixes within the run in the inside form; returns the
// run's total, the identity for an empty run.  fs_run_total: the same total,
// nothing written.  fs_run_apply: prefix k -> the canonical result at a.
template <int F, int OP>
H2T_HD FsEl<OP> fs_run_local(uint32_t* a, uint32_t* b, int cnt) {
  if (cnt <= 0) return fs_identity<F, OP>();
  FsEl<OP> acc = fs_load<F, OP>(a, b);
  fs_store<OP>(a, b, acc);
#pragma unroll 1
  for (int k = 1; k < cnt; ++k) {
    acc = fs_combine<F, OP>(acc, fs_load<F, OP>(a + 8 * k, b + 8 * k));
    fs_store<OP>(a + 8 * k, b + 8 * k, acc);
  }
  return acc;
}

template <int F, int OP>
H2T_HD FsEl<OP> fs_run_total(const uint32_t* a, const uint32_t* b,
                             long long stride, long long cnt) {
  if (cnt <= 0) return fs_identity<F, OP>();
  FsEl<OP> acc = fs_load<F, OP>(a, b);
#pragma unroll 1
  for (long long k = 1; k < cnt; ++k)
    acc = fs_combine<F, OP>(acc,
                            fs_load<F, OP>(a + stride * k, b + stride * k));
  return acc;
}

template <int F, int OP>
H2T_HD void fs_run_apply(uint32_t* a, const uint32_t* b, int cnt,
                         const Fe& off) {
#pragma unroll 1
  for (int k = 0; k < cnt; ++k) {
    FsEl<OP> x;
    x.v[0] = load_fe_v(a + 8 * k);
    if (OP == FS_AFFINE) x.v[FsEl<OP>::NV - 1] = load_fe_v(b + 8 * k);
    store_fe_v(a + 8 * k, fs_apply<F, OP>(off, x));
  }
}

// ---------------------------------------------------------------------------
// The four-step transform's base DFT (csrc/ntt_mxu.cu, ops/ntt_mxu.py).
// Column `col` of a (m / cstride, r, cstride) layout holds its element `row`
// at dft_addr(col, row, r, cstride).  An output element arrives as 64
// base-256 limbs, limb l = raw[l * stride] + corr[l], each in [0, 2^31) by
// the construction of corr (a multiple of p and the data's offset folded in
// on the host); they carry into 17 words V < 2^544, and
//   V = c0 + c1 2^253 + c2 2^506,  c0, c1 < 2^253 < p,  c2 < 2^38,
// so V mod p = c0 + mont_mul(c1, 2^253 R) + mont_mul(c2, 2^506 R).
// ---------------------------------------------------------------------------

static const int DFT_LIMBS = 64;  // product limbs of an output element
static const int DFT_BYTES = 32;  // exact bytes of an input element

H2T_HD long long dft_addr(long long col, long long row, int r,
                          long long cstride) {
  return ((col / cstride) * r + row) * cstride + col % cstride;
}

H2T_HD Fe dft_limbs_to_fe(const int32_t* raw, long long stride,
                          const int32_t* corr, const Fe& f253,
                          const Fe& f506) {
  uint32_t v[17];
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int l = 4 * i + t;
      acc += (uint64_t)(uint32_t)(raw[l * stride] + corr[l]) << (8 * t);
    }
    v[i] = (uint32_t)acc;
    acc >>= 32;
  }
  v[16] = (uint32_t)acc;
  Fe c0, c1, c2 = fe_zero();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c0.w[i] = v[i];
    c1.w[i] = (v[7 + i] >> 29) | (v[8 + i] << 3);
  }
  c0.w[7] &= 0x1fffffffu;
  c1.w[7] &= 0x1fffffffu;
  c2.w[0] = (v[15] >> 26) | (v[16] << 6);
  c2.w[1] = v[16] >> 26;
  return fadd<FR>(c0, fadd<FR>(mont_mul<FR>(c1, f253), mont_mul<FR>(c2, f506)));
}

}  // namespace bn254

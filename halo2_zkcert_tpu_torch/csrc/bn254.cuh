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

namespace bn254 {

enum FieldId { FR = 0, FQ = 1 };
enum BinOp { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

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
template <int F> H2T_HD Fe mont_mul(const Fe& a, const Fe& b) {
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
// Fr only; slots hold Montgomery form; the result slot leaves canonical.
// ---------------------------------------------------------------------------

enum TapeOp { TAPE_LOAD = 0, TAPE_CONST = 1, TAPE_ADD = 2, TAPE_SUB = 3,
              TAPE_MUL = 4 };

static const int TAPE_MAX_SLOTS = 64;

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

// leaves: (num_cols, n_rows, 8); consts: (num_consts, 8); tape: (T, 4).
H2T_HD Fe tape_eval_row(long long row, long long n_rows, const uint32_t* leaves,
                        const uint32_t* consts, const int32_t* tape, int T,
                        int out_slot, Fe* slots) {
  for (int t = 0; t < T; ++t) {
    const int32_t op = tape[4 * t], dst = tape[4 * t + 1];
    const int32_t a = tape[4 * t + 2], b = tape[4 * t + 3];
    Fe v;
    if (op == TAPE_LOAD) {
      long long r = (row + b) & (n_rows - 1);
      v = to_mont<FR>(load_fe(leaves + ((long long)a * n_rows + r) * 8));
    } else if (op == TAPE_CONST) {
      v = to_mont<FR>(load_fe(consts + (long long)a * 8));
    } else if (op == TAPE_ADD) {
      v = fadd<FR>(slots[a], slots[b]);
    } else if (op == TAPE_SUB) {
      v = fsub<FR>(slots[a], slots[b]);
    } else {
      v = mont_mul<FR>(slots[a], slots[b]);
    }
    slots[dst] = v;
  }
  return from_mont<FR>(slots[out_slot]);
}

// ---------------------------------------------------------------------------
// One row of the mixed-add prefix scan: C canonical affine points (x, y) at
// `src` (16 words each) -> C canonical projective inclusive prefixes at
// `dst` (24 words each).  Prefix 0 is the point itself with Z = 1; the
// running sum stays in Montgomery form across all C - 1 mixed additions.
// ---------------------------------------------------------------------------

H2T_HD void scan_madd_row(const uint32_t* src, uint32_t* dst, int C) {
  Fe one = fe_zero();
  one.w[0] = 1;
  Fe x = load_fe(src), y = load_fe(src + 8);
  store_fe(dst, x);
  store_fe(dst + 8, y);
  store_fe(dst + 16, one);
  Pt acc;
  acc.x = to_mont<FQ>(x);
  acc.y = to_mont<FQ>(y);
  acc.z = to_mont<FQ>(one);
#pragma unroll 1
  for (int j = 1; j < C; ++j) {
    x = to_mont<FQ>(load_fe(src + 16 * j));
    y = to_mont<FQ>(load_fe(src + 16 * j + 8));
    acc = point_madd_mont(acc, x, y);
    Pt out = pt_from_mont(acc);
    store_fe(dst + 24 * j, out.x);
    store_fe(dst + 24 * j + 8, out.y);
    store_fe(dst + 24 * j + 16, out.z);
  }
}

}  // namespace bn254

// hostmath: the host runtime of the port's Fiat-Shamir transcripts.
//
// The Poseidon permutation over BN254 Fr (T=3, R_F=8, R_P=57; round
// constants and MDS are passed in from Python, transcript/poseidon.py
// `poseidon_constants`, which stays the one source of their derivation) and
// Keccak-256 with Ethereum's padding, in 256-bit Montgomery arithmetic on
// u64 limbs.  It runs on the host between the device's kernel launches: a
// transcript is a sequential chain of a few hundred permutations a proof,
// which no device launch would shorten.  The pure-Python versions
// (transcript/poseidon.py `permute_plain`, utils/refcrypto.py `keccak256`)
// are the plain versions it is tested against.
//
// This is the part of the JAX package's native/hostmath.cpp that the
// transcript needs: the field context, Poseidon and Keccak.  Its field
// batches and G1 routines served the JAX package's host SRS generation;
// the port builds the SRS on the card (plonk/kzg.py `setup`).
//
// ABI: plain C functions over little-endian 32-byte scalars, bound with
// ctypes (native.py).  Build: g++ -O3 -std=c++17 -shared -fPIC.

#include <cstdint>
#include <cstring>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

// ---------------------------------------------------------------------------
// 256-bit integers as 4 little-endian u64 limbs
// ---------------------------------------------------------------------------

struct U256 {
  u64 v[4];
};

static inline U256 u256_load(const unsigned char *p) {
  U256 r;
  std::memcpy(r.v, p, 32);
  return r;
}

static inline void u256_store(unsigned char *p, const U256 &a) {
  std::memcpy(p, a.v, 32);
}

static inline bool u256_gte(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

// a += b, returns carry
static inline u64 u256_add(U256 &a, const U256 &b) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.v[i] + b.v[i];
    a.v[i] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

// a -= b, returns borrow
static inline u64 u256_sub(U256 &a, const U256 &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return (u64)borrow;
}

// ---------------------------------------------------------------------------
// Montgomery field context (modulus < 2^255, R = 2^256)
// ---------------------------------------------------------------------------

struct FieldCtx {
  U256 p;       // modulus
  U256 r2;      // R^2 mod p
  u64 n0inv;    // -p^{-1} mod 2^64
};

static FieldCtx FR_CTX;

static u64 inv64(u64 a) {  // a^{-1} mod 2^64 for odd a (Newton iteration)
  u64 x = a;               // 3 bits
  for (int i = 0; i < 5; ++i) x *= 2 - a * x;
  return x;
}

static void field_init(FieldCtx &ctx, const unsigned char *p_le) {
  ctx.p = u256_load(p_le);
  ctx.n0inv = (u64)(0 - inv64(ctx.p.v[0]));
  // R^2 mod p: start from 1 and double 512 times mod p
  U256 r{{1, 0, 0, 0}};
  for (int i = 0; i < 512; ++i) {
    u64 carry = u256_add(r, r);
    if (carry || u256_gte(r, ctx.p)) u256_sub(r, ctx.p);
  }
  ctx.r2 = r;
}

// CIOS Montgomery multiplication: returns a*b*R^{-1} mod p
static U256 mont_mul(const FieldCtx &ctx, const U256 &a, const U256 &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    // t += a[i] * b
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      c += (u128)t[j] + (u128)a.v[i] * b.v[j];
      t[j] = (u64)c;
      c >>= 64;
    }
    c += t[4];
    t[4] = (u64)c;
    t[5] = (u64)(c >> 64);
    // m = t[0] * n0inv; t += m * p; t >>= 64
    u64 m = t[0] * ctx.n0inv;
    c = (u128)t[0] + (u128)m * ctx.p.v[0];
    c >>= 64;
    for (int j = 1; j < 4; ++j) {
      c += (u128)t[j] + (u128)m * ctx.p.v[j];
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    c += t[4];
    t[3] = (u64)c;
    t[4] = t[5] + (u64)(c >> 64);
    t[5] = 0;
  }
  U256 r{{t[0], t[1], t[2], t[3]}};
  if (t[4] || u256_gte(r, ctx.p)) u256_sub(r, ctx.p);
  return r;
}

static U256 mont_sqr(const FieldCtx &ctx, const U256 &a) {
  return mont_mul(ctx, a, a);
}

static U256 f_add(const FieldCtx &ctx, const U256 &a, const U256 &b) {
  U256 r = a;
  u64 carry = u256_add(r, b);
  if (carry || u256_gte(r, ctx.p)) u256_sub(r, ctx.p);
  return r;
}

static U256 to_mont(const FieldCtx &ctx, const U256 &a) {
  return mont_mul(ctx, a, ctx.r2);
}

static U256 from_mont(const FieldCtx &ctx, const U256 &a) {
  U256 one{{1, 0, 0, 0}};
  return mont_mul(ctx, a, one);
}

// ---------------------------------------------------------------------------
// Poseidon permutation (constants passed in from Python)
// ---------------------------------------------------------------------------

static const int POS_MAX_T = 8;
static int POS_T = 0, POS_RF = 0, POS_RP = 0;
static U256 *POS_RC = nullptr;   // (RF + RP) * T, Montgomery
static U256 *POS_MDS = nullptr;  // T * T, Montgomery

static inline U256 pos_sbox(const U256 &x) {
  const FieldCtx &F = FR_CTX;
  U256 x2 = mont_sqr(F, x);
  U256 x4 = mont_sqr(F, x2);
  return mont_mul(F, x4, x);
}

// ---------------------------------------------------------------------------
// Keccak-f[1600] / Keccak-256 (Ethereum padding 0x01)
// ---------------------------------------------------------------------------

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int KECCAK_R[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                                 20, 3,  10, 43, 25, 39, 41, 45, 15,
                                 21, 8,  18, 2,  61, 56, 14};

static inline u64 rotl64(u64 x, int n) {
  return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccak_f(u64 st[25]) {
  for (int round = 0; round < 24; ++round) {
    u64 bc[5];
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      u64 t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    u64 tmp[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) {
        int src = x + 5 * y;
        int dst = y + 5 * ((2 * x + 3 * y) % 5);
        tmp[dst] = rotl64(st[src], KECCAK_R[src]);
      }
    // chi
    for (int j = 0; j < 25; j += 5) {
      u64 row[5];
      for (int i = 0; i < 5; ++i) row[i] = tmp[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
    }
    st[0] ^= KECCAK_RC[round];
  }
}

// ---------------------------------------------------------------------------
// Exported C ABI
// ---------------------------------------------------------------------------

extern "C" {

// fr_le: the scalar field's modulus, 32 LE bytes.
void hm_init(const unsigned char *fr_le) { field_init(FR_CTX, fr_le); }

// rc_le: (rf + rp) * t canonical scalars, mds_le: t * t; 32 LE bytes each.
// Returns 0, or -1 if t is out of range.
int hm_poseidon_setup(int t, int rf, int rp, const unsigned char *rc_le,
                      const unsigned char *mds_le) {
  if (t < 1 || t > POS_MAX_T) return -1;
  POS_T = t;
  POS_RF = rf;
  POS_RP = rp;
  delete[] POS_RC;
  delete[] POS_MDS;
  POS_RC = new U256[(rf + rp) * t];
  POS_MDS = new U256[t * t];
  for (int i = 0; i < (rf + rp) * t; ++i)
    POS_RC[i] = to_mont(FR_CTX, u256_load(rc_le + 32 * i));
  for (int i = 0; i < t * t; ++i)
    POS_MDS[i] = to_mont(FR_CTX, u256_load(mds_le + 32 * i));
  return 0;
}

// state: t canonical scalars of 32 LE bytes; permuted in place.
// Full rounds apply the sbox to all t elements, partial rounds only to
// element 0; round constants are added before the sbox each round, the MDS
// applied after it (transcript/poseidon.py `permute_plain`).
void hm_poseidon_permute(unsigned char *state) {
  const FieldCtx &F = FR_CTX;
  const int t = POS_T;
  U256 s[POS_MAX_T];
  for (int i = 0; i < t; ++i) s[i] = to_mont(F, u256_load(state + 32 * i));
  const int half = POS_RF / 2;
  int rc_idx = 0;
  U256 tmp[POS_MAX_T];
  for (int round = 0; round < POS_RF + POS_RP; ++round) {
    bool full = round < half || round >= half + POS_RP;
    for (int i = 0; i < t; ++i) s[i] = f_add(F, s[i], POS_RC[rc_idx + i]);
    rc_idx += t;
    if (full) {
      for (int i = 0; i < t; ++i) s[i] = pos_sbox(s[i]);
    } else {
      s[0] = pos_sbox(s[0]);
    }
    for (int i = 0; i < t; ++i) {
      U256 acc{{0, 0, 0, 0}};
      for (int j = 0; j < t; ++j)
        acc = f_add(F, acc, mont_mul(F, POS_MDS[i * t + j], s[j]));
      tmp[i] = acc;
    }
    for (int i = 0; i < t; ++i) s[i] = tmp[i];
  }
  for (int i = 0; i < t; ++i) u256_store(state + 32 * i, from_mont(F, s[i]));
}

// Keccak-256 of data[0:len) into out32.
void hm_keccak256(const unsigned char *data, long len, unsigned char *out32) {
  u64 st[25];
  std::memset(st, 0, sizeof(st));
  const long rate = 136;
  long off = 0;
  while (len - off >= rate) {
    for (int i = 0; i < rate / 8; ++i) {
      u64 w;
      std::memcpy(&w, data + off + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f(st);
    off += rate;
  }
  unsigned char block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, data + off, len - off);
  block[len - off] = 0x01;  // Keccak (pre-NIST) domain padding
  block[rate - 1] |= 0x80;
  for (int i = 0; i < rate / 8; ++i) {
    u64 w;
    std::memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f(st);
  std::memcpy(out32, st, 32);
}

}  // extern "C"

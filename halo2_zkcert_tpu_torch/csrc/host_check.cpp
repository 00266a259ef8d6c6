// Host build of bn254.cuh for the CPU tests only: the kernels' own field,
// group-law and tape arithmetic, compiled with g++ and driven through ctypes
// (tests/test_torch_csrc_host.py).  Never on the main path.
#include <algorithm>
#include <cstring>
#include <vector>

#include "bn254.cuh"

using namespace bn254;

extern "C" void hc_field_binop(int field, int op, const uint32_t* a,
                               const uint32_t* b, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    Fe x = load_fe(a + 8 * i), y = load_fe(b + 8 * i), r;
    if (field == FR) {
      r = op == OP_MUL ? binop_canon<FR, OP_MUL>(x, y)
        : op == OP_MULM ? binop_canon<FR, OP_MULM>(x, y)
        : op == OP_ADD ? binop_canon<FR, OP_ADD>(x, y)
                       : binop_canon<FR, OP_SUB>(x, y);
    } else {
      r = op == OP_MUL ? binop_canon<FQ, OP_MUL>(x, y)
        : op == OP_MULM ? binop_canon<FQ, OP_MULM>(x, y)
        : op == OP_ADD ? binop_canon<FQ, OP_ADD>(x, y)
                       : binop_canon<FQ, OP_SUB>(x, y);
    }
    store_fe(out + 8 * i, r);
  }
}

static Pt ldp(const uint32_t* p) {
  Pt r;
  r.x = load_fe(p);
  r.y = load_fe(p + 8);
  r.z = load_fe(p + 16);
  return r;
}

static void stp(uint32_t* p, const Pt& v) {
  store_fe(p, v.x);
  store_fe(p + 8, v.y);
  store_fe(p + 16, v.z);
}

extern "C" void hc_point_add(const uint32_t* P, const uint32_t* Q,
                             uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i)
    stp(out + 24 * i, point_add_canon(ldp(P + 24 * i), ldp(Q + 24 * i)));
}

extern "C" void hc_point_double(const uint32_t* P, uint32_t* out,
                                long long n) {
  for (long long i = 0; i < n; ++i)
    stp(out + 24 * i, point_double_canon(ldp(P + 24 * i)));
}

extern "C" void hc_point_add_mixed(const uint32_t* P, const uint32_t* Q,
                                   uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i)
    stp(out + 24 * i, point_madd_canon(ldp(P + 24 * i), load_fe(Q + 16 * i),
                                       load_fe(Q + 16 * i + 8)));
}

// digits may be null: every prefix is written.
extern "C" void hc_scan_madd(const uint32_t* xy, const int32_t* digits,
                             uint32_t* out, long long R, int C) {
  for (long long r = 0; r < R; ++r)
    scan_madd_row(xy + r * C * 16, digits ? digits + r * C : nullptr,
                  out + r * C * 24, C);
}

// The blocked point scan as point_scan.cu lays it out, on the host: each row
// (mirrored when `reverse`) is cut into runs of `run` points, every run goes
// through scan_run_local, the run totals are summed in order, and every run
// through scan_run_apply with the sum of the runs before it.
extern "C" void hc_point_scan(const uint32_t* P, uint32_t* out, long long B,
                              long long n, int run, int reverse) {
  std::vector<uint32_t> tile(24 * n);
  for (long long b = 0; b < B; ++b) {
    for (long long l = 0; l < n; ++l)
      std::memcpy(&tile[24 * l],
                  P + (b * n + (reverse ? n - 1 - l : l)) * 24, 96);
    std::vector<Pt> totals;
    for (long long s = 0; s < n; s += run)
      totals.push_back(scan_run_local(&tile[24 * s],
                                      (int)std::min<long long>(run, n - s)));
    Pt off = pt_identity_mont();
    for (long long s = 0, i = 0; s < n; s += run, ++i) {
      scan_run_apply(&tile[24 * s], (int)std::min<long long>(run, n - s), off);
      off = point_add_mont(off, totals[i]);
    }
    for (long long l = 0; l < n; ++l)
      std::memcpy(out + (b * n + (reverse ? n - 1 - l : l)) * 24,
                  &tile[24 * l], 96);
  }
}

// The blocked scan of affine points (16 words each in, 24 out), laid out as
// hc_point_scan lays out the projective one: each run goes through
// scan_run_local_affine in slots of 24 words, then scan_run_apply.  With
// `lanes` > 0 the row's total is also summed as k_point_reduce_affine sums
// it (point_sum_strided_affine over `lanes` strided partial sums) into
// totals (B, 24), canonical.
extern "C" void hc_point_scan_affine(const uint32_t* xy, uint32_t* out,
                                     uint32_t* totals, long long B,
                                     long long n, int run, int reverse,
                                     int lanes) {
  std::vector<uint32_t> tile(24 * n);
  for (long long b = 0; b < B; ++b) {
    for (long long l = 0; l < n; ++l)
      std::memcpy(&tile[24 * l],
                  xy + (b * n + (reverse ? n - 1 - l : l)) * 16, 64);
    std::vector<Pt> runs;
    for (long long s = 0; s < n; s += run)
      runs.push_back(scan_run_local_affine(
          &tile[24 * s], (int)std::min<long long>(run, n - s)));
    Pt off = pt_identity_mont();
    for (long long s = 0, i = 0; s < n; s += run, ++i) {
      scan_run_apply(&tile[24 * s], (int)std::min<long long>(run, n - s), off);
      off = point_add_mont(off, runs[i]);
    }
    for (long long l = 0; l < n; ++l)
      std::memcpy(out + (b * n + (reverse ? n - 1 - l : l)) * 24,
                  &tile[24 * l], 96);
    if (lanes <= 0) continue;
    Pt acc = pt_identity_mont();
    for (int t = 0; t < lanes; ++t)
      acc = point_add_mont(acc, point_sum_strided_affine(
          xy + (b * n + t) * 16, 16LL * lanes, (n - t + lanes - 1) / lanes));
    stp(totals + 24 * b, pt_from_mont(acc));
  }
}

// The chains of point_chain.cu, a thread's work for each point, column or
// scalar in turn.  windows: P (n, 24) -> out (nwin, n, 24).
extern "C" void hc_point_windows(const uint32_t* P, uint32_t* out, long long n,
                                 int c, int nwin) {
  for (long long i = 0; i < n; ++i)
    point_windows_chain(P + 24 * i, c, nwin, out + 24 * i, 24 * n);
}

// W (m, nwin, 24) -> out (m, 24).
extern "C" void hc_point_horner(const uint32_t* W, uint32_t* out, long long m,
                                int c, int nwin) {
  for (long long j = 0; j < m; ++j)
    stp(out + 24 * j,
        pt_from_mont(point_horner_chain(W + j * nwin * 24, 24, c, nwin)));
}

// table (32, 256, 16) in Montgomery form, s (n, 8) -> out (n, 24).
extern "C" void hc_point_fixed_mul(const uint32_t* table, const uint32_t* s,
                                   uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i)
    stp(out + 24 * i, pt_from_mont(point_fixed_mul_chain(table, s + 8 * i)));
}

// Row sums as k_point_reduce takes them: `lanes` strided partial sums a row
// (point_sum_strided), then their sum.
extern "C" void hc_point_row_sum(const uint32_t* P, uint32_t* out, long long B,
                                 long long n, int lanes) {
  for (long long b = 0; b < B; ++b) {
    Pt acc = pt_identity_mont();
    for (int t = 0; t < lanes; ++t)
      acc = point_add_mont(acc, point_sum_strided(
          P + (b * n + t) * 24, 24LL * lanes, (n - t + lanes - 1) / lanes));
    stp(out + 24 * b, pt_from_mont(acc));
  }
}

// Montgomery form in (leaves, constants), Montgomery form out.
struct HostSlots {
  std::vector<Fe> s;
  Fe get(int i) const { return s[i]; }
  void set(int i, const Fe& v) { s[i] = v; }
};

extern "C" void hc_quotient_forest(const uint32_t* leaves, long long n_rows,
                                   const uint32_t* consts, const int32_t* tape,
                                   int T, int num_slots, int out_slot,
                                   uint32_t* out) {
  HostSlots slots;
  slots.s.resize(num_slots);
  for (long long row = 0; row < n_rows; ++row)
    store_fe(out + 8 * row, tape_eval_row(row, n_rows, leaves, consts, tape, T,
                                          out_slot, slots));
}

// One pass of the transform as ntt.cu's kernel makes it, tile by tile: the
// arguments of h2t_ntt_pass without the stream, and any tile size.
extern "C" int hc_ntt_pass(const uint32_t* in, long long n_in, uint32_t* out,
                           long long B, int k, int s0, int t, int a,
                           const uint32_t* tw, const uint32_t* in_scale,
                           long long in_period, const uint32_t* out_scale,
                           long long out_period) {
  if (t < 0 || a < 0 || a > s0 || s0 + t > k) return 1;
  NttPass ps = {k, s0, t, a};
  const int cap = 1 << (t + a);
  std::vector<uint32_t> tile(8 * cap);
  for (long long col = 0; col < B; ++col) {
    uint32_t* col_out = out + (col << k) * 8;
    for (long long tile_idx = 0; tile_idx < (1LL << (k - t - a)); ++tile_idx) {
      for (int i = 0; i < cap; ++i)
        tile_st(tile.data(), cap, i,
                ntt_load(ps, tile_idx, i, in + col * n_in * 8, n_in, col_out,
                         in_scale, in_period));
      for (int sl = 0; sl < t; ++sl)   // two interleaved "threads"
        for (int b0 = 0; b0 < 2; ++b0)
          ntt_tile_stage(tile.data(), cap, ps, tile_idx, sl, tw, b0, 2);
      for (int i = 0; i < cap; ++i)
        ntt_store(ps, tile_idx, i, tile_ld(tile.data(), cap, i), col_out,
                  out_scale, out_period);
    }
  }
  return 0;
}

// The blocked field scan as field_scan.cu lays it out, on the host: each row
// (mirrored when `reverse`) is cut into runs of `run` elements, every run
// goes through fs_run_local, the run totals are combined in order, and every
// run through fs_run_apply with the combination of the runs before it.
template <int F, int OP>
static void field_scan_rows(const uint32_t* a, const uint32_t* b,
                            uint32_t* out, long long B, long long n, int run,
                            int reverse) {
  std::vector<uint32_t> ta(8 * n), tb(8 * n);
  for (long long r = 0; r < B; ++r) {
    for (long long l = 0; l < n; ++l) {
      long long src = (r * n + (reverse ? n - 1 - l : l)) * 8;
      std::memcpy(&ta[8 * l], a + src, 32);
      if (OP == FS_AFFINE) std::memcpy(&tb[8 * l], b + src, 32);
    }
    std::vector<FsEl<OP>> totals;
    for (long long s = 0; s < n; s += run)
      totals.push_back(fs_run_local<F, OP>(
          &ta[8 * s], &tb[8 * s], (int)std::min<long long>(run, n - s)));
    FsEl<OP> before = fs_identity<F, OP>();
    for (long long s = 0, i = 0; s < n; s += run, ++i) {
      fs_run_apply<F, OP>(&ta[8 * s], &tb[8 * s],
                          (int)std::min<long long>(run, n - s),
                          fs_offset<F, OP>(before));
      before = fs_combine<F, OP>(before, totals[i]);
    }
    for (long long l = 0; l < n; ++l)
      std::memcpy(out + (r * n + (reverse ? n - 1 - l : l)) * 8, &ta[8 * l],
                  32);
  }
}

extern "C" int hc_field_scan(int field, int op, const uint32_t* a,
                             const uint32_t* b, uint32_t* out, long long B,
                             long long n, int run, int reverse) {
#define HC_SCAN(F, OP) \
  if (field == F && op == OP) \
    return field_scan_rows<F, OP>(a, b, out, B, n, run, reverse), 0;
  HC_SCAN(FR, FS_PROD) HC_SCAN(FR, FS_SUM) HC_SCAN(FR, FS_AFFINE)
  HC_SCAN(FQ, FS_PROD) HC_SCAN(FQ, FS_SUM) HC_SCAN(FQ, FS_AFFINE)
  return 1;
}

// Row totals as k_field_reduce takes them: `lanes` consecutive chunks a row
// (fs_run_total), combined in order; canonical out.  The map's m goes to
// out_a and its b to out_b.
template <int F, int OP>
static void field_totals(const uint32_t* a, const uint32_t* b, uint32_t* out_a,
                         uint32_t* out_b, long long B, long long n,
                         int lanes) {
  const long long chunk = (n + lanes - 1) / lanes;
  for (long long r = 0; r < B; ++r) {
    FsEl<OP> acc = fs_identity<F, OP>();
    for (long long lo = 0; lo < n; lo += chunk)
      acc = fs_combine<F, OP>(acc, fs_run_total<F, OP>(
          a + (r * n + lo) * 8, b + (r * n + lo) * 8, 8,
          std::min(chunk, n - lo)));
    if (OP != FS_SUM) acc.v[0] = from_mont<F>(acc.v[0]);
    fs_store<OP>(out_a + 8 * r, out_b + 8 * r, acc);
  }
}

extern "C" int hc_field_reduce(int field, int op, const uint32_t* a,
                               const uint32_t* b, uint32_t* out_a,
                               uint32_t* out_b, long long B, long long n,
                               int lanes) {
#define HC_REDUCE(F, OP) \
  if (field == F && op == OP) \
    return field_totals<F, OP>(a, b, out_a, out_b, B, n, lanes), 0;
  HC_REDUCE(FR, FS_PROD) HC_REDUCE(FR, FS_SUM) HC_REDUCE(FR, FS_AFFINE)
  HC_REDUCE(FQ, FS_PROD) HC_REDUCE(FQ, FS_SUM) HC_REDUCE(FQ, FS_AFFINE)
  return 1;
}

// csrc/ntt_mxu.cu's base DFT with its product written as loops: the same
// digits (byte ^ 0x80 read as s8), addresses and epilogue.
extern "C" void hc_dft_s8(const int8_t* lhs, const int32_t* corr,
                          const uint32_t* fold, const uint32_t* in,
                          uint32_t* out, long long m, int r_log,
                          long long cin, long long cout) {
  const int r = 1 << r_log;
  const long long K = (long long)DFT_BYTES * r;
  std::vector<int8_t> digits(K);
  std::vector<int32_t> raw(DFT_LIMBS);
  const Fe f253 = load_fe(fold), f506 = load_fe(fold + 8);
  for (long long col = 0; col < m; ++col) {
    for (int j = 0; j < r; ++j) {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(
          in + dft_addr(col, j, r, cin) * 8);
      for (int l2 = 0; l2 < DFT_BYTES; ++l2)
        digits[j * DFT_BYTES + l2] = (int8_t)(b[l2] ^ 0x80);
    }
    for (int k = 0; k < r; ++k) {
      for (int l = 0; l < DFT_LIMBS; ++l) {
        const int8_t* row = lhs + ((long long)k * DFT_LIMBS + l) * K;
        int32_t s = 0;
        for (long long q = 0; q < K; ++q) s += (int32_t)row[q] * digits[q];
        raw[l] = s;
      }
      store_fe(out + dft_addr(col, k, r, cout) * 8,
               dft_limbs_to_fe(raw.data(), 1, corr + k * DFT_LIMBS, f253,
                               f506));
    }
  }
}

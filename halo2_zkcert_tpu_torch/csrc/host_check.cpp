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
        : op == OP_ADD ? binop_canon<FR, OP_ADD>(x, y)
                       : binop_canon<FR, OP_SUB>(x, y);
    } else {
      r = op == OP_MUL ? binop_canon<FQ, OP_MUL>(x, y)
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

extern "C" void hc_quotient_forest(const uint32_t* leaves, long long n_rows,
                                   const uint32_t* consts, const int32_t* tape,
                                   int T, int out_slot, uint32_t* out) {
  Fe slots[TAPE_MAX_SLOTS];
  for (long long row = 0; row < n_rows; ++row)
    store_fe(out + 8 * row, tape_eval_row(row, n_rows, leaves, consts, tape, T,
                                          out_slot, slots));
}

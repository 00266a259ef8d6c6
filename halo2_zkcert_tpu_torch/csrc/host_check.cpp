// Host build of bn254.cuh for the CPU tests only: the kernels' own field,
// group-law and tape arithmetic, compiled with g++ and driven through ctypes
// (tests/test_torch_csrc_host.py).  Never on the main path.
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

extern "C" void hc_scan_madd(const uint32_t* xy, uint32_t* out, long long R,
                             int C) {
  for (long long r = 0; r < R; ++r)
    scan_madd_row(xy + r * C * 16, out + r * C * 24, C);
}

extern "C" void hc_quotient_forest(const uint32_t* leaves, long long n_rows,
                                   const uint32_t* consts, const int32_t* tape,
                                   int T, int out_slot, uint32_t* out) {
  Fe slots[TAPE_MAX_SLOTS];
  for (long long row = 0; row < n_rows; ++row)
    store_fe(out + 8 * row, tape_eval_row(row, n_rows, leaves, consts, tape, T,
                                          out_slot, slots));
}

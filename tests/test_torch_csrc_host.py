"""The kernels' own arithmetic, checked without a GPU: csrc/bn254.cuh's
__host__ __device__ field, RCB16, tape-interpreter, transform-pass,
blocked-scan and chain functions, built with
g++ through csrc/host_check.cpp into a small host library, against the
Python-int oracle and the port's plain versions.  Test-only: the main path
never loads this library."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import curve, field, frops, msm_fb, ntt, scan
from halo2_zkcert_tpu_torch.ops.field import FQ, FR
from halo2_zkcert_tpu_torch.plonk import kzg, quotient
from halo2_zkcert_tpu_torch.plonk.cs import ConstraintSystem
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "halo2_zkcert_tpu_torch", "csrc")
P = ctypes.c_void_p
L = ctypes.c_longlong


@pytest.fixture(scope="module")
def hc(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("hc") / "libhostcheck.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(out),
                    os.path.join(CSRC, "host_check.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.hc_field_binop.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, L]
    lib.hc_point_add.argtypes = [P, P, P, L]
    lib.hc_point_double.argtypes = [P, P, L]
    lib.hc_point_add_mixed.argtypes = [P, P, P, L]
    lib.hc_scan_madd.argtypes = [P, P, P, L, ctypes.c_int]
    lib.hc_point_scan.argtypes = [P, P, L, L, ctypes.c_int, ctypes.c_int]
    lib.hc_point_row_sum.argtypes = [P, P, L, L, ctypes.c_int]
    lib.hc_point_scan_affine.argtypes = [P, P, P, L, L, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.hc_point_windows.argtypes = [P, P, L, ctypes.c_int, ctypes.c_int]
    lib.hc_point_horner.argtypes = [P, P, L, ctypes.c_int, ctypes.c_int]
    lib.hc_point_fixed_mul.argtypes = [P, P, P, L]
    lib.hc_quotient_forest.argtypes = [P, L, P, P, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, P]
    I = ctypes.c_int
    lib.hc_ntt_pass.argtypes = [P, L, P, L, I, I, I, I, P, P, L, P, L]
    lib.hc_field_scan.argtypes = [I, I, P, P, P, L, L, I, I]
    lib.hc_field_reduce.argtypes = [I, I, P, P, P, P, L, L, I]
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _vals(p, seed, count):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, p - 1, p - 2, (1 << 253) % p]
    return edge + [int.from_bytes(rng.bytes(32), "little") % p
                   for _ in range(count - len(edge))]


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_binop_host(hc, fname, op):
    F = FR if fname == "Fr" else FQ
    p = F.modulus
    a, b = _vals(p, 1, 64), _vals(p, 2, 64)[::-1]
    ta, tb = field.from_ints(F, a, "cpu"), field.from_ints(F, b, "cpu")
    out = torch.empty_like(ta)
    hc.hc_field_binop(F.fid, field._OPS[op], _ptr(ta), _ptr(tb), _ptr(out),
                      len(a))
    py = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    assert field.to_ints(out) == [py(x, y) % p for x, y in zip(a, b)]
    assert torch.equal(out, field.binop_plain(F, op, ta, tb))


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
def test_field_mulm_host(hc, fname):
    """K1's fourth operation, the bare Montgomery product: a * b / R, so
    a * v for an operand that holds v * R."""
    F = FR if fname == "Fr" else FQ
    p = F.modulus
    a, v = _vals(p, 3, 64), _vals(p, 4, 64)[::-1]
    ta = field.from_ints(F, a, "cpu")
    tb = field.from_ints(F, [x * F.r for x in v], "cpu")
    out = torch.empty_like(ta)
    hc.hc_field_binop(F.fid, field.OP_MULM, _ptr(ta), _ptr(tb), _ptr(out),
                      len(a))
    assert field.to_ints(out) == [x * y % p for x, y in zip(a, v)]
    assert torch.equal(out, field.mul_mont_plain(F, ta, tb))


def _points(seed, count):
    rng = np.random.default_rng(seed)
    G = rc.g1_from_affine(rc.G1_GEN)
    pts = [rc.g1_to_affine(rc.g1_mul(G, int.from_bytes(rng.bytes(32), "little")
                                     % rc.FR)) for _ in range(count)]
    return pts


def test_point_add_and_double_host(hc):
    ps, qs = _points(3, 12), _points(4, 12)
    qs[1] = ps[1]
    qs[2] = rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(ps[2])))
    ps[3] = (0, 0)
    P_ = curve.from_affine(curve.points_to_device(ps, "cpu")).contiguous()
    Q_ = curve.from_affine(curve.points_to_device(qs, "cpu")).contiguous()
    out = torch.empty_like(P_)
    hc.hc_point_add(_ptr(P_), _ptr(Q_), _ptr(out), len(ps))
    assert torch.equal(out, curve.add_plain(P_, Q_))
    assert curve.points_from_device(curve.to_affine(out)) == [
        rc.g1_to_affine(rc.g1_add(rc.g1_from_affine(p), rc.g1_from_affine(q)))
        for p, q in zip(ps, qs)]
    hc.hc_point_double(_ptr(P_), _ptr(out), len(ps))
    assert torch.equal(out, curve.double_plain(P_))


def test_point_add_mixed_host(hc):
    """P + Q with Q affine: random, P = Q, P = -Q, P = identity."""
    ps, qs = _points(5, 12), _points(6, 12)
    ps[1] = qs[1]
    ps[2] = rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(qs[2])))
    ps[3] = (0, 0)
    P_ = curve.from_affine(curve.points_to_device(ps, "cpu")).contiguous()
    Q_ = curve.points_to_device(qs, "cpu").contiguous()
    out = torch.empty_like(P_)
    hc.hc_point_add_mixed(_ptr(P_), _ptr(Q_), _ptr(out), len(ps))
    assert torch.equal(out, curve.add_mixed_plain(P_, Q_))
    assert torch.equal(out, curve.add_plain(P_, curve.from_affine(Q_)))
    assert curve.points_from_device(curve.to_affine(out)) == [
        rc.g1_to_affine(rc.g1_add(rc.g1_from_affine(p), rc.g1_from_affine(q)))
        for p, q in zip(ps, qs)]


@pytest.mark.parametrize("C", [1, 5, 64])
def test_scan_madd_host(hc, C):
    """Row prefixes of the K6 row function: equal to the plain version,
    and the last prefix of each row to the oracle's sum of the row; a row of
    one point repeated covers doubling inside the scan."""
    R = 3
    pts = _points(7 + C, R * C)
    pts[C:2 * C] = [pts[C]] * C
    xy = curve.points_to_device(pts, "cpu").reshape(R, C, 2, 8).contiguous()
    out = torch.empty((R, C, 3, 8), dtype=torch.int32)
    hc.hc_scan_madd(_ptr(xy), None, _ptr(out), R, C)
    assert torch.equal(out, msm_fb.scan_madd_plain(xy))
    assert curve.points_from_device(curve.to_affine(out[:, -1])) == [
        rc.g1_msm(pts[r * C:(r + 1) * C], [1] * C) for r in range(R)]


@pytest.mark.parametrize("C", [1, 5, 64])
def test_scan_madd_host_writes_the_defined_slots_only(hc, C):
    """With the rows' sorted digits the row function writes a prefix where
    the next pair has another digit and at the row's end, equal to the plain
    version's there, and leaves every other slot as it found it."""
    R = 4
    pts = _points(17 + C, R * C)
    xy = curve.points_to_device(pts, "cpu").reshape(R, C, 2, 8).contiguous()
    rng = np.random.default_rng(C)
    dsort = torch.from_numpy(np.sort(rng.integers(0, 6, size=(R, C)), axis=1)
                             .astype(np.int32))
    dsort[1] = 3                       # one digit: only the row's end
    dsort[2] = torch.arange(C)         # all different: every slot
    mask = msm_fb.scan_madd_defined(dsort)
    assert mask[1].sum() == 1 and mask[2].all() and mask[:, -1].all()
    out = torch.full((R, C, 3, 8), -7, dtype=torch.int32)
    hc.hc_scan_madd(_ptr(xy), _ptr(dsort), _ptr(out), R, C)
    assert torch.equal(out[mask], msm_fb.scan_madd_plain(xy)[mask])
    assert (out[~mask] == -7).all()


def _projective_rows(seed, B, n):
    """(B, n, 3, 8) projective points with random Z: a few multiples of G,
    the identity, a run of one repeated point and a point next to its
    inverse; and the same rows as affine oracle points."""
    rng = np.random.default_rng(seed)
    base = _points(seed, 5)
    base.append(rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(base[0]))))
    base.append((0, 0))
    pick = rng.integers(0, len(base), size=(B, n))
    if n >= 31:
        pick[:, 2:8] = 1
        pick[:, 9:11] = (0, 5)
        pick[:, 11] = pick[0, 0] = pick[1, -1] = 6
    flat = []
    for i in pick.reshape(-1):
        z = int.from_bytes(rng.bytes(32), "little") % (rc.FQ - 1) + 1
        x, y = base[i]
        flat += [0, z, 0] if base[i] == (0, 0) else [x * z % rc.FQ,
                                                     y * z % rc.FQ, z]
    rows = [[base[i] for i in row] for row in pick]
    return field.from_ints(FQ, flat, "cpu").reshape(B, n, 3, 8), rows


def _affine_list(P_):
    return curve.points_from_device(curve.to_affine(P_).reshape(-1, 2, 8))


@pytest.mark.parametrize("reverse", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("n,run", [(1, 8), (2, 8), (31, 8), (255, 8),
                                   (1000, 8), (255, 3)])
def test_point_scan_host(hc, n, run, reverse):
    """The blocked scan's run routines (scan_run_local, scan_run_apply) laid
    out as the kernel lays them out: equal to the plain version as affine
    points, and the row's last prefix to the oracle's sum of the row."""
    P_, rows = _projective_rows(40 + n, 2, n)
    out = torch.empty_like(P_)
    hc.hc_point_scan(_ptr(P_), _ptr(out), 2, n, run, reverse)
    assert _affine_list(out) == _affine_list(
        scan.point_scan_plain(P_, bool(reverse)))
    total = out[:, 0] if reverse else out[:, -1]
    assert _affine_list(total) == [rc.g1_msm(r, [1] * n) for r in rows]


@pytest.mark.parametrize("n,lanes", [(1, 128), (31, 128), (255, 128),
                                     (1000, 128), (1000, 7)])
def test_point_row_sum_host(hc, n, lanes):
    """The reduce half (point_sum_strided over `lanes` strided partial
    sums): equal to the plain version and to the oracle as affine points."""
    P_, rows = _projective_rows(60 + n, 2, n)
    out = torch.empty((2, 3, 8), dtype=torch.int32)
    hc.hc_point_row_sum(_ptr(P_), _ptr(out), 2, n, lanes)
    assert _affine_list(out) == _affine_list(scan.point_row_sum_plain(P_))
    assert _affine_list(out) == [rc.g1_msm(r, [1] * n) for r in rows]


@pytest.mark.parametrize("reverse", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("n,run,lanes", [(1, 8, 128), (2, 8, 128),
                                         (31, 8, 128), (255, 8, 128),
                                         (1000, 8, 7), (255, 3, 5)])
def test_point_scan_affine_host(hc, n, run, lanes, reverse):
    """The affine scan's run routines (scan_run_local_affine, then
    scan_run_apply) and its reduce half (point_sum_strided_affine) laid out
    as the kernels lay them out, (0, 0) among the points: equal to the plain
    version and to the oracle as affine points."""
    rng = np.random.default_rng(70 + n)
    base = _points(70 + n, 5) + [(0, 0)]
    pick = rng.integers(0, len(base), size=(2, n))
    if n >= 31:
        pick[:, 2:8] = 1
        pick[:, 0] = pick[1, -1] = 5
    rows = [[base[i] for i in row] for row in pick]
    xy = curve.points_to_device([p for r in rows for p in r],
                                "cpu").reshape(2, n, 2, 8)
    out = torch.empty((2, n, 3, 8), dtype=torch.int32)
    tot = torch.empty((2, 3, 8), dtype=torch.int32)
    hc.hc_point_scan_affine(_ptr(xy), _ptr(out), _ptr(tot), 2, n, run,
                            reverse, lanes)
    assert _affine_list(out) == _affine_list(
        scan.point_scan_affine_plain(xy, bool(reverse)))
    sums = [rc.g1_msm(r, [1] * n) for r in rows]
    assert _affine_list(out[:, 0] if reverse else out[:, -1]) == sums
    assert _affine_list(tot) == sums


@pytest.mark.parametrize("c,nwin", [(1, 4), (3, 5), (16, 2)])
def test_point_windows_host(hc, c, nwin):
    """The doubling chain of k_point_windows: every window equal to the
    plain loop over double_plain, word for word."""
    P_, _ = _projective_rows(90 + c, 1, 7)
    P_ = P_[0].contiguous()
    out = torch.empty((nwin, 7, 3, 8), dtype=torch.int32)
    hc.hc_point_windows(_ptr(P_), _ptr(out), 7, c, nwin)
    assert torch.equal(out, curve.windows_plain(P_, c, nwin))


@pytest.mark.parametrize("c,nwin", [(8, 32), (2, 3), (0, 4)])
def test_point_horner_host(hc, c, nwin):
    """The chain of k_point_horner: equal to the plain Horner word for word
    (the identity among the windows), and to the oracle's sum."""
    W, rows = _projective_rows(100 + nwin, 2, nwin)
    out = torch.empty((2, 3, 8), dtype=torch.int32)
    hc.hc_point_horner(_ptr(W), _ptr(out), 2, c, nwin)
    assert torch.equal(out, curve.horner_plain(W, c))
    assert _affine_list(out) == [
        rc.g1_msm(r, [1 << (c * w) for w in range(nwin)]) for r in rows]


def test_point_fixed_mul_host(hc):
    """The chain of k_point_fixed_mul over the window table of G: equal to
    the plain digit loop word for word and to the oracle's s * G; zero
    bytes, the zero scalar and r - 1 among the scalars."""
    table = kzg.g1_window_table(torch.device("cpu"))
    vals = _vals(rc.FR, 12, 20)
    vals[6:9] = [0x0100FF00000000FF, 1 << 250, 7]
    s = field.from_ints(FR, vals, "cpu")
    out = torch.empty((len(vals), 3, 8), dtype=torch.int32)
    hc.hc_point_fixed_mul(_ptr(table), _ptr(s), _ptr(out), len(vals))
    assert torch.equal(out, curve.fixed_mul_plain(s, table))
    G = rc.g1_from_affine(rc.G1_GEN)
    assert _affine_list(out) == [rc.g1_to_affine(rc.g1_mul(G, v))
                                 for v in vals]


def _toy_cs():
    from halo2_zkcert_tpu_torch.plonk import ADVICE, INSTANCE, Column
    cs = ConstraintSystem()
    q, tbl = cs.fixed_column(), cs.fixed_column()
    a, b, c = cs.advice_column(), cs.advice_column(), cs.advice_column()
    pi = cs.instance_column()
    cs.create_gate("mul_add", q * (a * b + a - c))
    cs.add_lookup("a_in_table", [(a, tbl)])
    for col in (Column(ADVICE, 0), Column(ADVICE, 1), Column(ADVICE, 2),
                Column(INSTANCE, pi.index)):
        cs.enable_permutation(col)
    return cs


def test_quotient_tape_host(hc):
    """The tape interpreter under its contract, Montgomery form in and out:
    equal to the plain version word for word, and nothing but the tape's
    products in between (a tape of one MUL gives a * b / R)."""
    cs = _toy_cs()
    k = 4
    n = 1 << k
    ext_n = n * 4
    tape = quotient.compile_tape(cs, n, ext_n)
    nleaves = len(quotient.leaf_layout(cs))
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(nleaves * ext_n)]
    leaves = field.from_ints(FR, vals, "cpu").reshape(nleaves, ext_n, 8)
    chal = field.from_ints(FR, [int(x) for x in rng.integers(1, 1 << 60,
                                                             size=4)], "cpu")
    consts = tape.const_table(chal)
    ins = torch.from_numpy(tape.ins).contiguous()
    out = torch.empty((ext_n, 8), dtype=torch.int32)
    hc.hc_quotient_forest(_ptr(leaves), ext_n, _ptr(consts), _ptr(ins),
                          ins.shape[0], tape.num_slots, tape.out_slot,
                          _ptr(out))
    assert torch.equal(out, quotient.quotient_forest_plain(leaves, consts,
                                                           tape))
    one_mul = torch.tensor([[quotient.LOAD, 0, 0, 0], [quotient.LOAD, 1, 1, 1],
                            [quotient.MUL, 2, 0, 1]], dtype=torch.int32)
    hc.hc_quotient_forest(_ptr(leaves), ext_n, _ptr(consts), _ptr(one_mul), 3,
                          3, 2, _ptr(out))
    rinv = rc.finv(FR.r, rc.FR)
    assert field.to_ints(out) == [
        vals[i] * vals[ext_n + (i + 1) % ext_n] * rinv % rc.FR
        for i in range(ext_n)]


def _host_ntt(hc, a, k, inverse, log_tile, in_scale=None, out_scale=None):
    def launch(*args):
        return hc.hc_ntt_pass(*args)
    return ntt.run_passes(launch, a.contiguous(), k,
                          ntt._twiddles(k, inverse, "cpu"), in_scale,
                          out_scale, log_tile)


@pytest.mark.parametrize("k,log_tile", [(1, 4), (3, 2), (3, 4), (8, 5),
                                        (8, 3), (11, 6), (11, 4)])
def test_ntt_host(hc, k, log_tile):
    """The transform's tile routine and pass indexing at a small tile, so
    that a transform crosses two passes (three at k = 8 over 2^3 and k = 11
    over 2^4): forward and inverse with 1/n, two columns, equal to the plain
    stage-by-stage transform."""
    assert len(ntt.passes(k, log_tile)) == -(-k // log_tile)
    n = 1 << k
    rng = np.random.default_rng(k)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(2 * n)]
    vals[:3] = [0, 1, rc.FR - 1]
    a = field.from_ints(FR, vals, "cpu").reshape(2, n, 8)
    assert torch.equal(_host_ntt(hc, a, k, False, log_tile),
                       ntt.ntt_plain(a, k))
    n_inv = field.const_mont(FR, rc.finv(n, rc.FR), "cpu")[None]
    assert torch.equal(_host_ntt(hc, a, k, True, log_tile, out_scale=n_inv),
                       ntt.intt_plain(a, k))


@pytest.mark.parametrize("k,log_tile,n_in", [(3, 2, 8), (8, 5, 64),
                                             (8, 5, 100), (11, 6, 512)])
def test_coset_ntt_host(hc, k, log_tile, n_in):
    """The scale tables on the first pass's loads and the last pass's
    stores, a short input read as zero-padded, and Montgomery form out of the
    forward transform and into the inverse one."""
    n, g = 1 << k, rc.FR_GENERATOR
    rng = np.random.default_rng(100 + k)
    a = field.from_ints(FR, [int.from_bytes(rng.bytes(32), "little") % rc.FR
                             for _ in range(n_in)], "cpu")[None]
    gpow = ntt.power_table(g, n, "cpu", mont=True)
    got = _host_ntt(hc, a, k, False, log_tile, in_scale=gpow)
    assert torch.equal(got, ntt.coset_ntt_plain(a, k, g))
    got_m = _host_ntt(hc, a, k, False, log_tile,
                      in_scale=field.to_mont(FR, gpow))
    assert torch.equal(got_m, field.to_mont(FR, got))
    assert torch.equal(got_m, ntt.coset_ntt_plain(a, k, g, out_mont=True))
    back = field.mul_const(FR, ntt.power_table(rc.finv(g, rc.FR), n, "cpu"),
                           rc.finv(n, rc.FR))
    want = ntt.coset_intt_plain(got, k, g)
    assert torch.equal(want[0, :n_in], a[0]) and not want[0, n_in:].any()
    assert torch.equal(_host_ntt(hc, got, k, True, log_tile,
                                 out_scale=field.to_mont(FR, back)), want)
    assert torch.equal(_host_ntt(hc, got_m, k, True, log_tile,
                                 out_scale=back), want)


def _scan_oracle(op, p, rows_a, rows_b, reverse):
    out = []
    for ra, rb in zip(rows_a, rows_b):
        if reverse:
            ra, rb = ra[::-1], rb[::-1]
        acc, row = {"mul": 1, "add": 0, "affine": 0}[op], []
        for x, y in zip(ra, rb):
            acc = {"mul": acc * x, "add": acc + x, "affine": x * acc + y}[op] % p
            row.append(acc)
        out.append(row[::-1] if reverse else row)
    return out


@pytest.mark.parametrize("reverse", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("fname", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "affine"])
@pytest.mark.parametrize("n,run", [(1, 8), (5, 8), (33, 8), (255, 3)])
def test_field_scan_host(hc, n, run, op, fname, reverse):
    """The blocked field scan's run routines (fs_run_local, fs_run_apply,
    fs_offset) laid out as the kernel lays them out: equal to the plain
    version and to the oracle's running product, sum or recurrence."""
    F = FR if fname == "Fr" else FQ
    p = F.modulus
    va = _vals(p, 7 * n + run, 2 * n + 6)[:2 * n]
    vb = _vals(p, 9 * n + run, 2 * n + 6)[-2 * n:]
    a = field.from_ints(F, va, "cpu").reshape(2, n, 8)
    b = field.from_ints(F, vb, "cpu").reshape(2, n, 8)
    out = torch.empty_like(a)
    assert hc.hc_field_scan(F.fid, frops._FS_OPS[op], _ptr(a), _ptr(b),
                            _ptr(out), 2, n, run, reverse) == 0
    want = _scan_oracle(op, p, [va[:n], va[n:]], [vb[:n], vb[n:]], reverse)
    assert field.to_ints(out) == want[0] + want[1]
    assert torch.equal(out, frops.field_scan_plain(
        a, op, bool(reverse), b if op == "affine" else None, F))


@pytest.mark.parametrize("op", ["mul", "add", "affine"])
@pytest.mark.parametrize("n,lanes", [(1, 128), (33, 128), (1000, 128),
                                     (1000, 7)])
def test_field_row_sum_host(hc, n, lanes, op):
    """The reduce half (fs_run_total over `lanes` consecutive chunks,
    combined in order): the row's sum equal to the plain pairwise halving,
    and its product or composed map to the oracle."""
    p = rc.FR
    va, vb = _vals(p, 11 * n, 2 * n + 6)[:2 * n], _vals(p, 13 * n, 2 * n + 6)[-2 * n:]
    a = field.from_ints(FR, va, "cpu").reshape(2, n, 8)
    b = field.from_ints(FR, vb, "cpu").reshape(2, n, 8)
    out_a = torch.empty((2, 8), dtype=torch.int32)
    out_b = torch.empty((2, 8), dtype=torch.int32)
    assert hc.hc_field_reduce(0, frops._FS_OPS[op], _ptr(a), _ptr(b),
                              _ptr(out_a), _ptr(out_b), 2, n, lanes) == 0
    rows = [va[:n], va[n:]]
    if op == "add":
        assert field.to_ints(out_a) == [sum(r) % p for r in rows]
        assert torch.equal(out_a, frops.tree_sum_batched_plain(a))
        return
    prods = []
    for r in rows:
        acc = 1
        for x in r:
            acc = acc * x % p
        prods.append(acc)
    assert field.to_ints(out_a) == prods
    if op == "affine":
        last = _scan_oracle(op, p, rows, [vb[:n], vb[n:]], False)
        assert field.to_ints(out_b) == [last[0][-1], last[1][-1]]

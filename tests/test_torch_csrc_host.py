"""The kernels' own arithmetic, checked without a GPU: csrc/bn254.cuh's
__host__ __device__ field, RCB16 and tape-interpreter functions, built with
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

from halo2_zkcert_tpu_torch.ops import curve, field, msm_fb, scan
from halo2_zkcert_tpu_torch.ops.field import FQ, FR
from halo2_zkcert_tpu_torch.plonk import quotient
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
    lib.hc_quotient_forest.argtypes = [P, L, P, P, ctypes.c_int, ctypes.c_int,
                                       P]
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
                          ins.shape[0], tape.out_slot, _ptr(out))
    assert torch.equal(out, quotient.quotient_forest_plain(leaves, consts,
                                                           tape))

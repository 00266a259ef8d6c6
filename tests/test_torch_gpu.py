"""Kernels K1-K6 on the card against their plain versions, at small shapes.

Marked `gpu`: each test decides inside itself whether a CUDA device exists
and skips without one.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import curve, field, kernels, msm_fb
from halo2_zkcert_tpu_torch.ops.field import FQ, FR
from halo2_zkcert_tpu_torch.plonk import quotient
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

pytestmark = pytest.mark.gpu


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(F, seed, count, device):
    rng = np.random.default_rng(seed)
    vals = [0, 1, F.modulus - 1] + [
        int.from_bytes(rng.bytes(32), "little") % F.modulus
        for _ in range(count - 3)]
    return field.from_ints(F, vals, device)


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_binop_kernel(fname, op):
    dev = _device()
    F = FR if fname == "Fr" else FQ
    a, b = _rand(F, 1, 1000, dev), _rand(F, 2, 1000, dev).flip(0)
    before = kernels.launches[f"field_binop.{op}"]
    got = field.binop(F, op, a, b)
    assert kernels.launches[f"field_binop.{op}"] == before + 1
    assert torch.equal(got, field.binop_plain(F, op, a, b))
    row = b[:7].contiguous()                       # a periodic operand
    got = field.binop(F, op, a[:7 * 100].reshape(100, 7, 8), row)
    want = field.binop_plain(F, op, a[:700].reshape(100, 7, 8), row)
    assert torch.equal(got, want)


def test_point_kernels():
    dev = _device()
    G = rc.g1_from_affine(rc.G1_GEN)
    pts = [rc.g1_to_affine(rc.g1_mul(G, s)) for s in range(1, 65)]
    P = curve.from_affine(curve.points_to_device(pts, dev))
    Q = P.roll(1, 0).contiguous()
    Q[:2] = P[:2]
    assert torch.equal(curve.add(P, Q), curve.add_plain(P, Q))
    assert torch.equal(curve.double(P), curve.double_plain(P))


def _multiples(count, dev):
    G = rc.g1_from_affine(rc.G1_GEN)
    return curve.points_to_device(
        [rc.g1_to_affine(rc.g1_mul(G, s)) for s in range(1, count + 1)], dev)


def test_point_add_mixed_kernel():
    """K5 against its plain version: P = identity, P = Q, P = -Q, random."""
    dev = _device()
    Q = _multiples(64, dev)
    P = curve.from_affine(Q.roll(1, 0)).contiguous()
    P[0] = curve.identity((), dev)
    P[1:3] = curve.from_affine(Q[1:3])
    P[3:5] = curve.neg(curve.from_affine(Q[3:5]))
    before = kernels.launches["point_add_mixed"]
    got = curve.add_mixed(P, Q)
    assert kernels.launches["point_add_mixed"] == before + 1
    assert torch.equal(got, curve.add_mixed_plain(P, Q))
    assert torch.equal(got, curve.add_plain(P, curve.from_affine(Q)))


@pytest.mark.parametrize("R,C", [(5, 64), (300, 7), (2, 1)])
def test_scan_madd_kernel(R, C):
    """K6 against its plain version, C a launch argument; one row repeats a
    point, so the scan doubles inside."""
    dev = _device()
    base = _multiples(97, dev)
    idx = torch.from_numpy(np.random.default_rng(R).integers(
        0, 97, size=(R, C))).to(dev)
    idx[0] = 3
    xy = base[idx]
    before = kernels.launches["scan_madd"]
    got = msm_fb.scan_madd(xy)
    assert kernels.launches["scan_madd"] == before + 1
    assert torch.equal(got, msm_fb.scan_madd_plain(xy))


def test_fixed_base_msm_on_card():
    """Both scan branches of the fixed-base MSM on the card (whole SCAN_C
    rows through K6, a ragged width through K5) against the variable-base
    MSM of the same points and scalars."""
    dev = _device()
    from halo2_zkcert_tpu_torch.ops import msm
    for n in (64, 37):
        base = _multiples(n, dev)
        cols = torch.stack([_rand(FR, 10 + j, n, dev) for j in range(3)])
        fb = msm_fb.FixedBaseMsm(base, wbits=8)
        kernels.reset_launches()
        got = curve.to_affine(fb.msm_many(cols))
        assert kernels.launches["scan_madd" if n == 64
                                else "point_add_mixed"] > 0
        assert torch.equal(got, curve.to_affine(msm.msm_many(base, cols)))


def test_quotient_kernel():
    dev = _device()
    from halo2_zkcert_tpu_torch.plonk import ADVICE, Column, ConstraintSystem
    cs = ConstraintSystem()
    q, tbl = cs.fixed_column(), cs.fixed_column()
    a, b = cs.advice_column(), cs.advice_column()
    cs.create_gate("mul", q * (a * b - a))
    cs.add_lookup("t", [(a, tbl)])
    cs.enable_permutation(Column(ADVICE, 0))
    cs.enable_permutation(Column(ADVICE, 1))
    tape = quotient.compile_tape(cs, 16, 64)
    L = len(quotient.leaf_layout(cs))
    leaves = _rand(FR, 3, L * 64, dev).reshape(L, 64, 8)
    consts = tape.const_table(_rand(FR, 4, tape.num_challenges, dev))
    assert torch.equal(quotient.quotient_forest(leaves, consts, tape),
                       quotient.quotient_forest_plain(leaves, consts, tape))

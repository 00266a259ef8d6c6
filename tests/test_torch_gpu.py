"""Kernels K1-K4 on the card against their plain versions, at small shapes.

Marked `gpu`: each test decides inside itself whether a CUDA device exists
and skips without one.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import curve, field, kernels
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

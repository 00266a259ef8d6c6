"""Port field arithmetic (halo2_zkcert_tpu_torch.ops.field) against the JAX
package's limb arithmetic and the Python-int oracle, exactly.

The port's wrapper of kernel K1 runs its plain version on CPU tensors; the
JAX side runs its XLA path (the Pallas route is TPU-only).  Inputs are made
with a seeded numpy generator and handed to both sides.
"""
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import limbs as jlimbs
from halo2_zkcert_tpu.ops.field import Fq as JFq
from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FQ, FR

torch.set_num_threads(2)

FIELDS = {"Fr": (FR, JFr, rc.FR), "Fq": (FQ, JFq, rc.FQ)}
ALL255 = (1 << 256) - 1


def _adversarial(p: int, rng: np.random.Generator, count: int) -> list:
    """Edge values first, then uniform values below p."""
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << 253, (1 << 254) % p,
            ALL255 % p]
    rand = [int.from_bytes(rng.bytes(32), "little") % p
            for _ in range(count - len(edge))]
    return edge + rand


def _pairs(p, seed, count=40):
    rng = np.random.default_rng(seed)
    a = _adversarial(p, rng, count)
    b = _adversarial(p, rng, count)[::-1]
    return a, b


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binop_matches_jax_and_oracle(fname, op):
    F, J, p = FIELDS[fname]
    a, b = _pairs(p, seed=("mul", "add", "sub").index(op) + 10 * (F is FQ))
    got = field.to_ints(field.binop(F, op, field.from_ints(F, a, "cpu"),
                                    field.from_ints(F, b, "cpu")))
    jfn = {"mul": J.mul, "add": J.add, "sub": J.sub}[op]
    want_jax = [int(v) for v in J.to_ints(jfn(J.from_ints(a), J.from_ints(b)))]
    py = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    want = [py(x, y) % p for x, y in zip(a, b)]
    assert got == want
    assert got == want_jax


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
def test_neg_inv_pow(fname):
    F, J, p = FIELDS[fname]
    a, _ = _pairs(p, seed=7, count=16)
    t = field.from_ints(F, a, "cpu")
    assert field.to_ints(field.neg(F, t)) == [(-x) % p for x in a]
    assert field.to_ints(field.neg(F, t)) == [
        int(v) for v in J.to_ints(J.neg(J.from_ints(a)))]
    inv = field.to_ints(field.inv(F, t))
    assert inv == [pow(x, p - 2, p) for x in a]           # 0 -> 0
    assert field.to_ints(field.pow_const(F, t, 5)) == [pow(x, 5, p) for x in a]
    assert field.to_ints(field.mul_const(F, t, 12345)) == [
        x * 12345 % p for x in a]


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
def test_mul_mont_and_conversions(fname):
    """`mul_mont` is a * b / R: with an operand that holds v * R it is the
    canonical product a * v, as `mul_const` uses it; `to_mont` and
    `from_mont` convert a whole tensor."""
    F, J, p = FIELDS[fname]
    a, v = _pairs(p, seed=21, count=24)
    R = 1 << 256
    ta = field.from_ints(F, a, "cpu")
    assert F.r == R % p and field.OP_NAMES[field.OP_MULM] == "mulm"
    tv = field.from_ints(F, [x * R for x in v], "cpu")
    want = [x * y % p for x, y in zip(a, v)]
    assert field.to_ints(field.mul_mont(F, ta, tv)) == want
    assert want == [int(x) for x in J.to_ints(
        J.mul(J.from_ints(a), J.from_ints(v)))]
    assert field.to_ints(field.mul_mont(F, ta, field.from_ints(F, v, "cpu"))) \
        == [x * y * pow(R, -1, p) % p for x, y in zip(a, v)]
    assert field.to_ints(field.to_mont(F, ta)) == [x * R % p for x in a]
    assert torch.equal(field.from_mont(F, field.to_mont(F, ta)), ta)
    assert field.to_int(field.const_mont(F, 7, "cpu")) == 7 * R % p
    assert field.to_ints(field.mul_const(F, ta, p - 2)) == [
        x * (p - 2) % p for x in a]
    assert torch.equal(field.binop(F, "mulm", ta, tv),
                       field.mul_mont_plain(F, ta, tv))


def test_canonical_bytes_roundtrip():
    rng = np.random.default_rng(3)
    vals = _adversarial(rc.FR, rng, 20)
    t = field.from_ints(FR, vals, "cpu")
    raw = t.numpy().astype("<i4").tobytes()
    assert raw == b"".join(rc.fe_to_bytes_le(v) for v in vals)
    assert field.to_ints(t) == vals
    # from_ints reduces its input mod p
    assert field.to_ints(field.from_ints(FR, [rc.FR, rc.FR + 5, ALL255],
                                         "cpu")) == [0, 5, ALL255 % rc.FR]


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
def test_from_resident_matches_jax(fname):
    """JAX resident limbs (limbs up to 511, value < 2^259) -> canonical."""
    F, J, p = FIELDS[fname]
    rng = np.random.default_rng(11)
    res = rng.integers(0, 512, size=(64, 33), dtype=np.int64)
    res[:, 32] = rng.integers(0, 4, size=64)
    res[0] = 0
    res[1, :32], res[1, 32] = 511, 3                     # the largest value
    res[2] = jlimbs.int_to_limbs(p)                       # p itself -> 0
    res = res.astype(np.int32)
    got = field.to_ints(field.from_resident(F, torch.from_numpy(res)))
    want_jax = [int(v) for v in J.to_ints(res)]
    want = [jlimbs.limbs_to_int(r) % p for r in res]
    assert got == want == want_jax


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
def test_mul_of_jax_resident_outputs(fname):
    """Lazy JAX outputs carried across and multiplied in the port agree with
    multiplying in JAX."""
    F, J, p = FIELDS[fname]
    a, b = _pairs(p, seed=5, count=24)
    ja = J.mul(J.from_ints(a), J.from_ints(b))           # resident, lazy
    jb = J.add(J.from_ints(b), J.from_ints(a))
    want = [int(v) for v in J.to_ints(J.mul(ja, jb))]
    ta = field.from_resident(F, torch.from_numpy(np.array(ja)))
    tb = field.from_resident(F, torch.from_numpy(np.array(jb)))
    assert field.to_ints(field.mul(F, ta, tb)) == want


def test_broadcasting_second_operand():
    rng = np.random.default_rng(9)
    a = [[int.from_bytes(rng.bytes(32), "little") % rc.FR for _ in range(5)]
         for _ in range(3)]
    row = [int.from_bytes(rng.bytes(32), "little") % rc.FR for _ in range(5)]
    ta = field.from_ints(FR, sum(a, []), "cpu").reshape(3, 5, 8)
    tr = field.from_ints(FR, row, "cpu")
    got = field.to_ints(field.mul(FR, ta, tr).reshape(-1, 8))
    assert got == [x * y % rc.FR for r in a for x, y in zip(r, row)]
    got = field.to_ints(field.sub(FR, tr, ta).reshape(-1, 8))
    assert got == [(y - x) % rc.FR for r in a for x, y in zip(r, row)]


def test_wrapper_refuses_nothing_on_cpu_and_needs_cuda_otherwise():
    """The kernel wrapper takes the plain version only for CPU tensors; its
    CUDA checks reject a CPU tensor handed to the launch path."""
    from halo2_zkcert_tpu_torch.ops import kernels
    t = field.from_ints(FR, [1, 2], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require_cuda_int32("field_binop", t)

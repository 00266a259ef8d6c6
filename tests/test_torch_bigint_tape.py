"""The port's bigint tape, ECC gadget and composed circuit
(halo2_zkcert_tpu_torch/circuits/{bigint_tape,ecc_gadget,composed}.py)
against the JAX package's, on the four programs of
tests/test_bigint_tape.py at k=17: both packages record and lay out each
program, and the constraint system, the fixed columns, the copies, the
instances and both phases' advice columns at the MockProver's challenge
are compared exactly.  The port's MockProver then runs on the CPU (the
plain arithmetic): satisfied on each program, and it reports a V-lane limb
tampered as in tests/test_bigint_tape.py.
"""
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.circuits.composed import ComposedCircuit as JComposed
from halo2_zkcert_tpu.circuits.ecc_gadget import EccGadget as JEccGadget
from halo2_zkcert_tpu.plonk.mock import mock_challenges as jmock_challenges
from halo2_zkcert_tpu_torch.circuits.composed import ComposedCircuit
from halo2_zkcert_tpu_torch.circuits.ecc_gadget import EccGadget
from halo2_zkcert_tpu_torch.plonk import run_mock
from halo2_zkcert_tpu_torch.plonk.assignment import copy_table
from halo2_zkcert_tpu_torch.plonk.mock import mock_challenges
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

A_VAL = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF1234567890ABCD
B_VAL = 0xFEDCBA0987654321FEDCBA0987654321FEDCBA0987654321FEDCBA09876543


def mulmod_lincomb(gb, tape, ecc_cls):
    a = tape.witness_elem(A_VAL)
    b = tape.witness_elem(B_VAL)
    z = tape.mulmod(a, b)
    assert z.value == A_VAL * B_VAL % rc.FQ
    s = tape.add(a, b)
    d = tape.sub(a, b)
    assert d.value % rc.FQ == (A_VAL - B_VAL) % rc.FQ
    r = tape.reduce(d)
    assert r.value == (A_VAL - B_VAL) % rc.FQ
    tape.assert_eq_mod(s, tape.constant_elem((A_VAL + B_VAL) % rc.FQ))
    w = tape.mulmod(z, s)
    tape.assert_eq_mod(
        w, tape.constant_elem(
            (A_VAL * B_VAL % rc.FQ) * ((A_VAL + B_VAL) % rc.FQ) % rc.FQ))


def mulmod_only(gb, tape, ecc_cls):
    a = tape.witness_elem(A_VAL)
    b = tape.witness_elem(B_VAL)
    tape.mulmod(a, b)


def ec_add_double(gb, tape, ecc_cls):
    g = rc.G1_GEN
    g2 = rc.g1_to_affine(rc.g1_double(rc.g1_from_affine(g)))
    g3 = rc.g1_to_affine(rc.g1_add(rc.g1_from_affine(g),
                                   rc.g1_from_affine(g2)))
    ecc = ecc_cls(tape)
    p = ecc.witness_point(g)
    q = ecc.witness_point(g2)
    s = ecc.add(p, q)
    assert s.value == g3
    d = ecc.double(p)
    assert d.value == g2
    tape.assert_eq_mod(s.x, tape.constant_elem(g3[0]))
    tape.assert_eq_mod(s.y, tape.constant_elem(g3[1]))
    tape.assert_eq_mod(d.x, tape.constant_elem(g2[0]))


def msm_small(gb, tape, ecc_cls):
    g = rc.g1_from_affine(rc.G1_GEN)
    p1 = rc.g1_to_affine(rc.g1_mul(g, 7))
    p2 = rc.g1_to_affine(rc.g1_mul(g, 11))
    s1, s2 = 0xBEEF, 0x1234
    expect = rc.g1_to_affine(rc.g1_mul(g, (7 * s1 + 11 * s2) % rc.FR))
    ecc = ecc_cls(tape)
    a = ecc.witness_point(p1)
    b = ecc.witness_point(p2)
    out = ecc.msm([a, b], [gb.witness(s1), gb.witness(s2)], nbits=16)
    assert out.value == expect
    tape.assert_eq_mod(out.x, tape.constant_elem(expect[0]))
    tape.assert_eq_mod(out.y, tape.constant_elem(expect[1]))


# (program, lanes, na) as tests/test_bigint_tape.py builds them at k=17
PROGRAMS = {"mulmod_lincomb": (mulmod_lincomb, 1, 1),
            "tampered_limb": (mulmod_only, 1, 1),
            "ec_add_double": (ec_add_double, 1, 1),
            "msm_small": (msm_small, 2, 2)}
K = 17


def _words_of_limbs(limbs) -> np.ndarray:
    """The JAX package's canonical 8-bit limbs -> (n, 8) int32 words."""
    raw = np.ascontiguousarray(np.asarray(limbs)[:, :32].astype(np.uint8))
    return raw.view("<i4").reshape(-1, 8)


def _both(name):
    program, lanes, na = PROGRAMS[name]
    jc = JComposed(lambda gb, tape: program(gb, tape, JEccGadget), k=K,
                   lanes=lanes, na=na)
    pc = ComposedCircuit(lambda gb, tape: program(gb, tape, EccGadget), k=K,
                         lanes=lanes, na=na)
    return jc, pc


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def both(request):
    return request.param, _both(request.param)


def test_structure_equal(both):
    """Constraint system, fixed columns, copies, instances and the row
    report equal the JAX package's."""
    _, (jc, pc) = both
    assert pc.cs.to_dict() == jc.cs.to_dict()
    assert pc.data.cs.digest_bytes() == jc.data.cs.digest_bytes()
    jfixed = np.asarray(jc.data.fixed, dtype=object)
    assert pc.data.fixed.shape == jfixed.shape
    assert (pc.data.fixed == jfixed).all()
    assert np.array_equal(copy_table(pc.data.copies),
                          copy_table(jc.data.copies))
    assert pc.data.num_instance == jc.data.num_instance
    assert pc.rows_report() == jc.rows_report()
    assert pc.data.cache_digest_bytes() == jc.data.cache_digest_bytes()


def test_witness_equal(both):
    """Both phases' advice columns at the MockProver's challenge, and the
    instances, equal the JAX package's word for word."""
    _, (jc, pc) = both
    ch = mock_challenges(pc.cs)
    assert ch == jmock_challenges(jc.cs)
    jfn, jinst = jc.witness()
    pfn, pinst = pc.witness("cpu")
    assert pinst == jinst
    for phase, avail in ((0, {}), (1, ch)):
        jcols, pcols = jfn(phase, avail), pfn(phase, avail)
        assert sorted(pcols) == sorted(jcols)
        for i, v in jcols.items():
            assert np.array_equal(pcols[i].numpy(), _words_of_limbs(v)), \
                (phase, i)


def test_witness_pass_is_kept_for_its_tau(both):
    """A second phase-1 call at the same tau reuses the pass; another tau
    records a new one, structure and phase 0 held to the build pass."""
    _, (_, pc) = both
    fn, _ = pc.witness("cpu")
    tau = mock_challenges(pc.cs)[0]
    first = fn(1, {0: tau})
    passes = len(pc.pass_seconds)
    again = fn(1, {0: tau})
    assert len(pc.pass_seconds) == passes
    assert all(torch.equal(first[i], again[i]) for i in first)
    other = fn(1, {0: tau + 1})
    assert len(pc.pass_seconds) == passes + 1
    assert any(not torch.equal(first[i], other[i]) for i in first)


def _advice(pc) -> torch.Tensor:
    ch = mock_challenges(pc.cs)
    fn, _ = pc.witness("cpu")
    cols = [None] * pc.cs.num_advice
    for phase in range(pc.cs.num_phases):
        avail = {i: ch[i] for i in range(pc.cs.num_challenges)
                 if pc.cs.challenge_phases[i] < phase}
        for i, v in fn(phase, avail).items():
            cols[i] = v
    return torch.stack(cols)


@pytest.mark.parametrize("name", ["mulmod_lincomb", "ec_add_double",
                                  "msm_small"])
def test_mock_satisfied(name):
    """The port's MockProver on the CPU is satisfied by each program (the
    tampered program's clean witness is the first half of mulmod_lincomb)."""
    _, pc = _both(name)
    fn, inst = pc.witness("cpu")
    fails = run_mock(pc.data, fn, inst, raise_on_failure=False)
    assert fails == [], fails[:5]


def test_mock_catches_tampered_limb():
    """One V-lane limb plus one inside the first witnessed region (as
    tests/test_bigint_tape.py tampers it) violates the constraints."""
    _, pc = _both("tampered_limb")
    adv = _advice(pc)
    reg = next(r for r in pc._pass0.tape.regions if r.kind == "w")
    adv[pc.v_indices[reg.lane], reg.start + 2, 0] += 1
    _, inst = pc.witness("cpu")
    fails = run_mock(pc.data, adv, inst, raise_on_failure=False)
    assert fails, "tampered witness must violate constraints"

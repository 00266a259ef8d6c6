"""The port's vertical-gate builder (halo2_zkcert_tpu_torch/builder.py) and
MockProver (plonk/mock.py) against the JAX package's, case by case as
tests/test_builder.py drives the JAX ones: the same CircuitData (constraint
system, fixed columns, copies, instance rows), the same advice words and
instances, and the same MockProver verdicts, failure strings included.

The sample's k=8 key and proof are held to tests/data/builder_reference.npz
(written by tests/data/make_builder_reference.py with the JAX package).  On
the plain versions the port's keygen and proof take the CPU about five
minutes, so that test is `slow`; tests/test_torch_gpu.py and chip_smoke.py
hold the same bytes on the card.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.builder import GateBuilder as JGateBuilder
from halo2_zkcert_tpu.ops import limbs as jlimbs
from halo2_zkcert_tpu.plonk import run_mock as jrun_mock
from halo2_zkcert_tpu_torch.builder import GateBuilder
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.plonk import run_mock
from halo2_zkcert_tpu_torch.plonk.assignment import CopyArray, copy_table
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, DATA)
from make_builder_reference import K, build_sample, reference  # noqa: E402

FIXTURE = os.path.join(DATA, "builder_reference.npz")


def _range_violation(cls):
    gb = cls(lookup_bits=7)
    x = gb.witness((1 << 14) + 3)   # too big for 14 bits
    gb.range_check(x, 14)
    return gb


def _multi_column(cls):
    gb = cls(lookup_bits=7)
    acc = gb.witness(1)
    for i in range(200):                 # ~800 cells -> 4+ columns at k=8
        acc = gb.mul_add(acc, gb.constant(3), gb.constant(i))
    gb.expose_public(acc)
    return gb


def _range_tight(cls):
    gb = cls(lookup_bits=7)
    for v, bits in ((5, 3), (100, 7), (1000, 10), (70000, 17)):
        gb.range_check(gb.witness(v), bits)
    gb.assert_bit(gb.witness(1))
    gb.expose_public(gb.select(gb.witness(1), gb.witness(9), gb.witness(4)))
    gb.expose_public(gb.horner([gb.witness(2), gb.witness(3)],
                               gb.neg(gb.witness(5))))
    gb.expose_public(gb.pow5(gb.add_const(gb.witness(7), rc.FR - 9)))
    return gb


CASES = {"sample": build_sample, "range_violation": _range_violation,
         "multi_column": _multi_column, "range_tight": _range_tight}


def _jax_words(advice) -> np.ndarray:
    a = np.asarray(advice)
    return np.array([[jlimbs.limbs_to_int(r) % rc.FR for r in col]
                     for col in a], dtype=object)


def _port_words(advice) -> np.ndarray:
    return np.array([field.words_to_ints(c) for c in advice], dtype=object)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    build = CASES[request.param]
    jd, ja, ji = build(JGateBuilder).finalize(K)
    td, ta, ti = build(GateBuilder).finalize(K, device="cpu")
    return request.param, (jd, ja, ji), (td, ta, ti)


def test_circuit_data_equals_jax(pair):
    _, (jd, _, ji), (td, _, ti) = pair
    assert td.cs.to_dict() == jd.cs.to_dict()
    assert td.cs.digest_bytes() == jd.cs.digest_bytes()
    assert td.k == jd.k and td.num_instance == jd.num_instance
    assert np.array_equal(td.fixed, jd.fixed)
    assert isinstance(td.copies, CopyArray)
    assert list(td.copies) == jd.copies
    assert td.cache_digest_bytes() == jd.cache_digest_bytes()
    assert ti == ji


def test_advice_words_equal_jax(pair):
    _, (_, ja, _), (_, ta, _) = pair
    assert ta.dtype == torch.int32 and ta.shape[-1] == 8
    assert np.array_equal(_port_words(ta), _jax_words(ja))


def test_mock_verdict_equals_jax(pair):
    name, (jd, ja, ji), (td, ta, ti) = pair
    want = jrun_mock(jd, ja, ji, raise_on_failure=False)
    assert run_mock(td, ta, ti, raise_on_failure=False) == want
    assert bool(want) == (name == "range_violation")


def test_values_and_params():
    gb = build_sample(GateBuilder)
    data, advice, instances = gb.finalize(K, device="cpu")
    x, y = 12, 45
    z = (5 + x * y) % rc.FR
    w = (z - x) % rc.FR
    assert instances[0] == [(x * y + y * z + z * w) % rc.FR, w]
    cfg = gb.calculate_params(K)
    assert cfg == build_sample(JGateBuilder).calculate_params(K)
    assert cfg["num_advice"] >= 1 and cfg["num_lookup_advice"] >= 1


def test_mock_rejects_wrong_instance():
    jd, ja, ji = build_sample(JGateBuilder).finalize(K)
    td, ta, ti = build_sample(GateBuilder).finalize(K, device="cpu")
    for pos in (0, 1):
        bad = [list(ti[0])]
        bad[0][pos] = (bad[0][pos] + 1) % rc.FR
        got = run_mock(td, ta, bad, raise_on_failure=False)
        assert got and got == jrun_mock(jd, ja, bad, raise_on_failure=False)


def test_mock_reports_a_corrupted_cell_as_jax_does():
    jd, ja, ji = build_sample(JGateBuilder).finalize(K)
    td, ta, ti = build_sample(GateBuilder).finalize(K, device="cpu")
    ja = np.asarray(ja).copy()
    for col, row in ((0, 5), (0, 46), (1, 0)):     # column 1: the lookup
        jbad = ja.copy()
        jbad[col, row, 0] += 1
        tbad = ta.clone()
        tbad[col, row, 0] += 1
        want = jrun_mock(jd, jbad, ji, raise_on_failure=False)
        assert want and run_mock(td, tbad, ti, raise_on_failure=False) == want


def test_mock_raises_on_failure():
    from halo2_zkcert_tpu_torch.plonk import MockFailure
    td, ta, _ = _range_violation(GateBuilder).finalize(K, device="cpu")
    with pytest.raises(MockFailure, match="copy constraint violated"):
        run_mock(td, ta, [])


def test_multi_column_packing():
    data, advice, instances = _multi_column(GateBuilder).finalize(
        K, device="cpu")
    assert data.cs.num_advice >= 2
    assert run_mock(data, advice, instances) == []


def test_trace_too_long_for_the_columns_raises():
    gb = _multi_column(GateBuilder)
    cs_cols = dict(gb.calculate_params(K), num_advice=1)
    with pytest.raises(ValueError, match="more columns"):
        gb.finalize(K, cs_cols, device="cpu")


def test_copy_array_reads_as_the_copy_list():
    copies = [(("advice", 0, 3), ("fixed", 2, 7)),
              (("instance", 0, 1), ("advice", 4, 0))]
    arr = CopyArray(copy_table(copies))
    assert len(arr) == 2 and list(arr) == copies
    assert arr[1] == copies[1] and arr[:1] == copies[:1]
    assert arr[-1:] == copies[-1:] and arr[::2] == copies[::2]
    assert repr(arr[:2]) == repr(copies)
    assert np.array_equal(copy_table(arr), copy_table(copies))


@pytest.mark.slow
def test_prove_verify_equals_reference():
    """The sample's key and proof on the CPU equal the JAX package's; a
    wrong instance is rejected.  About five minutes on the plain
    versions."""
    from halo2_zkcert_tpu_torch.plonk import (create_proof, keygen, setup,
                                              verify_proof)
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    z = np.load(FIXTURE)
    ref_vk = json.loads(z["vk_json"].tobytes())
    data, advice, instances = build_sample(GateBuilder).finalize(
        K, device="cpu")
    assert instances == json.loads(z["instances_json"].tobytes())
    params = setup(K, device="cpu")
    pk = keygen(params, data)
    assert vk_to_dict(pk.vk) == ref_vk
    proof = create_proof(params, pk, advice, instances, PoseidonTranscript())
    assert proof == z["proof_poseidon"].tobytes()
    assert verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    bad = [list(instances[0])]
    bad[0][1] = (bad[0][1] + 1) % rc.FR
    assert not verify_proof(params, pk.vk, bad, proof, PoseidonTranscript)


@pytest.mark.slow
def test_reference_fixture_is_current():
    """The committed fixture is what the JAX package computes now (about
    six minutes)."""
    z = np.load(FIXTURE)
    fresh = reference()
    assert sorted(fresh) == sorted(z.files)
    for key, arr in fresh.items():
        assert np.array_equal(arr, z[key]), key


def test_fixture_is_consistent():
    """The committed vk is of the port's sample circuit, and the fixture's
    instances are the sample's."""
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    z = np.load(FIXTURE)
    vk = vk_from_dict(json.loads(z["vk_json"].tobytes()))
    data, _, instances = build_sample(GateBuilder).finalize(K, device="cpu")
    assert vk.cs.digest_bytes() == data.cs.digest_bytes()
    assert vk.k == K and vk.num_instance == data.num_instance
    assert json.loads(z["instances_json"].tobytes()) == instances
    assert len(z["proof_poseidon"]) > 0

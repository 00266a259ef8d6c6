"""The port's gate-level SHA-256 circuit (circuits/sha256_gate.py) against
the JAX package's.

`Sha256GateCircuit(b"abc", k=15)` packs 396 010 cells into 13 advice
columns: the constraint system of the reference CLI's 970-byte TBS at its
default k=19.  At k=15 the port gives the JAX package's constraint system,
fixed columns, copies, witness, instances (the digest bytes, which equal
hashlib's), `permutation_mapping` and MockProver verdicts.  The key and
proof there are held to tests/data/sha256_gate_reference.npz (written by
tests/data/make_sha256_gate_reference.py with the JAX package) on the card
(tests/test_torch_gpu.py, chip_smoke.py): the plain versions would take
the CPU hours.  The 970-byte circuit at k=19 is compared with the JAX
package's in a `slow` test.
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.circuits.sha256_gate import \
    Sha256GateCircuit as JSha256GateCircuit
from halo2_zkcert_tpu.plonk import run_mock as jrun_mock
from halo2_zkcert_tpu.plonk.assignment import \
    permutation_mapping as jpermutation_mapping
from halo2_zkcert_tpu_torch.cert import (extract_public_key,
                                         extract_tbs_and_sig, parse_pem)
from halo2_zkcert_tpu_torch.circuits.rsa import RsaCircuit
from halo2_zkcert_tpu_torch.circuits.sha256_gate import Sha256GateCircuit
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.plonk import quotient, run_mock
from halo2_zkcert_tpu_torch.plonk.assignment import permutation_mapping
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, DATA)
from make_sha256_gate_reference import K, MSG, reference  # noqa: E402

FIXTURE = os.path.join(DATA, "sha256_gate_reference.npz")


def _jax_words(advice) -> torch.Tensor:
    return field.from_resident(field.FR, torch.from_numpy(
        np.array(advice, dtype=np.int32)))


@pytest.fixture(scope="module")
def circuits():
    return JSha256GateCircuit(MSG, k=K), Sha256GateCircuit(MSG, k=K,
                                                           device="cpu")


def _same_circuit(j, c):
    assert c.data.cs.to_dict() == j.data.cs.to_dict()
    assert c.data.k == j.data.k and c.data.num_instance == j.data.num_instance
    assert np.array_equal(c.data.fixed, j.data.fixed)
    assert len(c.data.copies) == len(j.data.copies)
    assert list(c.data.copies) == j.data.copies
    assert c.instances == j.instances
    assert torch.equal(c.advice, _jax_words(j.advice))


def test_circuit_and_witness_equal_jax(circuits):
    j, c = circuits
    cs = c.data.cs
    assert (cs.num_advice, cs.num_fixed, cs.num_instance) == (13, 14, 1)
    assert len(cs.permutation_columns) == 15 and not cs.lookups
    assert len(c.gb.values) == 396_010
    _same_circuit(j, c)


def test_instances_are_the_digest_bytes(circuits):
    _, c = circuits
    assert c.instances == [list(hashlib.sha256(MSG).digest())]


@pytest.mark.parametrize("msg", [b"", b"a" * 55, b"b" * 56, b"c" * 64])
def test_digest_cells_equal_hashlib(msg):
    c = Sha256GateCircuit(msg, k=K, device="cpu")
    assert c.instances == [list(hashlib.sha256(msg).digest())]


def test_permutation_mapping_equals_jax(circuits):
    j, c = circuits
    assert np.array_equal(permutation_mapping(c.data),
                          jpermutation_mapping(j.data))


def test_permutation_mapping_equals_jax_on_the_rsa_circuit():
    from halo2_zkcert_tpu import cert as jcert
    from halo2_zkcert_tpu.circuits.rsa import RsaCircuit as JRsaCircuit
    with open(os.path.join(ROOT, "testdata", "example_cert_2.pem"), "rb") as f:
        pem = f.read()
    c = RsaCircuit(extract_public_key(parse_pem(pem)), k=17)
    j = JRsaCircuit(jcert.extract_public_key(jcert.parse_pem(pem)), k=17)
    assert np.array_equal(permutation_mapping(c.data),
                          jpermutation_mapping(j.data))


def test_mock_verdicts_equal_jax(circuits):
    j, c = circuits
    assert run_mock(c.data, c.advice, c.instances) == []
    bad = [list(c.instances[0])]
    bad[0][0] ^= 1
    got = run_mock(c.data, c.advice, bad, raise_on_failure=False)
    assert got and got == jrun_mock(j.data, j.advice, bad,
                                    raise_on_failure=False)
    tbad = c.advice.clone()
    tbad[3, 1000, 0] ^= 1
    jbad = np.asarray(j.advice).copy()
    jbad[3, 1000, 0] ^= 1
    got = run_mock(c.data, tbad, c.instances, raise_on_failure=False)
    assert got and got == jrun_mock(j.data, jbad, j.instances,
                                    raise_on_failure=False)


def test_quotient_tape_fits_the_memoized_kernel(circuits):
    _, c = circuits
    cs = c.data.cs
    assert (cs.degree(), cs.quotient_degree, cs.permutation_chunk_len(),
            cs.num_permutation_chunks()) == (3, 2, 1, 15)
    tape = quotient.compile_tape(cs, 1 << 19, 1 << 20)
    assert (len(tape.ins), tape.num_slots) == (503, 37)
    assert tape.num_slots <= quotient.MEMO_SLOTS


def test_fixture_is_consistent(circuits):
    _, c = circuits
    z = np.load(FIXTURE)
    vk = vk_from_dict(json.loads(z["vk_json"].tobytes()))
    assert vk.cs.digest_bytes() == c.data.cs.digest_bytes()
    assert vk.k == K and vk.num_instance == c.data.num_instance
    assert json.loads(z["instances_json"].tobytes()) == c.instances
    assert len(vk.fixed_commitments) == 14
    assert len(vk.permutation_commitments) == 15


def _cli_tbs() -> bytes:
    with open(os.path.join(ROOT, "testdata", "example_cert_3.pem"), "rb") as f:
        return extract_tbs_and_sig(parse_pem(f.read()))[0]


@pytest.mark.slow
def test_cli_circuit_equals_jax():
    """The 970-byte TBS at k=19, the reference CLI's size: 6.3 M cells, the
    same circuit and witness as the JAX package's (about 2 minutes)."""
    tbs = _cli_tbs()
    assert len(tbs) == 970
    c = Sha256GateCircuit(tbs, k=19, device="cpu")
    assert len(c.gb.values) == 6_321_719
    assert c.instances == [list(hashlib.sha256(tbs).digest())]
    _same_circuit(JSha256GateCircuit(tbs, k=19), c)


@pytest.mark.slow
def test_reference_fixture_is_current():
    """The committed fixture is what the JAX package computes now (about
    80 minutes)."""
    z = np.load(FIXTURE)
    fresh = reference()
    assert sorted(fresh) == sorted(z.files)
    for key, arr in fresh.items():
        assert np.array_equal(arr, z[key]), key

"""The port's bit-plane SHA-256 circuit (circuits/sha256.py) against the JAX
package's and against the committed SHA-256 artifacts.

The constraint system has the JAX one's digest and that of
build/sha256_{1,2}.pk.vk; the circuit of each certificate's TBS (970 and
770 bytes) is built at k=12 with the JAX build's fixed columns and copies;
the witness equals the JAX witness and its instances the committed proofs';
the trace and the padding agree with hashlib.

At a short message (tests/data/sha256_reference.npz: the first 101 bytes of
example_cert_3's TBS, two blocks, k=9, written by
tests/data/make_sha256_reference.py with the JAX package) the port's key
columns and witness equal the JAX ones, and its verifier accepts the JAX
proof.  The port's whole keygen and proof there, through the plain
versions, take the CPU some 20 minutes: that test is `slow`.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from halo2_zkcert_tpu.circuits import sha256 as jsha
from halo2_zkcert_tpu_torch.cert import extract_tbs_and_sig, parse_pem
from halo2_zkcert_tpu_torch.circuits import sha256 as sha
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import (Domain, from_reference_pk, setup,
                                          verify_proof)
from halo2_zkcert_tpu_torch.plonk.keygen import sigma_columns
from halo2_zkcert_tpu_torch.sdk import PK_ARRAYS, Snark, read_vk
from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FIXTURE = os.path.join(DATA, "sha256_reference.npz")
LINKS = {1: "example_cert_3.pem", 2: "example_cert_2.pem"}


def _tbs(pem):
    with open(os.path.join(ROOT, "testdata", pem), "rb") as f:
        return extract_tbs_and_sig(parse_pem(f.read()))[0]


def _from_limbs(arr):
    return field.from_resident(FR, torch.from_numpy(np.array(arr)))


@pytest.fixture(scope="module")
def ref():
    z = np.load(FIXTURE)
    out = {k: z[k] for k in z.files}
    out["vk"] = json.loads(out["vk_json"].tobytes())
    out["instances"] = json.loads(out["instances_json"].tobytes())
    out["msg"] = _tbs(LINKS[1])[:101]
    return out


def test_cs_digest_equals_jax_and_committed_vks():
    cs, names = sha.build_cs()
    jcs, _ = jsha.build_cs()
    assert cs.digest_bytes() == jcs.digest_bytes()
    assert cs.to_dict() == jcs.to_dict()
    assert len(names["bits"]) == sha.NBITS and cs.num_advice == sha.NADVICE
    for i in LINKS:
        vk = read_vk(os.path.join(ROOT, "build", f"sha256_{i}.pk.vk"))
        assert vk.cs.digest_bytes() == cs.digest_bytes()
        assert vk.k == 12 and vk.num_instance == [2]


@pytest.mark.parametrize("index", sorted(LINKS))
def test_circuit_equals_jax_build(index):
    msg_len = len(_tbs(LINKS[index]))
    assert msg_len == {1: 970, 2: 770}[index]
    mine, theirs = (sha.Sha256Circuit.build(msg_len),
                    jsha.Sha256Circuit.build(msg_len))
    assert mine.data.k == theirs.data.k == sha.min_k(msg_len) == 12
    assert vars(mine.layout) == vars(theirs.layout)
    assert mine.data.fixed.shape == theirs.data.fixed.shape
    assert [[int(v) for v in col] for col in mine.data.fixed] == [
        [int(v) for v in col] for col in theirs.data.fixed]
    assert mine.data.copies == theirs.data.copies
    assert mine.data.num_instance == theirs.data.num_instance == [2]
    assert (mine.data.cache_digest_bytes()
            == theirs.data.cache_digest_bytes())


@pytest.mark.parametrize("index", sorted(LINKS))
def test_witness_equals_jax_and_committed_instances(index):
    tbs = _tbs(LINKS[index])
    mine = sha.Sha256Circuit.build(len(tbs))
    adv, inst = mine.witness(tbs, "cpu")
    jadv, jinst = jsha.Sha256Circuit.build(len(tbs)).witness(tbs)
    assert adv.shape == (sha.NADVICE, 1 << 12, 8) and adv.dtype == torch.int32
    assert torch.equal(adv, _from_limbs(jadv))
    assert inst == jinst
    digest = hashlib.sha256(tbs).digest()
    assert inst == [[int.from_bytes(digest[16:], "big"),
                     int.from_bytes(digest[:16], "big")]]
    committed = Snark.read(os.path.join(ROOT, "build",
                                        f"sha256_{index}.proof"))
    assert inst == committed.instances


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=0, max_size=200))
def test_trace_and_padding_agree_with_hashlib(msg):
    padded = sha._pad_message(msg)
    assert len(padded) % 64 == 0 and padded[:len(msg)] == msg
    assert len(padded) // 64 == sha.num_blocks(len(msg))
    assert padded == jsha._pad_message(msg)
    blocks, H = sha._sha_trace(msg)
    assert b"".join(h.to_bytes(4, "big") for h in H) == \
        hashlib.sha256(msg).digest()
    jblocks, jH = jsha._sha_trace(msg)
    assert H == jH and blocks == jblocks


def test_short_message_witness_equals_reference(ref):
    circuit = sha.Sha256Circuit.build(len(ref["msg"]))
    assert circuit.data.k == 9 and circuit.layout.nblocks == 2
    adv, inst = circuit.witness(ref["msg"], "cpu")
    assert torch.equal(adv, _from_limbs(ref["advice"]))
    assert inst == ref["instances"]


def test_short_message_key_columns_equal_reference(ref):
    """The key's columns without its commitments: fixed columns, sigma
    columns and both coefficient forms equal the JAX gen_pk's."""
    circuit = sha.Sha256Circuit.build(len(ref["msg"]))
    data = circuit.data
    dom = Domain(data.k, data.cs.quotient_degree, "cpu")
    fixed = data.fixed_tensor("cpu")
    sigma = sigma_columns(data, dom)
    got = dict(fixed_lagrange=fixed, sigma_lagrange=sigma,
               fixed_coeff=dom.lagrange_to_coeff(fixed),
               sigma_coeff=dom.lagrange_to_coeff(sigma))
    for name in PK_ARRAYS:
        assert torch.equal(got[name], _from_limbs(ref[name])), name


def test_verifier_accepts_the_reference_proof(ref):
    pk = from_reference_pk({k: ref[k] for k in PK_ARRAYS}, ref["vk"], "cpu",
                           cs=sha.build_cs()[0])
    params = setup(pk.vk.k, device="cpu")
    proof = ref["proof_poseidon"].tobytes()
    assert verify_proof(params, pk.vk, ref["instances"], proof,
                        PoseidonTranscript)
    bad = [[ref["instances"][0][0] ^ 1, ref["instances"][0][1]]]
    assert not verify_proof(params, pk.vk, bad, proof, PoseidonTranscript)


@pytest.mark.slow
def test_short_message_key_and_proof_equal_reference(ref):
    """The port's keygen (its commitments too) and its proof with the
    default blinding seed, through the plain versions on the CPU: the JAX
    key's vk and the JAX proof's bytes."""
    from halo2_zkcert_tpu_torch.plonk import create_proof, keygen
    circuit = sha.Sha256Circuit.build(len(ref["msg"]))
    params = setup(circuit.data.k, device="cpu")
    pk = keygen(params, circuit.data)
    ref_pk = from_reference_pk({k: ref[k] for k in PK_ARRAYS}, ref["vk"],
                               "cpu")
    assert pk.vk.fixed_commitments == ref_pk.vk.fixed_commitments
    assert (pk.vk.permutation_commitments
            == ref_pk.vk.permutation_commitments)
    assert pk.vk.transcript_repr() == ref_pk.vk.transcript_repr()
    adv, inst = circuit.witness(ref["msg"], "cpu")
    proof = create_proof(params, pk, adv, inst, PoseidonTranscript())
    assert proof == ref["proof_poseidon"].tobytes()


@pytest.mark.slow
def test_reference_fixture_is_current():
    """Regenerate the fixture with the JAX package: same arrays and bytes."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_sha256_reference",
        os.path.join(DATA, "make_sha256_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.reference()
    z = np.load(FIXTURE)
    assert sorted(fresh) == sorted(z.files)
    for k in z.files:
        assert np.array_equal(fresh[k], z[k]), k

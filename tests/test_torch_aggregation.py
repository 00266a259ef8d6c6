"""The port's aggregation circuits (halo2_zkcert_tpu_torch/circuits/
{agg_loader,aggregation,x509_agg}.py) against the JAX package's.

The JAX side is tests/data/aggregation_reference.npz (written by
tests/data/make_aggregation_reference.py): the toy inner snarks of
tests/test_aggregation.py, and for each aggregation circuit its
constraint system, cache digest, digests of its fixed columns and copies,
its instances and digests of both phases' advice columns at the
MockProver's challenge.  Here the port records the same circuits from the
same snarks: `AggregationCircuit` at k=19 in fixed-vk and in universal
mode, and `X509VerifierAggregationCircuit` at k=20 over the four committed
inner snarks as the JAX package records it (`keep_identity_terms=True`),
whose constraint system and cache digest also equal those of the
committed build/x509_agg.pk.vk.  That circuit's accumulator fails the
pairing (identity vk commitments in its MSM); the port's circuit leaves
those terms out, and its accumulator holds.  On this host's CPU one k=20 record
pass of the port takes about 45 s (the JAX package's about 80 s); the
k=20 test records twice, the build pass and the phase-1 pass.

The aggregation circuit's keygen, MockProver, proof and
`verify_aggregated` run on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.circuits.aggregation import \
    vk_binding_digest as jvk_binding_digest
from halo2_zkcert_tpu.sdk import _vk_from_dict as jvk_from_dict
from halo2_zkcert_tpu_torch import sdk
from halo2_zkcert_tpu_torch.circuits.aggregation import (
    AggregationCircuit, InnerSnark, decode_accumulator, vk_binding_digest)
from halo2_zkcert_tpu_torch.circuits.x509_agg import \
    X509VerifierAggregationCircuit
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import kzg
from halo2_zkcert_tpu_torch.plonk.assignment import copy_table
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
from halo2_zkcert_tpu_torch.plonk.mock import mock_challenges
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, DATA)
import make_aggregation_reference as ref  # noqa: E402


def _snark(name: str) -> InnerSnark:
    with np.load(ref.OUT) as z:
        return InnerSnark(
            vk=vk_from_dict(json.loads(z[f"{name}_vk_json"].tobytes())),
            instances=json.loads(z[f"{name}_instances_json"].tobytes()),
            proof=z[f"{name}_proof"].tobytes())


def _agg(inner: str, universal: bool, proof: bytes | None = None):
    s = _snark(inner)
    if proof is not None:
        s = InnerSnark(vk=s.vk, instances=s.instances, proof=proof)
    return AggregationCircuit([s], k=ref.K_AGG, lanes=ref.LANES_AGG,
                              na=ref.NA_AGG, nl=1, universal=universal)


def structure_record(circ) -> dict:
    """The build pass's part of a fixture record, from the port."""
    data = circ.data
    fixed = field.from_ints(FR, data.fixed, "cpu")
    fn, instances = circ.witness("cpu")
    return {
        "cs": data.cs.to_dict(),
        "cache_digest": data.cache_digest_bytes().hex(),
        "fixed": [ref.words_digest(col) for col in fixed],
        "copies": ref.digest(copy_table(data.copies).astype("<i8")
                             .tobytes()),
        "num_copies": len(data.copies),
        "instances": [[str(int(v)) for v in col] for col in instances],
        "phase0": {str(i): ref.words_digest(v)
                   for i, v in sorted(fn(0, {}).items())},
        "rows": circ.rows_report(),
    }


def phase1_record(circ) -> dict:
    tau = mock_challenges(circ.data.cs)[0]
    fn, _ = circ.witness("cpu")
    return {"tau": str(tau),
            "phase1": {str(i): ref.words_digest(v)
                       for i, v in sorted(fn(1, {0: tau}).items())}}


def _assert_matches(got: dict, want: dict) -> None:
    for key, val in got.items():
        assert val == want[key], key


AGG = {"agg_toy": ("toy", False), "agg_c5": ("c5", True),
       "agg_c7": ("c7", True)}


@pytest.fixture(scope="module")
def aggs():
    return {name: _agg(*AGG[name]) for name in AGG}


@pytest.mark.parametrize("name", sorted(AGG))
def test_k19_circuit_matches_fixture(name, aggs):
    """Structure, instances and both phases' columns equal the JAX
    package's, in fixed-vk (agg_toy) and universal mode (agg_c5, agg_c7)."""
    circ, want = aggs[name], ref.load_record(name)
    _assert_matches(structure_record(circ), want)
    _assert_matches(phase1_record(circ), want)


def test_universal_circuits_share_one_structure(aggs):
    """One universal circuit shape (one key) serves both inner vks; the
    exposed vk digest tells them apart."""
    a, b = aggs["agg_c5"], aggs["agg_c7"]
    assert a.composed._fp == b.composed._fp
    assert a.data.cache_digest_bytes() == b.data.cache_digest_bytes()
    assert a.witness("cpu")[1][0][8] != b.witness("cpu")[1][0][8]


def test_vk_binding_digest_equals_jax():
    with np.load(ref.OUT) as z:
        vks = {n: json.loads(z[f"{n}_vk_json"].tobytes())
               for n in ("c5", "c7")}
    for names in (["c5"], ["c7"], ["c5", "c7"]):
        got = vk_binding_digest([vk_from_dict(vks[n]) for n in names])
        assert got == jvk_binding_digest([jvk_from_dict(vks[n])
                                          for n in names])
    for n in ("c5", "c7"):
        inst = ref.load_record(f"agg_{n}")["instances"][0]
        assert int(inst[8]) == vk_binding_digest([vk_from_dict(vks[n])])


def _pairing(instances) -> bool:
    g2 = (rc.G2_GEN_X, rc.G2_GEN_Y)
    params = SimpleNamespace(g2=g2,
                             s_g2=rc.g2_mul_affine(g2, kzg._default_tau()))
    lhs, rhs = decode_accumulator(instances)
    return rc.pairing_check([
        (lhs, params.s_g2),
        (rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(rhs))), params.g2)])


def test_accumulator_pairing_holds(aggs):
    """The honest toy snark's exposed accumulator passes the deferred
    pairing against the default SRS the toy snark was proved on."""
    _, instances = aggs["agg_toy"].witness("cpu")
    assert len(instances[0]) == 8
    assert _pairing(instances)


def test_tampered_inner_proof_rejected():
    """Byte 40 of the inner proof flipped: the circuit refuses to record
    it, or its accumulator fails the pairing."""
    bad = bytearray(_snark("toy").proof)
    bad[40] ^= 1
    try:
        circ = _agg("toy", False, bytes(bad))
    except (AssertionError, ValueError):
        return
    assert not _pairing(circ.witness("cpu")[1])


def _inner(stem: str) -> InnerSnark:
    s = sdk.Snark.read(os.path.join(ROOT, "build", f"{stem}.proof"))
    return InnerSnark(vk=s.vk, instances=s.instances, proof=s.proof)


def _committed_vk() -> dict:
    with open(os.path.join(ROOT, "build", "x509_agg.pk.vk")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def x509():
    """The k=20 circuit as the JAX package records it."""
    return X509VerifierAggregationCircuit(
        [_inner(stem) for stem in ref.X509_STEMS], k=ref.K_X509,
        lanes=ref.LANES_X509, na=ref.NA_X509, keep_identity_terms=True)


def test_reference_x509_accumulator_fails_the_pairing():
    """The JAX package's k=20 circuit adds the SHA-256 vks' identity
    commitments to its MSM as affine points: its accumulator (the
    fixture's instances) fails the deferred pairing, though every inner
    proof verifies."""
    inst = [[int(v) for v in ref.load_record("x509")["instances"][0]]]
    assert not _pairing(inst)
    assert sum(pt == (0, 0) for pt in _inner("sha256_1")
               .vk.fixed_commitments) == 5


def test_identity_terms_left_out_of_the_msm():
    """One SHA-256 snark (five identity fixed commitments) aggregated at
    the X.509 configuration: the port's accumulator passes the pairing,
    the JAX package's circuit's does not; both have the constraint
    system of build/x509_agg.pk.vk."""
    snark = _inner("sha256_1")
    for keep, holds in ((False, True), (True, False)):
        circ = AggregationCircuit([snark], k=ref.K_X509,
                                  lanes=ref.LANES_X509, na=ref.NA_X509,
                                  keep_identity_terms=keep)
        assert circ.data.cs.to_dict() == _committed_vk()["cs"]
        assert _pairing(circ.witness("cpu")[1]) is holds


def test_x509_record_matches_committed_key(x509):
    """The JAX package's k=20 circuit, recorded by the port: its
    constraint system and cache digest are those of build/x509_agg.pk.vk,
    and its build pass equals the JAX package's."""
    sidecar = _committed_vk()
    assert x509.data.cs.to_dict() == sidecar["cs"]
    assert x509.data.cache_digest_bytes().hex() == sidecar["cache_digest"]
    _assert_matches(structure_record(x509), ref.load_record("x509"))


def test_x509_phase1_matches_fixture(x509):
    """Its phase-1 columns at the MockProver's challenge equal the JAX
    package's (a second record pass, held to the first)."""
    _assert_matches(phase1_record(x509), ref.load_record("x509"))


@pytest.mark.slow
def test_reference_fixture_is_current():
    """The committed fixture is what the JAX package writes today (about
    8 minutes on the CPU)."""
    fresh = ref.reference()
    with np.load(ref.OUT) as z:
        assert sorted(z.files) == sorted(fresh)
        for key, val in fresh.items():
            assert np.array_equal(z[key], val), key

"""The port's RsaCircuit against the JAX package's and the committed proving
key: the same constraint system (digest of build/rsa_1.pk.vk), the same
phase-0 limb tape and the same phase-1 accumulator column at a fixed
challenge, for the benchmark link (leaf testdata/example_cert_3.pem signed
by testdata/example_cert_2.pem) at k=17."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu import cert as jcert
from halo2_zkcert_tpu.circuits.rsa import RsaCircuit as JRsaCircuit
from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu_torch import cert
from halo2_zkcert_tpu_torch.circuits.rsa import RsaCircuit
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321


def _pem(name):
    with open(os.path.join(ROOT, "testdata", name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def link():
    inter = cert.parse_pem(_pem("example_cert_2.pem"))
    leaf = cert.parse_pem(_pem("example_cert_3.pem"))
    tbs, sig = cert.extract_tbs_and_sig(leaf)
    digest = hashlib.sha256(tbs).digest()
    circuit = RsaCircuit(cert.extract_public_key(inter), k=17)
    jinter = jcert.parse_pem(_pem("example_cert_2.pem"))
    jcircuit = JRsaCircuit(jcert.extract_public_key(jinter), k=17)
    wf, inst = circuit.witness(sig, digest, "cpu")
    jwf, jinst = jcircuit.witness(sig, digest)
    return dict(circuit=circuit, jcircuit=jcircuit, wf=wf, jwf=jwf,
                inst=inst, jinst=jinst, sig=sig, tbs=tbs)


def test_x509_parsing_matches_jax():
    for name in ("example_cert_2.pem", "example_cert_3.pem"):
        c, j = cert.parse_pem(_pem(name)), jcert.parse_pem(_pem(name))
        assert cert.extract_tbs_and_sig(c) == jcert.extract_tbs_and_sig(j)
    inter = _pem("example_cert_2.pem")
    assert cert.extract_public_key(cert.parse_pem(inter)) == \
        jcert.extract_public_key(jcert.parse_pem(inter))
    d = bytes(range(32))
    assert cert.pkcs1v15_sha256_em(d, 256) == jcert.pkcs1v15_sha256_em(d, 256)


def test_cs_digest_matches_committed_vk(link):
    with open(os.path.join(ROOT, "build", "rsa_1.pk.vk")) as f:
        vk = vk_from_dict(json.load(f))
    cs = link["circuit"].cs
    assert cs.digest_bytes() == vk.cs.digest_bytes()
    assert cs.digest_bytes() == link["jcircuit"].cs.digest_bytes()
    assert link["circuit"].verify_host(link["sig"], link["tbs"])


def test_fixed_columns_and_copies_match_jax(link):
    c, j = link["circuit"], link["jcircuit"]
    assert c.copies == j.copies
    assert np.array_equal(c.data.fixed.astype(np.int64),
                          j.data.fixed.astype(np.int64))
    for name in ("_msel", "_b_const", "_b_vmask", "_rel_dst", "_rel_src"):
        assert np.array_equal(getattr(c, name), getattr(j, name)), name


def test_phase0_witness_matches_jax(link):
    assert link["inst"] == link["jinst"]
    v = link["wf"](0, {})[RsaCircuit.COL_V]
    jv = link["jwf"](0, {})[JRsaCircuit.COL_V]
    assert field.to_ints(v) == [int(x) for x in JFr.to_ints(jv)]


def test_phase1_accumulator_matches_jax(link):
    a = link["wf"](1, {0: TAU})[RsaCircuit.COL_A]
    ja = link["jwf"](1, {0: TAU})[JRsaCircuit.COL_A]
    assert field.to_ints(a) == [int(x) for x in JFr.to_ints(ja)]

"""The port's RsaCircuit against the JAX package's and the committed proving
keys: the same constraint system (digest of build/rsa_{1,2}.pk.vk), the
same fixed columns and copies, the same phase-0 limb tape and the same
phase-1 accumulator column at a fixed challenge, at k=17, for both links of
the reference CLI's chain: rsa_1, the benchmark link (leaf
testdata/example_cert_3.pem signed by testdata/example_cert_2.pem, a
2048-bit key), and rsa_2 (example_cert_2.pem signed by the root
example_cert_1.pem, a 4096-bit key: 256 limbs); and each modular product's
tape rows against the nested-loop tape in Python ints."""
import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu import cert as jcert
from halo2_zkcert_tpu.circuits.rsa import RsaCircuit as JRsaCircuit
from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu_torch import cert
from halo2_zkcert_tpu_torch.circuits import rsa
from halo2_zkcert_tpu_torch.circuits.rsa import RsaCircuit
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321


def _pem(name):
    with open(os.path.join(ROOT, "testdata", name), "rb") as f:
        return f.read()


# stem of the committed key -> (signed certificate, issuer, modulus bits)
LINKS = {"rsa_1": ("example_cert_3.pem", "example_cert_2.pem", 2048),
         "rsa_2": ("example_cert_2.pem", "example_cert_1.pem", 4096)}


@pytest.fixture(scope="module", params=sorted(LINKS))
def link(request):
    signed, issuer, bits = LINKS[request.param]
    modulus = cert.extract_public_key(cert.parse_pem(_pem(issuer)))
    assert modulus.bit_length() == bits
    tbs, sig = cert.extract_tbs_and_sig(cert.parse_pem(_pem(signed)))
    digest = hashlib.sha256(tbs).digest()
    circuit = RsaCircuit(modulus, k=17)
    jcircuit = JRsaCircuit(jcert.extract_public_key(
        jcert.parse_pem(_pem(issuer))), k=17)
    wf, inst = circuit.witness(sig, digest, "cpu")
    jwf, jinst = jcircuit.witness(sig, digest)
    return dict(stem=request.param, circuit=circuit, jcircuit=jcircuit,
                wf=wf, jwf=jwf, inst=inst, jinst=jinst, sig=sig, tbs=tbs)


def test_x509_parsing_matches_jax():
    for name in ("example_cert_1.pem", "example_cert_2.pem",
                 "example_cert_3.pem"):
        c, j = cert.parse_pem(_pem(name)), jcert.parse_pem(_pem(name))
        assert cert.extract_tbs_and_sig(c) == jcert.extract_tbs_and_sig(j)
    for issuer in ("example_cert_1.pem", "example_cert_2.pem"):
        pem = _pem(issuer)
        assert cert.extract_public_key(cert.parse_pem(pem)) == \
            jcert.extract_public_key(jcert.parse_pem(pem))
    d = bytes(range(32))
    for k_bytes in (256, 512):
        assert cert.pkcs1v15_sha256_em(d, k_bytes) == \
            jcert.pkcs1v15_sha256_em(d, k_bytes)


def test_cs_digest_matches_committed_vk(link):
    with open(os.path.join(ROOT, "build", f"{link['stem']}.pk.vk")) as f:
        vk = vk_from_dict(json.load(f))
    cs = link["circuit"].cs
    assert cs.digest_bytes() == vk.cs.digest_bytes()
    assert cs.digest_bytes() == link["jcircuit"].cs.digest_bytes()
    # the key cache's digest (build/rsa_2.pk.vk's sidecar predates it)
    digest = link["circuit"].data.cache_digest_bytes()
    assert digest == link["jcircuit"].data.cache_digest_bytes()
    with open(os.path.join(ROOT, "build", f"{link['stem']}.pk.vk")) as f:
        stored = json.load(f).get("cache_digest")
    assert stored in (None, digest.hex())
    assert stored is not None or link["stem"] == "rsa_2"
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


def _loop_rows(x, y, modulus, L):
    """The tape rows of x y mod n, MSB-first, by nested loops over Python
    ints, the plain oracle of `rsa._mulmod_rows`: (z, q, clo, chi)."""
    B, OFF = 16, 1 << 26

    def limbs(v, count):
        return [(v >> (B * i)) & 0xFFFF for i in range(count)]

    z = x * y % modulus
    q = (x * y - z) // modulus
    xl, yl, zl, ql, nl = (limbs(x, L), limbs(y, L), limbs(z, L),
                          limbs(q, L + 1), limbs(modulus, L))
    d = [0] * (2 * L)
    for i in range(L):
        for j in range(L):
            d[i + j] += xl[i] * yl[j]
    for i in range(L + 1):
        for j in range(L):
            d[i + j] -= ql[i] * nl[j]
    for i in range(L):
        d[i] -= zl[i]
    c = [0] * (2 * L)
    acc = 0
    for kk in range(2 * L - 1, 0, -1):
        acc = d[kk] + (1 << B) * acc
        c[kk - 1] = acc
    assert d[0] + (1 << B) * c[0] == 0
    cp = [ci + OFF for ci in c]
    assert all(0 <= ci < (1 << (B + 11)) for ci in cp)
    return (z, ql[::-1], [ci & 0xFFFF for ci in cp][::-1],
            [ci >> B for ci in cp][::-1])


def _modulus(kind, L, rng):
    if kind == "all_ones":
        return (1 << (16 * L)) - 1
    if kind == "top_limb_one":
        return (1 << (16 * (L - 1))) | rng.getrandbits(16 * (L - 1)) | 1
    return (1 << (16 * L - 1)) | rng.getrandbits(16 * L - 1) | 1


# operands: "seeded" draws x, y < n; "ones" is x = y = the largest value below
# n whose limbs under the top one are all 2^16 - 1, the largest carries;
# "n-1" is x = y = n - 1, whose d(t) is identically zero; "zero" has x = 0
TAPE_CASES = [(L, kind, ops) for L in (128, 192, 256)
              for kind in ("random", "all_ones", "top_limb_one")
              for ops in ("seeded", "ones", "n-1", "zero")]


@pytest.mark.parametrize("L,kind,ops", TAPE_CASES)
def test_mulmod_rows_equal_the_python_int_loops(L, kind, ops):
    rng = random.Random(f"{L}-{kind}-{ops}")
    n = _modulus(kind, L, rng)
    low = 16 * (L - 1)
    ones = (((n >> low) - 1) << low) | ((1 << low) - 1)
    pairs = {"seeded": [(rng.randrange(n), rng.randrange(n)) for _ in range(3)],
             "ones": [(ones, ones)], "n-1": [(n - 1, n - 1)],
             "zero": [(0, rng.randrange(n)), (0, 0)]}[ops]
    n_limbs = rsa._limbs(n, L)
    for x, y in pairs:
        z, q, clo, chi = _loop_rows(x, y, n, L)
        got = rsa._mulmod_rows(x, y, (x * y - z) // n, z, n_limbs)
        for a, b in zip(got, (q, clo, chi)):
            assert a.dtype == np.int64 and a.tolist() == b


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("fault", ["z+1", "q+1", "x+1"])
def test_a_corrupted_product_fails_the_mulmod_identity(L, fault):
    rng = random.Random(L)
    n = _modulus("random", L, rng)
    x, y = n - 1, rng.randrange(n)
    q, z = divmod(x * y, n)
    x, q, z = (x + (fault == "x+1"), q + (fault == "q+1"),
               z + (fault == "z+1"))
    with pytest.raises(AssertionError, match="mulmod identity failed"):
        rsa._mulmod_rows(x, y, q, z, rsa._limbs(n, L))


def test_witness_rejects_a_signature_whose_chain_misses_em(link):
    """A signature that is not the key's on this digest reaches no tape."""
    c = link["circuit"]
    with pytest.raises(AssertionError):
        c.witness(link["sig"] + 1, hashlib.sha256(link["tbs"]).digest(),
                  "cpu")

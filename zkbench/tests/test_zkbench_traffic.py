"""The seeded inputs: the same seed gives the same issuer key, leaves and
signatures, other seeds give others, and every signature verifies."""
import hashlib

from zkbench import traffic
from zkbench.harness import load_cell
from zkbench.traffic import rsa as rsa_traffic

SEED = 2 ** 31 + 12345


def _inputs(seed, leaves=6):
    cell, config, _ = load_cell("rsa2048_k17.solo")
    cell = dict(cell, leaves=leaves)
    return traffic.make(config, cell, seed), config, cell


def test_same_seed_same_inputs():
    a, _, _ = _inputs(SEED)
    b, _, _ = _inputs(SEED)
    assert a == b


def test_other_seed_other_inputs():
    a, _, _ = _inputs(SEED)
    b, _, _ = _inputs(SEED + 1)
    assert a["modulus"] != b["modulus"]
    assert [t for t, _ in a["leaves"]] != [t for t, _ in b["leaves"]]


def test_key_and_leaves_have_the_configured_shape():
    inputs, config, cell = _inputs(SEED)
    assert inputs["modulus"].bit_length() == config["issuer_bits"]
    lo, hi = cell["tbs_bytes"]
    tbs = [t for t, _ in inputs["leaves"]]
    assert all(lo <= len(t) <= hi for t in tbs)
    assert len(set(tbs)) == len(tbs)


def test_every_signature_verifies_under_plain_pow():
    inputs, config, _ = _inputs(SEED)
    n, e = inputs["modulus"], inputs["exponent"]
    k = (n.bit_length() + 7) // 8
    for tbs, sig in inputs["leaves"]:
        em = pow(sig, e, n).to_bytes(k, "big")
        digest = hashlib.sha256(tbs).digest()
        assert em.startswith(b"\x00\x01\xff")
        assert em.endswith(rsa_traffic.DIGEST_INFO + digest)


def test_gate_message_is_seeded():
    cell, config, _ = load_cell("sha256_gate_k19.solo")
    a = traffic.make(config, cell, SEED)["message"]
    assert a == traffic.make(config, cell, SEED)["message"]
    assert a != traffic.make(config, cell, SEED + 1)["message"]
    assert len(a) == cell["tbs_bytes"]


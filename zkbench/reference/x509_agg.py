"""The X.509 chain aggregation: one outer proof that four inner snarks
[rsa_1, sha_1, rsa_2, sha_2] verify and that each RSA link signs the digest
its SHA-256 link computes, with the inner proofs' KZG pairs folded into one
accumulator exposed as the outer proof's 8 instances.

The inner snarks are the driver's artifacts.  Each is verified here against
a key worked out from the chain (the RSA link's from its issuer's modulus,
reference/rsa.py; the SHA-256 link's from its TBS's length, the bit-plane
layout of reference/sha256_bits.py) for the statement worked out from its
TBS; a failing one rejects every outer proof.  The outer layout, its key
and its statement (the accumulator) are the recording of
reference/agg_circuit.py over those inner keys, statements and proofs.  An
outer proof is correct when it verifies under that key for that statement
and its accumulator (lhs, rhs) holds: e(lhs, [tau]_2) = e(rhs, [1]_2), that
is tau * lhs == rhs in G1.
"""
from __future__ import annotations

from . import agg_circuit, keys, plonk, rsa, sha256_bits
from . import bn254 as B

STEMS = ("rsa_1", "sha_1", "rsa_2", "sha_2")


def decode_accumulator(instances: list):
    """8 instances (128-bit limbs, low first) -> (lhs, rhs) affine."""
    v = [int(x) for x in instances[0][:8]]
    c = [v[i] + (v[i + 1] << 128) for i in range(0, 8, 2)]
    return (c[0], c[1]), (c[2], c[3])


def accumulator_holds(instances: list, tau: int) -> bool:
    lhs, rhs = decode_accumulator(instances)
    if lhs == (0, 0) or rhs == (0, 0):
        return False
    on_curve = all((y * y - x * x * x - B.G1_B) % B.FQ == 0
                   for x, y in (lhs, rhs))
    return on_curve and B.g1_to_affine(
        B.g1_mul(B.g1_from_affine(lhs), tau)) == rhs


def inner_keys(config: dict, inputs: dict, tau: int) -> list:
    """[(verifying key, statement)] of [rsa_1, sha_1, rsa_2, sha_2]."""
    out, bases = [], {}

    def basis(k):
        if k not in bases:
            bases[k] = keys.Basis(k, tau)
        return bases[k]

    for link in inputs["links"]:
        tbs, k = link["tbs"], config["inner_k"]
        cs, fixed, copies, ninst = rsa.layout(link["modulus"], k)
        out.append((keys.verifying_key(k, cs, fixed, copies, ninst, basis(k)),
                    rsa.statement(tbs)))
        k = sha256_bits.min_k(len(tbs))
        cs, fixed, copies, ninst = sha256_bits.layout(len(tbs), k)
        out.append((keys.verifying_key(k, cs, fixed, copies, ninst, basis(k)),
                    sha256_bits.statement(tbs)))
    return out


class AggReference:
    """The outer circuit's reference; `inner_ok` is whether every inner
    snark the statement rests on verified."""

    def __init__(self, config: dict, inputs: dict, artifacts: dict,
                 tau: int):
        self.tau = tau
        inner = inner_keys(config, inputs, tau)
        snarks = artifacts.get("snarks", [])
        self.inner_ok = len(snarks) == len(inner) and all(
            s["name"] == stem and s["instances"] == stmt
            and plonk.verify(vk, stmt, s["proof"], tau)
            for s, stem, (vk, stmt) in zip(snarks, STEMS, inner))
        self.outer = None
        if not self.inner_ok:
            return
        cs, fixed, copies, ninst, self.instances = agg_circuit.layout(
            [(vk, stmt, s["proof"]) for (vk, stmt), s in zip(inner, snarks)],
            config["k"], config["lanes"], config["na"],
            link=agg_circuit.link_x509)
        self.outer = keys.PlonkReference(config["k"], cs, fixed, copies,
                                         ninst, lambda job: self.instances,
                                         tau)

    def verify(self, job: int, proof: bytes) -> bool:
        return (self.outer is not None and self.outer.verify(job, proof)
                and accumulator_holds(self.instances, self.tau))

    def random_commitment(self, proof: bytes) -> bytes:
        if self.outer is None:
            return proof
        return self.outer.random_commitment(proof)

    def key_differences(self, fixed: list, permutation: list) -> int:
        if self.outer is None:
            return len(fixed) + len(permutation)
        return self.outer.key_differences(fixed, permutation)


def reference(config: dict, inputs: dict, artifacts: dict,
              tau: int) -> AggReference:
    """Every job proves the one chain's aggregation; it rests on the four
    inner snarks of `artifacts["snarks"]`."""
    return AggReference(config, inputs, artifacts, tau)

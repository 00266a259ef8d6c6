"""The plain reference that decides whether a run's proofs are correct.

From the inputs the benchmark made (the issuer's modulus and the leaves, or
the message) and the SRS's public secret, it works out the circuit's layout,
its verifying key and each job's statement, and verifies proofs in Python
ints.  It imports nothing of the program and takes nothing it made: the
proofs are what it judges.
"""
from __future__ import annotations

from . import bn254, keys, plonk, rsa, sha256_gate


class Reference:
    def __init__(self, config: dict, inputs: dict):
        k = config["k"]
        self.tau = bn254.default_tau()
        if config["circuit"] == "rsa":
            self.cs, fixed, copies, ninst = rsa.layout(inputs["modulus"], k)
            self._statement = lambda job: rsa.statement(
                inputs["leaves"][job][0])
        elif config["circuit"] == "sha256_gate":
            self.cs, fixed, copies, ninst = sha256_gate.layout(
                inputs["message"], k)
            stmt = sha256_gate.statement(inputs["message"])
            self._statement = lambda job: stmt
        else:
            raise ValueError(f"no reference for {config['circuit']!r}")
        self.vk = keys.verifying_key(k, self.cs, fixed, copies, ninst,
                                     keys.Basis(k, self.tau))

    def verify(self, job: int, proof: bytes) -> bool:
        return plonk.verify(self.vk, self._statement(job), proof, self.tau)

    def random_commitment(self, proof: bytes) -> bytes:
        return plonk.random_commitment(self.cs, proof)

    def key_differences(self, fixed: list, permutation: list) -> int:
        """How many of a verifying key's commitments differ from these."""
        mine = self.vk.fixed_commitments + self.vk.permutation_commitments
        theirs = [tuple(p) for p in fixed] + [tuple(p) for p in permutation]
        if len(mine) != len(theirs):
            return max(len(mine), len(theirs))
        return sum(a != b for a, b in zip(mine, theirs))

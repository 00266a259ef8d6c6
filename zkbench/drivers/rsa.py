"""The RSA PKCS#1 v1.5 / SHA-256 link through the program's public calls:
set-up keys the issuer's circuit (its fixed columns hold the modulus) and a
proof is `RsaCircuit.witness` then `plonk.create_proof` with a Poseidon
transcript, as halo2_zkcert_tpu_torch/bench.py `prove_rsa` makes it."""
from __future__ import annotations

import hashlib
import time

from . import commitments, keyed


class Driver:
    def __init__(self, config: dict, inputs: dict, device):
        self.config, self.inputs, self.device = config, inputs, device

    def setup(self, params_dir: str) -> None:
        from halo2_zkcert_tpu_torch.circuits.rsa import RsaCircuit
        k = self.config["k"]
        self.circuit = RsaCircuit(self.inputs["modulus"], k=k)
        self.params, self.pk = keyed(k, self.circuit.data, self.device,
                                     params_dir)

    def prove(self, job: int, blinding: bytes, fault: str | None = None):
        """(proof bytes, witness seconds, the prover's stage seconds)."""
        from halo2_zkcert_tpu_torch.plonk import create_proof, prover
        from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
        from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
        tbs, sig = self.inputs["leaves"][job]
        t0 = time.perf_counter()
        witness_fn, instances = self.circuit.witness(
            sig, hashlib.sha256(tbs).digest(), self.device)
        t1 = time.perf_counter()
        if fault == "half":
            witness_fn = _half(witness_fn)
        proof = create_proof(self.params, self.pk, witness_fn, instances,
                             PoseidonTranscript(), BlindingRng(blinding))
        return proof, t1 - t0, dict(prover.LAST_STAGE_TIMES)

    def verifying_key(self):
        return commitments(self.pk)

    def close(self) -> None:
        for name in ("pk", "params", "circuit"):
            self.__dict__.pop(name, None)


def _half(witness_fn):
    """The witness with the second half of each column's filled rows (up to
    its last nonzero one) left out."""
    def fn(phase, challenges):
        out = {}
        for i, col in witness_fn(phase, challenges).items():
            rows = col.ne(0).any(-1).nonzero()
            col = col.clone()
            if rows.numel():
                last = int(rows.max()) + 1
                col[last // 2:last] = 0
            out[i] = col
        return out
    return fn

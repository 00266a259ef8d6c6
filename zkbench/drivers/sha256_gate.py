"""The gate-level SHA-256 of one TBS through the program's public calls:
set-up records `Sha256GateCircuit` (the message pinned in its fixed
columns) and keys it; a proof is `plonk.create_proof` of that statement
with a Poseidon transcript and a fresh blinding stream, as the program's
CLI `prove-unoptimized-sha256` makes it."""
from __future__ import annotations

from . import commitments, keyed


class Driver:
    def __init__(self, config: dict, inputs: dict, device):
        self.config, self.inputs, self.device = config, inputs, device

    def setup(self, params_dir: str) -> None:
        from halo2_zkcert_tpu_torch.circuits.sha256_gate import \
            Sha256GateCircuit
        k = self.config["k"]
        self.circuit = Sha256GateCircuit(self.inputs["message"], k,
                                         self.device)
        self.params, self.pk = keyed(k, self.circuit.data, self.device,
                                     params_dir)

    def prove(self, job: int, blinding: bytes, fault: str | None = None):
        """(proof bytes, None: the witness is set-up's, stage seconds)."""
        from halo2_zkcert_tpu_torch.plonk import create_proof, prover
        from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
        from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
        advice = self.circuit.advice
        if fault == "half":
            advice = advice.clone()
            advice[:, advice.shape[1] // 2:] = 0
        proof = create_proof(self.params, self.pk, advice,
                             self.circuit.instances, PoseidonTranscript(),
                             BlindingRng(blinding))
        return proof, None, dict(prover.LAST_STAGE_TIMES)

    def verifying_key(self):
        return commitments(self.pk)

    def close(self) -> None:
        for name in ("pk", "params", "circuit"):
            self.__dict__.pop(name, None)

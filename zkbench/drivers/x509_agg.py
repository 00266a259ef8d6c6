"""The X.509 chain aggregation through the program's public calls, as its
CLI makes it (gen-x509-agg-keys, then gen-x509-agg-proof): set-up proves the
chain's four inner snarks [rsa_1, sha_1, rsa_2, sha_2] (the RSA links at
k=17, `RsaCircuit`; the SHA-256 links in the bit-plane layout at the k its
TBS needs, `Sha256Circuit`), records the aggregation circuit over them
(`X509VerifierAggregationCircuit`, fixed inner keys), makes the replay's
record of its phase 1 (`prepare_replay`) and keys it.  A proof is
`plonk.create_proof` of that statement with a Poseidon transcript and a
fresh blinding stream; its witness callable replays phase 1 at the proof's
own challenge.  The four inner snarks are handed to the reference."""
from __future__ import annotations

import hashlib

from . import commitments, keyed
from .rsa import _half

STEMS = ("rsa_1", "sha_1", "rsa_2", "sha_2")


class Driver:
    def __init__(self, config: dict, inputs: dict, device):
        self.config, self.inputs, self.device = config, inputs, device

    def setup(self, params_dir: str) -> None:
        from halo2_zkcert_tpu_torch.circuits.aggregation import InnerSnark
        from halo2_zkcert_tpu_torch.circuits.composed import ComposedCircuit
        from halo2_zkcert_tpu_torch.circuits.x509_agg import \
            X509VerifierAggregationCircuit
        # the phase-1 replay is what makes a proof seconds, not a record
        # pass of the program: a program without it stops here
        prepare_replay = ComposedCircuit.prepare_replay
        cfg = self.config
        self.snarks = []
        for i, link in enumerate(self.inputs["links"]):
            for stem, snark in zip(STEMS[2 * i:2 * i + 2],
                                   self._inner(link, params_dir, i)):
                self.snarks.append((stem, snark))
        self.circuit = X509VerifierAggregationCircuit(
            [InnerSnark(vk=vk, instances=inst, proof=proof)
             for _, (vk, inst, proof) in self.snarks],
            k=cfg["k"], lanes=cfg["lanes"], na=cfg["na"],
            universal=cfg["universal"])
        prepare_replay(self.circuit.composed, self.device)
        self.params, self.pk = keyed(cfg["k"], self.circuit.data,
                                     self.device, params_dir)
        self.witness_fn, self.instances = self.circuit.witness(self.device)

    def _inner(self, link: dict, params_dir: str, i: int) -> list:
        """[(vk, instances, proof)] of the link's RSA and SHA-256 snarks,
        proved as the CLI's prove-rsa and prove-zkevm-sha256 prove them."""
        from halo2_zkcert_tpu_torch.circuits.rsa import RsaCircuit
        from halo2_zkcert_tpu_torch.circuits.sha256 import (Sha256Circuit,
                                                           min_k)
        tbs = link["tbs"]
        rsa = RsaCircuit(link["modulus"], k=self.config["inner_k"])
        params, pk = keyed(self.config["inner_k"], rsa.data, self.device,
                           params_dir)
        fn, inst = rsa.witness(link["signature"], hashlib.sha256(tbs).digest(),
                               self.device)
        out = [(pk.vk, inst, self._proof(params, pk, fn, inst, f"rsa{i}"))]
        sha = Sha256Circuit.build(len(tbs), min_k(len(tbs)))
        params, pk = keyed(sha.data.k, sha.data, self.device, params_dir)
        advice, inst = sha.witness(tbs, self.device)
        out.append((pk.vk, inst,
                    self._proof(params, pk, advice, inst, f"sha{i}")))
        return out

    def _proof(self, params, pk, witness, instances, tag: str) -> bytes:
        from halo2_zkcert_tpu_torch.plonk import create_proof, verify_proof
        from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
        from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
        proof = create_proof(params, pk, witness, instances,
                             PoseidonTranscript(),
                             BlindingRng(f"zkbench|inner|{tag}".encode()))
        if not verify_proof(params, pk.vk, instances, proof,
                            PoseidonTranscript):
            raise RuntimeError(f"the inner snark {tag} does not verify")
        return proof

    def prove(self, job: int, blinding: bytes, fault: str | None = None):
        """(proof bytes, None: the witness runs inside the proof, stage
        seconds)."""
        from halo2_zkcert_tpu_torch.plonk import create_proof, prover
        from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
        from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
        fn = _half(self.witness_fn) if fault == "half" else self.witness_fn
        proof = create_proof(self.params, self.pk, fn, self.instances,
                             PoseidonTranscript(), BlindingRng(blinding))
        return proof, None, dict(prover.LAST_STAGE_TIMES)

    def verifying_key(self):
        return commitments(self.pk)

    def artifacts(self) -> dict:
        """The inner snarks: each one's name, instances and proof bytes."""
        return {"snarks": [
            {"name": stem, "proof": bytes(proof),
             "instances": [[int(v) for v in col] for col in inst]}
            for stem, (_, inst, proof) in self.snarks]}

    def close(self) -> None:
        for name in ("witness_fn", "pk", "params", "circuit"):
            self.__dict__.pop(name, None)

"""SDK: proving and verifying key files, keygen with a key cache, snarks,
and the EVM verifier's calls.

Counterpart of halo2_zkcert_tpu/sdk.py.  A saved pk is a vk sidecar
`<path>.vk` (json, with the circuit's `cache_digest`) and `<path>.npz`
holding the four column arrays as (m, n, 33) int32 byte limbs, the layout
the JAX package writes; each package reads the other's files.
"""
from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from . import evm
from .plonk import create_proof, verify_proof
from .plonk.assignment import BlindingRng, CircuitData
from .plonk.keygen import (ProvingKey, VerifyingKey, from_reference_pk,
                           keygen, vk_from_dict, vk_to_dict)
from .plonk.kzg import ParamsKZG
from .transcript import KeccakTranscript, PoseidonTranscript

PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")


@dataclass
class Snark:
    """Proof + its verification context."""
    vk: VerifyingKey
    instances: list
    proof: bytes

    def write(self, path: str) -> None:
        blob = {"version": 2, "vk": vk_to_dict(self.vk),
                "instances": [[int(v) for v in col] for col in self.instances],
                "proof": self.proof.hex()}
        with open(path, "w") as f:
            json.dump(blob, f)

    @staticmethod
    def read(path: str) -> "Snark":
        with open(path) as f:
            blob = json.load(f)
        return Snark(vk=vk_from_dict(blob["vk"]),
                     instances=[[int(v) for v in col]
                                for col in blob["instances"]],
                     proof=bytes.fromhex(blob["proof"]))


def write_vk(vk: VerifyingKey, path: str) -> None:
    with open(path, "w") as f:
        json.dump(vk_to_dict(vk), f)


def read_vk(path: str) -> VerifyingKey:
    with open(path) as f:
        return vk_from_dict(json.load(f))


def _limbs(cols: torch.Tensor) -> np.ndarray:
    """(m, n, 8) canonical words -> (m, n, 33) int32 byte limbs."""
    raw = cols.cpu().contiguous().numpy().astype("<i4").view(np.uint8)
    out = np.zeros(raw.shape[:2] + (33,), dtype=np.int32)
    out[..., :32] = raw
    return out


def write_pk(pk: ProvingKey, path: str,
             cache_digest: bytes | None = None) -> None:
    """`<path>.vk` (with `cache_digest` when given) and `<path>.npz`."""
    d = vk_to_dict(pk.vk)
    if cache_digest is not None:
        d["cache_digest"] = cache_digest.hex()
    with open(path + ".vk", "w") as f:
        json.dump(d, f)
    np.savez_compressed(path, **{k: _limbs(getattr(pk, k))
                                 for k in PK_ARRAYS})


def read_pk(path: str, device="cuda", cs=None) -> ProvingKey:
    """Load `<path>.vk` + `<path>.npz`, written by either package (only the
    four column arrays are read), onto `device`; `cs` replaces the decoded
    constraint system when its digest is the same."""
    with open(path + ".vk") as f:
        vk_dict = json.load(f)
    z = np.load(path + ".npz", allow_pickle=False)
    return from_reference_pk({k: z[k] for k in PK_ARRAYS}, vk_dict, device,
                             cs=cs)


def gen_pk(params: ParamsKZG, data: CircuitData,
           path: str | None = None) -> ProvingKey:
    """keygen, or the key saved at `path` when it was made from this
    circuit (its sidecar's `cache_digest` equals the circuit's); a fresh key
    is saved there.  A sidecar without a digest is accepted on the
    constraint system's digest and given the circuit's digest."""
    device = params.g.device
    want = data.cache_digest_bytes()
    if path and os.path.exists(path + ".npz"):
        with open(path + ".vk") as f:
            sidecar = json.load(f)
        stored = sidecar.get("cache_digest")
        if stored is not None:
            valid = bytes.fromhex(stored) == want
        else:
            valid = (vk_from_dict(sidecar).cs.digest_bytes()
                     == data.cs.digest_bytes())
        if valid:
            pk = read_pk(path, device, cs=data.cs)
            if stored is None:
                sidecar["cache_digest"] = want.hex()
                with open(path + ".vk", "w") as f:
                    json.dump(sidecar, f)
            return pk
        print(f"# gen_pk: the key at {path} was made from another circuit; "
              "making it again", file=sys.stderr)
    pk = keygen(params, data)
    if path:
        write_pk(pk, path, cache_digest=want)
    return pk


def gen_snark(params: ParamsKZG, pk: ProvingKey, witness, instances,
              path: str | None = None, transcript_cls=PoseidonTranscript,
              rng: BlindingRng | None = None) -> Snark:
    """Prove, verify the proof, and write the snark to `path` when given."""
    proof = create_proof(params, pk, witness, instances, transcript_cls(),
                         rng=rng)
    if not verify_proof(params, pk.vk, instances, proof, transcript_cls):
        raise RuntimeError("gen_snark: the proof does not verify")
    snark = Snark(vk=pk.vk, instances=instances, proof=proof)
    if path:
        snark.write(path)
    return snark


def verify_snark(params: ParamsKZG, snark: Snark,
                 transcript_cls=PoseidonTranscript) -> bool:
    return verify_proof(params, snark.vk, snark.instances, snark.proof,
                        transcript_cls)


def gen_evm_proof(params: ParamsKZG, pk: ProvingKey, witness, instances,
                  path: str | None = None,
                  rng: BlindingRng | None = None) -> bytes:
    """A proof with the Keccak transcript, for the EVM verifier (reference
    `gen_evm_proof_shplonk`, cli.rs:519): verified, and written to `path`
    when given."""
    proof = create_proof(params, pk, witness, instances, KeccakTranscript(),
                         rng=rng)
    if not verify_proof(params, pk.vk, instances, proof, KeccakTranscript):
        raise RuntimeError("gen_evm_proof: the proof does not verify")
    if path:
        with open(path, "wb") as f:
            f.write(proof)
    return proof


def gen_evm_verifier(params: ParamsKZG, vk: VerifyingKey,
                     num_instance_rows: list, sol_path: str | None = None,
                     name: str = "Halo2TpuVerifier") -> str:
    """The Solidity verifier of `vk`, written to `sol_path` when given
    (reference `gen_evm_verifier_shplonk`, cli.rs:512-517)."""
    return evm.gen_evm_verifier(params, vk, num_instance_rows, sol_path, name)


def evm_verify(params: ParamsKZG, vk: VerifyingKey, instances,
               proof: bytes) -> bool:
    """Deploy the verifier's bytecode into the in-process EVM and call it
    with `instances ++ proof` (reference `evm_verify` into revm,
    cli.rs:524)."""
    accepted, _gas = evm.evm_verify_bytecode(params, vk, instances, proof)
    return accepted

"""SDK subset: proving keys saved by the JAX package, and snark files.

Counterpart of part of halo2_zkcert_tpu/sdk.py.  A saved pk is a vk
sidecar (`<path>.vk`, json) plus `<path>.npz` with the resident-limb
columns; `read_pk` carries it across with `keygen.from_reference_pk`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from .plonk.keygen import (ProvingKey, VerifyingKey, from_reference_pk,
                           vk_from_dict, vk_to_dict)

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


def read_vk(path: str) -> VerifyingKey:
    with open(path) as f:
        return vk_from_dict(json.load(f))


def read_pk(path: str, device="cuda", cs=None) -> ProvingKey:
    """Load `<path>.vk` + `<path>.npz` (only the four column arrays are
    read) onto `device`."""
    with open(path + ".vk") as f:
        vk_dict = json.load(f)
    z = np.load(path + ".npz", allow_pickle=False)
    return from_reference_pk({k: z[k] for k in PK_ARRAYS}, vk_dict, device,
                             cs=cs)

"""Verifying and proving keys, and keygen.

Counterpart of halo2_zkcert_tpu/plonk/keygen.py.  `keygen(params, data)`
makes a proving key on the SRS's device: the fixed columns, the
permutation's sigma columns (omega^row' x delta^col' of the next cell in
each copy cycle, two gathers and one K1 product), their commitments
through `kzg.commit_many_lagrange` (the fixed-base MSM on the card for
n >= 4096, its window tables built first) and their coefficient forms
through the inverse transform (csrc/ntt.cu).  Columns are kept as 8
canonical words; the JAX package's u8 byte representatives, which it needs
to fit its 16 GB TPU, are not kept.  A key the JAX package saved is carried
across with `from_reference_pk` (sdk.read_pk).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import field
from ..ops.field import FR
from ..utils import refcrypto as rc
from ..utils import trace
from .assignment import CircuitData, permutation_mapping
from .cs import DELTA, ConstraintSystem
from .domain import Domain
from .kzg import ParamsKZG, _fb_wanted, commit_many_lagrange


@dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: list          # [(x, y)]
    permutation_commitments: list    # [(x, y)] sigma commitments
    num_instance: list
    accumulator_indices: list | None = None

    @property
    def n(self) -> int:
        return 1 << self.k

    def domain(self, device="cpu") -> Domain:
        return Domain(self.k, self.cs.quotient_degree, str(device))

    def transcript_repr(self) -> int:
        """vk hash absorbed at the start of every transcript."""
        h = rc.blake2b(self.digest_bytes(), 64, persona=b"Halo2-Verify-Key")
        return rc.fr_from_u512_le(h[:32], h[32:])

    def digest_bytes(self) -> bytes:
        parts = [f"vk:v1;k={self.k};ninst={self.num_instance}".encode(),
                 self.cs.digest_bytes()]
        for (x, y) in self.fixed_commitments + self.permutation_commitments:
            parts.append(rc.fe_to_bytes_le(x) + rc.fe_to_bytes_le(y))
        return b"|".join(parts)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_lagrange: torch.Tensor     # (num_fixed, n, 8)
    fixed_coeff: torch.Tensor        # (num_fixed, n, 8)
    sigma_lagrange: torch.Tensor     # (m, n, 8)
    sigma_coeff: torch.Tensor        # (m, n, 8)

    @property
    def device(self) -> torch.device:
        parked = self.__dict__.get("_parked_device")
        return parked if parked is not None else self.fixed_lagrange.device

    def domain(self) -> Domain:
        return self.vk.domain(self.device)

    def park_lagrange(self) -> None:
        """Take the Lagrange columns off the device until `restore_lagrange`
        (the prover's big-domain residency: nothing reads them through the
        quotient).  Their host copies are made at the first park and kept
        for the next; `device` stays the card's meanwhile."""
        if self.fixed_lagrange is None:
            return
        self.__dict__["_parked_device"] = self.fixed_lagrange.device
        if "_host_lagrange" not in self.__dict__:
            self.__dict__["_host_lagrange"] = (self.fixed_lagrange.cpu(),
                                               self.sigma_lagrange.cpu())
        self.fixed_lagrange = self.sigma_lagrange = None

    def restore_lagrange(self) -> None:
        if self.fixed_lagrange is not None:
            return
        dev = self.__dict__.pop("_parked_device")
        fixed, sigma = self.__dict__["_host_lagrange"]
        self.fixed_lagrange, self.sigma_lagrange = fixed.to(dev), sigma.to(dev)


def vk_to_dict(vk: VerifyingKey) -> dict:
    return {
        "k": vk.k,
        "num_instance": vk.num_instance,
        "accumulator_indices": vk.accumulator_indices,
        "fixed_commitments": [[x, y] for (x, y) in vk.fixed_commitments],
        "permutation_commitments": [[x, y] for (x, y)
                                    in vk.permutation_commitments],
        "cs": vk.cs.to_dict(),
    }


def vk_from_dict(d: dict) -> VerifyingKey:
    acc = d.get("accumulator_indices")
    if isinstance(d["cs"], str):
        raise ValueError(
            "legacy pickle-format vk artifact; regenerate it -- pickled "
            "constraint systems are not loaded")
    return VerifyingKey(
        k=d["k"], cs=ConstraintSystem.from_dict(d["cs"]),
        fixed_commitments=[(int(x), int(y)) for x, y in d["fixed_commitments"]],
        permutation_commitments=[(int(x), int(y)) for x, y
                                 in d["permutation_commitments"]],
        num_instance=list(d["num_instance"]),
        accumulator_indices=[(int(c), int(r)) for c, r in acc] if acc else None,
    )


def resident_columns(arr, device) -> torch.Tensor:
    """(m, n, 33) resident limbs (numpy or tensor, any integer type) ->
    (m, n, 8) canonical, converted on `device` one column at a time."""
    arr = np.asarray(arr)
    out = torch.empty(arr.shape[:2] + (8,), dtype=torch.int32, device=device)
    for i in range(arr.shape[0]):
        col = torch.from_numpy(np.ascontiguousarray(arr[i], dtype=np.int32))
        out[i] = field.from_resident(FR, col.to(device))
    return out


def vk_with_cs(vk_dict: dict, cs: ConstraintSystem | None = None
               ) -> VerifyingKey:
    """The vk of a sidecar dict; `cs`, when given, replaces the decoded
    constraint system (a live circuit's, whose digest must match)."""
    vk = vk_from_dict(vk_dict)
    if cs is not None:
        assert cs.digest_bytes() == vk.cs.digest_bytes(), "cs digest mismatch"
        vk.cs = cs
    return vk


def from_reference_pk(arrays, vk_dict: dict, device="cuda",
                      cs: ConstraintSystem | None = None) -> ProvingKey:
    """Carry the JAX package's proving key across.

    `arrays` maps fixed_lagrange, fixed_coeff, sigma_lagrange, sigma_coeff
    to (m, n, 33) int32 resident limbs (the JAX pk's device arrays, or the
    arrays of a saved `.pk.npz`); `vk_dict` is its vk sidecar; `cs` as
    `vk_with_cs` takes it."""
    return ProvingKey(
        vk=vk_with_cs(vk_dict, cs),
        fixed_lagrange=resident_columns(arrays["fixed_lagrange"], device),
        fixed_coeff=resident_columns(arrays["fixed_coeff"], device),
        sigma_lagrange=resident_columns(arrays["sigma_lagrange"], device),
        sigma_coeff=resident_columns(arrays["sigma_coeff"], device),
    )


def sigma_columns(data: CircuitData, dom: Domain,
                  mapping: np.ndarray | None = None) -> torch.Tensor:
    """(m, n, 8) sigma columns on the domain's device: at (c, r) the value
    delta^c' omega^r' of the next cell (c', r') of the copy cycle holding
    (c, r) (`permutation_mapping`, or `mapping` when given)."""
    if mapping is None:
        mapping = permutation_mapping(data)
    m, dev = mapping.shape[0], dom.device
    if not m:
        return torch.zeros((0, dom.n, 8), dtype=torch.int32, device=dev)
    delta_pows = field.from_ints(FR, [pow(DELTA, c, rc.FR) for c in range(m)],
                                 dev)
    rows = torch.from_numpy(mapping[:, :, 1]).to(dev)
    cols = torch.from_numpy(mapping[:, :, 0]).to(dev)
    return field.mul(FR, dom.omega_pows_device[rows], delta_pows[cols])


def keygen(params: ParamsKZG, data: CircuitData) -> ProvingKey:
    """The proving key of `data` on the SRS's device; with H2T_PROFILE set,
    the reference's `[keygen] <stage>: <s>` ticks."""
    assert params.k == data.k, "SRS size must match circuit k"
    device = params.g.device
    dom = Domain(data.k, data.cs.quotient_degree, str(device))
    tick = trace.Ticks("keygen", "H2T_PROFILE", device)

    # the fixed-base tables first, before the key's columns take memory
    if _fb_wanted(params.n, device):
        params.fixed_base(lagrange=True)
    tick("fb tables")
    fixed_lag = data.fixed_tensor(device)
    tick("fixed limbs")
    mapping = permutation_mapping(data)
    tick("permutation mapping")
    sigma_lag = sigma_columns(data, dom, mapping)
    tick("sigma columns")
    vk = VerifyingKey(
        k=data.k, cs=data.cs,
        fixed_commitments=commit_many_lagrange(params, fixed_lag),
        permutation_commitments=commit_many_lagrange(params, sigma_lag),
        num_instance=list(data.num_instance),
        accumulator_indices=data.accumulator_indices)
    tick("commits")

    def coeff(cols):
        return dom.lagrange_to_coeff(cols) if cols.shape[0] else cols.clone()

    pk = ProvingKey(vk=vk, fixed_lagrange=fixed_lag,
                    fixed_coeff=coeff(fixed_lag), sigma_lagrange=sigma_lag,
                    sigma_coeff=coeff(sigma_lag))
    tick("lag2coeff+u8")
    return pk

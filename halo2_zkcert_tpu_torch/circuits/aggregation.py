"""SNARK aggregation circuit: verify N inner snarks in-circuit, expose one
KZG accumulator.

Counterpart of halo2_zkcert_tpu/circuits/aggregation.py.

Capability parity with the reference's `AggregationCircuit::new::<SHPLONK>`
(snark-verifier-sdk [dep] Cargo.lock:2714) and
`X509VerifierAggregationCircuit` (reference src/lib.rs:29-146): each inner
proof's PLONK verification is replayed in-circuit (agg_loader.CircuitLoader
driving plonk.verifier_core.verify_core), the per-proof KZG pairs are
folded with an in-circuit Fiat-Shamir challenge rho, and the folded pair
(LHS*, RHS*) is exposed as 8 public instances (2 points x 2 coords x 2
128-bit limbs — see transcript.LIMB_BITS; the reference exposes 12 x 88-bit
limbs, a halo2-ecc CRT-width convention this framework deviates from).

The outer verifier (native `verify_aggregated` below, or the EVM verifier)
checks the outer PLONK proof, reconstructs the pair, and runs the single
deferred pairing  e(LHS*, [s]_2) * e(-RHS*, [1]_2) == 1.

Vk handling: inner vks are baked in as circuit constants (fixed-vk mode —
the reference's VerifierUniversality::Full reads vks from witness instead;
keys must be regenerated per inner-circuit shape here).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..plonk import verify_proof
from ..plonk.verifier_core import verify_core
from ..transcript import LIMB_BITS
from ..transcript.poseidon import PoseidonSponge
from ..utils import refcrypto as rc
from .agg_loader import CircuitLoader, TAPE_LIMBS_PER_HALF
from .composed import ComposedCircuit
from .ecc_gadget import EccGadget
from .poseidon_gadget import PoseidonSpongeGadget


def fold_and_expose(gb, tape, ecc: EccGadget, loaders: list, pairs: list):
    """Fold per-proof (lhs_terms, rhs_terms) with rho, run the two MSMs,
    expose the folded pair as 8 instances.  Returns the pair's host values
    ((lhs_x, lhs_y), (rhs_x, rhs_y))."""
    # rho binds every proof's full transcript (one extra squeeze each)
    binder = PoseidonSpongeGadget(gb)
    for ld in loaders:
        binder.update([ld.t_squeeze()])
    rho = binder.squeeze()

    lhs_terms, rhs_terms = [], []
    rho_pow = None  # rho^0 = 1 -> no scaling for proof 0
    for (lt, rt) in pairs:
        for (pt, s) in lt:
            lhs_terms.append((pt, s if rho_pow is None else gb.mul(s, rho_pow)))
        for (pt, s) in rt:
            rhs_terms.append((pt, s if rho_pow is None else gb.mul(s, rho_pow)))
        rho_pow = rho if rho_pow is None else gb.mul(rho_pow, rho)

    lhs_pt = ecc.msm([p for p, _ in lhs_terms], [s for _, s in lhs_terms])
    rhs_pt = ecc.msm([p for p, _ in rhs_terms], [s for _, s in rhs_terms])

    H = TAPE_LIMBS_PER_HALF
    for coord in (lhs_pt.x, lhs_pt.y, rhs_pt.x, rhs_pt.y):
        cells = tape.limb_cells(coord)
        for half in (cells[:H], cells[H:2 * H]):
            acc = half[-1]
            for c in reversed(half[:-1]):
                acc = gb.mul_add(acc, gb.constant(1 << 16), c)
            gb.expose_public(acc)
    return lhs_pt.value, rhs_pt.value


@dataclass
class InnerSnark:
    vk: object            # plonk.VerifyingKey
    instances: list
    proof: bytes


class AggregationCircuit:
    """Aggregates `snarks`; optional `link(gb, loaders)` adds equality
    constraints between inner instance cells (the X509 digest linking,
    reference lib.rs:60-66).  `keep_identity_terms`: record the JAX
    package's circuit, whose accumulator is wrong when an inner vk has an
    identity commitment (agg_loader.py)."""

    def __init__(self, snarks: list, k: int, lanes: int = 4, na: int = 2,
                 nl: int = 1, link=None, universal: bool = False,
                 keep_identity_terms: bool = False):
        self.snarks = snarks
        self.link = link
        self.universal = universal
        self._acc_value = None

        def program(gb, tape):
            ecc = EccGadget(tape)
            loaders, pairs = [], []
            for s in snarks:
                ld = CircuitLoader(gb, tape, ecc, s.vk, s.instances, s.proof,
                                   universal=universal,
                                   keep_identity_terms=keep_identity_terms)
                res = verify_core(ld, s.vk, [len(c) for c in s.instances])
                loaders.append(ld)
                pairs.append(res)
            if link is not None:
                link(gb, loaders)
            self._acc_value = fold_and_expose(gb, tape, ecc, loaders, pairs)
            if universal:
                # bind every witnessed inner vk to the statement: ONE
                # Poseidon digest over the canonical binding cells, public
                # at instance row 8 (after the 8 accumulator limbs).  The
                # outer verifier recomputes it from the expected vks
                # (vk_binding_digest) — reference VerifierUniversality::
                # Full semantics with an explicit exposed digest.
                binder = PoseidonSpongeGadget(gb)
                for ld in loaders:
                    binder.update(ld.vk_binding_cells)
                gb.expose_public(binder.squeeze())

        self.composed = ComposedCircuit(program, k, lanes=lanes, na=na, nl=nl)
        self.data = self.composed.data
        self.data.accumulator_indices = [(0, i) for i in range(8)]

    def witness(self, device="cuda"):
        return self.composed.witness(device)

    def rows_report(self):
        return self.composed.rows_report()


def vk_binding_digest(vks: list) -> int:
    """Host mirror of the universal-mode vk digest: Poseidon over
    [transcript_repr, packed 128-bit halves of every fixed then sigma
    commitment] per vk, in snark order."""
    mask = (1 << 128) - 1
    sponge = PoseidonSponge()
    for vk in vks:
        cells = [vk.transcript_repr()]
        for (x, y) in vk.fixed_commitments + vk.permutation_commitments:
            for coord in (x, y):
                cells += [coord & mask, coord >> 128]
        sponge.update(cells)
    return sponge.squeeze()


def decode_accumulator(instances: list):
    """8 instance values -> ((lhs_x, lhs_y), (rhs_x, rhs_y))."""
    vals = [int(v) for v in instances[0][:8]]
    out = []
    for i in range(0, 8, 2):
        out.append(vals[i] + (vals[i + 1] << LIMB_BITS))
    return (out[0], out[1]), (out[2], out[3])


def verify_aggregated(params, vk, instances, proof, transcript_cls,
                      inner_vks: list | None = None) -> bool:
    """Outer PLONK verification + the deferred accumulator pairing.

    inner_vks: for UNIVERSAL aggregation circuits, the expected inner vks —
    the exposed vk digest (instance row 8) must match them, otherwise the
    proof only states "valid under SOME vks of this shape"."""
    if not verify_proof(params, vk, instances, proof, transcript_cls):
        return False
    if inner_vks is not None:
        if len(instances[0]) < 9 or \
                int(instances[0][8]) != vk_binding_digest(inner_vks):
            return False
    lhs, rhs = decode_accumulator(instances)
    if lhs == (0, 0) or rhs == (0, 0):
        return False
    return rc.pairing_check([
        (lhs, params.s_g2),
        (rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(rhs))), params.g2),
    ])

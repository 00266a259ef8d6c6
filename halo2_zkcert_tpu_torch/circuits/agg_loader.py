"""Circuit loader: the PLONK verifier replayed as a witness program.

Counterpart of halo2_zkcert_tpu/circuits/agg_loader.py, the same
recording operation for operation but for identity vk commitments (below).

Third interpreter of `plonk.verifier_core.verify_core` (reference:
snark-verifier's `Halo2Loader` [dep Cargo.lock:2676], SURVEY.md §3.4):
scalars become GateBuilder cells, the Fiat-Shamir transcript becomes the
Poseidon sponge gadget fed by proof bytes as witnesses, and commitments
become tape-witnessed G1 points whose linear combination is DEFERRED —
`final_check` returns (lhs_terms, rhs_terms) pair lists that the
aggregation circuit folds across proofs and evaluates with two in-circuit
MSMs (ecc_gadget.msm).

Pair semantics (scaled form of the native check, verifier_core
NativeLoader.final_check): per proof,
    e(z0 * W',  [s]_2) * e(-(u * z0 * W' + acc), [1]_2) == 1
so lhs_terms = [(W', z0)], rhs_terms = acc_terms + [(W', u*z0)].

Identity commitments: the commitment of a zero column is the identity,
which an affine EcPoint cannot hold.  In fixed-vk mode such a vk term adds
nothing to the native sum and is left out of the deferred MSM.  The JAX
package adds (0, 0) to its MSM as if it were an affine point, so its
accumulator fails the pairing whenever an inner vk has one (the SHA-256
k=12 vks have five zero fixed columns); `keep_identity_terms=True`
records that circuit, to hold this port to the JAX package and to
build/x509_agg.pk.vk.  Universal mode witnesses every vk point with an
on-curve check, so a vk with an identity commitment cannot be recorded
there (as in the JAX package).
"""
from __future__ import annotations

from ..transcript import LIMB_BITS
from ..utils import refcrypto as rc
from .ecc_gadget import EccGadget, EcPoint
from .poseidon_gadget import PoseidonSpongeGadget

TAPE_LIMBS_PER_HALF = LIMB_BITS // 16   # 8 tape limbs per 128-bit half


class CircuitLoader:
    """Implements the verify_core loader contract over (gb, tape, ecc).

    universal=True: the inner vk enters as WITNESSES instead of baked
    constants (reference `VerifierUniversality::Full`, lib.rs:47) — the
    transcript repr and every fixed/sigma commitment are witnessed in
    CANONICAL ORDER at construction and collected in `vk_binding_cells`;
    the aggregation circuit hashes those cells and exposes the digest as a
    public instance, so ONE aggregation pk serves any inner vk of the same
    circuit shape (the outer verifier pins the digest to the expected
    vks — aggregation.vk_binding_digest)."""

    def __init__(self, gb, tape, ecc: EccGadget, vk, instances: list,
                 proof: bytes, universal: bool = False,
                 keep_identity_terms: bool = False):
        self.gb = gb
        self.keep_identity_terms = keep_identity_terms
        self.tape = tape
        self.ecc = ecc
        self.vk = vk
        self.instances = instances
        self.proof = proof
        self.pos = 0
        self.sponge = PoseidonSpongeGadget(gb)
        self._inst_cells: dict = {}
        self._const_pts: dict = {}
        self.universal = universal
        self.vk_binding_cells: list = []
        self._vk_repr_cell = None
        self._vk_pts: dict = {}
        if universal:
            self._vk_repr_cell = gb.witness(vk.transcript_repr())
            self.vk_binding_cells.append(self._vk_repr_cell)
            for kind, comms in (("f", vk.fixed_commitments),
                                ("s", vk.permutation_commitments)):
                for i, xy in enumerate(comms):
                    pt = self.ecc.witness_point(xy, check=True)
                    self._vk_pts[(kind, i)] = pt
                    self.vk_binding_cells.extend(self._packed_halves(pt))

    # ---- scalars (builder cells) ---------------------------------------------

    def s_const(self, v: int):
        return self.gb.constant(v % rc.FR)

    def s_add(self, a, b):
        return self.gb.add(a, b)

    def s_sub(self, a, b):
        return self.gb.sub(a, b)

    def s_mul(self, a, b):
        return self.gb.mul(a, b)

    def s_inv(self, a):
        gb = self.gb
        inv = gb.witness(rc.finv(a.value, rc.FR))
        gb.assert_const(gb.mul(a, inv), 1)
        return inv

    def vk_repr_scalar(self, vk):
        """vk transcript repr: witness cell under universality, else
        constant (verify_core consults this hook when present)."""
        if self.universal:
            return self._vk_repr_cell
        return self.s_const(vk.transcript_repr())

    def instance_scalar(self, col: int, row: int):
        key = (col, row)
        if key not in self._inst_cells:
            self._inst_cells[key] = self.gb.witness(
                self.instances[col][row] % rc.FR)
        return self._inst_cells[key]

    # ---- transcript ------------------------------------------------------------

    def t_common_scalar(self, s) -> None:
        self.sponge.update([s])

    def t_read_scalar(self):
        raw = self.proof[self.pos:self.pos + 32]
        self.pos += 32
        v = rc.fe_from_bytes_le(raw)
        assert v < rc.FR, "non-canonical scalar in proof"
        c = self.gb.witness(v)
        self.sponge.update([c])
        return c

    def _packed_halves(self, pt: EcPoint) -> list:
        """[lo(x), hi(x), lo(y), hi(y)] 128-bit half cells of a point."""
        gb, t = self.gb, self.tape
        H = TAPE_LIMBS_PER_HALF
        out = []
        for coord in (pt.x, pt.y):
            cells = t.limb_cells(coord)
            for half in (cells[:H], cells[H:2 * H]):
                acc = half[-1]
                for c in reversed(half[:-1]):
                    acc = gb.mul_add(acc, gb.constant(1 << 16), c)
                out.append(acc)
        return out

    def _absorb_point(self, pt: EcPoint) -> None:
        """Absorb as [lo(x), hi(x), lo(y), hi(y)] 128-bit halves — exactly
        the native PoseidonTranscript.common_point convention."""
        self.sponge.update(self._packed_halves(pt))

    def t_read_point(self) -> EcPoint:
        raw = self.proof[self.pos:self.pos + 32]
        self.pos += 32
        xy = rc.g1_decompress(raw)
        pt = self.ecc.witness_point(xy, check=True)
        self._absorb_point(pt)
        return pt

    def t_squeeze(self):
        return self.sponge.squeeze()

    # ---- points (deferred linear combination) -----------------------------------

    def _const_point(self, xy) -> EcPoint:
        if xy not in self._const_pts:
            self._const_pts[xy] = self.ecc.constant_point(xy)
        return self._const_pts[xy]

    def _vk_point(self, kind: str, i: int) -> EcPoint:
        if self.universal:
            return self._vk_pts[(kind, i)]
        comms = self.vk.fixed_commitments if kind == "f" \
            else self.vk.permutation_commitments
        return self._const_point(comms[i])

    def _vk_terms(self, kind: str, i: int) -> list:
        comms = self.vk.fixed_commitments if kind == "f" \
            else self.vk.permutation_commitments
        if (comms[i] == (0, 0) and not self.universal
                and not self.keep_identity_terms):
            return []
        return [(self._vk_point(kind, i), None)]

    def _resolve(self, comm):
        """-> [(EcPoint, scalar_cell | None)]; None scalar = 1."""
        if isinstance(comm, tuple) and comm and comm[0] == "vk_fixed":
            return self._vk_terms("f", comm[1])
        if isinstance(comm, tuple) and comm and comm[0] == "vk_sigma":
            return self._vk_terms("s", comm[1])
        if isinstance(comm, tuple) and comm and comm[0] == "h_collapsed":
            _, pts, xn = comm
            out = []
            power = None
            for i, pt in enumerate(pts):
                out.append((pt, power))
                power = xn if power is None else self.gb.mul(power, xn)
            return out
        return [(comm, None)]

    def p_identity(self):
        return []

    def p_acc(self, acc: list, comm, scalar):
        for pt, coeff in self._resolve(comm):
            s = scalar if coeff is None else self.gb.mul(scalar, coeff)
            acc.append((pt, s))
        return acc

    def p_acc_generator(self, acc: list, scalar):
        acc.append((self._const_point(rc.G1_GEN), scalar))
        return acc

    def final_check(self, w_open: EcPoint, acc: list, z0_inv, u):
        z0 = self.s_inv(z0_inv)
        lhs_terms = [(w_open, z0)]
        rhs_terms = list(acc) + [(w_open, self.gb.mul(u, z0))]
        return lhs_terms, rhs_terms

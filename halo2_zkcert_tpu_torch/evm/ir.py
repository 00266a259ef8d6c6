"""Straight-line verification IR (the EVM loader's front half).

Counterpart of halo2_zkcert_tpu/evm/ir.py: `build_verifier_ir` drives
plonk/verifier_core.py `verify_core` through `EvmIrLoader` and gives the
same op list, tuple for tuple.

Ops (SSA; each yields a uint256 value id unless noted):
  ("const", v)                       constant scalar
  ("instance", col, row)             public input
  ("proof_scalar", off)              32-byte BE scalar at proof[off]
  ("proof_point", off)               64-byte point -> returns (id_x, id_y)
                                     via two ops ("proof_px", off)/("proof_py", off)
  ("addmod", a, b) ("mulmod", a, b) ("submod", a, b)   mod r
  ("invmod", a)                      a^(r-2) mod r (modexp precompile)
  ("absorb_scalar", a)               transcript side effect (no value)
  ("absorb_point", ax, ay)           transcript side effect
  ("squeeze",)                       keccak challenge (KeccakTranscript rules)
  ("ec_zero",)                       point accumulator = identity -> (id pair)
  ("ec_acc", accx, accy, px, py, s)  acc += s * P  -> new (x, y) ids
  ("ec_acc_const", accx, accy, X, Y, s)  constant point (vk commitment / G1)
  ("final", wx, wy, accx, accy, z0inv, u)  pairing check -> bool (last op)

The proof byte layout is the KeccakTranscript one (BE scalars, 64-byte
uncompressed points) — the EVM-flavored proof from gen_evm_proof.
"""
from __future__ import annotations

from ..utils import refcrypto as rc
from ..plonk.verifier_core import verify_core


class EvmIrLoader:
    def __init__(self, vk):
        self.vk = vk
        self.ops: list = []
        self.cursor = 0          # proof byte offset

    def _emit(self, *op) -> int:
        self.ops.append(op)
        return len(self.ops) - 1

    # scalars
    def s_const(self, v):
        return self._emit("const", v % rc.FR)

    def s_add(self, a, b):
        return self._emit("addmod", a, b)

    def s_sub(self, a, b):
        return self._emit("submod", a, b)

    def s_mul(self, a, b):
        return self._emit("mulmod", a, b)

    def s_inv(self, a):
        return self._emit("invmod", a)

    def instance_scalar(self, col, row):
        return self._emit("instance", col, row)

    # transcript
    def t_common_scalar(self, s):
        self._emit("absorb_scalar", s)

    def t_read_scalar(self):
        v = self._emit("proof_scalar", self.cursor)
        self.cursor += 32
        self._emit("absorb_scalar", v)
        return v

    def t_read_point(self):
        px = self._emit("proof_px", self.cursor)
        py = self._emit("proof_py", self.cursor)
        self.cursor += 64
        self._emit("absorb_point", px, py)
        return (px, py)

    def t_squeeze(self):
        return self._emit("squeeze")

    # points
    def p_identity(self):
        x = self._emit("ec_zero_x")
        y = self._emit("ec_zero_y")
        return (x, y)

    def _resolve_const(self, comm):
        if comm[0] == "vk_fixed":
            return [(self.vk.fixed_commitments[comm[1]], None)]
        if comm[0] == "vk_sigma":
            return [(self.vk.permutation_commitments[comm[1]], None)]
        raise AssertionError(comm)

    def p_acc(self, acc, comm, scalar):
        ax, ay = acc
        if isinstance(comm, tuple) and isinstance(comm[0], str):
            if comm[0] == "h_collapsed":
                _, pts, xn = comm
                s = scalar
                for i, (px, py) in enumerate(pts):
                    si = s if i == 0 else self._emit("mulmod", s, _pow_ir(self, xn, i))
                    nx = self._emit("ec_acc_x", ax, ay, px, py, si)
                    ny = self._emit("ec_acc_y")
                    ax, ay = nx, ny
                return (ax, ay)
            (X, Y), _ = self._resolve_const(comm)[0]
            nx = self._emit("ec_acc_const_x", ax, ay, X, Y, scalar)
            ny = self._emit("ec_acc_y")
            return (nx, ny)
        px, py = comm    # proof point ids
        nx = self._emit("ec_acc_x", ax, ay, px, py, scalar)
        ny = self._emit("ec_acc_y")
        return (nx, ny)

    def p_acc_generator(self, acc, scalar):
        ax, ay = acc
        nx = self._emit("ec_acc_const_x", ax, ay, 1, 2, scalar)
        ny = self._emit("ec_acc_y")
        return (nx, ny)

    def final_check(self, w_open, acc, z0_inv, u):
        wx, wy = w_open
        ax, ay = acc
        return self._emit("final", wx, wy, ax, ay, z0_inv, u)


def _pow_ir(L: EvmIrLoader, xn_id: int, e: int) -> int:
    """xn^e as IR ops (small e: h piece count)."""
    acc = None
    b = xn_id
    while e:
        if e & 1:
            acc = b if acc is None else L._emit("mulmod", acc, b)
        e >>= 1
        if e:
            b = L._emit("mulmod", b, b)
    return acc if acc is not None else L._emit("const", 1)


def build_verifier_ir(vk, num_instance_rows: list):
    """-> (ops, proof_len_bytes).

    For aggregation vks (vk.accumulator_indices set), the trailing pairing
    additionally folds in the deferred KZG accumulator reconstructed from
    the instance limbs, combined with a squeezed challenge rho (reference:
    snark-verifier EvmLoader accumulator handling [dep]):
        e(W' + rho*LHS*, [s]2) * e(-(u*W' + z0inv*acc + rho*RHS*), [1]2)
    """
    loader = EvmIrLoader(vk)
    result = verify_core(loader, vk, num_instance_rows)
    assert loader.ops and loader.ops[result][0] == "final"
    acc_idx = getattr(vk, "accumulator_indices", None)
    if acc_idx:
        assert len(acc_idx) == 8, "expected 2 points x 2 coords x 2 limbs"
        final = loader.ops.pop()
        ids = [loader._emit("instance", c, r) for (c, r) in acc_idx]
        coords = [loader._emit("comb128", ids[2 * i], ids[2 * i + 1])
                  for i in range(4)]
        rho = loader._emit("squeeze")
        loader._emit("final_acc", *final[1:], *coords, rho)
    return loader.ops, loader.cursor


def execute_ir(ops: list, instances: list, proof: bytes, params) -> bool:
    """Run the IR on the host (Python ints, refcrypto's Keccak and pairing
    with the SRS's G2 points): True iff the proof verifies."""
    try:
        return _execute(ops, instances, proof, params)
    except ValueError:
        return False


def _execute(ops, instances, proof, params) -> bool:
    vals: list = [None] * len(ops)
    hbuf = bytearray()
    pts: dict = {}
    for i, op in enumerate(ops):
        tag = op[0]
        if tag == "const":
            vals[i] = op[1]
        elif tag == "instance":
            vals[i] = instances[op[1]][op[2]] % rc.FR
        elif tag == "proof_scalar":
            v = int.from_bytes(proof[op[1]:op[1] + 32], "big")
            if v >= rc.FR:
                raise ValueError("bad scalar")
            vals[i] = v
        elif tag == "proof_px":
            vals[i] = int.from_bytes(proof[op[1]:op[1] + 32], "big")
        elif tag == "proof_py":
            off = ops[i - 1][1]
            vals[i] = int.from_bytes(proof[off + 32:off + 64], "big")
            x, y = vals[i - 1], vals[i]
            if x >= rc.FQ or y >= rc.FQ or not rc.g1_is_on_curve_affine((x, y)):
                raise ValueError("bad point")
        elif tag == "addmod":
            vals[i] = (vals[op[1]] + vals[op[2]]) % rc.FR
        elif tag == "submod":
            vals[i] = (vals[op[1]] - vals[op[2]]) % rc.FR
        elif tag == "mulmod":
            vals[i] = vals[op[1]] * vals[op[2]] % rc.FR
        elif tag == "invmod":
            vals[i] = pow(vals[op[1]], rc.FR - 2, rc.FR)
        elif tag == "absorb_scalar":
            hbuf += int(vals[op[1]]).to_bytes(32, "big")
        elif tag == "absorb_point":
            hbuf += int(vals[op[1]]).to_bytes(32, "big")
            hbuf += int(vals[op[2]]).to_bytes(32, "big")
        elif tag == "squeeze":
            d = rc.keccak256(bytes(hbuf) + b"\x01")
            vals[i] = int.from_bytes(d, "big") % rc.FR
            hbuf = bytearray(int(vals[i]).to_bytes(32, "big"))
        elif tag == "ec_zero_x":
            pts[i] = rc.G1_IDENTITY
            vals[i] = 0
        elif tag == "ec_zero_y":
            vals[i] = 0
        elif tag in ("ec_acc_x", "ec_acc_const_x"):
            base = pts[op[1]]
            P = (vals[op[3]], vals[op[4]]) if tag == "ec_acc_x" else (op[3], op[4])
            s = vals[op[5]]
            pts[i] = rc.g1_add(base, rc.g1_mul(rc.g1_from_affine(P), s))
            vals[i] = 0
        elif tag == "ec_acc_y":
            vals[i] = 0
        elif tag == "comb128":
            vals[i] = vals[op[1]] + (vals[op[2]] << 128)
        elif tag in ("final", "final_acc"):
            w = (vals[op[1]], vals[op[2]])
            accp = pts[op[3]]
            z0_inv, u = vals[op[5]], vals[op[6]]
            Lp = rc.g1_mul(accp, z0_inv)
            lhs = rc.g1_add(rc.g1_mul(rc.g1_from_affine(w), u), Lp)
            w_total = rc.g1_from_affine(w)
            if tag == "final_acc":
                coords = [vals[op[7 + j]] for j in range(4)]
                for x, y in ((coords[0], coords[1]), (coords[2], coords[3])):
                    if x >= rc.FQ or y >= rc.FQ or \
                            not rc.g1_is_on_curve_affine((x, y)):
                        raise ValueError("bad accumulator point")
                rho = vals[op[11]]
                w_total = rc.g1_add(
                    w_total, rc.g1_mul(
                        rc.g1_from_affine((coords[0], coords[1])), rho))
                lhs = rc.g1_add(lhs, rc.g1_mul(
                    rc.g1_from_affine((coords[2], coords[3])), rho))
            return rc.pairing_check([
                (rc.g1_to_affine(w_total), params.s_g2),
                (rc.g1_to_affine(rc.g1_neg(lhs)), params.g2)])
    raise AssertionError("no final op")

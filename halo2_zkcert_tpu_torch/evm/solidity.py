"""Solidity rendering of the verification IR.

Counterpart of halo2_zkcert_tpu/evm/solidity.py: the same text.

Reference behavior: `gen_evm_verifier_shplonk` writes a .sol artifact
(cli.rs:512-517 [dep], file `X509AggregationVerifierFinal.sol`).  The
contract exposes

    function verify(uint256[] calldata instances, bytes calldata proof)
        external view returns (bool)

and evaluates the straight-line IR with BN254 precompiles: ecAdd(0x6),
ecMul(0x7), ecPairing(0x8), modexp(0x5).  The Fiat-Shamir transcript is a
memory buffer hashed with keccak256 (KeccakTranscript conventions: BE
scalars, 64-byte points, 0x01 domain byte per squeeze, buffer reset to the
challenge).

The emitted source is checked through the same IR: `ir.execute_ir` and
the bytecode of evm/bytecode.py run that program; the rendering is one
line (or two) for each op.
"""
from __future__ import annotations

from ..utils import refcrypto as rc
from .ir import build_verifier_ir

R = rc.FR
Q = rc.FQ

_HEADER = """\
// SPDX-License-Identifier: MIT
// Auto-generated by halo2-zkcert-tpu gen_evm_verifier — do not edit.
pragma solidity ^0.8.19;

contract {name} {{
    uint256 internal constant R = {r};
    uint256 internal constant Qm = {q};

    function _ecAdd(uint256 ax, uint256 ay, uint256 bx, uint256 by)
        internal view returns (uint256 x, uint256 y) {{
        if (ax == 0 && ay == 0) return (bx, by);
        if (bx == 0 && by == 0) return (ax, ay);
        uint256[4] memory input_ = [ax, ay, bx, by];
        uint256[2] memory out_;
        assembly {{
            if iszero(staticcall(gas(), 0x06, input_, 0x80, out_, 0x40)) {{
                revert(0, 0)
            }}
        }}
        return (out_[0], out_[1]);
    }}

    function _ecMul(uint256 px, uint256 py, uint256 s)
        internal view returns (uint256 x, uint256 y) {{
        if (s == 0 || (px == 0 && py == 0)) return (0, 0);
        uint256[3] memory input_ = [px, py, s];
        uint256[2] memory out_;
        assembly {{
            if iszero(staticcall(gas(), 0x07, input_, 0x60, out_, 0x40)) {{
                revert(0, 0)
            }}
        }}
        return (out_[0], out_[1]);
    }}

    function _inv(uint256 a) internal view returns (uint256 r_) {{
        uint256[6] memory input_ = [uint256(32), 32, 32, a, R - 2, R];
        uint256[1] memory out_;
        assembly {{
            if iszero(staticcall(gas(), 0x05, input_, 0xc0, out_, 0x20)) {{
                revert(0, 0)
            }}
        }}
        return out_[0];
    }}

    function _squeeze(bytes memory buf)
        internal pure returns (uint256 c, bytes memory nbuf) {{
        bytes memory withDomain = bytes.concat(buf, hex"01");
        c = uint256(keccak256(withDomain)) % R;
        nbuf = abi.encodePacked(c);
    }}

    function verify(uint256[] calldata instances, bytes calldata proof)
        external view returns (bool) {{
        require(instances.length == {num_instances}, "bad instances");
        require(proof.length == {proof_len}, "bad proof length");
        uint256[] memory v = new uint256[]({num_vals});
        uint256[] memory px = new uint256[]({num_vals});
        uint256[] memory py = new uint256[]({num_vals});
        bytes memory buf;
        uint256 t0;
        uint256 t1;
"""

_FOOTER = """\
        return false; // unreachable
    }
}
"""


def emit_solidity(vk, num_instance_rows: list, name: str,
                  params=None) -> str:
    """Render the verifier contract for `vk`.  `params` provides the G2
    SRS points for the pairing (required)."""
    assert params is not None, "SRS params (G2 points) required"
    ops, proof_len = build_verifier_ir(vk, num_instance_rows)
    total_inst = sum(num_instance_rows)
    # flat instance indexing: col-major offsets
    offsets = []
    off = 0
    for rows in num_instance_rows:
        offsets.append(off)
        off += rows

    lines = []
    emit = lines.append
    for i, op in enumerate(ops):
        tag = op[0]
        if tag == "const":
            emit(f"v[{i}] = {op[1]};")
        elif tag == "instance":
            emit(f"v[{i}] = instances[{offsets[op[1]] + op[2]}] % R;")
        elif tag == "proof_scalar":
            emit(f"v[{i}] = uint256(bytes32(proof[{op[1]}:{op[1] + 32}]));"
                 f" require(v[{i}] < R, \"scalar\");")
        elif tag == "proof_px":
            emit(f"v[{i}] = uint256(bytes32(proof[{op[1]}:{op[1] + 32}]));")
        elif tag == "proof_py":
            o = ops[i - 1][1]
            emit(f"v[{i}] = uint256(bytes32(proof[{o + 32}:{o + 64}]));")
            emit(f"require(v[{i - 1}] < Qm && v[{i}] < Qm && "
                 f"mulmod(v[{i}], v[{i}], Qm) == addmod(mulmod(mulmod("
                 f"v[{i - 1}], v[{i - 1}], Qm), v[{i - 1}], Qm), 3, Qm), "
                 f"\"point\");")
        elif tag == "addmod":
            emit(f"v[{i}] = addmod(v[{op[1]}], v[{op[2]}], R);")
        elif tag == "submod":
            emit(f"v[{i}] = addmod(v[{op[1]}], R - v[{op[2]}], R);")
        elif tag == "mulmod":
            emit(f"v[{i}] = mulmod(v[{op[1]}], v[{op[2]}], R);")
        elif tag == "invmod":
            emit(f"v[{i}] = _inv(v[{op[1]}]);")
        elif tag == "absorb_scalar":
            emit(f"buf = bytes.concat(buf, abi.encodePacked(v[{op[1]}]));")
        elif tag == "absorb_point":
            emit(f"buf = bytes.concat(buf, abi.encodePacked(v[{op[1]}], "
                 f"v[{op[2]}]));")
        elif tag == "squeeze":
            emit(f"(v[{i}], buf) = _squeeze(buf);")
        elif tag == "ec_zero_x":
            emit(f"px[{i}] = 0; py[{i}] = 0;")
        elif tag == "ec_zero_y":
            pass
        elif tag == "ec_acc_x":
            emit(f"(t0, t1) = _ecMul(v[{op[3]}], v[{op[4]}], v[{op[5]}]);")
            emit(f"(px[{i}], py[{i}]) = _ecAdd(px[{op[1]}], py[{op[1]}], "
                 f"t0, t1);")
        elif tag == "ec_acc_const_x":
            emit(f"(t0, t1) = _ecMul({op[3]}, {op[4]}, v[{op[5]}]);")
            emit(f"(px[{i}], py[{i}]) = _ecAdd(px[{op[1]}], py[{op[1]}], "
                 f"t0, t1);")
        elif tag == "ec_acc_y":
            pass
        elif tag == "comb128":
            # plain integer recombination of 128-bit halves (no mod R):
            # instance limbs are < 2^128, so this cannot overflow uint256
            emit(f"require(v[{op[1]}] >> 128 == 0 && v[{op[2]}] >> 128 == 0, "
                 f"\"limb\");")
            emit(f"v[{i}] = v[{op[1]}] + (v[{op[2]}] << 128);")
        elif tag in ("final", "final_acc"):
            (x0, x1), (y0, y1) = params.g2
            (sx0, sx1), (sy0, sy1) = params.s_g2
            emit("// final pairing: e(W + rho*LHS*, [s]2) * "
                 "e(-(uW + z0inv*L + rho*RHS*), [1]2)")
            emit(f"(t0, t1) = _ecMul(px[{op[3]}], py[{op[3]}], v[{op[5]}]);")
            emit(f"{{ (uint256 a, uint256 b) = _ecMul(v[{op[1]}], "
                 f"v[{op[2]}], v[{op[6]}]);")
            emit(f"  (t0, t1) = _ecAdd(t0, t1, a, b); }}")
            if tag == "final_acc":
                # accumulator points must be on-curve (precompiles also
                # validate, but fail loudly here)
                for cx, cy in ((op[7], op[8]), (op[9], op[10])):
                    emit(f"require(v[{cx}] < Qm && v[{cy}] < Qm && "
                         f"mulmod(v[{cy}], v[{cy}], Qm) == addmod(mulmod("
                         f"mulmod(v[{cx}], v[{cx}], Qm), v[{cx}], Qm), 3, "
                         f"Qm), \"acc point\");")
                emit(f"{{ (uint256 a, uint256 b) = _ecMul(v[{op[9]}], "
                     f"v[{op[10]}], v[{op[11]}]);")
                emit(f"  (t0, t1) = _ecAdd(t0, t1, a, b); }}")
            emit("if (t1 != 0) { t1 = Qm - t1; }  // negate lhs")
            if tag == "final_acc":
                emit(f"{{ (uint256 a, uint256 b) = _ecMul(v[{op[7]}], "
                     f"v[{op[8]}], v[{op[11]}]);")
                emit(f"  (uint256 wx, uint256 wy) = _ecAdd(v[{op[1]}], "
                     f"v[{op[2]}], a, b);")
                emit("  t0 = t0; px[0] = wx; py[0] = wy; }")
                w_x, w_y = "px[0]", "py[0]"
            else:
                w_x, w_y = f"v[{op[1]}]", f"v[{op[2]}]"
            emit("uint256[12] memory pin;")
            emit(f"pin[0] = {w_x}; pin[1] = {w_y};")
            # EVM pairing expects G2 coords as (x_c1, x_c0, y_c1, y_c0)
            emit(f"pin[2] = {sx1}; pin[3] = {sx0}; "
                 f"pin[4] = {sy1}; pin[5] = {sy0};")
            emit("pin[6] = t0; pin[7] = t1;")
            emit(f"pin[8] = {x1}; pin[9] = {x0}; "
                 f"pin[10] = {y1}; pin[11] = {y0};")
            emit("uint256[1] memory pout;")
            emit("assembly { if iszero(staticcall(gas(), 0x08, pin, 0x180, "
                 "pout, 0x20)) { revert(0, 0) } }")
            emit("return pout[0] == 1;")
        else:
            raise AssertionError(tag)

    body = "\n".join("        " + ln for ln in lines)
    return (_HEADER.format(name=name, r=R, q=Q, num_instances=total_inst,
                           proof_len=proof_len, num_vals=len(ops))
            + body + "\n" + _FOOTER)


def gen_evm_verifier(params, vk, num_instance_rows: list,
                     sol_path: str | None = None,
                     name: str = "Halo2TpuVerifier") -> str:
    """Emit (and optionally write) the Solidity verifier; returns source."""
    src = emit_solidity(vk, num_instance_rows, name, params=params)
    if sol_path:
        with open(sol_path, "w") as f:
            f.write(src)
    return src

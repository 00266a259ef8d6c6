"""IR -> EVM bytecode compiler for the verifier contracts.

Counterpart of halo2_zkcert_tpu/evm/bytecode.py: the same bytes.

Reference behavior: snark-verifier's `EvmLoader` emits Yul that is compiled
to raw deployment bytecode handed to `evm_verify` (gen_evm_verifier_shplonk
/ cli.rs:512-524 [dep]).  This module plays the same role without solc: the
straight-line verification IR (evm/ir.py) is assembled directly into EVM
opcodes.  Calldata convention matches the reference loader: raw
`instances ++ proof` bytes (NOT abi-encoded — snark-verifier's generated
verifier reads calldata at fixed offsets the same way).

Memory map (runtime):
  0x000..0x3FF   precompile scratch (modexp/ecMul/ecAdd/pairing I/O)
  0x400..        one 32-byte slot per IR value id
  after slots    Fiat-Shamir keccak buffer (length tracked statically —
                 the IR is straight-line, so every absorb/squeeze offset
                 is a compile-time constant)

Control flow: a single revert block at PC 4; every validity check JUMPIs
into it.  Everything else is straight-line — no loops, no dispatcher (the
contract has exactly one entry point taking raw calldata).
"""
from __future__ import annotations

from ..utils import refcrypto as rc
from .ir import build_verifier_ir

R = rc.FR
Q = rc.FQ

# opcode table (only what the emitter uses)
OPS = dict(STOP=0x00, ADD=0x01, MUL=0x02, SUB=0x03, DIV=0x04, MOD=0x06,
           ADDMOD=0x08, MULMOD=0x09, LT=0x10, GT=0x11, EQ=0x14, ISZERO=0x15,
           AND=0x16, OR=0x17, XOR=0x18, NOT=0x19, SHL=0x1B, SHR=0x1C,
           KECCAK256=0x20, CALLDATALOAD=0x35, CALLDATASIZE=0x36,
           CALLDATACOPY=0x37, CODECOPY=0x39, POP=0x50, MLOAD=0x51,
           MSTORE=0x52, MSTORE8=0x53, JUMP=0x56, JUMPI=0x57, GAS=0x5A,
           JUMPDEST=0x5B, PUSH0=0x5F, DUP1=0x80, DUP2=0x81, SWAP1=0x90,
           SWAP2=0x91, RETURN=0xF3, STATICCALL=0xFA, REVERT=0xFD)

_REVERT_PC = 3          # PUSH1 main, JUMP == 3 bytes
_MAIN_PC = 7            # revert block: JUMPDEST PUSH0 PUSH0 REVERT == 4

# scratch offsets (see module docstring)
_MUL_IN = 0x000          # ecMul input: x, y, s           (0x60 bytes)
_PAIR_IN = 0x1A0         # pairing input                  (0x180 bytes)
_SLOT0 = 0x400


class _Asm:
    def __init__(self):
        self.code = bytearray()

    def op(self, name: str):
        self.code.append(OPS[name])
        return self

    def push(self, v: int):
        v = int(v)
        assert v >= 0
        if v == 0:
            self.code.append(OPS["PUSH0"])
            return self
        b = v.to_bytes((v.bit_length() + 7) // 8, "big")
        self.code.append(0x5F + len(b))
        self.code += b
        return self

    def raw(self, bs: bytes):
        self.code += bs
        return self


def assemble_runtime(ops: list, vk, num_instance_rows: list, params,
                     proof_len: int) -> bytes:
    """Assemble the IR into runtime bytecode."""
    col_off = []
    off = 0
    for rows in num_instance_rows:
        col_off.append(off)
        off += rows
    inst_bytes = 32 * off
    hashbuf = _SLOT0 + 32 * len(ops)

    a = _Asm()

    def slot(i: int) -> int:
        return _SLOT0 + 32 * i

    def mload(i: int):
        a.push(slot(i)).op("MLOAD")

    def mstore(i: int):
        a.push(slot(i)).op("MSTORE")

    def revert_if():
        """Consume a truthy-is-bad flag from the stack."""
        a.push(_REVERT_PC).op("JUMPI")

    def check_lt(const: int):
        """stack [v] -> [v], reverting unless v < const."""
        a.op("DUP1").push(const).op("SWAP1").op("LT").op("ISZERO")
        revert_if()

    def curve_check(xi: int, yi: int):
        """Revert unless (v[xi], v[yi]) is on y^2 = x^3 + 3 with coords < Q."""
        mload(xi)
        check_lt(Q)
        a.op("POP")
        mload(yi)
        check_lt(Q)
        a.op("POP")
        # rhs = addmod(mulmod(mulmod(x,x,Q),x,Q), 3, Q)
        a.push(Q).push(3).push(Q)
        mload(xi)
        a.push(Q)
        mload(xi)
        mload(xi)
        a.op("MULMOD").op("MULMOD").op("ADDMOD")
        # lhs = mulmod(y,y,Q)
        a.push(Q)
        mload(yi)
        mload(yi)
        a.op("MULMOD")
        a.op("EQ").op("ISZERO")
        revert_if()

    def staticcall(addr: int, arg_off: int, arg_sz: int, ret_off: int,
                   ret_sz: int):
        a.push(ret_sz).push(ret_off).push(arg_sz).push(arg_off)
        a.push(addr).op("GAS").op("STATICCALL")
        a.op("ISZERO")
        revert_if()

    def scratch_store(off2: int):
        """Pop a value into scratch memory at byte offset off2."""
        a.push(off2).op("MSTORE")

    def ec_mul_into(px_src, py_src, s_load, ret_off: int):
        """acc = s * P.  px_src/py_src: callables that push x/y; s_load:
        callable that pushes s.  Result at scratch ret_off (64 bytes)."""
        px_src(); scratch_store(_MUL_IN)
        py_src(); scratch_store(_MUL_IN + 0x20)
        s_load(); scratch_store(_MUL_IN + 0x40)
        staticcall(0x07, _MUL_IN, 0x60, ret_off, 0x40)

    def ec_add_sites(in_off: int, ret_off: int):
        """ecAdd over the 128-byte scratch window at in_off -> ret_off."""
        staticcall(0x06, in_off, 0x80, ret_off, 0x40)

    # ---- prologue: jump over the revert block, check calldata size --------
    a.push(_MAIN_PC).op("JUMP")
    assert len(a.code) == _REVERT_PC
    a.op("JUMPDEST").op("PUSH0").op("PUSH0").op("REVERT")
    assert len(a.code) == _MAIN_PC
    a.op("JUMPDEST")
    a.op("CALLDATASIZE").push(inst_bytes + proof_len).op("EQ").op("ISZERO")
    revert_if()

    # ---- straight-line op lowering ---------------------------------------
    buflen = 0
    for i, op in enumerate(ops):
        tag = op[0]
        if tag == "const":
            a.push(op[1] % R)
            mstore(i)
        elif tag == "instance":
            a.push(32 * (col_off[op[1]] + op[2])).op("CALLDATALOAD")
            a.push(R).op("SWAP1").op("MOD")
            mstore(i)
        elif tag == "proof_scalar":
            a.push(inst_bytes + op[1]).op("CALLDATALOAD")
            check_lt(R)
            mstore(i)
        elif tag == "proof_px":
            a.push(inst_bytes + op[1]).op("CALLDATALOAD")
            mstore(i)
        elif tag == "proof_py":
            poff = ops[i - 1][1]
            a.push(inst_bytes + poff + 32).op("CALLDATALOAD")
            mstore(i)
            curve_check(i - 1, i)
        elif tag == "addmod":
            a.push(R)
            mload(op[2]); mload(op[1])
            a.op("ADDMOD")
            mstore(i)
        elif tag == "submod":
            a.push(R)
            mload(op[2]); a.push(R).op("SUB")
            mload(op[1])
            a.op("ADDMOD")
            mstore(i)
        elif tag == "mulmod":
            a.push(R)
            mload(op[2]); mload(op[1])
            a.op("MULMOD")
            mstore(i)
        elif tag == "invmod":
            for j, v in enumerate((32, 32, 32)):
                a.push(v); scratch_store(0x20 * j)
            mload(op[1]); scratch_store(0x60)
            a.push(R - 2); scratch_store(0x80)
            a.push(R); scratch_store(0xA0)
            staticcall(0x05, 0x00, 0xC0, 0xC0, 0x20)
            a.push(0xC0).op("MLOAD")
            mstore(i)
        elif tag == "absorb_scalar":
            mload(op[1])
            a.push(hashbuf + buflen).op("MSTORE")
            buflen += 32
        elif tag == "absorb_point":
            mload(op[1])
            a.push(hashbuf + buflen).op("MSTORE")
            mload(op[2])
            a.push(hashbuf + buflen + 32).op("MSTORE")
            buflen += 64
        elif tag == "squeeze":
            a.push(0x01).push(hashbuf + buflen).op("MSTORE8")
            a.push(buflen + 1).push(hashbuf).op("KECCAK256")
            a.push(R).op("SWAP1").op("MOD")
            a.op("DUP1")
            mstore(i)
            a.push(hashbuf).op("MSTORE")
            buflen = 32
        elif tag == "ec_zero_x" or tag == "ec_zero_y":
            a.op("PUSH0")
            mstore(i)
        elif tag in ("ec_acc_x", "ec_acc_const_x"):
            assert ops[i + 1][0] == "ec_acc_y"
            if tag == "ec_acc_x":
                px = lambda: mload(op[3])
                py = lambda: mload(op[4])
            else:
                px = lambda: a.push(op[3])
                py = lambda: a.push(op[4])
            # mul result placed directly after acc for a contiguous ecAdd
            mload(op[1]); scratch_store(0xA0)
            mload(op[2]); scratch_store(0xC0)
            ec_mul_into(px, py, lambda: mload(op[5]), 0xE0)
            ec_add_sites(0xA0, 0xA0)
            a.push(0xA0).op("MLOAD")
            mstore(i)
            a.push(0xC0).op("MLOAD")
            mstore(i + 1)
        elif tag == "ec_acc_y":
            pass                               # filled by the _x lowering
        elif tag == "comb128":
            for src in (op[1], op[2]):
                mload(src)
                a.push(128).op("SHR")
                revert_if()
            mload(op[2]); a.push(128).op("SHL")
            mload(op[1]); a.op("ADD")
            mstore(i)
        elif tag in ("final", "final_acc"):
            _emit_final(a, op, mload, curve_check, ec_mul_into,
                        ec_add_sites, staticcall, params)
        else:
            raise AssertionError(tag)
    return bytes(a.code)


def _emit_final(a: _Asm, op, mload, curve_check, ec_mul_into, ec_add_sites,
                staticcall, params):
    """Pairing finale: e(w_total, [s]2) * e(-(u*W + z0inv*acc [+ rho*RHS]),
    [1]2) == 1, returned as a 32-byte bool."""
    tag = op[0]
    wx, wy, accx, accy, z0inv, u = op[1:7]

    def scratch_store(off2):
        a.push(off2).op("MSTORE")

    # lhs = z0inv*acc + u*W  (acc point lives in val slots accx/accy)
    ec_mul_into(lambda: mload(accx), lambda: mload(accy),
                lambda: mload(z0inv), 0xA0)
    ec_mul_into(lambda: mload(wx), lambda: mload(wy),
                lambda: mload(u), 0xE0)
    ec_add_sites(0xA0, 0xA0)                       # lhs at 0xA0/0xC0

    if tag == "final_acc":
        cx0, cy0, cx1, cy1 = op[7], op[8], op[9], op[10]
        rho = op[11]
        curve_check(cx0, cy0)
        curve_check(cx1, cy1)
        # lhs += rho * RHS*
        ec_mul_into(lambda: mload(cx1), lambda: mload(cy1),
                    lambda: mload(rho), 0xE0)
        ec_add_sites(0xA0, 0xA0)
        # w_total = W + rho * LHS*
        mload(wx); scratch_store(0x120)
        mload(wy); scratch_store(0x140)
        ec_mul_into(lambda: mload(cx0), lambda: mload(cy0),
                    lambda: mload(rho), 0x160)
        ec_add_sites(0x120, 0x120)                 # w_total at 0x120/0x140
    else:
        mload(wx); scratch_store(0x120)
        mload(wy); scratch_store(0x140)

    # negate lhs.y:  y = (Q - y) % Q
    a.push(0xC0).op("MLOAD").push(Q).op("SUB")
    a.push(Q).op("SWAP1").op("MOD")
    scratch_store(0xC0)

    # pairing input: (w_total, [s]2), (lhs_neg, [1]2)
    (sx0, sx1), (sy0, sy1) = params.s_g2
    (x0, x1), (y0, y1) = params.g2
    a.push(0x120).op("MLOAD"); scratch_store(_PAIR_IN + 0x00)
    a.push(0x140).op("MLOAD"); scratch_store(_PAIR_IN + 0x20)
    for j, v in enumerate((sx1, sx0, sy1, sy0)):
        a.push(v); scratch_store(_PAIR_IN + 0x40 + 0x20 * j)
    a.push(0xA0).op("MLOAD"); scratch_store(_PAIR_IN + 0xC0)
    a.push(0xC0).op("MLOAD"); scratch_store(_PAIR_IN + 0xE0)
    for j, v in enumerate((x1, x0, y1, y0)):
        a.push(v); scratch_store(_PAIR_IN + 0x100 + 0x20 * j)
    staticcall(0x08, _PAIR_IN, 0x180, 0x00, 0x20)
    a.push(0x20).op("PUSH0").op("RETURN")


def deployment_code(runtime: bytes) -> bytes:
    """Standard constructor: copy the runtime to memory and return it."""
    n = len(runtime)
    ctor = _Asm()
    # CODECOPY(dest=0, offset=ctor_len, len=n); RETURN(0, n)
    # fixed-width pushes so ctor length is static (16 bytes)
    ctor.raw(bytes([0x62]) + n.to_bytes(3, "big"))          # PUSH3 n
    ctor.raw(bytes([0x62]) + (16).to_bytes(3, "big"))       # PUSH3 ofs
    ctor.op("PUSH0").op("CODECOPY")
    ctor.raw(bytes([0x62]) + n.to_bytes(3, "big"))          # PUSH3 n
    ctor.op("PUSH0").op("RETURN")
    assert len(ctor.code) == 16
    return bytes(ctor.code) + runtime


def encode_calldata(instances: list, proof: bytes) -> bytes:
    """Raw `instances ++ proof` calldata (snark-verifier loader layout)."""
    blob = b"".join(int(v % R).to_bytes(32, "big")
                    for col in instances for v in col)
    return blob + proof


def gen_evm_verifier_bytecode(params, vk, num_instance_rows: list) -> dict:
    """-> {runtime, deploy, proof_len, num_ops}.  `deploy` is the creation
    bytecode (reference `gen_evm_verifier_shplonk` return value)."""
    ops, proof_len = build_verifier_ir(vk, num_instance_rows)
    runtime = assemble_runtime(ops, vk, num_instance_rows, params, proof_len)
    return dict(runtime=runtime, deploy=deployment_code(runtime),
                proof_len=proof_len, num_ops=len(ops))


def evm_verify_bytecode(params, vk, instances: list, proof: bytes):
    """Deploy + call in the in-process EVM (reference `evm_verify`).

    -> (accepted: bool, gas_used: int)."""
    from .interp import Evm
    art = gen_evm_verifier_bytecode(params, vk,
                                    [len(c) for c in instances])
    evm = Evm()
    res = evm.deploy(art["deploy"])
    if not (res.success and res.output == art["runtime"]):
        raise RuntimeError("evm_verify: the verifier's deployment failed")
    call = evm.call(encode_calldata(instances, proof))
    accepted = (call.success and len(call.output) == 32
                and int.from_bytes(call.output, "big") == 1)
    return accepted, call.gas_used

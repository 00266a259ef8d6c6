"""In-process EVM interpreter: the reference's `revm` role.

Counterpart of halo2_zkcert_tpu/evm/interp.py, the same machine and the
same gas.  `evm_verify` deploys the generated verifier bytecode into an
in-process EVM and calls it with `instances ++ proof` calldata, failing on
revert (reference cli.rs:524, snark-verifier-sdk [dep]).  It implements the
stack and memory machine for the opcodes the emitter produces, the four
BN254 precompiles (modexp 0x05, ecAdd 0x06, ecMul 0x07, pairing 0x08) over
utils/refcrypto.py, and KECCAK256 through the host library (native.py;
`refcrypto.keccak256` is its plain version).  Host code on Python ints.

Gas follows the Istanbul / EIP-2565 prices for the precompiles, Keccak and
memory expansion, and the standard base costs for the cheap opcodes.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import native
from ..utils import refcrypto as rc

U256 = 1 << 256
U255 = 1 << 255


class EvmRevert(Exception):
    def __init__(self, data: bytes = b""):
        self.data = data
        super().__init__(f"revert ({len(data)} bytes)")


class EvmError(Exception):
    """Invalid operation / stack underflow / bad jump — consumes all gas."""


# ---------------------------------------------------------------------------
# BN254 precompiles
# ---------------------------------------------------------------------------

def _read_word(data: bytes, off: int) -> int:
    chunk = data[off:off + 32]
    return int.from_bytes(chunk + b"\x00" * (32 - len(chunk)), "big")


def _g1_load(data: bytes, off: int):
    x, y = _read_word(data, off), _read_word(data, off + 32)
    if x >= rc.FQ or y >= rc.FQ:
        raise EvmError("ec point coord out of range")
    if x == 0 and y == 0:
        return None                       # point at infinity
    if not rc.g1_is_on_curve_affine((x, y)):
        raise EvmError("ec point not on curve")
    return (x, y)


def _g1_store(p) -> bytes:
    if p is None or rc.g1_is_identity(p):
        return b"\x00" * 64
    x, y = rc.g1_to_affine(p)
    return x.to_bytes(32, "big") + y.to_bytes(32, "big")


# twist curve: y^2 = x^3 + 3/(9+u)
_B2 = None


def _twist_b():
    global _B2
    if _B2 is None:
        _B2 = rc.f2_mul((3, 0), rc.f2_inv((9, 1)))
    return _B2


def _g2_load(data: bytes, off: int):
    # EVM layout per G2 point: (x_c1, x_c0, y_c1, y_c0)
    x1, x0 = _read_word(data, off), _read_word(data, off + 32)
    y1, y0 = _read_word(data, off + 64), _read_word(data, off + 96)
    for v in (x0, x1, y0, y1):
        if v >= rc.FQ:
            raise EvmError("g2 coord out of range")
    if x0 == x1 == y0 == y1 == 0:
        return None
    x, y = (x0, x1), (y0, y1)
    lhs = rc.f2_sqr(y)
    rhs = rc.f2_add(rc.f2_mul(rc.f2_sqr(x), x), _twist_b())
    if lhs != rhs:
        raise EvmError("g2 point not on twist")
    return (x, y)


def _precompile(addr: int, data: bytes):
    """-> (output_bytes, gas). Raises EvmError on invalid input."""
    if addr == 0x05:                      # modexp (EIP-198 / EIP-2565 gas)
        blen, elen, mlen = (_read_word(data, 0), _read_word(data, 32),
                            _read_word(data, 64))
        if max(blen, elen, mlen) > 4096:
            raise EvmError("modexp length")
        body = data[96:]
        b = int.from_bytes(body[:blen].ljust(blen, b"\x00"), "big")
        e = int.from_bytes(body[blen:blen + elen].ljust(elen, b"\x00"), "big")
        m = int.from_bytes(body[blen + elen:blen + elen + mlen]
                           .ljust(mlen, b"\x00"), "big")
        out = pow(b, e, m) if m else 0
        words = (max(blen, mlen) + 7) // 8
        adj = max(e.bit_length() - 1, 0) if elen <= 32 else \
            8 * (elen - 32) + max(e.bit_length() - 1, 0)
        gas = max(200, words * words * max(adj, 1) // 3)
        return out.to_bytes(mlen, "big"), gas
    if addr == 0x06:                      # ecAdd
        a, b = _g1_load(data, 0), _g1_load(data, 64)
        if a is None:
            return _g1_store(b and rc.g1_from_affine(b)), 150
        if b is None:
            return _g1_store(rc.g1_from_affine(a)), 150
        s = rc.g1_add(rc.g1_from_affine(a), rc.g1_from_affine(b))
        return _g1_store(s), 150
    if addr == 0x07:                      # ecMul
        p = _g1_load(data, 0)
        s = _read_word(data, 64)
        if p is None or s % rc.FR == 0:
            # NB: the precompile does NOT reduce s mod r; identity only for
            # s == 0 — but s*P for s ≡ 0 (mod r) is the identity anyway
            return b"\x00" * 64, 6000
        return _g1_store(rc.g1_mul(rc.g1_from_affine(p), s)), 6000
    if addr == 0x08:                      # pairing
        if len(data) % 192 != 0:
            raise EvmError("pairing input size")
        k = len(data) // 192
        pairs = []
        for i in range(k):
            g1 = _g1_load(data, 192 * i)
            g2 = _g2_load(data, 192 * i + 64)
            if g1 is None or g2 is None:
                continue                  # identity factors contribute 1
            pairs.append((g1, g2))
        ok = rc.pairing_check(pairs) if pairs else True
        return (int(ok).to_bytes(32, "big"), 45000 + 34000 * k)
    raise EvmError(f"unknown precompile {addr:#x}")


# ---------------------------------------------------------------------------
# the machine
# ---------------------------------------------------------------------------

@dataclass
class ExecResult:
    success: bool
    output: bytes
    gas_used: int


class Evm:
    """Single-contract EVM: deploy() runs constructor code, call() executes
    the stored runtime code with calldata (view-only — no storage opcodes
    are implemented because verifier contracts are pure)."""

    def __init__(self):
        self.runtime: bytes | None = None

    def deploy(self, creation_code: bytes) -> ExecResult:
        res = self._execute(creation_code, b"")
        if res.success:
            self.runtime = res.output
        return res

    def call(self, calldata: bytes) -> ExecResult:
        assert self.runtime is not None, "deploy first"
        return self._execute(self.runtime, calldata)

    # -- core loop ---------------------------------------------------------
    def _execute(self, code: bytes, calldata: bytes) -> ExecResult:
        stack: list[int] = []
        mem = bytearray()
        gas = [0]
        jumpdests = _jumpdests(code)

        def charge(n):
            gas[0] += n

        def mem_expand(off, size):
            if size == 0:
                return
            end = off + size
            if end > len(mem):
                new_words = (end + 31) // 32
                old_words = (len(mem) + 31) // 32
                # quadratic memory expansion cost
                cost = lambda w: 3 * w + w * w // 512
                charge(cost(new_words) - cost(old_words))
                mem.extend(b"\x00" * (new_words * 32 - len(mem)))

        def pop():
            if not stack:
                raise EvmError("stack underflow")
            return stack.pop()

        def push(v):
            if len(stack) >= 1024:
                raise EvmError("stack overflow")
            stack.append(v & (U256 - 1))

        pc = 0
        try:
            while pc < len(code):
                op = code[pc]
                pc += 1
                if 0x60 <= op <= 0x7F:            # PUSH1..PUSH32
                    n = op - 0x5F
                    push(int.from_bytes(code[pc:pc + n], "big"))
                    pc += n
                    charge(3)
                elif op == 0x5F:                  # PUSH0
                    push(0); charge(2)
                elif 0x80 <= op <= 0x8F:          # DUP1..DUP16
                    n = op - 0x7F
                    if len(stack) < n:
                        raise EvmError("stack underflow")
                    push(stack[-n]); charge(3)
                elif 0x90 <= op <= 0x9F:          # SWAP1..SWAP16
                    n = op - 0x8F
                    if len(stack) < n + 1:
                        raise EvmError("stack underflow")
                    stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
                    charge(3)
                elif op == 0x00:                  # STOP
                    return ExecResult(True, b"", gas[0])
                elif op == 0x01:                  # ADD
                    push(pop() + pop()); charge(3)
                elif op == 0x02:                  # MUL
                    push(pop() * pop()); charge(5)
                elif op == 0x03:                  # SUB
                    a = pop(); push(a - pop()); charge(3)
                elif op == 0x04:                  # DIV
                    a, b = pop(), pop()
                    push(a // b if b else 0); charge(5)
                elif op == 0x06:                  # MOD
                    a, b = pop(), pop()
                    push(a % b if b else 0); charge(5)
                elif op == 0x08:                  # ADDMOD
                    a, b, n = pop(), pop(), pop()
                    push((a + b) % n if n else 0); charge(8)
                elif op == 0x09:                  # MULMOD
                    a, b, n = pop(), pop(), pop()
                    push(a * b % n if n else 0); charge(8)
                elif op == 0x10:                  # LT
                    push(int(pop() < pop())); charge(3)
                elif op == 0x11:                  # GT
                    push(int(pop() > pop())); charge(3)
                elif op == 0x14:                  # EQ
                    push(int(pop() == pop())); charge(3)
                elif op == 0x15:                  # ISZERO
                    push(int(pop() == 0)); charge(3)
                elif op == 0x16:                  # AND
                    push(pop() & pop()); charge(3)
                elif op == 0x17:                  # OR
                    push(pop() | pop()); charge(3)
                elif op == 0x18:                  # XOR
                    push(pop() ^ pop()); charge(3)
                elif op == 0x19:                  # NOT
                    push(~pop()); charge(3)
                elif op == 0x1B:                  # SHL
                    s, v = pop(), pop()
                    push(v << s if s < 256 else 0); charge(3)
                elif op == 0x1C:                  # SHR
                    s, v = pop(), pop()
                    push(v >> s if s < 256 else 0); charge(3)
                elif op == 0x20:                  # KECCAK256
                    off, size = pop(), pop()
                    mem_expand(off, size)
                    push(int.from_bytes(
                        native.keccak256(bytes(mem[off:off + size])), "big"))
                    charge(30 + 6 * ((size + 31) // 32))
                elif op == 0x35:                  # CALLDATALOAD
                    off = pop()
                    chunk = calldata[off:off + 32]
                    push(int.from_bytes(chunk + b"\x00" * (32 - len(chunk)),
                                        "big"))
                    charge(3)
                elif op == 0x36:                  # CALLDATASIZE
                    push(len(calldata)); charge(2)
                elif op == 0x37:                  # CALLDATACOPY
                    dst, src, size = pop(), pop(), pop()
                    mem_expand(dst, size)
                    chunk = calldata[src:src + size]
                    mem[dst:dst + size] = chunk.ljust(size, b"\x00")
                    charge(3 + 3 * ((size + 31) // 32))
                elif op == 0x38:                  # CODESIZE
                    push(len(code)); charge(2)
                elif op == 0x39:                  # CODECOPY
                    dst, src, size = pop(), pop(), pop()
                    mem_expand(dst, size)
                    chunk = code[src:src + size]
                    mem[dst:dst + size] = chunk.ljust(size, b"\x00")
                    charge(3 + 3 * ((size + 31) // 32))
                elif op == 0x50:                  # POP
                    pop(); charge(2)
                elif op == 0x51:                  # MLOAD
                    off = pop()
                    mem_expand(off, 32)
                    push(int.from_bytes(mem[off:off + 32], "big")); charge(3)
                elif op == 0x52:                  # MSTORE
                    off, v = pop(), pop()
                    mem_expand(off, 32)
                    mem[off:off + 32] = v.to_bytes(32, "big"); charge(3)
                elif op == 0x53:                  # MSTORE8
                    off, v = pop(), pop()
                    mem_expand(off, 1)
                    mem[off] = v & 0xFF; charge(3)
                elif op == 0x56:                  # JUMP
                    pc = pop()
                    if pc not in jumpdests:
                        raise EvmError("bad jump")
                    charge(8)
                elif op == 0x57:                  # JUMPI
                    dst, cond = pop(), pop()
                    if cond:
                        if dst not in jumpdests:
                            raise EvmError("bad jump")
                        pc = dst
                    charge(10)
                elif op == 0x58:                  # PC
                    push(pc - 1); charge(2)
                elif op == 0x5A:                  # GAS (approximate)
                    push(10**9); charge(2)
                elif op == 0x5B:                  # JUMPDEST
                    charge(1)
                elif op == 0xFA:                  # STATICCALL
                    (g, addr, aoff, asz, roff, rsz) = (
                        pop(), pop(), pop(), pop(), pop(), pop())
                    mem_expand(aoff, asz)
                    mem_expand(roff, rsz)
                    charge(100)
                    try:
                        out, pgas = _precompile(addr,
                                                bytes(mem[aoff:aoff + asz]))
                        charge(pgas)
                        mem[roff:roff + rsz] = out[:rsz].ljust(rsz, b"\x00")
                        push(1)
                    except EvmError:
                        push(0)
                elif op == 0xF3:                  # RETURN
                    off, size = pop(), pop()
                    mem_expand(off, size)
                    return ExecResult(True, bytes(mem[off:off + size]), gas[0])
                elif op == 0xFD:                  # REVERT
                    off, size = pop(), pop()
                    mem_expand(off, size)
                    return ExecResult(False, bytes(mem[off:off + size]),
                                      gas[0])
                else:
                    raise EvmError(f"invalid opcode {op:#x} at {pc - 1}")
            return ExecResult(True, b"", gas[0])
        except EvmError:
            return ExecResult(False, b"", gas[0])


def _jumpdests(code: bytes) -> set:
    """Valid JUMPDEST positions (skipping PUSH immediates)."""
    dests = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            dests.add(i)
        i += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return dests

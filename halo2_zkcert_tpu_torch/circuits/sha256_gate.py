"""Gate-level SHA-256 over the vertical-gate builder (the "unoptimized"
flavor).  Counterpart of halo2_zkcert_tpu/circuits/sha256_gate.py.

Capability parity with `halo2-sha256-unoptimized` (reference
Cargo.lock:1254 [dep], used by `create_default_unoptimized_sha256_circuit_
with_instances`, helpers.rs:174-199): SHA-256 computed entirely as
GateBuilder rows — bit decompositions, boolean xor/ch/maj algebra, mod-2^32
additions — with the digest exposed as 32 byte instances.

This is deliberately the slow/generic path (the reference runs it at k=19;
its purpose is exercising the generic gate stack rather than a bespoke
arithmetization).  The production path is the bit-plane circuit
(circuits/sha256.py).  Instance convention here matches the reference's
unoptimized flavor: 32 digest BYTES big-endian (helpers.rs:195-197), which
is also what the RSA circuit exposes — so elementwise digest linking works,
unlike the zkevm [lo, hi] u128 pair.
"""
from __future__ import annotations

from ..builder import Cell, GateBuilder
from .sha256 import H_INIT, K_CONST, _pad_message

M32 = (1 << 32) - 1


class _Word:
    """A 32-bit word: value cell + bit cells (LSB first)."""

    __slots__ = ("cell", "bits")

    def __init__(self, cell: Cell, bits: list):
        self.cell = cell
        self.bits = bits


def _decompose(gb: GateBuilder, cell: Cell, nbits: int) -> list:
    """Constrain cell = sum 2^i b_i with boolean b_i; returns bit cells."""
    v = cell.value
    bits = []
    for i in range(nbits):
        b = gb.witness((v >> i) & 1)
        gb.assert_bit(b)
        bits.append(b)
    acc = bits[-1]
    for i in range(nbits - 2, -1, -1):
        acc = gb.mul_add(acc, gb.constant(2), bits[i])
    gb.assert_equal(acc, cell)
    return bits


def _recompose(gb: GateBuilder, bits: list) -> Cell:
    acc = bits[-1]
    for i in range(len(bits) - 2, -1, -1):
        acc = gb.mul_add(acc, gb.constant(2), bits[i])
    return acc


def _word_from_cell(gb: GateBuilder, cell: Cell) -> _Word:
    return _Word(cell, _decompose(gb, cell, 32))


def _word_const(gb: GateBuilder, v: int) -> _Word:
    return _Word(gb.constant(v & M32),
                 [gb.constant((v >> i) & 1) for i in range(32)])


def _mod32_add(gb: GateBuilder, cells: list) -> _Word:
    """sum(cells) mod 2^32 -> fresh word (carry bits constrained)."""
    acc = cells[0]
    for c in cells[1:]:
        acc = gb.add(acc, c)
    total = acc.value
    nbits = 32 + max(1, (len(cells) - 1).bit_length())
    bits = _decompose(gb, acc, nbits)
    word_bits = bits[:32]
    cell = _recompose(gb, word_bits)
    assert cell.value == total & M32
    return _Word(cell, word_bits)


class Sha256GateChip:
    """SHA-256 rounds as builder ops (reference `Sha256Chip` [dep])."""

    def __init__(self, gb: GateBuilder):
        self.gb = gb

    # -- bitwise helpers ------------------------------------------------------

    def _xor2(self, xa: list, xb: list) -> list:
        gb = self.gb
        out = []
        for a, b in zip(xa, xb):
            ab = gb.mul(a, b)
            s = gb.add(a, b)
            out.append(gb.mul_add(ab, gb.constant(-2), s))
        return out

    def _xor3(self, xa, xb, xc):
        return self._xor2(self._xor2(xa, xb), xc)

    def _ch(self, e, f, g):
        gb = self.gb
        out = []
        for eb, fb, gbit in zip(e, f, g):
            ef = gb.mul(eb, fb)
            eg = gb.mul(eb, gbit)
            out.append(gb.add(gbit, gb.mul_add(eg, gb.constant(-1), ef)))
        return out

    def _maj(self, a, b, c):
        gb = self.gb
        out = []
        for ab_, bb, cb in zip(a, b, c):
            ab = gb.mul(ab_, bb)
            bc = gb.mul(bb, cb)
            ac = gb.mul(ab_, cb)
            t = gb.add(gb.add(ab, bc), ac)
            # maj = ab + bc + ac - 2abc
            out.append(gb.mul_add(gb.mul(ab, cb), gb.constant(-2), t))
        return out

    @staticmethod
    def _rotr(bits: list, s: int) -> list:
        return [bits[(i + s) % 32] for i in range(32)]

    @staticmethod
    def _shr(bits: list, s: int, gb) -> list:
        zero = gb.constant(0)
        return [bits[i + s] if i + s < 32 else zero for i in range(32)]

    # -- compression ----------------------------------------------------------

    def digest(self, msg: bytes) -> list:
        """Run SHA-256 over msg; returns 32 byte cells (big-endian)."""
        gb = self.gb
        padded = _pad_message(msg)
        H = [_word_const(gb, h) for h in H_INIT]
        # message words are witnessed and byte-pinned by the caller via
        # the returned input byte cells; here we witness and decompose
        msg_byte_cells = []
        for blk in range(len(padded) // 64):
            chunk = padded[64 * blk:64 * blk + 64]
            w = []
            for i in range(16):
                word_val = int.from_bytes(chunk[4 * i:4 * i + 4], "big")
                cell = gb.witness(word_val)
                wd = _word_from_cell(gb, cell)
                w.append(wd)
                # expose byte cells (b3..b0 big-endian) for linking/pinning
                for bidx in range(4):
                    byte_bits = wd.bits[24 - 8 * bidx:32 - 8 * bidx]
                    msg_byte_cells.append(_recompose(gb, byte_bits))
            for r in range(16, 64):
                s0b = self._xor3(self._rotr(w[r - 15].bits, 7),
                                 self._rotr(w[r - 15].bits, 18),
                                 self._shr(w[r - 15].bits, 3, gb))
                s1b = self._xor3(self._rotr(w[r - 2].bits, 17),
                                 self._rotr(w[r - 2].bits, 19),
                                 self._shr(w[r - 2].bits, 10, gb))
                wd = _mod32_add(gb, [w[r - 16].cell, _recompose(gb, s0b),
                                     w[r - 7].cell, _recompose(gb, s1b)])
                w.append(wd)
            a, b, c, d, e, f, g, h = H
            for r in range(64):
                S1 = _recompose(gb, self._xor3(self._rotr(e.bits, 6),
                                               self._rotr(e.bits, 11),
                                               self._rotr(e.bits, 25)))
                ch = _recompose(gb, self._ch(e.bits, f.bits, g.bits))
                t1 = [h.cell, S1, ch, gb.constant(K_CONST[r]), w[r].cell]
                S0 = _recompose(gb, self._xor3(self._rotr(a.bits, 2),
                                               self._rotr(a.bits, 13),
                                               self._rotr(a.bits, 22)))
                mj = _recompose(gb, self._maj(a.bits, b.bits, c.bits))
                e_new = _mod32_add(gb, [d.cell] + t1)
                a_new = _mod32_add(gb, t1 + [S0, mj])
                h, g, f, e = g, f, e, e_new
                d, c, b, a = c, b, a, a_new
            H = [_mod32_add(gb, [x.cell, y.cell])
                 for x, y in zip(H, [a, b, c, d, e, f, g, h])]
        digest_bytes = []
        for wd in H:
            for bidx in range(4):
                byte_bits = wd.bits[24 - 8 * bidx:32 - 8 * bidx]
                digest_bytes.append(_recompose(gb, byte_bits))
        self.msg_byte_cells = msg_byte_cells
        return digest_bytes


class Sha256GateCircuit:
    """Standalone unoptimized-SHA256 circuit: digest bytes as instances."""

    def __init__(self, msg: bytes, k: int = 19, device="cuda"):
        gb = GateBuilder()
        chip = Sha256GateChip(gb)
        out = chip.digest(msg)
        # pin the message bytes as constants (standalone use; composition
        # links chip.msg_byte_cells instead)
        padded = _pad_message(msg)
        for i, cell in enumerate(chip.msg_byte_cells):
            gb.assert_const(cell, padded[i])
        for cell in out:
            gb.expose_public(cell)
        params = gb.calculate_params(k)
        self.gb = gb
        data, advice, instances = gb.finalize(k, params, device)
        self.data, self.advice, self.instances = data, advice, instances

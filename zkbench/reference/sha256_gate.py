"""The gate-level SHA-256 circuit as a layout: one vertical gate
q (v[i] + v[i+1] v[i+2] - v[i+3]) over a trace of cells packed into columns,
bits decomposed and recomposed, copies linking reused cells, constants
pinned by copy against one fixed column, the message's bytes pinned as
constants and the digest's 32 bytes exposed as instances.

A frozen copy of the recording the program proves, kept to the cells'
places: values are carried only as far as the layout depends on them
(which constants exist).
"""
from __future__ import annotations

import hashlib
from array import array
from typing import NamedTuple

import numpy as np

from .bn254 import FR
from .keys import PlonkReference
from .plonk import ADVICE, FIXED, INSTANCE, Advice, Column, ConstraintSystem

M32 = (1 << 32) - 1
K_CONST = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
H_INIT = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def pad(msg: bytes) -> bytes:
    n = len(msg)
    return msg + b"\x80" + b"\x00" * ((55 - n) % 64) + (8 * n).to_bytes(8, "big")


def statement(msg: bytes) -> list:
    return [list(hashlib.sha256(msg).digest())]


def reference(config: dict, inputs: dict, artifacts: dict,
              tau: int) -> PlonkReference:
    """The circuit that pins the message; every job proves its digest.  It
    rests on no artifact."""
    msg = inputs["message"]
    cs, fixed, copies, ninst = layout(msg, config["k"])
    stmt = statement(msg)
    return PlonkReference(config["k"], cs, fixed, copies, ninst,
                          lambda job: stmt, tau)


class Cell(NamedTuple):
    index: int
    value: int


class Recorder:
    def __init__(self):
        self.count = 0
        self.gate_rows = array("q")
        self.copy_a = array("q")
        self.copy_b = array("q")
        self.constants: dict = {}
        self.const_cells: list = []
        self.instance_cells: list = []
        self.instance_values: list = []

    def witness(self, v):
        self.count += 1
        return Cell(self.count - 1, v % FR)

    def constant(self, c):
        c %= FR
        i = self.constants.get(c)
        if i is None:
            i = self.witness(c).index
            self.constants[c] = i
            self.const_cells.append((i, c))
        return Cell(i, c)

    def _gate(self, a, b, c, out):
        base = self.count
        self.count += 4
        self.copy_a.extend((a.index, b.index, c.index))
        self.copy_b.extend((base, base + 1, base + 2))
        self.gate_rows.append(base)
        return Cell(base + 3, out % FR)

    def add(self, a, b):
        return self._gate(a, b, self.constant(1), a.value + b.value)

    def mul(self, a, b):
        return self._gate(self.constant(0), a, b, a.value * b.value)

    def mul_add(self, a, b, c):
        return self._gate(c, a, b, c.value + a.value * b.value)

    def assert_equal(self, a, b):
        self.copy_a.append(a.index)
        self.copy_b.append(b.index)

    def assert_bit(self, a):
        self.assert_equal(self.mul(a, a), a)


def _decompose(gb, cell, nbits):
    bits = []
    for i in range(nbits):
        b = gb.witness((cell.value >> i) & 1)
        gb.assert_bit(b)
        bits.append(b)
    gb.assert_equal(_recompose(gb, bits), cell)
    return bits


def _recompose(gb, bits):
    acc = bits[-1]
    for i in range(len(bits) - 2, -1, -1):
        acc = gb.mul_add(acc, gb.constant(2), bits[i])
    return acc


def _mod32_add(gb, cells):
    acc = cells[0]
    for c in cells[1:]:
        acc = gb.add(acc, c)
    bits = _decompose(gb, acc, 32 + max(1, (len(cells) - 1).bit_length()))
    return (_recompose(gb, bits[:32]), bits[:32])


def _xor2(gb, xa, xb):
    out = []
    for a, b in zip(xa, xb):
        ab = gb.mul(a, b)
        s = gb.add(a, b)
        out.append(gb.mul_add(ab, gb.constant(-2), s))
    return out


def _xor3(gb, xa, xb, xc):
    return _xor2(gb, _xor2(gb, xa, xb), xc)


def _ch(gb, e, f, g):
    out = []
    for eb, fb, gbit in zip(e, f, g):
        ef = gb.mul(eb, fb)
        eg = gb.mul(eb, gbit)
        out.append(gb.add(gbit, gb.mul_add(eg, gb.constant(-1), ef)))
    return out


def _maj(gb, a, b, c):
    out = []
    for x, y, z in zip(a, b, c):
        xy, yz, xz = gb.mul(x, y), gb.mul(y, z), gb.mul(x, z)
        t = gb.add(gb.add(xy, yz), xz)
        out.append(gb.mul_add(gb.mul(xy, z), gb.constant(-2), t))
    return out


def _rotr(bits, s):
    return [bits[(i + s) % 32] for i in range(32)]


def _shr(gb, bits, s):
    zero = gb.constant(0)
    return [bits[i + s] if i + s < 32 else zero for i in range(32)]


def record(msg: bytes) -> Recorder:
    gb = Recorder()
    padded = pad(msg)
    H = [(gb.constant(h & M32), [gb.constant((h >> i) & 1) for i in range(32)])
         for h in H_INIT]
    msg_bytes = []
    for blk in range(len(padded) // 64):
        chunk = padded[64 * blk:64 * blk + 64]
        w = []
        for i in range(16):
            cell = gb.witness(int.from_bytes(chunk[4 * i:4 * i + 4], "big"))
            bits = _decompose(gb, cell, 32)
            w.append((cell, bits))
            for b in range(4):
                msg_bytes.append(_recompose(gb, bits[24 - 8 * b:32 - 8 * b]))
        for r in range(16, 64):
            b15, b2 = w[r - 15][1], w[r - 2][1]
            s0 = _xor3(gb, _rotr(b15, 7), _rotr(b15, 18), _shr(gb, b15, 3))
            s1 = _xor3(gb, _rotr(b2, 17), _rotr(b2, 19), _shr(gb, b2, 10))
            w.append(_mod32_add(gb, [w[r - 16][0], _recompose(gb, s0),
                                     w[r - 7][0], _recompose(gb, s1)]))
        a, b, c, d, e, f, g, h = H
        for r in range(64):
            S1 = _recompose(gb, _xor3(gb, _rotr(e[1], 6), _rotr(e[1], 11),
                                      _rotr(e[1], 25)))
            ch = _recompose(gb, _ch(gb, e[1], f[1], g[1]))
            t1 = [h[0], S1, ch, gb.constant(K_CONST[r]), w[r][0]]
            S0 = _recompose(gb, _xor3(gb, _rotr(a[1], 2), _rotr(a[1], 13),
                                      _rotr(a[1], 22)))
            mj = _recompose(gb, _maj(gb, a[1], b[1], c[1]))
            e_new = _mod32_add(gb, [d[0]] + t1)
            a_new = _mod32_add(gb, t1 + [S0, mj])
            h, g, f, e = g, f, e, e_new
            d, c, b, a = c, b, a, a_new
        H = [_mod32_add(gb, [x[0], y[0]])
             for x, y in zip(H, [a, b, c, d, e, f, g, h])]
    digest = []
    for _, bits in H:
        for b in range(4):
            digest.append(_recompose(gb, bits[24 - 8 * b:32 - 8 * b]))
    for i, cell in enumerate(msg_bytes):
        gb.assert_equal(cell, gb.constant(padded[i]))
    for cell in digest:
        gb.instance_cells.append(cell.index)
        gb.instance_values.append(cell.value)
    return gb


def layout(msg: bytes, k: int):
    """(cs, fixed {column: (rows, values)}, copies (m, 2, 3),
    [instances]); raises if the recorded digest is not SHA-256's."""
    gb = record(msg)
    if gb.instance_values != statement(msg)[0]:
        raise ValueError("the recorded circuit's digest is not SHA-256's")
    n = 1 << k
    usable_guess = n - 10 - 10
    na = max(1, -(-gb.count // usable_guess))
    cs = ConstraintSystem()
    adv = [cs.advice_column(phase=0) for _ in range(na)]
    inst = cs.instance_column()
    sels = [cs.fixed_column() for _ in range(na)]
    f_const = cs.fixed_column()
    for j, col in enumerate(adv):
        A = [Advice(col.index, r, phase=0) for r in range(4)]
        cs.create_gate(f"vgate{col.index}", sels[j] * (A[0] + A[1] * A[2]
                                                       - A[3]))
    for col in adv:
        cs.enable_permutation(Column(ADVICE, col.index))
    cs.enable_permutation(Column(FIXED, f_const.index))
    cs.enable_permutation(Column(INSTANCE, inst.index))

    usable = cs.usable_rows(n)
    gates = np.frombuffer(gb.gate_rows, dtype=np.int64)
    starts, s = [], 0
    while s < gb.count:
        starts.append(s)
        if len(starts) > na:
            raise ValueError("the trace needs more columns")
        nxt = s + usable
        g = np.searchsorted(gates, nxt - 3)
        if g < gates.size and gates[g] < nxt:
            nxt = int(gates[g])
        s = nxt
    starts = np.asarray(starts, dtype=np.int64)
    idx = np.arange(gb.count, dtype=np.int64)
    col = np.searchsorted(starts, idx, side="right") - 1
    row = idx - starts[col]
    if len(gb.const_cells) > usable:
        raise ValueError("too many distinct constants")

    fixed = {}
    gcol, grow = col[gates], row[gates]
    for j, sel in enumerate(sels):
        fixed[sel.index] = (grow[gcol == j], None)
    fixed[f_const.index] = (np.arange(len(gb.const_cells)),
                            [v for _, v in gb.const_cells])

    adv_index = np.array([c.index for c in adv], dtype=np.int64)

    def cells(kind, column, r):
        return np.stack([np.full(r.size, kind), column, r], axis=-1)

    def placed(i):
        return cells(0, adv_index[col[i]], row[i])

    ca = np.frombuffer(gb.copy_a, dtype=np.int64)
    cb = np.frombuffer(gb.copy_b, dtype=np.int64)
    c_idx = np.array([i for i, _ in gb.const_cells], dtype=np.int64)
    i_idx = np.array(gb.instance_cells, dtype=np.int64)
    pairs = [(placed(ca), placed(cb)),
             (placed(c_idx), cells(1, np.full(c_idx.size, f_const.index),
                                   np.arange(c_idx.size))),
             (placed(i_idx), cells(2, np.full(i_idx.size, inst.index),
                                   np.arange(i_idx.size)))]
    copies = np.concatenate([np.stack(p, axis=1) for p in pairs], axis=0)
    return cs, fixed, copies, [len(gb.instance_cells)]

"""The bit-plane SHA-256 circuit as a layout: 32 bit columns and three carry
columns, rounds in [W, E, A] row triplets (the first four triplets of a
block hold its incoming state), gates over word values recomposed from
bits at fixed rotations, padding words pinned as constants, the one
message/padding boundary word pinned byte by byte, and the digest packed
into two 128-bit cells copied to the instance column as [lo, hi].

A frozen copy of the circuit the program proves for a message of a given
length (the message itself is witness), so that an inner SHA-256 proof's
verifying key is worked out here.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .plonk import (ADVICE, INSTANCE, Advice, Column, Constant,
                    ConstraintSystem, Scaled, Sum)

NBITS = 32
ROWS_PER_BLOCK = 204
DIG_REGION = 12
PACK_ROWS = 2
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


def num_blocks(msg_len: int) -> int:
    return (msg_len + 8) // 64 + 1


def min_k(msg_len: int) -> int:
    """The domain the program picks for a message of this length."""
    rows = num_blocks(msg_len) * ROWS_PER_BLOCK + DIG_REGION + PACK_ROWS
    k = 1
    while (1 << k) < rows + 64:
        k += 1
    return k


def statement(msg: bytes) -> list:
    """[lo, hi]: the digest's big-endian halves as numbers."""
    d = hashlib.sha256(msg).digest()
    return [[int.from_bytes(d[16:], "big"), int.from_bytes(d[:16], "big")]]


def _bit(col, rot):
    return Advice(col, rot)


def _sum_bits(terms):
    acc = None
    for t in terms:
        acc = t if acc is None else Sum(acc, t)
    return acc


def _word(rot):
    return _sum_bits(Scaled(_bit(j, rot), 1 << j) for j in range(NBITS))


def _xor2(x, y):
    return x + y - 2 * (x * y)


def _xor3(x, y, z):
    s = x + y + z
    p = x * y + y * z + x * z
    return s - 2 * p + 4 * (x * y * z)


def _sigma(rot, shs, shift_last=False):
    out = []
    for j in range(NBITS):
        x = _bit((j + shs[0]) % NBITS, rot)
        y = _bit((j + shs[1]) % NBITS, rot)
        if shift_last:
            b = _xor3(x, y, _bit(j + shs[2], rot)) \
                if j + shs[2] < NBITS else _xor2(x, y)
        else:
            b = _xor3(x, y, _bit((j + shs[2]) % NBITS, rot))
        out.append(Scaled(b, 1 << j))
    return _sum_bits(out)


def _ch(re, rf, rg):
    out = []
    for j in range(NBITS):
        e, f, g = _bit(j, re), _bit(j, rf), _bit(j, rg)
        out.append(Scaled(e * f + g - e * g, 1 << j))
    return _sum_bits(out)


def _maj(ra, rb, rc_):
    out = []
    for j in range(NBITS):
        a, b, c = _bit(j, ra), _bit(j, rb), _bit(j, rc_)
        out.append(Scaled(a * b + b * c + a * c - 2 * (a * b * c), 1 << j))
    return _sum_bits(out)


def _carry(nc=3):
    return _sum_bits(Scaled(Advice(NBITS + j, 0), 1 << (NBITS + j))
                     for j in range(nc))


def build_cs() -> ConstraintSystem:
    cs = ConstraintSystem()
    bits = [cs.advice_column() for _ in range(NBITS)]
    carries = [cs.advice_column() for _ in range(3)]
    inst = cs.instance_column()
    (q_bool, q_e, q_a, q_ws, q_init, q_dig, q_wconst,
     f_const) = [cs.fixed_column() for _ in range(8)]
    q_bytes = [cs.fixed_column() for _ in range(4)]
    f_bytes = [cs.fixed_column() for _ in range(4)]
    q_pack_hi, q_pack_lo = cs.fixed_column(), cs.fixed_column()
    for col in bits + carries:
        cs.create_gate(f"bool{col.index}", q_bool * (col * col - col))
    e_rhs = (_word(-11) + _word(-12) + _sigma(-3, (6, 11, 25))
             + _ch(-3, -6, -9) + f_const + _word(-1))
    cs.create_gate("e_row", q_e * (_word(0) + _carry(3) - e_rhs))
    a_rhs = (_word(-1) + (Constant(1 << 32) - _word(-12))
             + _sigma(-3, (2, 13, 22)) + _maj(-3, -6, -9))
    cs.create_gate("a_row", q_a * (_word(0) + _carry(3) - a_rhs))
    ws_rhs = (_sigma(-6, (17, 19, 10), shift_last=True) + _word(-21)
              + _sigma(-45, (7, 18, 3), shift_last=True) + _word(-48))
    cs.create_gate("w_sched", q_ws * (_word(0) + _carry(2) - ws_rhs))
    cs.create_gate("init", q_init * (_word(0) - f_const))
    dig_rhs = _word(-ROWS_PER_BLOCK) + _word(-12)
    cs.create_gate("digest", q_dig * (_word(0) + _carry(1) - dig_rhs))
    cs.create_gate("w_const", q_wconst * (_word(0) - f_const))
    for kk in range(4):
        acc = _sum_bits(Scaled(_bit(24 - 8 * kk + j, 0), 1 << j)
                        for j in range(8))
        cs.create_gate(f"byte{kk}", q_bytes[kk] * (acc - f_bytes[kk]))
    pack = Advice(NBITS, 0)
    hi = _sum_bits(Scaled(_word(-(1 + 3 * i)), 1 << (32 * (3 - i)))
                   for i in range(4))
    cs.create_gate("pack_hi", q_pack_hi * (pack - hi))
    lo = _sum_bits(Scaled(_word(-(3 + 3 * i)), 1 << (32 * (3 - i)))
                   for i in range(4))
    cs.create_gate("pack_lo", q_pack_lo * (pack - lo))
    cs.enable_permutation(Column(ADVICE, NBITS))
    cs.enable_permutation(Column(INSTANCE, inst.index))
    return cs


def layout(msg_len: int, k: int):
    """(cs, fixed {column: (rows, values)}, copies (m, 2, 3), [2])."""
    nb = num_blocks(msg_len)
    cs = build_cs()
    n = 1 << k

    def row(b, t, kind):
        return b * ROWS_PER_BLOCK + 3 * (t + 4) + kind

    dig_base = nb * ROWS_PER_BLOCK
    pack_hi, pack_lo = dig_base + DIG_REGION, dig_base + DIG_REGION + 1
    usable = cs.usable_rows(n)
    if pack_lo + 1 > usable:
        raise ValueError(f"k={k} is too small for {msg_len} bytes")
    fx = np.zeros((cs.num_fixed, n), dtype=np.int64)
    Q_BOOL, Q_E, Q_A, Q_WS, Q_INIT, Q_DIG, Q_WCONST, F_CONST = range(8)
    fx[Q_BOOL, :min(usable, pack_lo + 1)] = 1
    fx[Q_BOOL, [pack_hi, pack_lo]] = 0
    msg = b"\x00" * msg_len
    padded = msg + b"\x80" + b"\x00" * ((55 - msg_len) % 64) \
        + (8 * msg_len).to_bytes(8, "big")
    for b in range(nb):
        for r in range(64):
            fx[Q_E, row(b, r, 1)] = 1
            fx[F_CONST, row(b, r, 1)] = K_CONST[r]
            fx[Q_A, row(b, r, 2)] = 1
            if r >= 16:
                fx[Q_WS, row(b, r, 0)] = 1
        for t in range(4):
            if b == 0:
                fx[Q_INIT, row(0, t - 4, 2)] = 1
                fx[F_CONST, row(0, t - 4, 2)] = H_INIT[3 - t]
                fx[Q_INIT, row(0, t - 4, 1)] = 1
                fx[F_CONST, row(0, t - 4, 1)] = H_INIT[7 - t]
            else:
                fx[Q_DIG, row(b, t - 4, 2)] = 1
                fx[Q_DIG, row(b, t - 4, 1)] = 1
    for t in range(4):
        fx[Q_DIG, dig_base + 3 * t + 2] = 1
        fx[Q_DIG, dig_base + 3 * t + 1] = 1
    fx[16, pack_hi] = 1
    fx[17, pack_lo] = 1
    for b in range(nb):
        for r in range(16):
            wrow = row(b, r, 0)
            off = 64 * b + 4 * r
            in_msg = max(0, min(4, msg_len - off))
            if in_msg == 4:
                continue
            word = padded[off:off + 4]
            if in_msg == 0:
                fx[Q_WCONST, wrow] = 1
                fx[F_CONST, wrow] = int.from_bytes(word, "big")
            else:
                for kk in range(in_msg, 4):
                    fx[8 + kk, wrow] = 1
                    fx[12 + kk, wrow] = word[kk]
    copies = np.array([[[0, NBITS, pack_lo], [2, 0, 0]],
                       [[0, NBITS, pack_hi], [2, 0, 1]]], dtype=np.int64)
    fixed = {}
    for j in range(cs.num_fixed):
        rows = np.nonzero(fx[j])[0]
        fixed[j] = (rows, fx[j, rows].tolist())
    return cs, fixed, copies, [2]

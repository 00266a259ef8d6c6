"""The Poseidon transcript that the proofs are made with, read back in
Python ints: T = 3, RATE = 2, R_F = 8, R_P = 57 over BN254 Fr, constants
from the Grain LFSR, a duplex sponge with capacity 2^64, points absorbed as
two 128-bit limbs a coordinate, halo2curves' point encoding in the proof.
"""
from __future__ import annotations

from functools import lru_cache

from .bn254 import FR, finv, g1_decompress

T, RATE, R_F, R_P = 3, 2, 8, 57


def _grain_bits(field_bits: int):
    bits = [1] * 80

    def put(offset, length, value):
        for i in range(length):
            bits[offset + length - 1 - i] = (value >> i) & 1

    put(0, 2, 1)
    put(2, 4, 0)
    put(6, 12, field_bits)
    put(18, 12, T)
    put(30, 10, R_F)
    put(40, 10, R_P)

    def raw():
        new = bits[62] ^ bits[51] ^ bits[38] ^ bits[23] ^ bits[13] ^ bits[0]
        del bits[0]
        bits.append(new)
        return new

    for _ in range(160):
        raw()
    while True:
        b0, b1 = raw(), raw()
        if b0:
            yield b1


@lru_cache(maxsize=1)
def constants():
    """(round constants, MDS matrix)."""
    nb = FR.bit_length()
    stream = _grain_bits(nb)

    def take():
        v = 0
        for _ in range(nb):
            v = (v << 1) | next(stream)
        return v

    def sample():
        while True:
            v = take()
            if v < FR:
                return v

    rcs = [[sample() for _ in range(T)] for _ in range(R_F + R_P)]
    xs = [take() % FR for _ in range(T)]
    ys = [take() % FR for _ in range(T)]
    mds = [[finv((xs[i] + ys[j]) % FR, FR) for j in range(T)]
           for i in range(T)]
    return rcs, mds


def permute(s: list) -> list:
    p = FR
    rcs, ((m00, m01, m02), (m10, m11, m12), (m20, m21, m22)) = constants()
    a, b, c = s
    half = R_F // 2
    for r, (k0, k1, k2) in enumerate(rcs):
        a, b, c = a + k0, b + k1, c + k2
        a2 = a * a % p
        a = a2 * a2 % p * a % p
        if not half <= r < half + R_P:
            b2 = b * b % p
            b = b2 * b2 % p * b % p
            c2 = c * c % p
            c = c2 * c2 % p * c % p
        a, b, c = ((m00 * a + m01 * b + m02 * c) % p,
                   (m10 * a + m11 * b + m12 * c) % p,
                   (m20 * a + m21 * b + m22 * c) % p)
    return [a, b, c]


class TranscriptReader:
    """Reads a proof and squeezes the same challenges its prover did."""

    def __init__(self, data: bytes):
        self.state = [1 << 64, 0, 0]
        self.buf: list = []
        self.data = data
        self.pos = 0

    def common_scalar(self, s: int) -> None:
        self.buf.append(s % FR)

    def common_point(self, pt) -> None:
        x, y = pt
        if x == 0 and y == 0:
            raise ValueError("cannot absorb the identity point")
        m = (1 << 128) - 1
        self.buf += [x & m, x >> 128, y & m, y >> 128]

    def squeeze_challenge(self) -> int:
        inputs = self.buf + [1]
        self.buf = []
        st = self.state
        for off in range(0, len(inputs), RATE):
            for i, v in enumerate(inputs[off:off + RATE]):
                st[i + 1] = (st[i + 1] + v) % FR
            st = permute(st)
        self.state = st
        return st[1]

    def _take(self) -> bytes:
        raw = self.data[self.pos:self.pos + 32]
        if len(raw) != 32:
            raise ValueError("proof ends early")
        self.pos += 32
        return raw

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(), "little")
        if s >= FR:
            raise ValueError("non-canonical scalar in proof")
        self.common_scalar(s)
        return s

    def read_point(self):
        pt = g1_decompress(self._take())
        self.common_point(pt)
        return pt

    def at_end(self) -> bool:
        return self.pos == len(self.data)

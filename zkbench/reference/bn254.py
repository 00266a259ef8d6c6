"""BN254 arithmetic in Python ints: the fields, G1 in Jacobian coordinates,
the halo2curves point encoding, and the default SRS's secret.

A frozen copy of the formulas that the prover's own oracle uses, kept here
so that the judgement of a proof depends on no module of the program.
"""
from __future__ import annotations

import hashlib

FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
FR_GENERATOR = 7
FR_TWO_ADICITY = 28
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR - 1) >> FR_TWO_ADICITY, FR)
# the permutation argument's coset shift: g^(2^S)
DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, FR)
G1_B = 3
G1_GEN = (1, 2)
G1_IDENTITY = (0, 1, 0)
# The SRS that the program builds when it is given no secret (its public
# default): tau is this string's 64-byte blake2b read as a number mod r.
DEFAULT_TAU_SEED = b"halo2-zkcert-tpu-test-srs"


def finv(a: int, m: int) -> int:
    return 0 if a % m == 0 else pow(a, -1, m)


def root_of_unity(k: int) -> int:
    """A primitive 2^k-th root of unity in Fr."""
    w = FR_ROOT_OF_UNITY
    for _ in range(FR_TWO_ADICITY - k):
        w = w * w % FR
    return w


def fr_from_wide(b64: bytes) -> int:
    return (int.from_bytes(b64[:32], "little")
            + (int.from_bytes(b64[32:64], "little") << 256)) % FR


def blake2b(data: bytes, size: int = 64, persona: bytes = b"") -> bytes:
    return hashlib.blake2b(data, digest_size=size, person=persona).digest()


def default_tau() -> int:
    return fr_from_wide(blake2b(DEFAULT_TAU_SEED, 64))


def g1_double(p):
    X1, Y1, Z1 = p
    if Z1 == 0:
        return p
    q = FQ
    A = X1 * X1 % q
    B = Y1 * Y1 % q
    C = B * B % q
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % q
    E = 3 * A % q
    X3 = (E * E - 2 * D) % q
    return (X3, (E * (D - X3) - 8 * C) % q, 2 * Y1 * Z1 % q)


def g1_add(p, r):
    if p[2] == 0:
        return r
    if r[2] == 0:
        return p
    q = FQ
    X1, Y1, Z1 = p
    X2, Y2, Z2 = r
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    U2 = X2 * Z1Z1 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    S2 = Y2 * Z1 * Z1Z1 % q
    if U1 == U2:
        return g1_double(p) if S1 == S2 else G1_IDENTITY
    H = (U2 - U1) % q
    I = 4 * H * H % q
    J = H * I % q
    rr = 2 * (S2 - S1) % q
    V = U1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    return (X3, (rr * (V - X3) - 2 * S1 * J) % q, 2 * H * Z1 * Z2 % q)


def g1_neg(p):
    return (p[0], (-p[1]) % FQ, p[2])


def g1_mul(p, k: int):
    k %= FR
    acc = G1_IDENTITY
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_double(p)
        k >>= 1
    return acc


def g1_from_affine(a):
    return G1_IDENTITY if a == (0, 0) else (a[0], a[1], 1)


def g1_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return (0, 0)
    zi = finv(Z, FQ)
    zi2 = zi * zi % FQ
    return (X * zi2 % FQ, Y * zi2 * zi % FQ)


def g1_eq(p, r) -> bool:
    return g1_to_affine(p) == g1_to_affine(r)


def g1_decompress(b: bytes):
    """halo2curves' 32-byte encoding: x little-endian, y's parity in bit 7
    of the last byte; 32 zero bytes are the identity."""
    if b == bytes(32):
        return (0, 0)
    bb = bytearray(b)
    sign = (bb[31] >> 7) & 1
    bb[31] &= 0x3F
    x = int.from_bytes(bytes(bb), "little")
    if x >= FQ:
        raise ValueError("x coordinate not canonical")
    y2 = (x * x * x + G1_B) % FQ
    y = pow(y2, (FQ + 1) // 4, FQ)
    if y * y % FQ != y2:
        raise ValueError("not on curve")
    if (y & 1) != sign:
        y = FQ - y
    return (x, y)


def fe_bytes(a: int) -> bytes:
    return int(a).to_bytes(32, "little")

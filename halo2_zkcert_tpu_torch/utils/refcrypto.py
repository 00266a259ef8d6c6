"""Pure-Python (arbitrary-precision int) ground-truth cryptography for BN254.

This module is the *oracle* against which every field and curve kernel of
the port is tested (a copy of the JAX package's module, so that the port
imports nothing from it).  It mirrors the arithmetic of the reference stack's
`halo2curves` axiom fork (the upstream zkCert Cargo.lock pins it):
BN254 scalar field Fr, base field Fq, G1/G2 groups, and the polynomial /
commitment math used by the halo2 prover.

Everything here is slow-but-obviously-correct Python.  It is used:
  * in tests, as golden-vector generator,
  * on the host, for tiny verify-only computations (pairings, transcript
    spot checks) that never touch the device hot path.

No external dependencies beyond the standard library.
"""
from __future__ import annotations

import hashlib

# ---------------------------------------------------------------------------
# BN254 parameters (match halo2curves bn256 constants)
# ---------------------------------------------------------------------------

#: Base field modulus  q  (Fq)
FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
#: Scalar field modulus r  (Fr)
FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

#: Multiplicative generator of Fr (halo2curves `Fr::MULTIPLICATIVE_GENERATOR` = 7)
FR_GENERATOR = 7
#: 2-adicity of Fr - 1:  r - 1 = 2^28 * t  (halo2curves `Fr::S` = 28)
FR_TWO_ADICITY = 28
#: 2^28-th primitive root of unity, g^((r-1)/2^28) mod r
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR - 1) >> FR_TWO_ADICITY, FR)

# G1: y^2 = x^3 + 3 over Fq, generator (1, 2)
G1_B = 3
G1_GEN = (1, 2)

# G2 over Fq2 = Fq[u]/(u^2+1); b2 = 3/(9+u).
# Generator coordinates (c0, c1) as in halo2curves bn256::G2Affine::generator().
G2_GEN_X = (
    0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,  # x.c0
    0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2,  # x.c1
)
G2_GEN_Y = (
    0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,  # y.c0
    0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B,  # y.c1
)


# ---------------------------------------------------------------------------
# Field helpers (plain ints mod m)
# ---------------------------------------------------------------------------

def finv(a: int, m: int) -> int:
    """Modular inverse (0 maps to 0, matching ff's `invert().unwrap_or(0)` uses)."""
    if a % m == 0:
        return 0
    return pow(a, -1, m)


def fr_root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (k <= 28)."""
    assert k <= FR_TWO_ADICITY
    w = FR_ROOT_OF_UNITY
    for _ in range(FR_TWO_ADICITY - k):
        w = w * w % FR
    return w


def fe_to_bytes_le(a: int, n: int = 32) -> bytes:
    return int(a).to_bytes(n, "little")


def fe_from_bytes_le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def fr_from_u512_le(lo32: bytes, hi32: bytes) -> int:
    """ff `Field::random`-style wide reduction: interpret 64 LE bytes mod r."""
    return (int.from_bytes(lo32, "little") + (int.from_bytes(hi32, "little") << 256)) % FR


# ---------------------------------------------------------------------------
# G1 (short Weierstrass y^2 = x^3 + 3 over Fq) — Jacobian coordinates
# ---------------------------------------------------------------------------
# Point = (X, Y, Z) with x = X/Z^2, y = Y/Z^3; identity = (0, 1, 0).

G1_IDENTITY = (0, 1, 0)


def g1_is_identity(p):
    return p[2] == 0


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
    F = E * E % q
    X3 = (F - 2 * D) % q
    Y3 = (E * (D - X3) - 8 * C) % q
    Z3 = 2 * Y1 * Z1 % q
    return (X3, Y3, Z3)


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
        if S1 == S2:
            return g1_double(p)
        return G1_IDENTITY
    H = (U2 - U1) % q
    I = 4 * H * H % q
    J = H * I % q
    rr = 2 * (S2 - S1) % q
    V = U1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * S1 * J) % q
    Z3 = 2 * H * Z1 * Z2 % q
    return (X3, Y3, Z3)


def g1_neg(p):
    X, Y, Z = p
    return (X, (-Y) % FQ, Z)


def g1_mul(p, k: int):
    k %= FR
    acc = G1_IDENTITY
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_double(p)
        k >>= 1
    return acc


def g1_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return (0, 0)  # halo2curves uses (0,0) as affine identity encoding
    zinv = finv(Z, FQ)
    zinv2 = zinv * zinv % FQ
    return (X * zinv2 % FQ, Y * zinv2 * zinv % FQ)


def g1_from_affine(a):
    x, y = a
    if x == 0 and y == 0:
        return G1_IDENTITY
    return (x, y, 1)


def g1_is_on_curve_affine(a) -> bool:
    x, y = a
    if x == 0 and y == 0:
        return True
    return (y * y - x * x * x - G1_B) % FQ == 0


def g1_msm(points_affine, scalars):
    """Naive MSM oracle: sum_i scalars[i] * points[i]. Points affine, result affine."""
    acc = G1_IDENTITY
    for a, s in zip(points_affine, scalars):
        if s % FR == 0:
            continue
        acc = g1_add(acc, g1_mul(g1_from_affine(a), s))
    return g1_to_affine(acc)


# ---------------------------------------------------------------------------
# G1 point serialization (halo2curves bn256 compressed format, 32 bytes)
# ---------------------------------------------------------------------------
# halo2curves G1Affine::to_bytes: x in LE; top byte carries a sign bit
# (bit 7 of byte 31) = sign of y (y > (q-1)/2 ? ... uses `y.is_odd()` in the
# `derive_curve_impl!` CompressedFlagConfig::TwoSpare scheme).  Identity is
# encoded as 32 zero bytes.  TODO(round-2): validate bit placement against the
# pinned halo2curves e185711 — cannot run Rust in this environment.

def g1_compress(a) -> bytes:
    x, y = a
    if x == 0 and y == 0:
        return bytes(32)
    b = bytearray(fe_to_bytes_le(x))
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def g1_decompress(b: bytes):
    if b == bytes(32):
        return (0, 0)
    bb = bytearray(b)
    sign = (bb[31] >> 7) & 1
    bb[31] &= 0x3F
    x = fe_from_bytes_le(bytes(bb))
    if x >= FQ:
        raise ValueError("x coordinate not canonical")
    y2 = (x * x * x + G1_B) % FQ
    y = pow(y2, (FQ + 1) // 4, FQ)  # q % 4 == 3
    if y * y % FQ != y2:
        raise ValueError("not on curve")
    if (y & 1) != sign:
        y = FQ - y
    return (x, y)


# ---------------------------------------------------------------------------
# Fq2 / Fq6 / Fq12 and the BN254 pairing (verify-only, host side)
# ---------------------------------------------------------------------------
# Used solely for KZG pairing checks in the host verifier; never on device.

def f2_add(a, b):
    return ((a[0] + b[0]) % FQ, (a[1] + b[1]) % FQ)


def f2_sub(a, b):
    return ((a[0] - b[0]) % FQ, (a[1] - b[1]) % FQ)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % FQ
    t1 = a[1] * b[1] % FQ
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % FQ
    return ((t0 - t1) % FQ, (t2 - t0 - t1) % FQ)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_neg(a):
    return ((-a[0]) % FQ, (-a[1]) % FQ)


def f2_scalar(a, k):
    return (a[0] * k % FQ, a[1] * k % FQ)


def f2_conj(a):
    return (a[0], (-a[1]) % FQ)


def f2_inv(a):
    d = finv((a[0] * a[0] + a[1] * a[1]) % FQ, FQ)
    return (a[0] * d % FQ, (-a[1] * d) % FQ)


F2_ONE = (1, 0)
F2_ZERO = (0, 0)

# Fq2 non-residue for the sextic twist: xi = 9 + u
XI = (9, 1)


def _f6(c0, c1, c2):
    return (c0, c1, c2)


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_xi(a):
    """Multiply by v (the cubic non-residue generator): (c0,c1,c2) -> (xi*c2, c0, c1)."""
    return (f2_mul(XI, a[2]), a[0], a[1])


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_mul(a0, a0), f2_mul(XI, f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul(XI, f2_mul(a2, a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    d = f2_add(f2_mul(a0, t0), f2_mul(XI, f2_add(f2_mul(a2, t1), f2_mul(a1, t2))))
    dinv = f2_inv(d)
    return (f2_mul(t0, dinv), f2_mul(t1, dinv), f2_mul(t2, dinv))


F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_xi(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    d = f6_sub(f6_mul(a0, a0), f6_mul_by_xi(f6_mul(a1, a1)))
    dinv = f6_inv(d)
    return (f6_mul(a0, dinv), f6_neg(f6_mul(a1, dinv)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


# Frobenius coefficients for Fq2: a -> a^q is conjugation.
# For Fq12 frobenius we use exponentiation fallback (slow but fine: verify-only).

def f12_pow(a, e):
    r = F12_ONE
    while e:
        if e & 1:
            r = f12_mul(r, a)
        a = f12_sqr(a)
        e >>= 1
    return r


# --- G2 arithmetic (affine over Fq2), for the pairing only -----------------

def g2_neg(p):
    return (p[0], f2_neg(p[1]))


def _g2_double_jac(p):
    X1, Y1, Z1 = p
    A = f2_sqr(X1)
    B = f2_sqr(Y1)
    C = f2_sqr(B)
    D = f2_scalar(f2_sub(f2_sub(f2_sqr(f2_add(X1, B)), A), C), 2)
    E = f2_scalar(A, 3)
    F = f2_sqr(E)
    X3 = f2_sub(F, f2_scalar(D, 2))
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), f2_scalar(C, 8))
    Z3 = f2_scalar(f2_mul(Y1, Z1), 2)
    return (X3, Y3, Z3)


def _g2_add_jac(p, q):
    if p[2] == F2_ZERO:
        return q
    if q[2] == F2_ZERO:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f2_sqr(Z1)
    Z2Z2 = f2_sqr(Z2)
    U1 = f2_mul(X1, Z2Z2)
    U2 = f2_mul(X2, Z1Z1)
    S1 = f2_mul(f2_mul(Y1, Z2), Z2Z2)
    S2 = f2_mul(f2_mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return _g2_double_jac(p)
        return (F2_ZERO, F2_ONE, F2_ZERO)
    H = f2_sub(U2, U1)
    I = f2_scalar(f2_sqr(H), 4)
    J = f2_mul(H, I)
    rr = f2_scalar(f2_sub(S2, S1), 2)
    V = f2_mul(U1, I)
    X3 = f2_sub(f2_sub(f2_sqr(rr), J), f2_scalar(V, 2))
    Y3 = f2_sub(f2_mul(rr, f2_sub(V, X3)), f2_scalar(f2_mul(S1, J), 2))
    Z3 = f2_scalar(f2_mul(f2_mul(H, Z1), Z2), 2)
    return (X3, Y3, Z3)


def g2_mul_affine(p_aff, k):
    """Scalar-multiply an affine G2 point, returning affine."""
    acc = (F2_ZERO, F2_ONE, F2_ZERO)
    p = (p_aff[0], p_aff[1], F2_ONE)
    while k:
        if k & 1:
            acc = _g2_add_jac(acc, p)
        p = _g2_double_jac(p)
        k >>= 1
    if acc[2] == F2_ZERO:
        return None
    zinv = f2_inv(acc[2])
    zinv2 = f2_sqr(zinv)
    return (f2_mul(acc[0], zinv2), f2_mul(f2_mul(acc[1], zinv2), zinv))


# --- Optimal ate pairing (textbook, generic over Fq12) ---------------------
#
# We untwist G2 points into E(Fq12) and run a fully generic Miller loop with
# affine line functions.  Slow (seconds per pairing) but straightforwardly
# correct; only used for host-side KZG pairing checks and tests.

BN_X = 4965661367192848881  # BN254 curve parameter x
ATE_LOOP_COUNT = 6 * BN_X + 2

F12_ZERO = (F6_ZERO, F6_ZERO)


def f12_from_f2(a):
    return ((a, F2_ZERO, F2_ZERO), F6_ZERO)


def f12_from_int(n):
    return f12_from_f2((n % FQ, 0))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


# w = generator of Fq12 over Fq6: w^2 = v, v^3 = xi.
F12_W = (F6_ZERO, F6_ONE)
F12_W2 = ((F2_ZERO, F2_ONE, F2_ZERO), F6_ZERO)       # w^2 = v
F12_W3 = (F6_ZERO, (F2_ZERO, F2_ONE, F2_ZERO))        # w^3 = v*w


def untwist_g2(q_aff):
    """psi: E'(Fq2) -> E(Fq12): (x, y) -> (x*w^2, y*w^3) for the D-twist b'=b/xi."""
    x, y = q_aff
    return (f12_mul(f12_from_f2(x), F12_W2), f12_mul(f12_from_f2(y), F12_W3))


def _f12_point_neg(p):
    return (p[0], f12_sub(F12_ZERO, p[1]))


def _f12_point_double(p):
    x, y = p
    m = f12_mul(f12_mul(f12_from_int(3), f12_mul(x, x)), f12_inv(f12_mul(f12_from_int(2), y)))
    x3 = f12_sub(f12_mul(m, m), f12_mul(f12_from_int(2), x))
    y3 = f12_sub(f12_mul(m, f12_sub(x, x3)), y)
    return (x3, y3)


def _f12_point_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _f12_point_double(p)
        return None  # infinity
    m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_mul(m, m), x1), x2)
    y3 = f12_sub(f12_mul(m, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _line_eval(a, b, p):
    """Evaluate at p the line through points a, b on E(Fq12) (affine)."""
    xa, ya = a
    xp, yp = p
    if b is not None and a != b and xa == b[0]:
        # vertical line x = xa
        return f12_sub(xp, xa)
    if b is None or a == b:
        m = f12_mul(f12_mul(f12_from_int(3), f12_mul(xa, xa)),
                    f12_inv(f12_mul(f12_from_int(2), ya)))
    else:
        m = f12_mul(f12_sub(b[1], ya), f12_inv(f12_sub(b[0], xa)))
    return f12_sub(f12_sub(yp, ya), f12_mul(m, f12_sub(xp, xa)))


def _g2_frobenius_f12(q):
    """pi(Q) = (x^q, y^q) on E(Fq12) by direct exponentiation (slow, fine)."""
    x, y = q
    return (f12_pow(x, FQ), f12_pow(y, FQ))


def miller_loop(p_aff, q_aff):
    """Optimal ate Miller loop f_{6x+2,Q}(P) * line corrections. Fq12 result."""
    if (p_aff[0] == 0 and p_aff[1] == 0):
        return F12_ONE
    P = (f12_from_int(p_aff[0]), f12_from_int(p_aff[1]))
    Q = untwist_g2(q_aff)
    T = Q
    f = F12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:
        f = f12_mul(f12_sqr(f), _line_eval(T, T, P))
        T = _f12_point_double(T)
        if bit == "1":
            f = f12_mul(f, _line_eval(T, Q, P))
            T = _f12_point_add(T, Q)
    q1 = _g2_frobenius_f12(Q)
    q2 = _f12_point_neg(_g2_frobenius_f12(q1))
    f = f12_mul(f, _line_eval(T, q1, P))
    T = _f12_point_add(T, q1)
    f = f12_mul(f, _line_eval(T, q2, P))
    return f


def _final_exponentiation(f):
    """f^((q^12-1)/r) by plain exponentiation (slow, verify-only)."""
    e = (FQ ** 12 - 1) // FR
    return f12_pow(f, e)


def pairing(p_aff, q_aff):
    """Optimal ate pairing e(P, Q) -> Fq12. P affine G1, Q affine G2 (Fq2)."""
    return _final_exponentiation(miller_loop(p_aff, q_aff))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the form used by KZG verification.

    Accumulates Miller loops, then one shared final exponentiation.
    """
    f = F12_ONE
    for p_aff, q_aff in pairs:
        if p_aff[0] == 0 and p_aff[1] == 0:
            continue
        f = f12_mul(f, miller_loop(p_aff, q_aff))
    return _final_exponentiation(f) == F12_ONE


# ---------------------------------------------------------------------------
# Keccak-256 (Ethereum flavor, NOT sha3-256) — for the EVM transcript
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl64(x, n):
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(state):
    for rnd in range(24):
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl64(state[x][y], _KECCAK_ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
        # iota
        state[0][0] ^= _KECCAK_RC[rnd]
    return state


def keccak256(data: bytes) -> bytes:
    # pure-Python golden reference
    rate = 136
    state = [[0] * 5 for _ in range(5)]
    # pad10*1 with 0x01 domain byte (Keccak, not SHA3's 0x06)
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % rate:
        padded.append(0x00)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        state = _keccak_f(state)
    out = bytearray()
    for i in range(4):  # 32 bytes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return bytes(out[:32])


def blake2b(data: bytes, digest_size: int = 64, persona: bytes = b"") -> bytes:
    return hashlib.blake2b(data, digest_size=digest_size, person=persona).digest()

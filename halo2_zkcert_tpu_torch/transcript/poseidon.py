"""Poseidon permutation + sponge over BN254 Fr (host-side, Python ints).

Reference behavior: `snark-verifier`'s `PoseidonTranscript` (Cargo.lock:2676
[dep]) built on the PSE/axiom `poseidon-rs` crate (Cargo.lock:2068 [dep]) with
parameters T=3, RATE=2, R_F=8, R_P=57 (SURVEY.md §7 step 4).

Constants are generated with the Grain-LFSR procedure from the Poseidon
reference implementation (the same scheme the PSE crate's `Spec::new(r_f,
r_p)` / halo2_gadgets `grain.rs` use):

* 80-bit LFSR seeded with (field-type=prime-order(1), sbox=pow(0),
  n=field-bits, t, R_F, R_P) packed big-endian per field, remaining bits 1;
  160 bits discarded; output via the self-shrinking rule (read bit pairs,
  emit the 2nd when the 1st is 1).
* round constants: NUM_BITS-bit samples MSB-first with rejection sampling
  (resample while >= p).
* MDS: Cauchy matrix mds[i][j] = 1/(x_i + y_j) from 2*T non-rejected samples.

The transcript is sequential Fiat-Shamir glue between device kernel launches
— it stays on the host (a few hundred permutations per proof), in the C++
host library over BN254 Fr (`permute`), in Python ints in `permute_plain`.

NOTE(verify-upstream): bit-exactness vs the pinned Rust crates cannot be
executed in this environment (no Rust toolchain, no vendored source). The
scheme below follows the published Grain procedure + the PSE sponge
conventions (capacity element initialized to 2^64 = "capacity value is
2**64 + (o-1), o=1"; squeeze pads with a single 1). All conventions are
centralized HERE so a future cross-check against Rust only touches this file.
"""
from __future__ import annotations

from functools import lru_cache

from .. import native
from ..utils import refcrypto as rc

# Transcript parameters used by snark-verifier (SURVEY.md §2b row snark-verifier)
T = 3
RATE = 2
R_F = 8
R_P = 57


class _Grain:
    """Grain LFSR bit stream per the Poseidon reference implementation."""

    STATE = 80
    # b_{i+80} = b_{i+62} ^ b_{i+51} ^ b_{i+38} ^ b_{i+23} ^ b_{i+13} ^ b_i
    TAPS = (62, 51, 38, 23, 13, 0)

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int,
                 sbox_tag: int = 0, field_tag: int = 1):
        bits = [1] * self.STATE

        def set_bits(offset: int, length: int, value: int):
            for i in range(length):
                bits[offset + length - 1 - i] = (value >> i) & 1

        set_bits(0, 2, field_tag)     # prime-order field = 1
        set_bits(2, 4, sbox_tag)      # x^alpha sbox = 0
        set_bits(6, 12, field_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        self.bits = bits
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> int:
        new = 0
        for tap in self.TAPS:
            new ^= self.bits[tap]
        self.bits = self.bits[1:] + [new]
        return new

    def bit(self) -> int:
        """Self-shrinking output: emit the 2nd bit of a pair whose 1st is 1."""
        while True:
            b0 = self._raw_bit()
            b1 = self._raw_bit()
            if b0:
                return b1

    def take(self, n: int) -> int:
        """n bits, MSB first, as an int."""
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def field_element(self, modulus: int, num_bits: int) -> int:
        """Rejection-sampled field element (round constants)."""
        while True:
            v = self.take(num_bits)
            if v < modulus:
                return v

    def field_element_no_reject(self, modulus: int, num_bits: int) -> int:
        """Reduced (non-rejected) field element (MDS x/y samples)."""
        return self.take(num_bits) % modulus


@lru_cache(maxsize=4)
def poseidon_constants(modulus: int = rc.FR, t: int = T, r_f: int = R_F,
                       r_p: int = R_P):
    """(round_constants, mds): constants for the HADES permutation.

    round_constants: (r_f + r_p) rows of t elements; mds: t x t Cauchy matrix.
    """
    num_bits = modulus.bit_length()  # 254 for BN254 Fr
    grain = _Grain(num_bits, t, r_f, r_p)
    rounds = r_f + r_p
    rcs = [[grain.field_element(modulus, num_bits) for _ in range(t)]
           for _ in range(rounds)]
    # MDS: sample xs then ys; Cauchy matrix 1/(x_i + y_j).  The reference
    # checks invertibility/security criteria and can re-sample ("select");
    # for these parameters the first candidate passes.
    xs = [grain.field_element_no_reject(modulus, num_bits) for _ in range(t)]
    ys = [grain.field_element_no_reject(modulus, num_bits) for _ in range(t)]
    mds = [[rc.finv((xs[i] + ys[j]) % modulus, modulus) for j in range(t)]
           for i in range(t)]
    return rcs, mds


def _sbox(x: int, p: int) -> int:
    """alpha = 5 for BN254 (gcd(5, p-1) = 1)."""
    x2 = x * x % p
    x4 = x2 * x2 % p
    return x4 * x % p


def permute(state: list, modulus: int = rc.FR) -> list:
    """Standard HADES Poseidon permutation (T=3, R_F=8, R_P=57).

    Over BN254 Fr it runs in the host library (native.py,
    csrc/hostmath.cpp); `permute_plain` is the same function in Python,
    the plain version that library is tested against."""
    if modulus == rc.FR:
        return native.poseidon_permute(state)
    return permute_plain(state, modulus)


def permute_plain(state: list, modulus: int = rc.FR) -> list:
    """The permutation in Python ints.

    Full rounds: add-constants, sbox all, MDS.  Partial: sbox lane 0 only.
    Algebraically equal to the PSE crate's "optimized" evaluation.
    """
    p = modulus
    rcs, mds = poseidon_constants(p)
    s = list(state)
    half = R_F // 2
    for r in range(R_F + R_P):
        s = [(s[i] + rcs[r][i]) % p for i in range(T)]
        if half <= r < half + R_P:
            s[0] = _sbox(s[0], p)
        else:
            s = [_sbox(x, p) for x in s]
        s = [sum(mds[i][j] * s[j] for j in range(T)) % p for i in range(T)]
    return s


class PoseidonSponge:
    """Duplex sponge matching the PSE `Poseidon` hasher conventions:

    * initial state = [2^64, 0, 0]  (capacity value 2^64 + (o-1), o=1);
    * `update(elems)` buffers absorbed elements;
    * `squeeze()` appends the 1-padding, absorbs buffered elements RATE at a
      time into state[1..], permuting after each full chunk, and returns
      state[1]; the buffer resets so the duplex can continue absorbing.
    """

    def __init__(self, modulus: int = rc.FR):
        self.p = modulus
        self.state = [1 << 64] + [0] * (T - 1)
        self.buf: list = []

    def update(self, elements) -> None:
        self.buf.extend(int(e) % self.p for e in elements)

    def squeeze(self) -> int:
        inputs = self.buf + [1]
        self.buf = []
        for off in range(0, len(inputs), RATE):
            chunk = inputs[off:off + RATE]
            for i, v in enumerate(chunk):
                self.state[i + 1] = (self.state[i + 1] + v) % self.p
            self.state = permute(self.state, self.p)
        return self.state[1]

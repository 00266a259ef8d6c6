"""Fiat-Shamir transcripts (host-side).

Three flavors, mirroring the reference stack (SURVEY.md §2b):

* `PoseidonTranscript` — used for aggregatable SNARKs (snark-verifier-sdk
  `gen_snark_shplonk`, reference helpers.rs:15-19 [dep]).  EC points are
  absorbed as their base-field coordinates split into 3x88-bit limbs (the
  same representation halo2-ecc's non-native arithmetic uses, so the
  in-circuit replay absorbs identical field elements).
* `KeccakTranscript` — the EVM transcript (gen_evm_proof_shplonk,
  reference cli.rs:519 [dep]): big-endian byte serialization, keccak256
  challenge squeezing.
* `Blake2bTranscript` — halo2_proofs' default transcript; used here for
  vk hashing (`transcript_repr`).

Proof byte stream conventions (halo2curves bn256 [dep], Cargo.lock:1359):
points 32-byte compressed (x LE, sign-of-y in bit 7 of byte 31), scalars
32-byte LE — see `utils.refcrypto.g1_compress`.
"""
from __future__ import annotations

from .. import native
from ..utils import refcrypto as rc
from ..utils import trace
from . import poseidon as _poseidon
from .poseidon import PoseidonSponge, permute, poseidon_constants


def _keccak(data: bytes) -> bytes:
    """Keccak-256 in the host library (native.py); utils/refcrypto.py
    `keccak256` is its plain version."""
    return native.keccak256(data)

# Fq-over-Fr limb decomposition for point absorption & accumulator
# exposure.  The reference uses halo2-ecc's CRT width LIMBS=3, BITS=88
# [dep Cargo.lock:2714]; this framework's non-native arithmetic is the
# 16-bit challenge tape (circuits/bigint_tape.py), so the natural exact
# packing is 2 x 128 bits (8 tape limbs each, no bit splitting in-circuit
# and one sponge permutation per coordinate pair).  Known deviation from
# the reference convention — consistent across native/EVM/in-circuit here.
NUM_LIMBS = 2
LIMB_BITS = 128


def fe_to_limbs(x: int, num_limbs: int = NUM_LIMBS, limb_bits: int = LIMB_BITS):
    mask = (1 << limb_bits) - 1
    return [(x >> (i * limb_bits)) & mask for i in range(num_limbs)]


def limbs_to_fe(limbs, limb_bits: int = LIMB_BITS) -> int:
    return sum(int(v) << (i * limb_bits) for i, v in enumerate(limbs))


class PoseidonTranscript:
    """Prover/verifier transcript over a Poseidon sponge (BN254 Fr).

    In write mode, `buf` accumulates the proof bytes; in read mode, bytes are
    consumed from `data`.  The prover's calls add their host seconds to the
    span recorder's proof counter `transcript_s` (utils/trace.py).
    """

    def __init__(self, data: bytes | None = None):
        self.sponge = PoseidonSponge(rc.FR)
        self.buf = bytearray()
        self.data = data
        self.pos = 0

    # -- common (absorb-only) -------------------------------------------------
    @trace.timed("transcript_s")
    def common_scalar(self, s: int) -> None:
        self.sponge.update([s % rc.FR])

    def common_point(self, pt) -> None:
        x, y = pt
        if x == 0 and y == 0:
            raise ValueError("cannot absorb the identity point")
        self.sponge.update(fe_to_limbs(x) + fe_to_limbs(y))

    @trace.timed("transcript_s")
    def squeeze_challenge(self) -> int:
        return self.sponge.squeeze()

    # -- prover side ----------------------------------------------------------
    @trace.timed("transcript_s")
    def write_scalar(self, s: int) -> None:
        s %= rc.FR
        self.common_scalar(s)
        self.buf += rc.fe_to_bytes_le(s)

    @trace.timed("transcript_s")
    def write_point(self, pt) -> None:
        self.common_point(pt)
        self.buf += rc.g1_compress(pt)

    @trace.timed("transcript_s")
    def finalize(self) -> bytes:
        return bytes(self.buf)

    # -- verifier side ----------------------------------------------------------
    def read_scalar(self) -> int:
        raw = self.data[self.pos:self.pos + 32]
        self.pos += 32
        s = rc.fe_from_bytes_le(raw)
        if s >= rc.FR:
            raise ValueError("non-canonical scalar in proof")
        self.common_scalar(s)
        return s

    def read_point(self):
        raw = self.data[self.pos:self.pos + 32]
        self.pos += 32
        pt = rc.g1_decompress(raw)
        self.common_point(pt)
        return pt


class KeccakTranscript:
    """EVM transcript: keccak256 Fiat-Shamir, big-endian serialization.

    Convention (snark-verifier EvmTranscript [dep]): points are written as
    two 32-byte big-endian coordinates; scalars 32-byte big-endian; a
    challenge is keccak256(running-buffer) reduced mod r, and the squeezed
    challenge's 32-byte BE form re-seeds the running buffer.
    """

    def __init__(self, data: bytes | None = None):
        self.stream = bytearray()   # proof bytes (write mode)
        self.hbuf = bytearray()     # hash absorption buffer
        self.data = data
        self.pos = 0

    def common_scalar(self, s: int) -> None:
        self.hbuf += int(s % rc.FR).to_bytes(32, "big")

    def common_point(self, pt) -> None:
        x, y = pt
        if x == 0 and y == 0:
            raise ValueError("cannot absorb the identity point")
        self.hbuf += int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")

    def squeeze_challenge(self) -> int:
        # domain-separate squeezes with a trailing 0x01 byte, as the EVM
        # verifier can cheaply reproduce with MSTORE8
        digest = _keccak(bytes(self.hbuf) + b"\x01")
        c = int.from_bytes(digest, "big") % rc.FR
        self.hbuf = bytearray(int(c).to_bytes(32, "big"))
        return c

    def write_scalar(self, s: int) -> None:
        s %= rc.FR
        self.common_scalar(s)
        self.stream += int(s).to_bytes(32, "big")

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self.stream += int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")

    def finalize(self) -> bytes:
        return bytes(self.stream)

    def read_scalar(self) -> int:
        raw = self.data[self.pos:self.pos + 32]
        self.pos += 32
        s = int.from_bytes(raw, "big")
        if s >= rc.FR:
            raise ValueError("non-canonical scalar in proof")
        self.common_scalar(s)
        return s

    def read_point(self):
        xraw = self.data[self.pos:self.pos + 32]
        yraw = self.data[self.pos + 32:self.pos + 64]
        self.pos += 64
        x, y = int.from_bytes(xraw, "big"), int.from_bytes(yraw, "big")
        if x >= rc.FQ or y >= rc.FQ or not rc.g1_is_on_curve_affine((x, y)):
            raise ValueError("invalid point in proof")
        self.common_point((x, y))
        return (x, y)


class Blake2bTranscript:
    """halo2_proofs Blake2bWrite-style transcript (used for vk hashing).

    Conventions [dep halo2_proofs transcript.rs]: state is a running blake2b
    personalised "Halo2-Transcript"; absorbing prefixes a domain byte
    (0 = challenge, 1 = point, 2 = scalar); challenges are 64-byte wide
    reductions mod r.
    """

    PERSONA = b"Halo2-Transcript"
    PREFIX_CHALLENGE = b"\x00"
    PREFIX_POINT = b"\x01"
    PREFIX_SCALAR = b"\x02"

    def __init__(self, data: bytes | None = None):
        import hashlib
        self._h = hashlib.blake2b(digest_size=64, person=self.PERSONA)
        self.buf = bytearray()
        self.data = data
        self.pos = 0

    def common_scalar(self, s: int) -> None:
        self._h.update(self.PREFIX_SCALAR)
        self._h.update(rc.fe_to_bytes_le(s % rc.FR))

    def common_point(self, pt) -> None:
        self._h.update(self.PREFIX_POINT)
        x, y = pt
        self._h.update(rc.fe_to_bytes_le(x) + rc.fe_to_bytes_le(y))

    def squeeze_challenge(self) -> int:
        self._h.update(self.PREFIX_CHALLENGE)
        digest = self._h.copy().digest()
        self._h.update(digest)
        return rc.fr_from_u512_le(digest[:32], digest[32:])

    def write_scalar(self, s: int) -> None:
        s %= rc.FR
        self.common_scalar(s)
        self.buf += rc.fe_to_bytes_le(s)

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self.buf += rc.g1_compress(pt)

    def finalize(self) -> bytes:
        return bytes(self.buf)

    def read_scalar(self) -> int:
        raw = self.data[self.pos:self.pos + 32]
        self.pos += 32
        s = rc.fe_from_bytes_le(raw)
        self.common_scalar(s)
        return s

    def read_point(self):
        raw = self.data[self.pos:self.pos + 32]
        self.pos += 32
        pt = rc.g1_decompress(raw)
        self.common_point(pt)
        return pt

"""An issuer's RSA key pair and the leaves it signs, from the seed.

The modulus has exactly `issuer_bits` bits, the product of two primes of
half that size (top two bits set, Miller-Rabin with 40 seeded bases), with
the configuration's public exponent.  Each leaf is a TBS of uniformly drawn
length in the cell's `tbs_bytes` range and random bytes, signed under
PKCS#1 v1.5 with SHA-256 (signature = EM^d mod n, by the CRT)."""
from __future__ import annotations

import hashlib
import random

DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_SMALL = [p for p in range(3, 2000)
          if all(p % q for q in range(2, int(p ** 0.5) + 1))]


def is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def prime(bits: int, e: int, rng: random.Random) -> int:
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (c - 1) % e and is_probable_prime(c, rng):
            return c


def keypair(bits: int, e: int, rng: random.Random) -> dict:
    while True:
        p, q = prime(bits // 2, e, rng), prime(bits // 2, e, rng)
        n = p * q
        if p != q and n.bit_length() == bits:
            break
    d = pow(e, -1, (p - 1) * (q - 1))
    return {"n": n, "e": e, "p": p, "q": q, "dp": d % (p - 1),
            "dq": d % (q - 1), "qinv": pow(q, -1, p)}


def em(digest: bytes, k_bytes: int) -> int:
    t = DIGEST_INFO + digest
    return int.from_bytes(b"\x00\x01" + b"\xff" * (k_bytes - 3 - len(t))
                          + b"\x00" + t, "big")


def sign(key: dict, tbs: bytes) -> int:
    m = em(hashlib.sha256(tbs).digest(), (key["n"].bit_length() + 7) // 8)
    p, q = key["p"], key["q"]
    m1, m2 = pow(m, key["dp"], p), pow(m, key["dq"], q)
    return m2 + q * (key["qinv"] * (m1 - m2) % p)


def make(config: dict, cell: dict, rng: random.Random) -> dict:
    key = keypair(config["issuer_bits"], config["public_exponent"], rng)
    lo, hi = cell["tbs_bytes"]
    count = cell["leaves"]
    leaves = []
    for _ in range(count):
        tbs = rng.randbytes(rng.randint(lo, hi))
        leaves.append((tbs, sign(key, tbs)))
    return {"modulus": key["n"], "exponent": key["e"], "leaves": leaves,
            "jobs": count}

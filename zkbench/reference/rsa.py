"""The RSA PKCS#1 v1.5 / SHA-256 link's circuit as a layout: its constraint
system, fixed columns and copies for a modulus, and the statement a proof
of one leaf has to prove (the 32 digest bytes, big-endian).

A frozen copy of the circuit the program proves (a 16-bit limb tape, a
Horner accumulator under a challenge, e = 65537 as 16 squarings and one
product), so that the verifying key is worked out here from the modulus.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .keys import PlonkReference
from .plonk import ADVICE, INSTANCE, Advice, Column, ConstraintSystem

LIMB = 16
OFF = 1 << 26
SQUARINGS = 16
DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def pkcs1_em(digest: bytes, k_bytes: int) -> int:
    t = DIGEST_INFO + digest
    em = b"\x00\x01" + b"\xff" * (k_bytes - 3 - len(t)) + b"\x00" + t
    return int.from_bytes(em, "big")


def statement(tbs: bytes) -> list:
    """The instance column of a proof that a signature over `tbs` verifies."""
    return [list(hashlib.sha256(tbs).digest())]


def reference(config: dict, inputs: dict, artifacts: dict,
              tau: int) -> PlonkReference:
    """The issuer's circuit; a job's statement is its own leaf's digest.
    It rests on no artifact."""
    cs, fixed, copies, ninst = layout(inputs["modulus"], config["k"])
    leaves = inputs["leaves"]
    return PlonkReference(config["k"], cs, fixed, copies, ninst,
                          lambda job: statement(leaves[job][0]), tau)


def _limbs(x: int, count: int) -> list:
    return [(x >> (LIMB * i)) & 0xFFFF for i in range(count)]


def layout(modulus: int, k: int):
    """(cs, fixed {column: (rows, values)}, copies (m, 2, 3), [32])."""
    nbits = ((modulus.bit_length() + LIMB - 1) // LIMB) * LIMB
    L = nbits // LIMB
    n = 1 << k
    cs = ConstraintSystem()
    v = cs.advice_column(phase=0)
    a = cs.advice_column(phase=1)
    cs.instance_column()
    tau = cs.challenge(phase=0)
    (t16, q_h, f_pass, f_tau, f_v, f_n, f_one, q_rel, q_pack, q_const,
     f_const, f_nval) = [cs.fixed_column() for _ in range(12)]
    am1 = Advice(1, -1, phase=1)
    cs.create_gate("horner", q_h * (a - f_pass * am1 - f_tau * (am1 * tau)
                                    - f_v * v - f_n * f_nval - f_one))

    def A(r):
        return Advice(1, r, phase=1)

    rel = (A(0) * A(1) - A(2) * A(6) - A(3)
           - (tau - (1 << LIMB)) * (A(4) + (1 << LIMB) * A(5) - OFF * A(7)))
    cs.create_gate("mulmod_relation", q_rel * rel)
    cs.create_gate("byte_pack", q_pack * (v - 256 * Advice(0, -2, phase=0)
                                          - Advice(0, -1, phase=0)))
    cs.create_gate("pin_const", q_const * (v - f_const))
    cs.add_lookup("range16", [(v, t16)])
    for col in (Column(ADVICE, 0), Column(ADVICE, 1), Column(INSTANCE, 0)):
        cs.enable_permutation(col)

    regions, copies, cursor = {}, [], 1

    def region(name, length, kind):
        nonlocal cursor
        regions[name] = (cursor, length, kind)
        cursor += length

    region("sig", L, "v")
    region("mod", L, "n")
    region("ones", 2 * L, "one")
    region("em", (L - 16) + 16 * 3, "em")
    for g in range(SQUARINGS + 1):
        region(f"q{g}", L + 1, "v")
        region(f"clo{g}", 2 * L, "v")
        region(f"chi{g}", 2 * L, "v")
        if g < SQUARINGS:
            region(f"z{g}", L, "v")
        region(f"rel{g}", 8, "rel")
    usable = cs.usable_rows(n)
    if cursor > usable or (1 << LIMB) > usable:
        raise ValueError(f"k={k} too small for a {nbits}-bit modulus")

    fx = np.zeros((12, n), dtype=object)
    fx[0, :1 << LIMB] = np.arange(1 << LIMB)
    fx[1, :usable] = 1
    col = dict(fpass=2, ftau=3, fv=4, fn=5, fone=6)

    def flags(r, **kw):
        for name, val in kw.items():
            fx[col[name], r] = val

    mod_limbs = _limbs(modulus, L)
    for start, length, kind in regions.values():
        if kind in ("v", "n", "one"):
            for i in range(length):
                r = start + i
                flags(r, ftau=0 if i == 0 else 1)
                if kind == "v":
                    flags(r, fv=1)
                elif kind == "n":
                    flags(r, fn=1)
                    fx[11, r] = mod_limbs[L - 1 - i]
                else:
                    flags(r, fone=1)
        elif kind == "rel":
            fx[1, start:start + length] = 0
            fx[7, start] = 1

    em_const = _limbs(pkcs1_em(b"\x00" * 32, nbits // 8), L)
    r = regions["em"][0]
    for i in range(L - 1, -1, -1):
        first = i == L - 1
        if i >= 16:
            flags(r, ftau=0 if first else 1, fv=1)
            fx[9, r] = 1
            fx[10, r] = em_const[i]
            r += 1
        else:
            for byte in (30 - 2 * i, 31 - 2 * i):
                flags(r, fpass=1)
                copies.append(((0, 0, r), (2, 0, byte)))
                r += 1
            flags(r, ftau=0 if first else 1, fv=1)
            fx[8, r] = 1
            r += 1
    for g in range(SQUARINGS + 1):
        for name, val in (("clo", 0), ("chi", OFF >> LIMB)):
            rr = regions[f"{name}{g}"][0]
            fx[9, rr] = 1
            fx[10, rr] = val

    def ev(name):
        start, length, _ = regions[name]
        return start + length - 1

    for g in range(SQUARINGS + 1):
        x_src = ev("sig") if g == 0 else ev(f"z{g - 1}")
        y_src = x_src if g < SQUARINGS else ev("sig")
        z_src = ev(f"z{g}") if g < SQUARINGS else ev("em")
        srcs = [x_src, y_src, ev(f"q{g}"), z_src, ev(f"clo{g}"),
                ev(f"chi{g}"), ev("mod"), ev("ones")]
        base = regions[f"rel{g}"][0]
        for slot, src in enumerate(srcs):
            copies.append(((0, 1, base + slot), (0, 1, src)))

    fixed = {}
    for j in range(12):
        rows = np.nonzero(fx[j] != 0)[0]
        fixed[j] = (rows, fx[j, rows].tolist())
    return cs, fixed, np.asarray(copies, dtype=np.int64), [32]

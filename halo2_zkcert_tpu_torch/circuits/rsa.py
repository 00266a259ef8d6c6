"""RSA PKCS#1-v1.5 / SHA-256 signature-verification circuit.

Capability parity with the reference RSA circuit
(upstream zkCert `src/helpers.rs:97-172`, on halo2-rsa):
prove `sig^65537 mod n == EM(H)` where H = SHA256(TBS) is exposed as 32
byte-valued public instances in big-endian order (helpers.rs:166-167), with
the modulus `n` pinned as fixed-column constants (keygen is per-issuer, as
in the reference CLI flow cli.rs:225-248).

Counterpart of halo2_zkcert_tpu/circuits/rsa.py: the same constraint
system (its digest equals the JAX package's) and the same witness; the
phase-1 accumulator column is one device scan (ops/frops.affine_scan).

NOT a port of halo2-rsa: halo2-rsa materializes every limb product through vertical
a+b*c=d gates (~1k gates per modular multiply).  This circuit instead uses
a *challenge-based polynomial identity* (halo2 multi-phase challenges):

  phase 0:  commit the limb tape V  — all operand/quotient/carry limbs,
            16-bit each, one vertical column, range-checked by ONE lookup;
  challenge tau;
  phase 1:  commit the Horner accumulator column A evaluating every limb
            array at tau (uniform scan gate), plus per-mulmod relation rows
            checking   X(t)Y(t) - Q(t)N(t) - Z(t) = (t - 2^16) C(t)  at tau.

Soundness: all committed limb vectors are fixed before tau, so equality at
tau implies the polynomial identity whp (Schwartz-Zippel); with 16-bit
range-checked limbs and bounded carries the identity at t=2^16 is the exact
integer statement x*y = q*n + z.  e = 65537 = 2^16+1 gives a chain of 16
squarings + 1 multiply (same shape as halo2-rsa's pow_mod_fixed_exp [dep]).

EM is rebuilt in-circuit from PKCS#1 constants + the instance hash bytes
(interleaved byte-pair packing rows), evaluated at tau, and equated to the
final multiply's Z(tau) — vector equality via eval equality whp.

Row cost: ~6L rows per mulmod (L = nbits/16), ~14k rows for RSA-2048 —
the k=17 benchmark config has 128k rows of headroom; requires k >= 17
(the 2^16 range table must fit the column).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import field, frops
from ..ops.field import FR
from ..utils import refcrypto as rc
from ..utils import trace
from ..cert.x509 import pkcs1v15_sha256_em
from ..plonk import ADVICE, INSTANCE, CircuitData, Column, ConstraintSystem
from ..plonk import expression as ex

B = 16                     # limb bits (= range table bits)
OFF_POW = 26               # carry offset exponent: c' = c + 2^26
OFF = 1 << OFF_POW
NUM_SQUARINGS = 16         # e = 2^16 + 1


def _limbs_of(x: int, L: int, base_bits: int = B) -> list:
    mask = (1 << base_bits) - 1
    return [(x >> (base_bits * i)) & mask for i in range(L)]


@dataclass
class _Region:
    name: str
    start: int
    length: int
    kind: str          # 'v' | 'n' | 'one' | 'em' | 'rel' | 'byte-pad'

    @property
    def eval_row(self) -> int:
        return self.start + self.length - 1


class RsaCircuit:
    """Compiled per-modulus circuit (structure fixed at build time)."""

    # advice columns
    COL_V = 0
    COL_A = 1
    # fixed columns (creation order).  NOTE: no byte-range table — the EM
    # hash-byte rows are copy-constrained to PUBLIC INSTANCE values
    # (digest bytes the verifier supplies), so an in-circuit 8-bit range
    # check would be redundant: the byte-ness of the claim's inputs is the
    # caller's statement, validated host-side (`validate_instances`).
    (F_T16, F_QH, F_PASS, F_TAU, F_V, F_N, F_ONE,
     F_QREL, F_QPACK, F_QCONST, F_CONST, F_NVAL) = range(12)

    def __init__(self, modulus: int, k: int = 17):
        assert k >= 17, "16-bit range table requires k >= 17"
        self.modulus = modulus
        self.nbits = ((modulus.bit_length() + B - 1) // B) * B
        self.L = self.nbits // B
        self.k = k
        self.n = 1 << k
        self._build()

    # ------------------------------------------------------------------ build

    def _build(self) -> None:
        cs = ConstraintSystem()
        # V tape: 16-bit range-checked limbs -> bounded-window commits
        v = cs.advice_column(phase=0, value_bits=16)
        a = cs.advice_column(phase=1)
        inst = cs.instance_column()
        tau = cs.challenge(phase=0)
        fcols = [cs.fixed_column() for _ in range(12)]
        (t16, q_h, f_pass, f_tau, f_v, f_n, f_one,
         q_rel, q_pack, q_const, f_const, f_nval) = fcols

        A0, Am1 = a, ex.Advice(1, -1, phase=1)
        horner = q_h * (a - f_pass * Am1 - f_tau * (Am1 * tau)
                        - f_v * v - f_n * f_nval - f_one)
        cs.create_gate("horner", horner)

        def A(r):
            return ex.Advice(1, r, phase=1)

        rel = (A(0) * A(1) - A(2) * A(6) - A(3)
               - (tau - (1 << B)) * (A(4) + (1 << B) * A(5) - OFF * A(7)))
        cs.create_gate("mulmod_relation", q_rel * rel)

        Vm = lambda r: ex.Advice(0, r, phase=0)
        cs.create_gate("byte_pack", q_pack * (v - 256 * Vm(-2) - Vm(-1)))
        cs.create_gate("pin_const", q_const * (v - f_const))

        cs.add_lookup("range16", [(v, t16)], max_bits=16)

        cs.enable_permutation(Column(ADVICE, self.COL_V))
        cs.enable_permutation(Column(ADVICE, self.COL_A))
        cs.enable_permutation(Column(INSTANCE, 0))

        # ---------------- layout ----------------
        L = self.L
        self.regions: dict = {}
        self.copies: list = []
        cursor = 1  # row 0: zero row

        def region(name: str, length: int, kind: str) -> _Region:
            nonlocal cursor
            r = _Region(name, cursor, length, kind)
            self.regions[name] = r
            cursor += length
            return r

        region("sig", L, "v")
        region("mod", L, "n")
        region("ones", 2 * L, "one")
        # EM construction region: limbs MSB-first; the low 16 limbs carry the
        # hash and are emitted as [b_hi, b_lo, limb] triplets
        em_len = (L - 16) + 16 * 3
        region("em", em_len, "em")
        for g in range(NUM_SQUARINGS + 1):
            region(f"q{g}", L + 1, "v")
            region(f"clo{g}", 2 * L, "v")
            region(f"chi{g}", 2 * L, "v")
            if g < NUM_SQUARINGS:
                region(f"z{g}", L, "v")
            region(f"rel{g}", 8, "rel")
        self.rows_used = cursor
        n = self.n
        usable = cs.usable_rows(n)
        assert self.rows_used <= usable, \
            f"k={self.k} too small: {self.rows_used} rows > {usable} usable"
        assert (1 << B) <= usable, "range table must fit usable rows"

        # ---------------- fixed assignment ----------------
        NF = cs.num_fixed
        fixed = np.zeros((NF, n), dtype=object)
        F = self.__class__
        for r in range(1 << B):
            fixed[F.F_T16][r] = r

        def set_flags(r, **kw):
            m = dict(qh=F.F_QH, fpass=F.F_PASS, ftau=F.F_TAU, fv=F.F_V,
                     fn=F.F_N, fone=F.F_ONE)
            for kname, val in kw.items():
                fixed[m[kname]][r] = val

        for r in range(usable):
            fixed[F.F_QH][r] = 1

        mod_limbs = _limbs_of(self.modulus, L)
        for reg in self.regions.values():
            if reg.kind in ("v", "n", "one"):
                for i in range(reg.length):
                    r = reg.start + i
                    set_flags(r, ftau=0 if i == 0 else 1)
                    if reg.kind == "v":
                        set_flags(r, fv=1)
                    elif reg.kind == "n":
                        set_flags(r, fn=1)
                        # MSB-first: row i holds limb L-1-i
                        fixed[F.F_NVAL][r] = mod_limbs[L - 1 - i]
                    else:
                        set_flags(r, fone=1)
            elif reg.kind == "rel":
                for i in range(reg.length):
                    fixed[F.F_QH][reg.start + i] = 0
                fixed[F.F_QREL][reg.start] = 1

        # EM region structure: iterate EM limbs MSB-first
        em = self.regions["em"]
        em_limb_template = self._em_template()
        r = em.start
        first = True
        self.em_rows = {"bytes": {}, "limbs": []}
        for (limb_idx, kind, payload) in em_limb_template:
            if kind == "const":
                set_flags(r, ftau=0 if first else 1, fv=1)
                fixed[F.F_QCONST][r] = 1
                fixed[F.F_CONST][r] = payload
                self.em_rows["limbs"].append(r)
                r += 1
            else:  # hash limb: byte rows then limb row
                bhi_idx, blo_idx = payload
                set_flags(r, fpass=1)
                self.em_rows["bytes"][bhi_idx] = r
                self.copies.append(((ADVICE, self.COL_V, r),
                                    (INSTANCE, 0, bhi_idx)))
                r += 1
                set_flags(r, fpass=1)
                self.em_rows["bytes"][blo_idx] = r
                self.copies.append(((ADVICE, self.COL_V, r),
                                    (INSTANCE, 0, blo_idx)))
                r += 1
                set_flags(r, ftau=0 if first else 1, fv=1)
                fixed[F.F_QPACK][r] = 1
                self.em_rows["limbs"].append(r)
                r += 1
            first = False
        assert r == em.start + em.length

        # carry-top pinning: c'_{2L-1} (first row of clo/chi, MSB-first) = OFF
        for g in range(NUM_SQUARINGS + 1):
            for nm, val in (("clo", 0), ("chi", OFF >> B)):
                rr = self.regions[f"{nm}{g}"].start
                fixed[F.F_QCONST][rr] = 1
                fixed[F.F_CONST][rr] = val

        # ---------------- relation-row copies ----------------
        def rel_copy(g: int, slot: int, src_row: int):
            dst = self.regions[f"rel{g}"].start + slot
            self.copies.append(((ADVICE, self.COL_A, dst),
                                (ADVICE, self.COL_A, src_row)))

        ev = lambda name: self.regions[name].eval_row
        for g in range(NUM_SQUARINGS + 1):
            x_src = ev("sig") if g == 0 else ev(f"z{g-1}" if g - 1 < NUM_SQUARINGS
                                                else "em")
            if g == NUM_SQUARINGS:
                x_src = ev(f"z{g-1}")
            y_src = x_src if g < NUM_SQUARINGS else ev("sig")
            z_src = ev(f"z{g}") if g < NUM_SQUARINGS else ev("em")
            rel_copy(g, 0, x_src)
            rel_copy(g, 1, y_src)
            rel_copy(g, 2, ev(f"q{g}"))
            rel_copy(g, 3, z_src)
            rel_copy(g, 4, ev(f"clo{g}"))
            rel_copy(g, 5, ev(f"chi{g}"))
            rel_copy(g, 6, ev("mod"))
            rel_copy(g, 7, ev("ones"))

        self.cs = cs
        self.data = CircuitData(cs=cs, k=self.k, fixed=fixed,
                                copies=self.copies, num_instance=[32])
        self._build_phase1_program(fixed)

    def _build_phase1_program(self, fixed) -> None:
        """Static (per-circuit) arrays driving the DEVICE phase-1 witness.

        The A column is the affine recurrence A[r] = m[r]*A[r-1] + b[r]
        with m[r] in {0, 1, tau} (selected by F_PASS/F_TAU) and
        b[r] = fv*V[r] + fn*nval[r] + fone — a parallel prefix scan under
        the (m, b) composition monoid, replacing the reference-shaped
        host loop (halo2-base assigns cells sequentially [dep]; here
        the column is one scan program).  Relation rows (qh=0) are then
        scatter-filled from their source eval rows.
        """
        n = self.n
        F = self.__class__
        qh = np.asarray([int(x) for x in fixed[F.F_QH]], np.int32)
        fpass = np.asarray([int(x) for x in fixed[F.F_PASS]], np.int32)
        ftau = np.asarray([int(x) for x in fixed[F.F_TAU]], np.int32)
        fv = np.asarray([int(x) for x in fixed[F.F_V]], np.int32)
        fn_ = np.asarray([int(x) for x in fixed[F.F_N]], np.int32)
        fone = np.asarray([int(x) for x in fixed[F.F_ONE]], np.int32)
        nval = np.asarray([int(x) for x in fixed[F.F_NVAL]], np.int64)
        # m selector: 0 = zero, 1 = one, 2 = tau (never both flags set)
        self._msel = (qh * (fpass + 2 * ftau)).astype(np.int32)
        self._b_const = qh.astype(np.int64) * (fn_ * nval + fone)
        self._b_vmask = (qh * fv).astype(np.int64)
        dst, src = [], []
        ev = lambda name: self.regions[name].eval_row
        for g in range(NUM_SQUARINGS + 1):
            base = self.regions[f"rel{g}"].start
            x_src = ev("sig") if g == 0 else ev(f"z{g-1}")
            y_src = x_src if g < NUM_SQUARINGS else ev("sig")
            z_src = ev(f"z{g}") if g < NUM_SQUARINGS else ev("em")
            srcs = [x_src, y_src, ev(f"q{g}"), z_src, ev(f"clo{g}"),
                    ev(f"chi{g}"), ev("mod"), ev("ones")]
            for s, sr in enumerate(srcs):
                dst.append(base + s)
                src.append(sr)
        self._rel_dst = np.asarray(dst, np.int32)
        self._rel_src = np.asarray(src, np.int32)

    def _em_template(self) -> list:
        """EM limbs MSB-first: (limb_index, 'const'|'hash', payload).

        payload: const value, or (instance_byte_hi, instance_byte_lo).
        Instance bytes are digest bytes in big-endian order (index 0 = MSB),
        matching reference helpers.rs:166-167.
        """
        L = self.L
        k_bytes = self.nbits // 8
        em_const = pkcs1v15_sha256_em(b"\x00" * 32, k_bytes)  # zero-hash EM
        const_limbs = _limbs_of(em_const, L)
        out = []
        for i in range(L - 1, -1, -1):
            if i >= 16:
                out.append((i, "const", const_limbs[i]))
            else:
                # limb i bytes: lo = EM byte 2i = digest[31-2i], hi = digest[30-2i]
                out.append((i, "hash", (30 - 2 * i, 31 - 2 * i)))
        return out

    # ---------------------------------------------------------------- witness

    @trace.traced("witness")
    def witness(self, signature: int, digest: bytes, device="cuda"):
        """Witness program: phase-0 tape V (host ints) + phase-1
        accumulators A (device scan).  Returns a callable for
        `create_proof`, plus the instances.  The call is the span recorder's
        span `witness`; `create_proof` records each phase's call as
        another."""
        L, nmod = self.L, self.modulus
        n_rows = self.n
        V = [0] * n_rows

        def put(reg_name: str, vals_msb_first: list):
            reg = self.regions[reg_name]
            assert len(vals_msb_first) == reg.length
            for i, val in enumerate(vals_msb_first):
                V[reg.start + i] = val

        put("sig", list(reversed(_limbs_of(signature, L))))

        em_int = pkcs1v15_sha256_em(digest, self.nbits // 8)
        # chain m_{i+1} = m_i^2 mod n; last: em = m_16 * s mod n
        m = signature
        muls = []
        for g in range(NUM_SQUARINGS + 1):
            x = m
            y = m if g < NUM_SQUARINGS else signature
            z = x * y % nmod
            q = (x * y - z) // nmod
            muls.append((x, y, z, q))
            m = z
        assert m == pow(signature, (1 << 16) + 1, nmod)

        for g, (x, y, z, q) in enumerate(muls):
            xl = _limbs_of(x, L)
            yl = _limbs_of(y, L)
            zl = _limbs_of(z, L)
            ql = _limbs_of(q, L + 1)
            nl = _limbs_of(nmod, L)
            # d_k = conv(x,y)_k - conv(q,n)_k - z_k, k = 0..2L-1
            d = [0] * (2 * L)
            for i in range(L):
                for j in range(L):
                    d[i + j] += xl[i] * yl[j]
            for i in range(L + 1):
                for j in range(L):
                    d[i + j] -= ql[i] * nl[j]
            for i in range(L):
                d[i] -= zl[i]
            # synthetic division by (t - 2^B) from the top: c_{k-1} = d_k + 2^B c_k
            c = [0] * (2 * L)
            acc = 0
            for kk in range(2 * L - 1, 0, -1):
                acc = d[kk] + (1 << B) * acc
                c[kk - 1] = acc
            assert d[0] + (1 << B) * c[0] == 0, "mulmod identity failed"
            assert c[2 * L - 1] == 0
            cp = [ci + OFF for ci in c]
            assert all(0 <= ci < (1 << (B + 11)) for ci in cp), "carry overflow"
            put(f"q{g}", list(reversed(ql)))
            put(f"clo{g}", list(reversed([ci & ((1 << B) - 1) for ci in cp])))
            put(f"chi{g}", list(reversed([ci >> B for ci in cp])))
            if g < NUM_SQUARINGS:
                put(f"z{g}", list(reversed(_limbs_of(z, L))))
        assert muls[-1][2] == em_int % nmod
        assert muls[-1][2] == em_int, "final EM not canonical (z == em required)"

        # EM region values
        em = self.regions["em"]
        em_limbs = _limbs_of(em_int, L)
        for byte_idx, row in self.em_rows["bytes"].items():
            V[row] = digest[byte_idx]
        for i, row in enumerate(self.em_rows["limbs"]):
            V[row] = em_limbs[L - 1 - i]

        instances = [[digest[i] for i in range(32)]]

        def witness_fn(phase: int, challenges: dict):
            if phase == 0:
                col = torch.zeros((n_rows, 8), dtype=torch.int32)
                col[:, 0] = torch.from_numpy(np.asarray(V, dtype=np.int64))
                return {self.COL_V: col.to(device)}
            # phase 1: the A column is ONE device scan program (see
            # _build_phase1_program) instead of a host loop over 2^k rows.
            tau = challenges[0] % rc.FR
            b_ints = self._b_const + self._b_vmask * np.asarray(V, np.int64)
            b = torch.zeros((n_rows, 8), dtype=torch.int32)
            b[:, 0] = torch.from_numpy(b_ints)        # b < 2^17 + 2^8
            msel = torch.from_numpy(self._msel).to(device)[:, None]
            m = torch.where(msel == 1, field.one(device, (1,)),
                            torch.where(msel == 2,
                                        field.const(FR, tau, device)[None],
                                        torch.zeros_like(msel)))
            A = frops.affine_scan(m.contiguous(), b.to(device))
            dst = torch.from_numpy(self._rel_dst).long().to(device)
            src = torch.from_numpy(self._rel_src).long().to(device)
            A[dst] = A[src]
            return {self.COL_A: A}

        return witness_fn, instances

    @staticmethod
    def validate_instances(instances: list) -> None:
        """Host-side byte validation of the public inputs.

        The EM hash-byte rows are COPY-constrained to these instance
        values; their byte range is part of the public claim, so a
        verifier must reject instance vectors with entries >= 256 (the
        in-circuit 8-bit lookup this replaces was redundant for honest
        claims and cost a whole lookup argument per proof)."""
        assert len(instances) == 1 and len(instances[0]) == 32, \
            "RSA circuit expects one instance column of 32 digest bytes"
        for v in instances[0]:
            assert 0 <= int(v) < 256, f"instance byte out of range: {v}"

    def verify_host(self, signature: int, tbs: bytes) -> bool:
        """Host oracle shortcut (not the SNARK): sig^e mod n == EM."""
        digest = hashlib.sha256(tbs).digest()
        em = pkcs1v15_sha256_em(digest, self.nbits // 8)
        return pow(signature, (1 << 16) + 1, self.modulus) == em

"""In-circuit BN254 G1 arithmetic over bigint-tape handles.

Counterpart of halo2_zkcert_tpu/circuits/ecc_gadget.py, the same
recording operation for operation.

Reference behavior: halo2-ecc's `ecc` chip (Cargo.lock:1199 [dep]) —
affine point add/double/MSM with witnessed slopes — rebuilt on the
challenge-based tape (circuits/bigint_tape.py): each curve equation is ONE
mulmod relation instead of a page of per-limb gates.

Soundness notes (adversarial witnesses):
* every witnessed point gets an on-curve check  y^2 == x^3 + 3 (mod q);
* incomplete adds are STRICT: (x2 - x1) is proven nonzero via a witnessed
  inverse, so the chord equations force the exact sum (halo2-ecc's
  `ec_add_unequal(is_strict=true)` [dep] plays the same role);
* doubles need no y != 0 check: BN254 G1 has odd prime order, so no
  on-curve point has y = 0;
* the MSM offsets every window table by a distinct constant multiple of a
  fixed point H (and starts from C0), then subtracts the known aggregate
  offset once at the end — identity never appears for honest witnesses,
  and a dishonest collision makes some strict-add constraint unsatisfiable
  (proof rejected), never unsound.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..utils import refcrypto as rc
from .bigint_tape import BigintTape, FqVal


@dataclass(frozen=True)
class EcPoint:
    """Affine point; handles are bigint-tape FqVals.  Never the identity."""
    x: FqVal
    y: FqVal

    @property
    def value(self):
        return (self.x.value % rc.FQ, self.y.value % rc.FQ)


class EccGadget:
    def __init__(self, tape: BigintTape):
        assert tape.modulus == rc.FQ
        self.tape = tape
        self.gb = tape.gb

    # ---- point construction ---------------------------------------------------

    def witness_point(self, xy, check: bool = True) -> EcPoint:
        """Witness an affine point; constrain on-curve unless `check=False`
        (only for values already bound elsewhere)."""
        t = self.tape
        x = t.witness_elem(xy[0] % rc.FQ)
        y = t.witness_elem(xy[1] % rc.FQ)
        p = EcPoint(x, y)
        if check:
            self.assert_on_curve(p)
        return p

    def constant_point(self, xy) -> EcPoint:
        t = self.tape
        return EcPoint(t.constant_elem(xy[0] % rc.FQ, t.L),
                       t.constant_elem(xy[1] % rc.FQ, t.L))

    def assert_on_curve(self, p: EcPoint) -> None:
        t = self.tape
        x2 = t.mulmod(p.x, p.x)
        y2 = t.mulmod(p.y, p.y)
        # x*x2 == y2 - 3 + pad  <=>  y^2 = x^3 + 3
        t.assert_mul_eq(p.x, x2, t.sub(y2, t.constant_elem(3)))

    def assert_nonzero(self, a: FqVal) -> None:
        """a != 0 (mod q) via witnessed inverse."""
        t = self.tape
        inv = t.witness_elem(rc.finv(a.value % rc.FQ, rc.FQ))
        t.assert_mul_eq(a, inv, t.one_const)

    # ---- group law (incomplete affine, witnessed slopes) -----------------------

    def add(self, p: EcPoint, q: EcPoint, strict: bool = True) -> EcPoint:
        """p + q with p.x != q.x.  `strict` proves the inequality (required
        whenever an adversary could steer the operands into a collision)."""
        t = self.tape
        qm = rc.FQ
        x1, y1 = p.x.value % qm, p.y.value % qm
        x2, y2 = q.x.value % qm, q.y.value % qm
        dx = t.sub(q.x, p.x)
        if strict:
            self.assert_nonzero(dx)
        lam_v = (y2 - y1) * rc.finv((x2 - x1) % qm, qm) % qm
        lam = t.witness_elem(lam_v)
        x3_v = (lam_v * lam_v - x1 - x2) % qm
        y3_v = (lam_v * (x1 - x3_v) - y1) % qm
        x3 = t.witness_elem(x3_v)
        y3 = t.witness_elem(y3_v)
        # lam*(x2-x1) == y2-y1 ; lam^2 == x3+x1+x2 ; lam*(x1-x3) == y3+y1
        t.assert_mul_eq(lam, dx, t.sub(q.y, p.y))
        t.assert_mul_eq(lam, lam, t.lincomb([(x3, 1), (p.x, 1), (q.x, 1)]))
        t.assert_mul_eq(lam, t.sub(p.x, x3), t.add(y3, p.y))
        return EcPoint(x3, y3)

    def double(self, p: EcPoint) -> EcPoint:
        t = self.tape
        qm = rc.FQ
        x1, y1 = p.x.value % qm, p.y.value % qm
        lam_v = 3 * x1 * x1 * rc.finv(2 * y1 % qm, qm) % qm
        x3_v = (lam_v * lam_v - 2 * x1) % qm
        y3_v = (lam_v * (x1 - x3_v) - y1) % qm
        xx = t.mulmod(p.x, p.x)
        lam = t.witness_elem(lam_v)
        x3 = t.witness_elem(x3_v)
        y3 = t.witness_elem(y3_v)
        # lam*2y == 3x^2 ; lam^2 == x3+2x ; lam*(x-x3) == y3+y
        t.assert_mul_eq(lam, t.scale(p.y, 2), t.scale(xx, 3))
        t.assert_mul_eq(lam, lam, t.lincomb([(x3, 1), (p.x, 2)]))
        t.assert_mul_eq(lam, t.sub(p.x, x3), t.add(y3, p.y))
        return EcPoint(x3, y3)

    def neg_value(self, xy):
        return (xy[0], (rc.FQ - xy[1]) % rc.FQ)

    # ---- selection (free: builder eval-cell muxes) ------------------------------

    def select_fq(self, options: list, bits: list, sel: int) -> FqVal:
        """Mux 2^len(bits) FqVals by constrained bit cells.  The output
        eval-cell equals one committed region eval, so it remains a valid
        relation operand (bound = max over options)."""
        gb = self.gb
        cells = [o.eval_cell for o in options]
        vals = list(options)
        for b in bits:
            cells = [gb.select(b, cells[2 * i + 1], cells[2 * i])
                     for i in range(len(cells) // 2)]
        coeffs = vals[sel].coeffs
        bound = max(o.bound for o in options)
        width = max(len(o.coeffs) for o in options)
        coeffs = tuple(coeffs) + (0,) * (width - len(coeffs))
        return FqVal(coeffs, bound, cells[0])

    def select_point(self, options: list, bits: list, sel: int) -> EcPoint:
        return EcPoint(
            self.select_fq([o.x for o in options], bits, sel),
            self.select_fq([o.y for o in options], bits, sel))

    # ---- MSM --------------------------------------------------------------------

    def msm(self, points: list, scalar_cells: list, window: int = 4,
            nbits: int = 254) -> EcPoint:
        """sum_i s_i * P_i (s_i builder cells, P_i EcPoints).

        Strauss windowed with shared doubles; per-point window tables are
        offset by distinct constant points ((i+1)*H); the aggregate offset
        (known constant) is subtracted at the end.  `nbits` bounds the
        scalars (the window recomposition constrains s_i < 2^nbits; use the
        default 254 for arbitrary Fr scalars).
        """
        gb, t = self.gb, self.tape
        nwin = (nbits + window - 1) // window  # 64 for w=4, full width
        nopt = 1 << window

        # constant offsets (host-side points)
        H = rc.g1_mul(rc.g1_from_affine(rc.G1_GEN),
                      int.from_bytes(rc.blake2b(b"h2t-msm-offset", 32),
                                     "little") % rc.FR)
        C0 = rc.g1_mul(rc.g1_from_affine(rc.G1_GEN),
                       int.from_bytes(rc.blake2b(b"h2t-msm-acc0", 32),
                                      "little") % rc.FR)

        # scalar decomposition: nwin window cells, each `window` bits
        all_windows = []
        for s in scalar_cells:
            sv = s.value % rc.FR
            wins = []
            for j in range(nwin):
                wv = (sv >> (window * j)) & (nopt - 1)
                wc = gb.witness(wv)
                bits = []
                for bidx in range(window):
                    bc = gb.witness((wv >> bidx) & 1)
                    gb.assert_bit(bc)
                    bits.append(bc)
                # recompose window from bits
                acc = bits[-1]
                for bidx in range(window - 2, -1, -1):
                    acc = gb.mul_add(acc, gb.constant(2), bits[bidx])
                gb.assert_equal(acc, wc)
                wins.append((wc, bits, wv))
            # recompose scalar from windows (Horner, MSB-first)
            acc = wins[-1][0]
            for j in range(nwin - 2, -1, -1):
                acc = gb.mul_add(acc, gb.constant(nopt), wins[j][0])
            gb.assert_equal(acc, s)
            all_windows.append(wins)

        # per-point tables T_i[w] = Q_i + w*P_i, Q_i = (i+1)*H
        tables = []
        for i, p in enumerate(points):
            q_i = rc.g1_mul(H, i + 1)
            tbl = [self.constant_point(rc.g1_to_affine(q_i))]
            for w in range(1, nopt):
                tbl.append(self.add(tbl[-1], p, strict=True))
            tables.append(tbl)

        # main loop: windows MSB-first
        acc_pt = self.constant_point(rc.g1_to_affine(C0))
        for j in range(nwin - 1, -1, -1):
            if j != nwin - 1:
                for _ in range(window):
                    acc_pt = self.double(acc_pt)
            for i in range(len(points)):
                wc, bits, wv = all_windows[i][j]
                sel = self.select_point(tables[i], bits, wv)
                acc_pt = self.add(acc_pt, sel, strict=True)

        # subtract aggregate offset:
        #   acc = 2^(w*(nwin-1)) * C0 + sum_i s_i P_i + K * sum_i (i+1)*H,
        #   K = sum_j 2^(w*j)
        K = sum(1 << (window * j) for j in range(nwin)) % rc.FR
        m = len(points)
        corr = rc.g1_add(
            rc.g1_mul(C0, 1 << (window * (nwin - 1))),
            rc.g1_mul(H, K * (m * (m + 1) // 2) % rc.FR))
        neg_corr = rc.g1_neg(corr)
        return self.add(acc_pt,
                        self.constant_point(rc.g1_to_affine(neg_corr)),
                        strict=True)

"""The aggregation circuit as a layout: snarks verified inside one circuit
(each inner proof's PLONK verification recorded as vertical gates, its
commitments as G1 points on a 16-bit limb tape under a challenge), the
per-proof KZG pairs folded with a Poseidon challenge and the folded pair
exposed as 8 instances.

A frozen copy of the recording the program proves, step for step and cell
for cell, so that its constraint system, fixed columns and copies (in the
program's order, which the permutation's cycles follow) and its instances
are worked out here from the inner snarks: a trace builder with the gate
q (v[i] + v[i+1] v[i+2] - v[i+3]), a limb tape with Horner and relation
gates, G1 arithmetic with witnessed slopes, a Poseidon sponge over cells, a
loader that reads each inner proof through them, and the verifier they run.
Values are carried as the recording computes them: the instances are the
accumulator, the only thing a statement takes from them.
"""
from __future__ import annotations

from array import array
from typing import NamedTuple

import numpy as np

from . import bn254 as B
from . import poseidon
from .bn254 import FQ, FR, finv
from .plonk import ADVICE, FIXED, INSTANCE, Advice, Column, ConstraintSystem
from .plonk import Constant, Fixed, Instance, Challenge, Product, Scaled, Sum

CODES = {ADVICE: 0, FIXED: 1, INSTANCE: 2}
LIMB_BITS = 128
TAPE_LIMBS_PER_HALF = LIMB_BITS // 16
DUMMY_TAU = int.from_bytes(B.blake2b(b"h2t-dummy-tau", 32), "little") % FR


# ---- the trace builder ------------------------------------------------------

class Cell(NamedTuple):
    index: int
    value: int


class Builder:
    def __init__(self, lookup_bits: int = 16):
        self.values: list = []
        self.gate_rows = array("q")
        self.copy_a = array("q")
        self.copy_b = array("q")
        self.constants: dict = {}
        self.const_cells: list = []
        self.range_checked: list = []
        self.lookup_bits = lookup_bits
        self.instance_cells: list = []

    def witness(self, v: int) -> Cell:
        self.values.append(v % FR)
        return Cell(len(self.values) - 1, v % FR)

    def constant(self, c: int) -> Cell:
        c %= FR
        i = self.constants.get(c)
        if i is not None:
            return Cell(i, c)
        self.values.append(c)
        i = len(self.values) - 1
        self.constants[c] = i
        self.const_cells.append((i, c))
        return Cell(i, c)

    def _gate(self, a: Cell, b: Cell, c: Cell, out_val: int) -> Cell:
        values = self.values
        base = len(values)
        values += (a.value, b.value, c.value, out_val % FR)
        self.copy_a.extend((a.index, b.index, c.index))
        self.copy_b.extend((base, base + 1, base + 2))
        self.gate_rows.append(base)
        return Cell(base + 3, out_val % FR)

    def add(self, a, b):
        return self._gate(a, b, self.constant(1), a.value + b.value)

    def sub(self, a, b):
        return self._gate(a, b, self.constant(FR - 1), a.value - b.value)

    def mul(self, a, b):
        return self._gate(self.constant(0), a, b, a.value * b.value)

    def mul_add(self, a, b, c):
        return self._gate(c, a, b, c.value + a.value * b.value)

    def square(self, a):
        return self.mul(a, a)

    def add_const(self, a, c):
        return self.add(a, self.constant(c))

    def mul_const(self, a, c):
        return self.mul(a, self.constant(c))

    def pow5(self, a):
        a4 = self.square(self.square(a))
        return self.mul(a4, a)

    def assert_equal(self, a, b):
        self.copy_a.append(a.index)
        self.copy_b.append(b.index)

    def assert_const(self, a, c):
        self.assert_equal(a, self.constant(c))

    def assert_bit(self, a):
        self.assert_equal(self.square(a), a)

    def select(self, cond, a, b):
        return self.mul_add(cond, self.sub(a, b), b)

    def expose_public(self, a):
        self.instance_cells.append(a.index)

    def register(self, cs, na: int, nl: int, phase: int, table):
        adv = [cs.advice_column(phase=phase) for _ in range(na)]
        lk_adv = [cs.advice_column(phase=phase) for _ in range(nl)]
        inst = cs.instance_column() if self.instance_cells else None
        selectors = [cs.fixed_column() for _ in range(na)]
        f_const = cs.fixed_column()
        for j, col in enumerate(adv):
            def A(r, cj=col):
                return Advice(cj.index, r, phase=phase)
            cs.create_gate(f"vgate{col.index}",
                           selectors[j] * (A(0) + A(1) * A(2) - A(3)))
        for col in lk_adv:
            cs.add_lookup(f"range{col.index}",
                          [(Advice(col.index, phase=phase), table)])
        for col in adv + lk_adv:
            cs.enable_permutation(Column(ADVICE, col.index))
        cs.enable_permutation(Column(FIXED, f_const.index))
        if inst is not None:
            cs.enable_permutation(Column(INSTANCE, inst.index))
        return {"adv": adv, "lk_adv": lk_adv, "inst": inst,
                "selectors": selectors, "f_const": f_const}

    def pack(self, cs, cols: dict, n: int, fixed: np.ndarray, consts: dict):
        """Place the trace: writes the selectors into `fixed`, the constants
        into `consts` (column -> (rows, values)); -> (copies (m, 2, 3),
        each cell's (column index, row))."""
        adv, lk_adv = cols["adv"], cols["lk_adv"]
        na, nl = len(adv), len(lk_adv)
        usable = cs.usable_rows(n)
        count = len(self.values)
        gates = np.frombuffer(self.gate_rows, dtype=np.int64)
        starts, s = [], 0
        while s < count:
            starts.append(s)
            if len(starts) > na:
                raise ValueError("the trace needs more advice columns")
            nxt = s + usable
            g = np.searchsorted(gates, nxt - 3)
            if g < gates.size and gates[g] < nxt:
                nxt = int(gates[g])
            s = nxt
        starts = np.asarray(starts, dtype=np.int64)
        idx = np.arange(count, dtype=np.int64)
        col = np.searchsorted(starts, idx, side="right") - 1
        row = idx - starts[col]
        sel = np.array([c.index for c in cols["selectors"]], dtype=np.int64)
        fixed[sel[col[gates]], row[gates]] = 1
        if len(self.const_cells) > usable:
            raise ValueError("too many distinct constants")
        c_idx = np.array([i for i, _ in self.const_cells], dtype=np.int64)
        fc = cols["f_const"].index
        consts[fc] = (np.arange(c_idx.size),
                      [v for _, v in self.const_cells])
        rc_idx = np.array(self.range_checked, dtype=np.int64)
        lk_cur = np.arange(rc_idx.size, dtype=np.int64)
        if rc_idx.size and lk_cur[-1] // usable >= nl:
            raise ValueError("the trace needs more lookup columns")
        adv_index = np.array([c.index for c in adv], dtype=np.int64)
        lk_index = np.array([c.index for c in lk_adv], dtype=np.int64)

        def cells(kind, column, r):
            return np.stack([np.full(r.size, CODES[kind]), column, r], -1)

        def placed(i):
            return cells(ADVICE, adv_index[col[i]], row[i])

        ca = np.frombuffer(self.copy_a, dtype=np.int64)
        cb = np.frombuffer(self.copy_b, dtype=np.int64)
        pairs = [(placed(ca), placed(cb)),
                 (placed(c_idx), cells(FIXED, np.full(c_idx.size, fc),
                                       np.arange(c_idx.size))),
                 (placed(rc_idx), cells(ADVICE, lk_index[lk_cur // usable],
                                        lk_cur % usable))]
        if cols["inst"] is not None:
            i_idx = np.array(self.instance_cells, dtype=np.int64)
            pairs.append((placed(i_idx),
                          cells(INSTANCE, np.full(i_idx.size,
                                                  cols["inst"].index),
                                np.arange(i_idx.size))))
        copies = np.concatenate([np.stack(p, axis=1) for p in pairs])
        return copies, adv_index[col], row


# ---- the limb tape -----------------------------------------------------------

LB = 16
BASE = 1 << LB
OFF = 1 << 28
REL_SLOTS = 8
_KIND = {"w": 0, "c": 1, "rel": 2}


def int_to_coeffs(x: int, n: int) -> tuple:
    assert x >= 0 and x >> (LB * n) == 0
    return tuple((x >> (LB * i)) & (BASE - 1) for i in range(n))


class FqVal(NamedTuple):
    coeffs: tuple
    bound: int
    eval_cell: Cell
    region_idx: int | None = None

    @property
    def value(self) -> int:
        return sum(c << (LB * i) for i, c in enumerate(self.coeffs))

    @property
    def int_bound(self) -> int:
        return self.bound * ((1 << (LB * len(self.coeffs))) - 1) // (BASE - 1)


class Tape:
    def __init__(self, gb: Builder, tau: int, lanes: int):
        self.gb, self.tau, self.lanes = gb, tau % FR, lanes
        self.modulus = FQ
        self.L = (FQ.bit_length() + LB - 1) // LB
        self.rel_len = 2 * self.L + 4
        self.lane_rows = [0] * lanes
        self.kinds, self.lane_of, self.len_of = array("q"), array("q"), \
            array("q")
        self.copy_cells = array("q")
        self.lin_vals = array("q")
        self.limb_copies: list = []
        self._consts: dict = {}
        self._tau_pows = [1]
        self._n_limbs = np.asarray(int_to_coeffs(FQ, self.L), dtype=np.int64)
        self.n_const = self.constant_elem(FQ)
        self.ones_const = self._constant_coeffs((1,) * self.rel_len)
        self.one_const = self.constant_elem(1)

    def _lane(self) -> int:
        return min(range(self.lanes), key=lambda i: self.lane_rows[i])

    def _eval(self, coeffs) -> int:
        while len(self._tau_pows) < len(coeffs):
            self._tau_pows.append(self._tau_pows[-1] * self.tau % FR)
        return sum(c * self._tau_pows[i] for i, c in enumerate(coeffs)) % FR

    def _region(self, kind: str, coeffs: tuple) -> FqVal:
        cell = self.gb.witness(self._eval(coeffs))
        lane = self._lane()
        self.lane_rows[lane] += len(coeffs)
        self.kinds.append(_KIND[kind])
        self.lane_of.append(lane)
        self.len_of.append(len(coeffs))
        self.copy_cells.append(cell.index)
        self.lin_vals.extend(reversed(coeffs))
        bound = BASE - 1 if kind == "w" else max([abs(c) for c in coeffs]
                                                 or [0])
        return FqVal(coeffs, bound, cell, len(self.kinds) - 1)

    def limb_cells(self, v: FqVal) -> list:
        assert v.region_idx is not None and self.kinds[v.region_idx] == 0
        cells = []
        for i, coeff in enumerate(v.coeffs):
            c = self.gb.witness(coeff)
            self.limb_copies.append((v.region_idx, i, c.index))
            cells.append(c)
        return cells

    def witness_elem(self, value: int, nlimbs: int | None = None) -> FqVal:
        return self._region("w", int_to_coeffs(value, nlimbs or self.L))

    def _constant_coeffs(self, coeffs: tuple) -> FqVal:
        if coeffs not in self._consts:
            self._consts[coeffs] = self._region("c", coeffs)
        return self._consts[coeffs]

    def constant_elem(self, value: int, nlimbs: int | None = None) -> FqVal:
        n = nlimbs or max(1, (value.bit_length() + LB - 1) // LB)
        return self._constant_coeffs(int_to_coeffs(value, n))

    def lincomb(self, terms: list) -> FqVal:
        gb = self.gb
        width = max(len(a.coeffs) for a, _ in terms)
        coeffs = [0] * width
        bound = 0
        for a, c in terms:
            for i, x in enumerate(a.coeffs):
                coeffs[i] += c * x
            bound += abs(c) * a.bound
        acc = None
        for a, c in terms:
            if acc is None:
                acc = a.eval_cell if c == 1 else gb.mul_const(a.eval_cell, c)
            elif c == 1:
                acc = gb.add(acc, a.eval_cell)
            else:
                acc = gb.mul_add(a.eval_cell, gb.constant(c % FR), acc)
        return FqVal(tuple(coeffs), bound, acc)

    def add(self, a, b):
        return self.lincomb([(a, 1), (b, 1)])

    def sub(self, a, b):
        pad = (b.int_bound // FQ + 1) * FQ
        return self.lincomb([(a, 1), (b, -1), (self.constant_elem(pad), 1)])

    def scale(self, a, c):
        return self.lincomb([(a, c)])

    def assert_mul_eq(self, x: FqVal, y: FqVal, z: FqVal) -> None:
        N = FQ
        diff = x.value * y.value - z.value
        assert diff % N == 0, "mul relation does not hold"
        qmax = x.int_bound * y.int_bound // N + 1
        qoff = z.int_bound // N + 1
        nq = max(1, ((qmax + qoff).bit_length() + LB - 1) // LB)
        qp_v = self._region("w", int_to_coeffs(diff // N + qoff, nq))
        qoff_v = self.constant_elem(qoff, nq)
        q_eff = self.gb.sub(qp_v.eval_cell, qoff_v.eval_cell)
        q_coeffs = [a - b for a, b in zip(qp_v.coeffs,
                                          qoff_v.coeffs + (0,) * nq)]
        ln = self.rel_len
        d = np.zeros(ln + 1, dtype=np.int64)
        cxy = np.convolve(np.asarray(x.coeffs, dtype=np.int64),
                          np.asarray(y.coeffs, dtype=np.int64))
        d[:len(cxy)] += cxy
        cqn = np.convolve(np.asarray(q_coeffs, dtype=np.int64), self._n_limbs)
        d[:len(cqn)] -= cqn
        d[:len(z.coeffs)] -= np.asarray(z.coeffs, dtype=np.int64)
        d = d.tolist()
        c, acc = [0] * ln, 0
        for k in range(ln, 0, -1):
            acc = d[k] + (acc << LB)
            c[k - 1] = acc
        cp = [ci + OFF for ci in c]
        clo = self._region("w", tuple(ci & (BASE - 1) for ci in cp))
        chi = self._region("w", tuple(ci >> LB for ci in cp))
        slots = (x.eval_cell.index, y.eval_cell.index, q_eff.index,
                 z.eval_cell.index, clo.eval_cell.index, chi.eval_cell.index,
                 self.n_const.eval_cell.index,
                 self.ones_const.eval_cell.index)
        lane = self._lane()
        self.lane_rows[lane] += REL_SLOTS
        self.kinds.append(_KIND["rel"])
        self.lane_of.append(lane)
        self.len_of.append(REL_SLOTS)
        self.copy_cells.extend(slots)

    def mulmod(self, x, y):
        z = self.witness_elem(x.value * y.value % FQ)
        self.assert_mul_eq(x, y, z)
        return z

    def register(self, cs, tau):
        v_cols = [cs.advice_column(phase=0) for _ in range(self.lanes)]
        a_cols = [cs.advice_column(phase=1) for _ in range(self.lanes)]
        table = cs.fixed_column()
        flags = []
        for ln in range(self.lanes):
            fl = [cs.fixed_column() for _ in range(6)]
            q_h, f_pass, f_tau, f_v, f_cval, q_rel = fl
            flags.append(fl)
            a, v = a_cols[ln], v_cols[ln]
            a_prev = Advice(a.index, -1, phase=1)

            def A(r, _a=a):
                return Advice(_a.index, r, phase=1)

            cs.create_gate(f"tape_horner{ln}",
                           q_h * (A(0) - f_pass * a_prev
                                  - f_tau * (a_prev * tau) - f_v * v - f_cval))
            rel = (A(0) * A(1) - A(2) * A(6) - A(3)
                   - (tau - BASE) * (A(4) + BASE * A(5) - OFF * A(7)))
            cs.create_gate(f"tape_rel{ln}", q_rel * rel)
            cs.add_lookup(f"tape_range{ln}", [(v, table)])
            cs.enable_permutation(Column(ADVICE, a.index))
            cs.enable_permutation(Column(ADVICE, v.index))
        return {"v_cols": v_cols, "a_cols": a_cols, "table": table,
                "flags": flags}

    def place(self, cs, cols: dict, n: int, fixed: np.ndarray,
              cell_col: np.ndarray, cell_row: np.ndarray) -> np.ndarray:
        """Lay the regions out a lane at a time from row 1; write the tape's
        fixed columns into `fixed`; -> the copies (m, 2, 3): each region's
        evaluation row or relation rows against the builder cells they copy
        (placed at `cell_col`, `cell_row`), then the limb mirrors."""
        lane = np.frombuffer(self.lane_of, dtype=np.int64)
        length = np.frombuffer(self.len_of, dtype=np.int64)
        kind = np.frombuffer(self.kinds, dtype=np.int64)
        start = np.empty_like(length)
        for ln in range(self.lanes):
            m = lane == ln
            ends = 1 + np.cumsum(length[m])
            start[m] = ends - length[m]
            if ends.size and int(ends[-1]) > cs.usable_rows(n):
                raise ValueError("tape lanes overflow the usable rows")
        usable = cs.usable_rows(n)
        fl = np.array([[c.index for c in f] for f in cols["flags"]],
                      dtype=np.int64)
        q_h, f_tau, f_v, f_cval, q_rel = (fl[:, j] for j in (0, 2, 3, 4, 5))
        row_reg = np.repeat(np.arange(kind.size), length)
        first = np.cumsum(length) - length
        pos = np.arange(row_reg.size) - first[row_reg]
        rows = start[row_reg] + pos
        row_lane, row_kind = lane[row_reg], kind[row_reg]
        lin, rel = row_kind < 2, row_kind == 2
        lin_vals = np.frombuffer(self.lin_vals, dtype=np.int64)
        fixed[cols["table"].index, :BASE] = np.arange(BASE)
        fixed[q_h, :usable] = 1
        fixed[q_h[row_lane[rel]], rows[rel]] = 0
        step = lin & (pos > 0)
        fixed[f_tau[row_lane[step]], rows[step]] = 1
        w_rows = row_kind == 0
        fixed[f_v[row_lane[w_rows]], rows[w_rows]] = 1
        c_rows = row_kind[lin] == 1
        fixed[f_cval[row_lane[lin][c_rows]], rows[lin][c_rows]] = \
            lin_vals[c_rows]
        rel_start = rel & (pos == 0)
        fixed[q_rel[row_lane[rel_start]], rows[rel_start]] = 1

        a_col = np.array([c.index for c in cols["a_cols"]], dtype=np.int64)
        v_col = np.array([c.index for c in cols["v_cols"]], dtype=np.int64)
        take = (lin & (pos == length[row_reg] - 1)) | rel
        b_idx = np.frombuffer(self.copy_cells, dtype=np.int64)
        code = CODES[ADVICE]

        def builder(idx):
            return np.stack([np.full(idx.size, code), cell_col[idx],
                             cell_row[idx]], -1)

        tape_side = np.stack([np.full(b_idx.size, code),
                              a_col[row_lane[take]], rows[take]], -1)
        pairs = [np.stack([tape_side, builder(b_idx)], axis=1)]
        if self.limb_copies:
            lc = np.array(self.limb_copies, dtype=np.int64)
            reg = lc[:, 0]
            mirror = np.stack([np.full(reg.size, code), v_col[lane[reg]],
                               start[reg] + length[reg] - 1 - lc[:, 1]], -1)
            pairs.append(np.stack([mirror, builder(lc[:, 2])], axis=1))
        return np.concatenate(pairs)


# ---- G1 over the tape -------------------------------------------------------

class EcPoint(NamedTuple):
    x: FqVal
    y: FqVal


def _g1(xy):
    return B.g1_from_affine(xy)


class Ecc:
    def __init__(self, tape: Tape):
        self.t, self.gb = tape, tape.gb

    def witness_point(self, xy, check=True):
        t = self.t
        p = EcPoint(t.witness_elem(xy[0] % FQ), t.witness_elem(xy[1] % FQ))
        if check:
            x2, y2 = t.mulmod(p.x, p.x), t.mulmod(p.y, p.y)
            t.assert_mul_eq(p.x, x2, t.sub(y2, t.constant_elem(3)))
        return p

    def constant_point(self, xy):
        t = self.t
        return EcPoint(t.constant_elem(xy[0] % FQ, t.L),
                       t.constant_elem(xy[1] % FQ, t.L))

    def add(self, p, q, strict=True):
        t = self.t
        x1, y1 = p.x.value % FQ, p.y.value % FQ
        x2, y2 = q.x.value % FQ, q.y.value % FQ
        dx = t.sub(q.x, p.x)
        if strict:
            inv = t.witness_elem(finv(dx.value % FQ, FQ))
            t.assert_mul_eq(dx, inv, t.one_const)
        lam_v = (y2 - y1) * finv((x2 - x1) % FQ, FQ) % FQ
        lam = t.witness_elem(lam_v)
        x3_v = (lam_v * lam_v - x1 - x2) % FQ
        y3_v = (lam_v * (x1 - x3_v) - y1) % FQ
        x3, y3 = t.witness_elem(x3_v), t.witness_elem(y3_v)
        t.assert_mul_eq(lam, dx, t.sub(q.y, p.y))
        t.assert_mul_eq(lam, lam, t.lincomb([(x3, 1), (p.x, 1), (q.x, 1)]))
        t.assert_mul_eq(lam, t.sub(p.x, x3), t.add(y3, p.y))
        return EcPoint(x3, y3)

    def double(self, p):
        t = self.t
        x1, y1 = p.x.value % FQ, p.y.value % FQ
        lam_v = 3 * x1 * x1 * finv(2 * y1 % FQ, FQ) % FQ
        x3_v = (lam_v * lam_v - 2 * x1) % FQ
        y3_v = (lam_v * (x1 - x3_v) - y1) % FQ
        xx = t.mulmod(p.x, p.x)
        lam = t.witness_elem(lam_v)
        x3, y3 = t.witness_elem(x3_v), t.witness_elem(y3_v)
        t.assert_mul_eq(lam, t.scale(p.y, 2), t.scale(xx, 3))
        t.assert_mul_eq(lam, lam, t.lincomb([(x3, 1), (p.x, 2)]))
        t.assert_mul_eq(lam, t.sub(p.x, x3), t.add(y3, p.y))
        return EcPoint(x3, y3)

    def _select_fq(self, options, bits, sel):
        gb = self.gb
        cells = [o.eval_cell for o in options]
        for b in bits:
            cells = [gb.select(b, cells[2 * i + 1], cells[2 * i])
                     for i in range(len(cells) // 2)]
        width = max(len(o.coeffs) for o in options)
        coeffs = tuple(options[sel].coeffs) + (0,) * (
            width - len(options[sel].coeffs))
        return FqVal(coeffs, max(o.bound for o in options), cells[0])

    def msm(self, points, scalar_cells, window=4, nbits=254):
        gb = self.gb
        nwin = (nbits + window - 1) // window
        nopt = 1 << window
        G = _g1(B.G1_GEN)
        H = B.g1_mul(G, int.from_bytes(B.blake2b(b"h2t-msm-offset", 32),
                                       "little") % FR)
        C0 = B.g1_mul(G, int.from_bytes(B.blake2b(b"h2t-msm-acc0", 32),
                                        "little") % FR)
        all_windows = []
        for s in scalar_cells:
            sv = s.value % FR
            wins = []
            for j in range(nwin):
                wv = (sv >> (window * j)) & (nopt - 1)
                wc = gb.witness(wv)
                bits = []
                for bidx in range(window):
                    bc = gb.witness((wv >> bidx) & 1)
                    gb.assert_bit(bc)
                    bits.append(bc)
                acc = bits[-1]
                for bidx in range(window - 2, -1, -1):
                    acc = gb.mul_add(acc, gb.constant(2), bits[bidx])
                gb.assert_equal(acc, wc)
                wins.append((wc, bits, wv))
            acc = wins[-1][0]
            for j in range(nwin - 2, -1, -1):
                acc = gb.mul_add(acc, gb.constant(nopt), wins[j][0])
            gb.assert_equal(acc, s)
            all_windows.append(wins)
        tables = []
        for i, p in enumerate(points):
            tbl = [self.constant_point(B.g1_to_affine(B.g1_mul(H, i + 1)))]
            for _ in range(1, nopt):
                tbl.append(self.add(tbl[-1], p))
            tables.append(tbl)
        acc_pt = self.constant_point(B.g1_to_affine(C0))
        for j in range(nwin - 1, -1, -1):
            if j != nwin - 1:
                for _ in range(window):
                    acc_pt = self.double(acc_pt)
            for i in range(len(points)):
                _, bits, wv = all_windows[i][j]
                opts = tables[i]
                sel = EcPoint(self._select_fq([o.x for o in opts], bits, wv),
                              self._select_fq([o.y for o in opts], bits, wv))
                acc_pt = self.add(acc_pt, sel)
        K = sum(1 << (window * j) for j in range(nwin)) % FR
        m = len(points)
        corr = B.g1_add(B.g1_mul(C0, 1 << (window * (nwin - 1))),
                        B.g1_mul(H, K * (m * (m + 1) // 2) % FR))
        return self.add(acc_pt, self.constant_point(
            B.g1_to_affine(B.g1_neg(corr))))


# ---- Poseidon over cells -----------------------------------------------------

def _permute_cells(gb, state):
    rcs, mds = poseidon.constants()
    half = poseidon.R_F // 2
    s = list(state)
    for r in range(poseidon.R_F + poseidon.R_P):
        s = [gb.add_const(s[i], rcs[r][i]) for i in range(poseidon.T)]
        if half <= r < half + poseidon.R_P:
            s[0] = gb.pow5(s[0])
        else:
            s = [gb.pow5(x) for x in s]
        new = []
        for i in range(poseidon.T):
            acc = gb.mul_const(s[0], mds[i][0])
            for j in range(1, poseidon.T):
                acc = gb.mul_add(s[j], gb.constant(mds[i][j]), acc)
            new.append(acc)
        s = new
    return s


class Sponge:
    def __init__(self, gb):
        self.gb = gb
        self.state = [gb.constant(1 << 64), gb.constant(0), gb.constant(0)]
        self.buf: list = []

    def update(self, cells):
        self.buf.extend(cells)

    def squeeze(self):
        gb = self.gb
        inputs = self.buf + [gb.constant(1)]
        self.buf = []
        for off in range(0, len(inputs), poseidon.RATE):
            for i, c in enumerate(inputs[off:off + poseidon.RATE]):
                self.state[i + 1] = gb.add(self.state[i + 1], c)
            self.state = _permute_cells(gb, self.state)
        return self.state[1]


# ---- the inner verifier, read through cells -------------------------------------

class Loader:
    """An inner proof's verification as cells (fixed-vk mode: the inner
    key's commitments and transcript value are constants; an identity
    commitment adds nothing and is left out)."""

    def __init__(self, gb, tape, ecc, vk, instances, proof):
        self.gb, self.tape, self.ecc = gb, tape, ecc
        self.vk, self.instances, self.proof = vk, instances, proof
        self.pos = 0
        self.sponge = Sponge(gb)
        self._inst_cells: dict = {}
        self._const_pts: dict = {}

    def s_const(self, v):
        return self.gb.constant(v % FR)

    def s_add(self, a, b):
        return self.gb.add(a, b)

    def s_sub(self, a, b):
        return self.gb.sub(a, b)

    def s_mul(self, a, b):
        return self.gb.mul(a, b)

    def s_inv(self, a):
        gb = self.gb
        inv = gb.witness(finv(a.value, FR))
        gb.assert_const(gb.mul(a, inv), 1)
        return inv

    def instance_scalar(self, col, row):
        key = (col, row)
        if key not in self._inst_cells:
            self._inst_cells[key] = self.gb.witness(
                self.instances[col][row] % FR)
        return self._inst_cells[key]

    def t_common_scalar(self, s):
        self.sponge.update([s])

    def t_read_scalar(self):
        raw = self.proof[self.pos:self.pos + 32]
        self.pos += 32
        v = int.from_bytes(raw, "little")
        if v >= FR:
            raise ValueError("non-canonical scalar in an inner proof")
        c = self.gb.witness(v)
        self.sponge.update([c])
        return c

    def _packed_halves(self, pt):
        gb, t = self.gb, self.tape
        H = TAPE_LIMBS_PER_HALF
        out = []
        for coord in (pt.x, pt.y):
            cells = t.limb_cells(coord)
            for half in (cells[:H], cells[H:2 * H]):
                acc = half[-1]
                for c in reversed(half[:-1]):
                    acc = gb.mul_add(acc, gb.constant(1 << 16), c)
                out.append(acc)
        return out

    def t_read_point(self):
        raw = self.proof[self.pos:self.pos + 32]
        self.pos += 32
        pt = self.ecc.witness_point(B.g1_decompress(raw), check=True)
        self.sponge.update(self._packed_halves(pt))
        return pt

    def t_squeeze(self):
        return self.sponge.squeeze()

    def t_binder(self):
        return self.sponge.squeeze()

    def _const_point(self, xy):
        if xy not in self._const_pts:
            self._const_pts[xy] = self.ecc.constant_point(xy)
        return self._const_pts[xy]

    def _vk_terms(self, comms, i):
        if comms[i] == (0, 0):
            return []
        return [(self._const_point(comms[i]), None)]

    def _resolve(self, comm):
        if isinstance(comm, tuple) and comm and comm[0] == "vk_fixed":
            return self._vk_terms(self.vk.fixed_commitments, comm[1])
        if isinstance(comm, tuple) and comm and comm[0] == "vk_sigma":
            return self._vk_terms(self.vk.permutation_commitments, comm[1])
        if isinstance(comm, tuple) and comm and comm[0] == "h_collapsed":
            _, pts, xn = comm
            out, power = [], None
            for pt in pts:
                out.append((pt, power))
                power = xn if power is None else self.gb.mul(power, xn)
            return out
        return [(comm, None)]

    def p_acc(self, acc, comm, scalar):
        for pt, coeff in self._resolve(comm):
            acc.append((pt, scalar if coeff is None
                        else self.gb.mul(scalar, coeff)))
        return acc

    def p_acc_generator(self, acc, scalar):
        acc.append((self._const_point(B.G1_GEN), scalar))
        return acc

    def final_check(self, w_open, acc, z0_inv, u):
        z0 = self.s_inv(z0_inv)
        return [(w_open, z0)], list(acc) + [(w_open, self.gb.mul(u, z0))]


def _evaluate(e, L, leaf, cache):
    hit = cache.get(e)
    if hit is not None:
        return hit
    if isinstance(e, Constant):
        v = L.s_const(e.value % FR)
    elif isinstance(e, (Fixed, Advice, Instance, Challenge)):
        v = leaf(e)
    elif isinstance(e, Sum):
        v = L.s_add(_evaluate(e.a, L, leaf, cache),
                    _evaluate(e.b, L, leaf, cache))
    elif isinstance(e, Product):
        v = L.s_mul(_evaluate(e.a, L, leaf, cache),
                    _evaluate(e.b, L, leaf, cache))
    elif isinstance(e, Scaled):
        v = L.s_mul(_evaluate(e.a, L, leaf, cache), L.s_const(e.scalar % FR))
    else:
        raise TypeError(f"unknown expression {e!r}")
    cache[e] = v
    return v


def verify_core(L, vk, num_instance_rows: list):
    """The inner proof's PLONK and SHPLONK verification as cells; -> its
    KZG pair's (lhs terms, rhs terms)."""
    cs = vk.cs
    n = 1 << vk.k
    omega = B.root_of_unity(vk.k)
    omega_inv = finv(omega, FR)
    bf = cs.blinding_factors()
    u_row = n - bf - 1
    chunk_len, num_chunks = cs.chunk_len(), cs.num_chunks()
    fixed_queries, advice_queries = cs.queries[0], cs.queries[1]
    num_sigmas = len(cs.permutation_columns)
    one = L.s_const(1)

    def s_pow(base, e):
        acc, b = None, base
        while e:
            if e & 1:
                acc = b if acc is None else L.s_mul(acc, b)
            b = L.s_mul(b, b)
            e >>= 1
        return acc if acc is not None else one

    L.t_common_scalar(L.s_const(vk.transcript_repr()))
    for col, rows in enumerate(num_instance_rows):
        for r in range(rows):
            L.t_common_scalar(L.instance_scalar(col, r))
    advice_commits = [None] * cs.num_advice
    challenges = {}
    for phase in range(cs.num_phases):
        for i in range(cs.num_advice):
            if cs.advice_phases[i] == phase:
                advice_commits[i] = L.t_read_point()
        for ci, cp in enumerate(cs.challenge_phases):
            if cp == phase:
                challenges[ci] = L.t_squeeze()
    theta = L.t_squeeze()
    lookup_permuted = [(L.t_read_point(), L.t_read_point())
                       for _ in cs.lookups]
    beta = L.t_squeeze()
    gamma = L.t_squeeze()
    perm_z_commits = [L.t_read_point() for _ in range(num_chunks)]
    lookup_z_commits = [L.t_read_point() for _ in cs.lookups]
    random_commit = L.t_read_point()
    y = L.t_squeeze()
    h_commits = [L.t_read_point() for _ in range(cs.quotient_degree)]
    x = L.t_squeeze()
    xn = s_pow(x, n)
    advice_evals = [L.t_read_scalar() for _ in advice_queries]
    fixed_evals = [L.t_read_scalar() for _ in fixed_queries]
    random_eval = L.t_read_scalar()
    sigma_evals = [L.t_read_scalar() for _ in range(num_sigmas)]
    perm_z = [{"x": L.t_read_scalar(), "next": L.t_read_scalar()}
              for _ in range(num_chunks)]
    for c in range(num_chunks - 1):
        perm_z[c]["last"] = L.t_read_scalar()
    lookup_evals = [{"z": L.t_read_scalar(), "z_next": L.t_read_scalar(),
                     "a": L.t_read_scalar(), "a_prev": L.t_read_scalar(),
                     "s": L.t_read_scalar()} for _ in cs.lookups]

    zh = L.s_sub(xn, one)
    n_inv = L.s_const(finv(n, FR))

    def instance_eval(col, rot):
        z = L.s_mul(x, L.s_const(pow(omega if rot >= 0 else omega_inv,
                                     abs(rot), FR)))
        acc = None
        for i in range(num_instance_rows[col]):
            wi = L.s_const(pow(omega, i, FR))
            term = L.s_mul(L.s_mul(L.instance_scalar(col, i), wi),
                           L.s_inv(L.s_sub(z, wi)))
            acc = term if acc is None else L.s_add(acc, term)
        if acc is None:
            return L.s_const(0)
        return L.s_mul(L.s_mul(L.s_sub(s_pow(z, n), one), n_inv), acc)

    inst_cache: dict = {}

    def instance_cached(col, rot):
        if (col, rot) not in inst_cache:
            inst_cache[(col, rot)] = instance_eval(col, rot)
        return inst_cache[(col, rot)]

    adv_map = dict(zip(advice_queries, advice_evals))
    fix_map = dict(zip(fixed_queries, fixed_evals))

    def leaf(e):
        if isinstance(e, Fixed):
            return fix_map[(e.index, e.rotation)]
        if isinstance(e, Advice):
            return adv_map[(e.index, e.rotation)]
        if isinstance(e, Instance):
            return instance_cached(e.index, e.rotation)
        return challenges[e.index]

    def eval_expr(e):
        return _evaluate(e, L, leaf, {})

    def l_i(i):
        wi = L.s_const(pow(omega, i, FR))
        return L.s_mul(L.s_mul(zh, L.s_mul(wi, n_inv)),
                       L.s_inv(L.s_sub(x, wi)))

    l0, l_last = l_i(0), l_i(u_row)
    l_blind = None
    for i in range(u_row + 1, n):
        t = l_i(i)
        l_blind = t if l_blind is None else L.s_add(l_blind, t)
    active = L.s_sub(L.s_sub(one, l_last), l_blind)

    exprs = [eval_expr(g) for _, g in cs.gates]
    if num_chunks:
        exprs.append(L.s_mul(l0, L.s_sub(one, perm_z[0]["x"])))
        zl = perm_z[-1]["x"]
        exprs.append(L.s_mul(l_last, L.s_sub(L.s_mul(zl, zl), zl)))
        for c in range(1, num_chunks):
            exprs.append(L.s_mul(l0, L.s_sub(perm_z[c]["x"],
                                             perm_z[c - 1]["last"])))

        def col_eval(col):
            if col.kind == ADVICE:
                return adv_map[(col.index, 0)]
            if col.kind == FIXED:
                return fix_map[(col.index, 0)]
            return instance_cached(col.index, 0)

        for ci in range(num_chunks):
            chunk = cs.permutation_columns[ci * chunk_len:(ci + 1) * chunk_len]
            left, right = perm_z[ci]["next"], perm_z[ci]["x"]
            for p, col in enumerate(chunk):
                gpos = ci * chunk_len + p
                v = col_eval(col)
                left = L.s_mul(left, L.s_add(L.s_add(
                    v, L.s_mul(beta, sigma_evals[gpos])), gamma))
                right = L.s_mul(right, L.s_add(L.s_add(
                    v, L.s_mul(L.s_const(pow(B.DELTA, gpos, FR)),
                               L.s_mul(beta, x))), gamma))
            exprs.append(L.s_mul(active, L.s_sub(left, right)))
    for lk, le in zip(cs.lookups, lookup_evals):
        a_comp = s_comp = None
        for p_in, _ in lk.pairs:
            v = eval_expr(p_in)
            a_comp = v if a_comp is None else L.s_add(L.s_mul(a_comp, theta),
                                                      v)
        for _, p_tab in lk.pairs:
            v = eval_expr(p_tab)
            s_comp = v if s_comp is None else L.s_add(L.s_mul(s_comp, theta),
                                                      v)
        exprs.append(L.s_mul(l0, L.s_sub(one, le["z"])))
        exprs.append(L.s_mul(l_last, L.s_sub(L.s_mul(le["z"], le["z"]),
                                             le["z"])))
        lhs = L.s_mul(L.s_mul(le["z_next"], L.s_add(le["a"], beta)),
                      L.s_add(le["s"], gamma))
        rhs = L.s_mul(L.s_mul(le["z"], L.s_add(a_comp, beta)),
                      L.s_add(s_comp, gamma))
        exprs.append(L.s_mul(active, L.s_sub(lhs, rhs)))
        exprs.append(L.s_mul(l0, L.s_sub(le["a"], le["s"])))
        exprs.append(L.s_mul(L.s_mul(active, L.s_sub(le["a"], le["s"])),
                             L.s_sub(le["a"], le["a_prev"])))
    h_eval = None
    for e in exprs:
        h_eval = e if h_eval is None else L.s_add(L.s_mul(h_eval, y), e)
    expected_h = L.s_mul(h_eval, L.s_inv(zh))

    rot_cache = {}

    def point_scalar(rot):
        if rot not in rot_cache:
            rot_cache[rot] = L.s_mul(x, L.s_const(pow(omega, rot % n, FR)))
        return rot_cache[rot]

    queries = []
    for j, (i, r) in enumerate(advice_queries):
        queries.append((advice_commits[i], r, advice_evals[j], f"advice{i}"))
    for c in range(num_chunks):
        queries.append((perm_z_commits[c], 0, perm_z[c]["x"], f"perm_z{c}"))
        queries.append((perm_z_commits[c], 1, perm_z[c]["next"],
                        f"perm_z{c}"))
        if c != num_chunks - 1:
            queries.append((perm_z_commits[c], u_row, perm_z[c]["last"],
                            f"perm_z{c}"))
    for li, le in enumerate(lookup_evals):
        a_c, s_c = lookup_permuted[li]
        queries += [(lookup_z_commits[li], 0, le["z"], f"lookup{li}_z"),
                    (lookup_z_commits[li], 1, le["z_next"], f"lookup{li}_z"),
                    (a_c, 0, le["a"], f"lookup{li}_a"),
                    (a_c, -1, le["a_prev"], f"lookup{li}_a"),
                    (s_c, 0, le["s"], f"lookup{li}_s")]
    for j, (i, r) in enumerate(fixed_queries):
        queries.append((("vk_fixed", i), r, fixed_evals[j], f"fixed{i}"))
    for gpos in range(num_sigmas):
        queries.append((("vk_sigma", gpos), 0, sigma_evals[gpos],
                        f"sigma{gpos}"))
    queries.append((random_commit, 0, random_eval, "random"))
    queries.append((("h_collapsed", h_commits, xn), 0, expected_h, "h"))

    by_poly, poly_order = {}, []
    for comm, rot, evl, name in queries:
        if name not in by_poly:
            by_poly[name] = {}
            poly_order.append(name)
        by_poly[name][rot] = (comm, evl)
    sets, set_order = {}, []
    for name in poly_order:
        rots = tuple(sorted(by_poly[name]))
        if rots not in sets:
            sets[rots] = []
            set_order.append(rots)
        sets[rots].append(name)
    super_rots = []
    for rots in set_order:
        for r in rots:
            if r not in super_rots:
                super_rots.append(r)
    yv = L.t_squeeze()
    combined = []
    for rots in set_order:
        evs, comms, yk, first = [None] * len(rots), [], one, True
        for name in sets[rots]:
            comms.append((by_poly[name][rots[0]][0], yk))
            for t, rr in enumerate(rots):
                term = by_poly[name][rr][1] if first else \
                    L.s_mul(yk, by_poly[name][rr][1])
                evs[t] = term if evs[t] is None else L.s_add(evs[t], term)
            yk = L.s_mul(yk, yv)
            first = False
        combined.append((rots, comms, evs))
    v = L.t_squeeze()
    h_open = L.t_read_point()
    u = L.t_squeeze()

    def z_eval(subset):
        acc = None
        for rr in subset:
            t = L.s_sub(u, point_scalar(rr))
            acc = t if acc is None else L.s_mul(acc, t)
        return acc if acc is not None else one

    zt_eval = z_eval(super_rots)

    def r_u(rots, evs):
        acc = None
        for i, ri in enumerate(rots):
            xi = point_scalar(ri)
            num = den = None
            for j, rj in enumerate(rots):
                if i == j:
                    continue
                xj = point_scalar(rj)
                tn, td = L.s_sub(u, xj), L.s_sub(xi, xj)
                num = tn if num is None else L.s_mul(num, tn)
                den = td if den is None else L.s_mul(den, td)
            term = evs[i]
            if num is not None:
                term = L.s_mul(term, L.s_mul(num, L.s_inv(den)))
            acc = term if acc is None else L.s_add(acc, term)
        return acc

    acc, const_acc, vk_pow, z_diff_0, first_set = [], None, one, None, True
    for rots, comms, evs in combined:
        z_i = z_eval([rr for rr in super_rots if rr not in rots])
        if z_diff_0 is None:
            z_diff_0 = z_i
        w = z_i if first_set else L.s_mul(vk_pow, z_i)
        for comm, yk in comms:
            acc = L.p_acc(acc, comm, L.s_mul(w, yk))
        t = L.s_mul(w, r_u(rots, evs))
        const_acc = t if const_acc is None else L.s_add(const_acc, t)
        vk_pow = L.s_mul(vk_pow, v)
        first_set = False
    minus1 = L.s_const(FR - 1)
    acc = L.p_acc_generator(acc, L.s_mul(const_acc, minus1))
    acc = L.p_acc(acc, h_open, L.s_mul(zt_eval, minus1))
    z0_inv = L.s_inv(z_diff_0)
    return L.final_check(L.t_read_point(), acc, z0_inv, u)


# ---- the circuit ---------------------------------------------------------------

def _fold_and_expose(gb, tape, ecc, loaders, pairs):
    binder = Sponge(gb)
    for ld in loaders:
        binder.update([ld.t_binder()])
    rho = binder.squeeze()
    lhs_terms, rhs_terms, rho_pow = [], [], None
    for lt, rt in pairs:
        for pt, s in lt:
            lhs_terms.append((pt, s if rho_pow is None else gb.mul(s, rho_pow)))
        for pt, s in rt:
            rhs_terms.append((pt, s if rho_pow is None else gb.mul(s, rho_pow)))
        rho_pow = rho if rho_pow is None else gb.mul(rho_pow, rho)
    lhs = ecc.msm([p for p, _ in lhs_terms], [s for _, s in lhs_terms])
    rhs = ecc.msm([p for p, _ in rhs_terms], [s for _, s in rhs_terms])
    H = TAPE_LIMBS_PER_HALF
    for coord in (lhs.x, lhs.y, rhs.x, rhs.y):
        cells = tape.limb_cells(coord)
        for half in (cells[:H], cells[H:2 * H]):
            acc = half[-1]
            for c in reversed(half[:-1]):
                acc = gb.mul_add(acc, gb.constant(1 << 16), c)
            gb.expose_public(acc)


def link_x509(gb, loaders) -> None:
    """[rsa_1, sha_1, rsa_2, sha_2]: each RSA link's 32 digest bytes packed
    big-endian into the two 128-bit halves its SHA-256 link exposes."""
    for rsa, sha in ((loaders[0], loaders[1]), (loaders[2], loaders[3])):
        digest = [rsa.instance_scalar(0, i) for i in range(32)]
        lo, hi = sha.instance_scalar(0, 0), sha.instance_scalar(0, 1)
        for target, chunk in ((hi, digest[:16]), (lo, digest[16:])):
            acc = chunk[0]
            for b in chunk[1:]:
                acc = gb.mul_add(acc, gb.constant(256), b)
            gb.assert_equal(acc, target)


def layout(snarks: list, k: int, lanes: int, na: int, nl: int = 1,
           link=None):
    """`snarks`: [(vk, instances, proof)] with reference verifying keys.
    -> (cs, fixed {column: (rows, values)}, copies (m, 2, 3), num_instance,
    the instances)."""
    gb = Builder()
    tape = Tape(gb, DUMMY_TAU, lanes)
    ecc = Ecc(tape)
    loaders, pairs = [], []
    for vk, instances, proof in snarks:
        ld = Loader(gb, tape, ecc, vk, instances, proof)
        pairs.append(verify_core(ld, vk, [len(c) for c in instances]))
        loaders.append(ld)
    if link is not None:
        link(gb, loaders)
    _fold_and_expose(gb, tape, ecc, loaders, pairs)

    cs = ConstraintSystem()
    tau = cs.challenge(phase=0)
    tcols = tape.register(cs, tau)
    bcols = gb.register(cs, na, nl, phase=1, table=tcols["table"])
    n = 1 << k
    fixed = np.zeros((cs.num_fixed, n), dtype=np.int64)
    consts: dict = {}
    b_copies, cell_col, cell_row = gb.pack(cs, bcols, n, fixed, consts)
    t_copies = tape.place(cs, tcols, n, fixed, cell_col, cell_row)
    out = {}
    for j in range(cs.num_fixed):
        if j in consts:
            out[j] = consts[j]
        else:
            rows = np.nonzero(fixed[j])[0]
            out[j] = (rows, fixed[j, rows].tolist())
    instances = [[gb.values[i] for i in gb.instance_cells]]
    return (cs, out, np.concatenate([b_copies, t_copies]),
            [len(gb.instance_cells)], instances)

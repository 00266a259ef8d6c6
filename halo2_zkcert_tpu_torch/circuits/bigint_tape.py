"""Non-native big-integer arithmetic subsystem for composed circuits.

Counterpart of halo2_zkcert_tpu/circuits/bigint_tape.py: the same
recording, relation for relation and row for row; `layout` and
`materialize` lay the regions out with numpy over the whole tape (the
aggregation circuit at k=20 holds some 7 M tape rows) where the JAX
package walks them row by row.

Generalizes the RSA circuit's challenge-based mulmod machinery
(circuits/rsa.py) into a reusable component that composes with
`builder.GateBuilder` columns inside one ConstraintSystem — the foundation
of the aggregation circuit's in-circuit G1 arithmetic (the JAX package's
docs/AGGREGATION_DESIGN.md; reference behavior: halo2-ecc's CRT bigint
chip [dep] Cargo.lock:1199, redesigned around one polynomial-identity
check per modular multiply instead of per-limb product gates).

Design (one challenge tau shared by every relation):

* phase-0 advice lane columns V hold all witnessed 16-bit limbs — operand
  limbs, quotient limbs, carry limbs — each row range-checked by ONE
  lookup against a shared 2^16 table;
* phase-1 lane columns A hold Horner accumulators: per *region* of rows,
  A[r] = f_pass*A[r-1] + f_tau*A[r-1]*tau + f_v*V[r] + f_cval  (uniform
  gate; f_cval injects fixed constants), so the last region row carries
  the evaluation of the region's limb vector at tau;
* every region eval is mirrored into a GateBuilder cell by a copy
  constraint; Fq adds/subs/scalings are FREE builder algebra on eval
  cells (with signed-coefficient and magnitude-bound bookkeeping);
* one *relation row group* per modular multiply checks, at tau,
      X(t)*Y(t) - Q(t)*N(t) - Z(t) = (t - 2^16) * C(t)
  with C committed as offset carries c' = c + OFF split into 16-bit
  lo/hi rows.  All committed vectors are fixed before tau is squeezed,
  so equality at tau implies the polynomial identity (Schwartz-Zippel),
  and bounded coefficients make the identity at t=2^16 the exact integer
  statement x*y = q*n + z.  Quotients are SIGNED via a constant offset
  (Q(t) = Q'(t) - QOFF(t), Q' witnessed nonnegative), so relations where
  z is an arbitrary lazy combination (e.g. the witnessed-lambda ECC
  equations, ecc_gadget.py) stay sound when x*y < z.
"""
from __future__ import annotations

from array import array
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..builder import Cell, GateBuilder
from ..plonk import ADVICE, Column, ConstraintSystem
from ..plonk import expression as ex
from ..plonk.assignment import CopyArray
from ..utils import refcrypto as rc

B = 16                     # tape limb bits (= shared range-table bits)
BASE = 1 << B
OFF_POW = 28               # carry offset: c' = c + 2^28, c' in [0, 2^32)
OFF = 1 << OFF_POW
_KIND = {"w": 0, "c": 1, "rel": 2}


def int_to_coeffs(x: int, n: int) -> tuple:
    assert x >= 0
    mask = BASE - 1
    out = tuple((x >> (B * i)) & mask for i in range(n))
    assert x >> (B * n) == 0, f"{x.bit_length()} bits > {n} limbs"
    return out


@dataclass(frozen=True)
class FqVal:
    """Handle to a non-native element: a committed-limb polynomial.

    coeffs: signed limb coefficients LSB-first (concrete, this pass);
    bound:  static max |coeff| (identical across keygen/prove passes);
    eval_cell: builder cell holding sum coeffs[i] * tau^i;
    region_idx: tape region index for 'w' regions (enables limb_cells).
    """
    coeffs: tuple
    bound: int
    eval_cell: Cell
    region_idx: int | None = None

    @cached_property
    def value(self) -> int:
        return sum(c << (B * i) for i, c in enumerate(self.coeffs))

    @cached_property
    def int_bound(self) -> int:
        """Static max |integer value|."""
        return self.bound * ((1 << (B * len(self.coeffs))) - 1) // (BASE - 1)


@dataclass
class _Reg:
    kind: str                  # 'w' | 'c' | 'rel'
    lane: int
    length: int
    coeffs: tuple | None = None      # row coefficients, LSB-first
    slots: tuple | None = None       # rel: 8 slot values
    slot_cells: tuple | None = None  # rel: 8 builder trace indices
    eval_cell_idx: int | None = None # mirror builder trace index
    start: int = -1


class BigintTape:
    """Records non-native ops; `register`/`materialize` wire them into a
    shared ConstraintSystem next to the GateBuilder's columns."""

    REL_SLOTS = 8  # x, y, q_eff, z, clo, chi, n, ones

    def __init__(self, gb: GateBuilder, tau: int, modulus: int = rc.FQ,
                 lanes: int = 1):
        self.gb = gb
        self.tau = tau % rc.FR
        self.modulus = modulus
        self.L = (modulus.bit_length() + B - 1) // B
        self.rel_len = 2 * self.L + 4      # carry-vector length
        self.lanes = lanes
        self.regions: list[_Reg] = []
        self.lane_rows = [0] * lanes
        self._limb_copies: list = []     # (region_idx, limb_i, builder_idx)
        self._consts: dict = {}
        self._tau_pows = [1]
        # the regions as flat arrays, for `layout` and `materialize`: kind,
        # lane and length of each; the builder cells each copies, in copy
        # order; the rows' values ('w'/'c' rows MSB-first, relation slots)
        self._kind, self._lane_of, self._len_of = (array("q"), array("q"),
                                                   array("q"))
        self._copy_cells = array("q")
        self._lin_vals = array("q")
        self._rel_vals: list = []
        self._n_limbs = np.asarray(int_to_coeffs(modulus, self.L),
                                   dtype=np.int64)
        self.n_const = self.constant_elem(modulus)
        self.ones_const = self._constant_coeffs((1,) * self.rel_len)
        self.one_const = self.constant_elem(1)

    # ---- recording -----------------------------------------------------------

    def _flat(self, kind: int, lane: int, length: int, cells) -> None:
        self._kind.append(kind)
        self._lane_of.append(lane)
        self._len_of.append(length)
        self._copy_cells.extend(cells)

    def _lane(self) -> int:
        return min(range(self.lanes), key=lambda i: self.lane_rows[i])

    def _eval(self, coeffs) -> int:
        while len(self._tau_pows) < len(coeffs):
            self._tau_pows.append(self._tau_pows[-1] * self.tau % rc.FR)
        return sum(c * self._tau_pows[i] for i, c in enumerate(coeffs)) % rc.FR

    def _region(self, kind: str, coeffs: tuple) -> FqVal:
        ev = self._eval(coeffs)
        cell = self.gb.witness(ev)
        lane = self._lane()
        reg = _Reg(kind, lane, len(coeffs), coeffs=coeffs,
                   eval_cell_idx=cell.index)
        self.regions.append(reg)
        self.lane_rows[lane] += len(coeffs)
        self._flat(_KIND[kind], lane, len(coeffs), (cell.index,))
        self._lin_vals.extend(reversed(coeffs))
        bound = BASE - 1 if kind == "w" else max(
            [abs(c) for c in coeffs] or [0])
        return FqVal(coeffs, bound, cell, len(self.regions) - 1)

    def limb_cells(self, v: FqVal) -> list:
        """Mirror each 16-bit limb of a witnessed region into a builder
        cell (copy-constrained to the V lane), LSB-first — used to pack
        coordinates for transcript absorption / instance exposure."""
        assert v.region_idx is not None \
            and self.regions[v.region_idx].kind == "w", \
            "limb_cells needs a fresh witnessed region"
        cells = []
        for i, coeff in enumerate(v.coeffs):
            c = self.gb.witness(coeff)
            self._limb_copies.append((v.region_idx, i, c.index))
            cells.append(c)
        return cells

    def witness_elem(self, value: int, nlimbs: int | None = None) -> FqVal:
        """Fresh region of range-checked 16-bit limbs (value >= 0)."""
        return self._region("w", int_to_coeffs(value, nlimbs or self.L))

    def _constant_coeffs(self, coeffs: tuple) -> FqVal:
        if coeffs in self._consts:
            return self._consts[coeffs]
        v = self._region("c", coeffs)
        self._consts[coeffs] = v
        return v

    def constant_elem(self, value: int, nlimbs: int | None = None) -> FqVal:
        n = nlimbs or max(1, (value.bit_length() + B - 1) // B)
        return self._constant_coeffs(int_to_coeffs(value, n))

    # ---- free linear algebra (builder eval cells + coeff bookkeeping) --------

    def lincomb(self, terms: list) -> FqVal:
        """sum_i c_i * a_i with small integer c_i — no tape rows."""
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
                acc = gb.mul_add(a.eval_cell, gb.constant(c % rc.FR), acc)
        return FqVal(tuple(coeffs), bound, acc)

    def add(self, a: FqVal, b: FqVal) -> FqVal:
        return self.lincomb([(a, 1), (b, 1)])

    def sub(self, a: FqVal, b: FqVal) -> FqVal:
        """a - b + pad*modulus, padded so the value stays nonnegative."""
        pad = (b.int_bound // self.modulus + 1) * self.modulus
        padc = self.constant_elem(pad)
        return self.lincomb([(a, 1), (b, -1), (padc, 1)])

    def scale(self, a: FqVal, c: int) -> FqVal:
        assert c > 0
        return self.lincomb([(a, c)])

    def add_int(self, a: FqVal, c: int) -> FqVal:
        assert c > 0
        return self.lincomb([(a, 1), (self.constant_elem(c), 1)])

    # ---- relations -----------------------------------------------------------

    def _select_cell(self, v: FqVal) -> int:
        return v.eval_cell.index

    def assert_mul_eq(self, x: FqVal, y: FqVal, z: FqVal) -> None:
        """Constrain x*y == z (mod modulus); x, y, z any handles >= 0."""
        N = self.modulus
        prod = x.value * y.value
        assert x.value >= 0 and y.value >= 0 and z.value >= 0
        diff = prod - z.value
        assert diff % N == 0, "mul relation does not hold"
        qw = diff // N

        # static quotient bounds -> offset so the witnessed Q' is nonneg
        qmax = x.int_bound * y.int_bound // N + 1
        qneg = z.int_bound // N + 1
        qoff = qneg
        nq = max(1, ((qmax + qoff).bit_length() + B - 1) // B)
        qp = qw + qoff
        assert 0 <= qp < (1 << (B * nq))
        qp_v = self._region("w", int_to_coeffs(qp, nq))
        qoff_v = self.constant_elem(qoff, nq)
        q_eff_cell = self.gb.sub(qp_v.eval_cell, qoff_v.eval_cell)
        q_coeffs = [a - b for a, b in
                    zip(qp_v.coeffs, qoff_v.coeffs + (0,) * nq)]

        # static carry bound: |c_k| <= max|d| / (2^B - 1) + 1
        nconv = min(len(x.coeffs), len(y.coeffs))
        bound_d = (nconv * x.bound * y.bound
                   + min(nq, self.L) * BASE * BASE + z.bound)
        bound_c = bound_d // (BASE - 1) + 1
        assert bound_c < OFF // 2, \
            f"carry bound 2^{bound_c.bit_length()} too large: reduce operands"

        # D = conv(x,y) - conv(q_eff, N) - z, padded to rel_len + 1; every
        # partial sum is below bound_d < 2^43 in magnitude, so int64 holds
        ln = self.rel_len
        d = np.zeros(ln + 1, dtype=np.int64)
        cxy = np.convolve(np.asarray(x.coeffs, dtype=np.int64),
                          np.asarray(y.coeffs, dtype=np.int64))
        assert len(cxy) <= ln + 1, "operand too wide for relation"
        d[:len(cxy)] += cxy
        cqn = np.convolve(np.asarray(q_coeffs, dtype=np.int64), self._n_limbs)
        assert len(cqn) <= ln + 1
        d[:len(cqn)] -= cqn
        d[:len(z.coeffs)] -= np.asarray(z.coeffs, dtype=np.int64)
        d = d.tolist()

        # synthetic division by (t - 2^B): c_{k-1} = d_k + 2^B c_k (top down)
        c = [0] * ln
        acc = 0
        for k in range(ln, 0, -1):
            acc = d[k] + (acc << B)
            c[k - 1] = acc
        assert d[0] + (c[0] << B) == 0, "carry telescoping failed"
        cp = [ci + OFF for ci in c]
        assert all(0 <= ci < (1 << 32) for ci in cp), "carry overflow"
        clo = self._region("w", tuple(ci & (BASE - 1) for ci in cp))
        chi = self._region("w", tuple(ci >> B for ci in cp))

        slots = (x.eval_cell.index, y.eval_cell.index, q_eff_cell.index,
                 z.eval_cell.index, clo.eval_cell.index, chi.eval_cell.index,
                 self.n_const.eval_cell.index, self.ones_const.eval_cell.index)
        vals = tuple(self.gb.values[i] for i in slots)
        lane = self._lane()
        reg = _Reg("rel", lane, self.REL_SLOTS, slots=vals, slot_cells=slots)
        self.regions.append(reg)
        self.lane_rows[lane] += self.REL_SLOTS
        self._flat(_KIND["rel"], lane, self.REL_SLOTS, slots)
        self._rel_vals.extend(vals)

    def mulmod(self, x: FqVal, y: FqVal) -> FqVal:
        """Fresh canonical z = x*y mod modulus."""
        z = self.witness_elem(x.value * y.value % self.modulus)
        self.assert_mul_eq(x, y, z)
        return z

    def reduce(self, a: FqVal) -> FqVal:
        """Fresh canonical representative of a (mod modulus)."""
        return self.mulmod(a, self.one_const)

    def assert_eq_mod(self, a: FqVal, b: FqVal) -> None:
        """a == b (mod modulus)."""
        self.assert_mul_eq(a, self.one_const, b)

    def rows_used(self) -> list:
        return list(self.lane_rows)

    # ---- wiring --------------------------------------------------------------

    def register(self, cs: ConstraintSystem, tau: ex.Challenge) -> dict:
        """Create lane columns + gates + the shared range table in `cs`.

        Call AFTER recording (lane count fixed at init, rows known)."""
        v_cols = [cs.advice_column(phase=0) for _ in range(self.lanes)]
        a_cols = [cs.advice_column(phase=1) for _ in range(self.lanes)]
        table = cs.fixed_column()
        flags = []
        for ln in range(self.lanes):
            q_h = cs.fixed_column()
            f_pass = cs.fixed_column()
            f_tau = cs.fixed_column()
            f_v = cs.fixed_column()
            f_cval = cs.fixed_column()
            q_rel = cs.fixed_column()
            flags.append((q_h, f_pass, f_tau, f_v, f_cval, q_rel))
            a, v = a_cols[ln], v_cols[ln]
            a_prev = ex.Advice(a.index, -1, phase=1)

            def A(r, _a=a):
                return ex.Advice(_a.index, r, phase=1)

            cs.create_gate(
                f"tape_horner{ln}",
                q_h * (A(0) - f_pass * a_prev - f_tau * (a_prev * tau)
                       - f_v * v - f_cval))
            rel = (A(0) * A(1) - A(2) * A(6) - A(3)
                   - (tau - BASE) * (A(4) + BASE * A(5) - OFF * A(7)))
            cs.create_gate(f"tape_rel{ln}", q_rel * rel)
            cs.add_lookup(f"tape_range{ln}", [(v, table)], max_bits=B)
            cs.enable_permutation(Column(ADVICE, a.index))
            cs.enable_permutation(Column(ADVICE, v.index))
        return {"v_cols": v_cols, "a_cols": a_cols, "table": table,
                "flags": flags}

    def layout(self, cs: ConstraintSystem, n: int) -> None:
        """Assign region start rows (row 0 of each lane kept zero)."""
        lane = np.frombuffer(self._lane_of, dtype=np.int64)
        length = np.frombuffer(self._len_of, dtype=np.int64)
        start = np.empty_like(length)
        cursors = [1] * self.lanes
        for ln in range(self.lanes):
            m = lane == ln
            ends = 1 + np.cumsum(length[m])
            start[m] = ends - length[m]
            if ends.size:
                cursors[ln] = int(ends[-1])
        usable = cs.usable_rows(n)
        assert max(cursors) <= usable, \
            f"tape lanes overflow: {max(cursors)} > {usable} usable rows"
        assert (1 << B) <= usable, "range table must fit usable rows"
        for reg, st in zip(self.regions, start.tolist()):
            reg.start = st
        self._cursors = cursors
        self._lane, self._length, self._start = lane, length, start

    def _rows(self) -> tuple:
        """Every row of every region, in region order: (region, position in
        it, row, lane, kind).  'w'/'c' rows are MSB-first, so the last row
        of such a region carries its evaluation.  Call after `layout`."""
        length = self._length
        row_reg = np.repeat(np.arange(len(self.regions)), length)
        first = np.cumsum(length) - length
        pos = np.arange(row_reg.size) - first[row_reg]
        kind = np.frombuffer(self._kind, dtype=np.int64)
        return (row_reg, pos, self._start[row_reg] + pos,
                self._lane[row_reg], kind[row_reg])

    def replay_plan(self) -> dict:
        """What the phase-1 lane columns are made of at any tau, as flat
        arrays (call after `layout`): `vals`, the 'w'/'c' rows' limbs in
        region order; `steps`, for each position i >= 1 the indices into
        `vals` of the rows at that position (each row's Horner accumulator
        is the one above it times tau plus its limb); `last` and
        `eval_cells`, each 'w'/'c' region's last row and the builder cell
        that mirrors its evaluation; `lin_at`, `rel_at` the (lane, row) of
        the 'w'/'c' rows and the relation rows; `rel_cells`, the builder
        cell each relation row copies."""
        row_reg, pos, rows, row_lane, row_kind = self._rows()
        lin = row_kind < 2
        lpos = pos[lin]
        lin_reg = row_reg[lin]
        last = np.nonzero(lpos == self._length[lin_reg] - 1)[0]
        cells = np.frombuffer(self._copy_cells, dtype=np.int64)
        reg_lin = np.frombuffer(self._kind, dtype=np.int64) < 2
        take_reg = np.repeat(reg_lin, np.where(reg_lin, 1, self.REL_SLOTS))
        return {"vals": np.frombuffer(self._lin_vals, dtype=np.int64),
                "steps": [np.nonzero(lpos == i)[0]
                          for i in range(1, int(lpos.max(initial=0)) + 1)],
                "last": last, "eval_cells": cells[take_reg],
                "lin_at": (row_lane[lin], rows[lin]),
                "rel_at": (row_lane[~lin], rows[~lin]),
                "rel_cells": cells[~take_reg]}

    def materialize(self, cs: ConstraintSystem, cols: dict, n: int,
                    builder_cells, fixed_out: np.ndarray | None = None):
        """Fill `fixed_out` (num_fixed, n array; None: a witness pass,
        which needs no fixed columns) for the tape's fixed columns;
        -> (v_values, a_values, copies).  Call after `layout`.

        builder_cells(idx) -> (m, 3) copy cells (kind code, column, row)
        of the builder trace indices `idx` as placed (`GateBuilder.pack`).
        v_values: (lanes, n) int64 limbs (phase 0, tau-free); a_values:
        (lanes, n) object array of Fr ints; copies: a `CopyArray` in the
        JAX package's order (per region: a 'w'/'c' region's eval row, or
        a relation's 8 slot rows; then the limb mirrors).
        """
        usable = cs.usable_rows(n)
        lanes = self.lanes
        lane, length = self._lane, self._length
        row_reg, pos, rows, row_lane, row_kind = self._rows()
        flags = np.array([[c.index for c in f] for f in cols["flags"]],
                         dtype=np.int64).reshape(lanes, 6)
        q_h, f_tau, f_v, f_cval, q_rel = (flags[:, j] for j in (0, 2, 3, 4, 5))
        a_col = np.array([c.index for c in cols["a_cols"]], dtype=np.int64)
        v_col = np.array([c.index for c in cols["v_cols"]], dtype=np.int64)

        lin = row_kind < 2
        rel = ~lin
        lin_vals = np.frombuffer(self._lin_vals, dtype=np.int64)
        w_rows = row_kind == 0
        if fixed_out is not None:
            fixed_out[cols["table"].index, :1 << B] = np.arange(1 << B)
            # q_h = 1 on all usable rows except relation rows (forces A = 0
            # outside regions); relation rows are gate-free (copy-pinned)
            fixed_out[q_h, :usable] = 1
            fixed_out[q_h[row_lane[rel]], rows[rel]] = 0
            c_rows = row_kind[lin] == 1
            fixed_out[f_tau[row_lane[lin & (pos > 0)]],
                      rows[lin & (pos > 0)]] = 1
            fixed_out[f_v[row_lane[w_rows]], rows[w_rows]] = 1
            fixed_out[f_cval[row_lane[lin][c_rows]], rows[lin][c_rows]] = \
                lin_vals[c_rows]
            rel_start = rel & (pos == 0)
            fixed_out[q_rel[row_lane[rel_start]], rows[rel_start]] = 1

        v_vals = np.zeros((lanes, n), dtype=np.int64)
        v_vals[row_lane[w_rows], rows[w_rows]] = lin_vals[w_rows[lin]]
        # A: the Horner accumulator of each 'w'/'c' region at tau, one
        # position of every region at a time; a relation's slot values
        acc = np.empty(row_reg.size, dtype=object)
        acc[lin] = lin_vals.tolist()
        acc[rel] = self._rel_vals
        tau = self.tau
        for i in range(1, int(length.max(initial=1))):
            at = np.nonzero(lin & (pos == i))[0]
            acc[at] = (acc[at - 1] * tau + acc[at]) % rc.FR
        a_vals = np.zeros((lanes, n), dtype=object)
        a_vals[row_lane, rows] = acc

        # copies: a 'w'/'c' region's last row <-> its eval cell; each
        # relation row <-> its slot cell; then the limb mirrors (V-lane
        # row start + (length - 1 - limb) <-> the mirror cell)
        take = (lin & (pos == length[row_reg] - 1)) | rel
        b_idx = np.frombuffer(self._copy_cells, dtype=np.int64)
        code = CopyArray.CODES[ADVICE]
        tape_side = np.stack([np.full(b_idx.size, code),
                              a_col[row_lane[take]], rows[take]], axis=-1)
        pairs = [np.stack([tape_side, builder_cells(b_idx)], axis=1)]
        if self._limb_copies:
            lc = np.array(self._limb_copies, dtype=np.int64)
            reg = lc[:, 0]
            mirror = np.stack([np.full(reg.size, code), v_col[lane[reg]],
                               self._start[reg] + length[reg] - 1 - lc[:, 1]],
                              axis=-1)
            pairs.append(np.stack([mirror, builder_cells(lc[:, 2])], axis=1))
        return v_vals, a_vals, CopyArray(np.concatenate(pairs))

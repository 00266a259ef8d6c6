"""Vertical-gate trace builder, the halo2-base equivalent.

Counterpart of halo2_zkcert_tpu/builder.py.  A circuit is recorded as a
flat trace of cells over one virtual column with the single vertical gate

    q[i] * (v[i] + v[i+1] * v[i+2] - v[i+3]) = 0

(each arithmetic op appends 4 cells [acc_in, a, b, out]; reused values are
linked with copy constraints).  `finalize()` packs the virtual trace into
`num_advice` physical columns (a gate never straddles a column boundary),
pins constants by copy against a shared fixed column, routes range-checked
cells into lookup-advice columns checked against a `lookup_bits` table, and
sizes the column count for a target k (`calculate_params`).

Values are computed eagerly (host ints) while recording, so one code path
serves structure (keygen) and witness (proving).  The packing is numpy over
the whole trace: a gate-level SHA-256 of a 970-byte message records 6.3 M
cells and 4.8 M copies, which a loop per cell would spend minutes on.
"""
from __future__ import annotations

from array import array
from typing import NamedTuple

import numpy as np
import torch

from .ops import field
from .ops.field import FR
from .plonk import ADVICE, FIXED, INSTANCE, CircuitData, Column, ConstraintSystem
from .plonk import expression as ex
from .plonk.assignment import CopyArray
from .utils import refcrypto as rc

P = rc.FR


class Cell(NamedTuple):
    """Handle to a virtual-trace position."""
    index: int
    value: int


class GateBuilder:
    def __init__(self, lookup_bits: int = 16):
        self.values: list = []
        self.gate_rows = array("q")     # trace offsets where the gate fires
        self.copy_a = array("q")        # copy constraints (idx_a, idx_b)
        self.copy_b = array("q")
        self.constants: dict = {}       # value -> trace index (first pin)
        self.const_cells: list = []     # (trace idx, value) needing fixed pin
        self.range_checked: list = []   # trace idx (must be < 2^lookup_bits)
        self.lookup_bits = lookup_bits
        self.instance_cells: list = []

    # ---- raw trace ops -------------------------------------------------------

    def _push(self, v: int) -> int:
        self.values.append(v % P)
        return len(self.values) - 1

    def witness(self, v: int) -> Cell:
        return Cell(self._push(v), v % P)

    def constant(self, c: int) -> Cell:
        c %= P
        i = self.constants.get(c)
        if i is not None:
            return Cell(i, c)
        i = self._push(c)
        self.constants[c] = i
        self.const_cells.append((i, c))
        return Cell(i, c)

    def _gate(self, a: Cell, b: Cell, c: Cell, out_val: int) -> Cell:
        values = self.values
        base = len(values)
        values += (a.value, b.value, c.value, out_val % P)
        self.copy_a.extend((a.index, b.index, c.index))
        self.copy_b.extend((base, base + 1, base + 2))
        self.gate_rows.append(base)
        return Cell(base + 3, out_val % P)

    # ---- arithmetic (halo2-base GateInstructions parity) ----------------------

    def add(self, a: Cell, b: Cell) -> Cell:
        return self._gate(a, b, self.constant(1), a.value + b.value)

    def sub(self, a: Cell, b: Cell) -> Cell:
        return self._gate(a, b, self.constant(P - 1), a.value - b.value)

    def mul(self, a: Cell, b: Cell) -> Cell:
        return self._gate(self.constant(0), a, b, a.value * b.value)

    def mul_add(self, a: Cell, b: Cell, c: Cell) -> Cell:
        """c + a*b in one row."""
        return self._gate(c, a, b, c.value + a.value * b.value)

    def neg(self, a: Cell) -> Cell:
        return self.mul(a, self.constant(P - 1))

    def square(self, a: Cell) -> Cell:
        return self.mul(a, a)

    def add_const(self, a: Cell, c: int) -> Cell:
        return self.add(a, self.constant(c))

    def mul_const(self, a: Cell, c: int) -> Cell:
        return self.mul(a, self.constant(c))

    def inner_product(self, xs: list, ys: list) -> Cell:
        acc = self.mul(xs[0], ys[0])
        for x, y in zip(xs[1:], ys[1:]):
            acc = self.mul_add(x, y, acc)
        return acc

    def horner(self, coeffs_msb_first: list, x: Cell) -> Cell:
        acc = coeffs_msb_first[0]
        for c in coeffs_msb_first[1:]:
            acc = self.mul_add(acc, x, c)
        return acc

    def pow5(self, a: Cell) -> Cell:
        a2 = self.square(a)
        a4 = self.square(a2)
        return self.mul(a4, a)

    def assert_equal(self, a: Cell, b: Cell) -> None:
        self.copy_a.append(a.index)
        self.copy_b.append(b.index)

    def assert_const(self, a: Cell, c: int) -> None:
        self.assert_equal(a, self.constant(c))

    def assert_bit(self, a: Cell) -> None:
        self.assert_equal(self.square(a), a)

    def select(self, cond: Cell, a: Cell, b: Cell) -> Cell:
        """cond ? a : b (cond must be a constrained bit)."""
        d = self.sub(a, b)
        return self.mul_add(cond, d, b)

    def is_zero(self, a: Cell) -> Cell:
        inv = self.witness(rc.finv(a.value, P))
        out = self.witness(1 if a.value % P == 0 else 0)
        self.assert_const(self.mul_add(a, inv, out), 1)
        self.assert_const(self.mul(a, out), 0)
        return out

    def range_check(self, a: Cell, bits: int) -> None:
        """Decompose into lookup_bits chunks looked up against the table."""
        lb = self.lookup_bits
        if bits <= lb:
            if bits == lb:
                self.range_checked.append(a.index)
            else:
                # tight check: a << (lb-bits) must also be a table entry
                sh = self.mul_const(a, 1 << (lb - bits))
                self.range_checked.append(a.index)
                self.range_checked.append(sh.index)
            return
        nchunks = (bits + lb - 1) // lb
        v = a.value
        chunks = []
        for i in range(nchunks):
            cbits = min(lb, bits - i * lb)
            cv = (v >> (i * lb)) & ((1 << cbits) - 1)
            c = self.witness(cv)
            self.range_checked.append(c.index)
            if cbits < lb:
                sh = self.mul_const(c, 1 << (lb - cbits))
                self.range_checked.append(sh.index)
            chunks.append(c)
        acc = chunks[-1]
        for i in range(nchunks - 2, -1, -1):
            acc = self.mul_add(acc, self.constant(1 << lb), chunks[i])
        self.assert_equal(acc, a)

    def expose_public(self, a: Cell) -> None:
        self.instance_cells.append(a.index)

    # ---- packing ---------------------------------------------------------------

    def calculate_params(self, k: int, minimum_rows: int = 10) -> dict:
        usable = (1 << k) - minimum_rows - 10
        num_advice = max(1, -(-len(self.values) // usable))
        num_lookup = max(1, -(-len(self.range_checked) // usable)) \
            if self.range_checked else 0
        return {"k": k, "num_advice": num_advice,
                "num_lookup_advice": num_lookup,
                "lookup_bits": self.lookup_bits}

    def register(self, cs: ConstraintSystem, na: int, nl: int,
                 phase: int = 0, table=None):
        """Register this trace's columns, gates and lookups into `cs`
        (shared-CS composition: the aggregation circuit packs builder
        columns next to bigint-tape columns).

        Returns a dict of column handles.  `table` is an existing
        2^lookup_bits range-table fixed column to share (created here if
        None and nl > 0).
        """
        adv = [cs.advice_column(phase=phase) for _ in range(na)]
        lk_adv = [cs.advice_column(phase=phase) for _ in range(nl)]
        inst = cs.instance_column() if self.instance_cells else None
        selectors = [cs.fixed_column() for _ in range(na)]
        f_const = cs.fixed_column()
        if nl and table is None:
            table = cs.fixed_column()
            for_table_fill = True
        else:
            for_table_fill = False

        for j, col in enumerate(adv):
            A = lambda r, cj=col: ex.Advice(cj.index, r, phase=phase)
            cs.create_gate(f"vgate{col.index}",
                           selectors[j] * (A(0) + A(1) * A(2) - A(3)))
        for col in lk_adv:
            # max_bits: prover hint (bounded-window commits + 1-word sort
            # keys); lookup-advice values are copies of range-checked cells
            cs.add_lookup(f"range{col.index}",
                          [(ex.Advice(col.index, phase=phase), table)],
                          max_bits=self.lookup_bits)
        for col in adv + lk_adv:
            cs.enable_permutation(Column(ADVICE, col.index))
        cs.enable_permutation(Column(FIXED, f_const.index))
        if inst is not None:
            cs.enable_permutation(Column(INSTANCE, inst.index))
        return {"adv": adv, "lk_adv": lk_adv, "inst": inst,
                "selectors": selectors, "f_const": f_const, "table": table,
                "fill_table": for_table_fill}

    def finalize(self, k: int, params: dict | None = None, device="cuda"):
        """-> (CircuitData, (na + nl, n, 8) int32 canonical words on
        `device`, instances).

        Layout: advice columns A_0..A_{na-1} (each with its own selector
        fixed column), lookup-advice columns, one constants fixed column
        (copy-pinned), one table fixed column.
        """
        cfg = params or self.calculate_params(k)
        n = 1 << k
        na, nl = cfg["num_advice"], cfg["num_lookup_advice"]
        if self.range_checked and self.lookup_bits > k - 1:
            raise ValueError(f"a {self.lookup_bits}-bit table does not fit "
                             f"a column of 2^{k} rows")

        cs = ConstraintSystem()
        cols = self.register(cs, na, nl)
        packed = self.pack(cs, cols, n)
        fixed = np.zeros((cs.num_fixed, n), dtype=object)
        f_cols, f_rows, f_vals = packed["fixed"]
        fixed[f_cols, f_rows] = f_vals
        if cols["table"] is not None:
            fixed[cols["table"].index, :1 << self.lookup_bits] = list(
                range(1 << self.lookup_bits))
        data = CircuitData(cs=cs, k=k, fixed=fixed, copies=packed["copies"],
                           num_instance=[len(self.instance_cells)]
                           if cols["inst"] is not None else [])
        advice = packed["advice"].to(device)
        return data, advice, packed["instances"]

    def pack(self, cs: ConstraintSystem, cols: dict, n: int) -> dict:
        """Place the virtual trace into the registered columns.

        Returns {col, row: each trace cell's placement (numpy); words:
        (cells, 8) canonical words of every cell; advice: (na + nl, n, 8)
        canonical words of the registered columns, a CPU tensor; lookup:
        (cells, rows) of the lookup-advice copies; fixed: (columns, rows,
        values) to write; copies: a `CopyArray` in the JAX package's order;
        instances}.  Shared-CS callers merge these into their own arrays.
        """
        adv, lk_adv, inst = cols["adv"], cols["lk_adv"], cols["inst"]
        na, nl = len(adv), len(lk_adv)
        usable = cs.usable_rows(n)
        count = len(self.values)
        gates = np.frombuffer(self.gate_rows, dtype=np.int64)

        # column breaks: a column ends after `usable` cells, or earlier at
        # the first gate that would not fit its 4 cells
        starts = []
        s = 0
        while s < count:
            starts.append(s)
            if len(starts) > na:
                raise ValueError(f"trace needs more columns: {count} cells, "
                                 f"n={n}")
            nxt = s + usable
            g = np.searchsorted(gates, nxt - 3)
            if g < gates.size and gates[g] < nxt:
                nxt = int(gates[g])
            s = nxt
        starts = np.asarray(starts, dtype=np.int64)
        idx = np.arange(count, dtype=np.int64)
        col = np.searchsorted(starts, idx, side="right") - 1
        row = idx - starts[col]

        sel_index = np.array([c.index for c in cols["selectors"]],
                             dtype=np.int64)
        if len(self.const_cells) > usable:
            raise ValueError("too many distinct constants")
        c_idx = np.array([i for i, _ in self.const_cells], dtype=np.int64)
        f_cols = np.concatenate([sel_index[col[gates]],
                                 np.full(c_idx.size, cols["f_const"].index)])
        f_rows = np.concatenate([row[gates], np.arange(c_idx.size)])
        f_vals = np.empty(f_cols.size, dtype=object)
        f_vals[:gates.size] = 1
        f_vals[gates.size:] = [v for _, v in self.const_cells]

        words = field.from_ints(FR, self.values, "cpu")
        advice = torch.zeros((na + nl, n, 8), dtype=torch.int32)
        advice[col, row] = words
        rc_idx = np.array(self.range_checked, dtype=np.int64)
        lk_cur = np.arange(rc_idx.size, dtype=np.int64)
        if rc_idx.size and lk_cur[-1] // usable >= nl:
            raise ValueError("need more lookup-advice columns")
        advice[na + lk_cur // usable, lk_cur % usable] = words[rc_idx]

        adv_index = np.array([c.index for c in adv], dtype=np.int64)
        lk_index = np.array([c.index for c in lk_adv], dtype=np.int64)

        def cells(kind, column, r):
            return np.stack([np.full(r.size, CopyArray.CODES[kind]),
                             column, r], axis=-1)

        def placed(i):
            return cells(ADVICE, adv_index[col[i]], row[i])

        ca = np.frombuffer(self.copy_a, dtype=np.int64)
        cb = np.frombuffer(self.copy_b, dtype=np.int64)
        pairs = [(placed(ca), placed(cb)),
                 (placed(c_idx), cells(FIXED, np.full(c_idx.size,
                                                      cols["f_const"].index),
                                       np.arange(c_idx.size))),
                 (placed(rc_idx), cells(ADVICE, lk_index[lk_cur // usable],
                                        lk_cur % usable))]
        instances = []
        if inst is not None:
            i_idx = np.array(self.instance_cells, dtype=np.int64)
            pairs.append((placed(i_idx),
                          cells(INSTANCE, np.full(i_idx.size, inst.index),
                                np.arange(i_idx.size))))
            instances = [[self.values[i] for i in self.instance_cells]]
        copies = CopyArray(np.concatenate(
            [np.stack(p, axis=1) for p in pairs], axis=0))
        return {"col": col, "row": row, "words": words, "advice": advice,
                "lookup": (rc_idx, lk_cur), "fixed": (f_cols, f_rows, f_vals),
                "copies": copies, "instances": instances}

    # ---- replay ----------------------------------------------------------------

    def dataflow(self, roots) -> list:
        """The gates whose values follow from the cells `roots`, by level:
        a list of int64 arrays of gate offsets, and beside each the (3, m)
        cells its inputs copy.  A gate's inputs are copies of earlier cells
        and its output is acc_in + a * b, so a level reads only the roots,
        cells no listed gate writes and earlier levels' outputs."""
        count = len(self.values)
        gates = np.frombuffer(self.gate_rows, dtype=np.int64)
        ca = np.frombuffer(self.copy_a, dtype=np.int64)
        cb = np.frombuffer(self.copy_b, dtype=np.int64)
        is_input = np.zeros(count, dtype=bool)
        for j in range(3):
            is_input[gates + j] = True
        src = np.full(count, -1, dtype=np.int64)
        mine = is_input[cb]
        src[cb[mine]] = ca[mine]
        assert (src[is_input] >= 0).all(), "a gate input copies no cell"
        level = [-1] * count
        for r in np.asarray(roots, dtype=np.int64).tolist():
            level[r] = 0
        s = src.tolist()
        gate_level = []
        for g in gates.tolist():
            lv = max(level[s[g]], level[s[g + 1]], level[s[g + 2]])
            if lv >= 0:
                level[g + 3] = lv + 1
            gate_level.append(lv + 1)
        gate_level = np.asarray(gate_level, dtype=np.int64)
        out = []
        for lv in range(1, int(gate_level.max(initial=0)) + 1):
            g = gates[gate_level == lv]
            out.append((g, np.stack([src[g], src[g + 1], src[g + 2]])))
        return out


def replay_gates(words: torch.Tensor, levels: list) -> None:
    """Recompute, in place, the (cells, 8) canonical `words` of the gates of
    `GateBuilder.dataflow`, given as tensors on `words`' device: each
    level's inputs gathered from the cells they copy, then its outputs."""
    for g, src in levels:
        ins = words[src.reshape(-1)].view(3, -1, 8)
        words[torch.stack((g, g + 1, g + 2)).reshape(-1)] = ins.reshape(-1, 8)
        words[g + 3] = field.add(FR, ins[0], field.mul(FR, ins[1], ins[2]))


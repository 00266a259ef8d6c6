"""Composed circuits: GateBuilder trace + BigintTape lanes in ONE
ConstraintSystem -- the assembly layer for the aggregation circuit.

Counterpart of halo2_zkcert_tpu/circuits/composed.py.  Reference analog:
halo2-base's `BaseCircuitBuilder` packing multiple chip regions into one
circuit [dep Cargo.lock:1135].  The composed circuit is a static
CircuitData plus advice columns as (n, 8) canonical words; the
builder/tape record pass is host bookkeeping, its packing numpy
(`GateBuilder.pack`, `BigintTape.materialize`).

Two-pass witness protocol (the tape's phase-1 Horner evals depend on the
challenge tau, which only exists mid-proof):
  * build pass (keygen + phase-0 witness): run the program with a fixed
    dummy tau -- structure and all phase-0 (V-lane) values are
    tau-independent;
  * phase-1 pass: re-run the program with the real squeezed tau; emit the
    A-lane and builder columns.  A structure fingerprint asserts the two
    passes laid out identically, and the phase-0 values are asserted
    unchanged.
The last phase-1 pass is kept for its tau, so MockProver and a check of
the columns at one tau share one pass.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np

from ..builder import GateBuilder
from ..ops import field
from ..ops.field import FR
from ..plonk import CircuitData, ConstraintSystem
from ..plonk.assignment import CopyArray
from ..utils import refcrypto as rc
from .bigint_tape import BigintTape

# deterministic dummy challenge for structure/keygen passes
DUMMY_TAU = int.from_bytes(rc.blake2b(b"h2t-dummy-tau", 32), "little") % rc.FR


@dataclass
class _Pass:
    gb: GateBuilder
    tape: BigintTape
    instances: list


class ComposedCircuit:
    """program(gb, tape) records the circuit; this class wires it up.

    The program must be deterministic in structure (op counts, constants,
    region shapes) across tau values -- only cell VALUES may differ.
    `pass_seconds` holds the wall seconds of each record pass so far
    (recording, then packing), in order.
    """

    def __init__(self, program, k: int, lanes: int = 1, na: int = 1,
                 nl: int = 1, modulus: int = rc.FQ, lookup_bits: int = 16):
        self.program = program
        self.k = k
        self.lanes = lanes
        self.na, self.nl = na, nl
        self.modulus = modulus
        self.lookup_bits = lookup_bits
        self.pass_seconds: list = []
        self._phase1 = None
        self._build()

    def _run(self, tau: int) -> _Pass:
        gb = GateBuilder(lookup_bits=self.lookup_bits)
        tape = BigintTape(gb, tau, self.modulus, self.lanes)
        self.program(gb, tape)
        return _Pass(gb, tape, [list(gb.values[i] for i in gb.instance_cells)]
                     if gb.instance_cells else [])

    @staticmethod
    def fingerprint(p: _Pass) -> bytes:
        """Digest of the pass's structure: cell count, gate rows, copies,
        constants, range checks, instances, tape regions, limb mirrors."""
        gb, tape = p.gb, p.tape
        h = hashlib.blake2b(digest_size=32)
        h.update(repr((len(gb.values), [v for _, v in gb.const_cells],
                       gb.range_checked, gb.instance_cells,
                       [(r.kind, r.lane, r.length) for r in tape.regions],
                       tape._limb_copies)).encode())
        for arr in (gb.gate_rows, gb.copy_a, gb.copy_b):
            h.update(b"|")
            h.update(bytes(arr))
        return h.digest()

    def _pack(self, p: _Pass, fixed: np.ndarray | None) -> tuple:
        """Lay out the pass into the registered columns: -> (v_vals,
        a_vals, builder advice words, copies); fills `fixed` unless
        None."""
        n = 1 << self.k
        p.tape.layout(self.cs, n)
        packed = p.gb.pack(self.cs, self._bcols, n)
        if fixed is not None:
            f_cols, f_rows, f_vals = packed["fixed"]
            fixed[f_cols, f_rows] = f_vals
        adv_index = np.array([c.index for c in self._bcols["adv"]],
                             dtype=np.int64)
        code = CopyArray.CODES["advice"]
        col, row = packed["col"], packed["row"]

        def builder_cells(idx):
            return np.stack([np.full(idx.size, code), adv_index[col[idx]],
                             row[idx]], axis=-1)

        v_vals, a_vals, tape_copies = p.tape.materialize(
            self.cs, self._tcols, n, builder_cells, fixed)
        copies = CopyArray(np.concatenate([packed["copies"].table,
                                           tape_copies.table]))
        return v_vals, a_vals, packed["advice"], copies

    def _build(self) -> None:
        t0 = time.perf_counter()
        p = self._run(DUMMY_TAU)
        t1 = time.perf_counter()
        self._fp = self.fingerprint(p)
        cs = ConstraintSystem()
        tau = cs.challenge(phase=0)
        self._tcols = p.tape.register(cs, tau)
        self._bcols = p.gb.register(cs, self.na, self.nl, phase=1,
                                    table=self._tcols["table"])
        self.cs = cs
        n = 1 << self.k
        fixed = np.zeros((cs.num_fixed, n), dtype=object)
        v_vals, _, _, copies = self._pack(p, fixed)
        num_inst = ([len(p.gb.instance_cells)] if p.gb.instance_cells else [])
        self.data = CircuitData(cs=cs, k=self.k, fixed=fixed, copies=copies,
                                num_instance=num_inst)
        self._pass0 = p
        # column index groups for the witness fn
        self.v_indices = [c.index for c in self._tcols["v_cols"]]
        self.a_indices = [c.index for c in self._tcols["a_cols"]]
        self.b_indices = [c.index for c in self._bcols["adv"]
                          + self._bcols["lk_adv"]]
        self._v_vals0 = v_vals
        self.pass_seconds.append((t1 - t0, time.perf_counter() - t1))

    def rows_report(self) -> dict:
        return {"tape_rows": self._pass0.tape.rows_used(),
                "builder_cells": len(self._pass0.gb.values),
                "usable": self.cs.usable_rows(1 << self.k)}

    # ---- witness ------------------------------------------------------------

    def phase1_columns(self, tau: int) -> dict:
        """{column: (n, 8) CPU words} of phase 1 at `tau`: a second pass of
        the program, held to the build pass's structure and phase-0
        values; the last one is kept."""
        tau %= rc.FR
        if self._phase1 is not None and self._phase1[0] == tau:
            return self._phase1[1]
        t0 = time.perf_counter()
        p = self._run(tau)
        t1 = time.perf_counter()
        assert self.fingerprint(p) == self._fp, \
            "tau-dependent circuit structure (program bug)"
        v_vals, a_vals, b_words, _ = self._pack(p, None)
        assert np.array_equal(v_vals, self._v_vals0), \
            "phase-0 values changed with tau (program bug)"
        a_words = field.from_ints(FR, a_vals, "cpu")
        out = {i: a_words[j] for j, i in enumerate(self.a_indices)}
        for j, i in enumerate(self.b_indices):
            out[i] = b_words[j]
        self._phase1 = (tau, out)
        self.pass_seconds.append((t1 - t0, time.perf_counter() - t1))
        return out

    def witness(self, device="cuda"):
        """-> (witness_fn, instances) for create_proof / run_mock; the
        columns are (n, 8) int32 canonical words on `device`."""
        instances = self._pass0.instances

        def witness_fn(phase: int, challenges: dict):
            if phase == 0:
                words = field.from_ints(FR, self._v_vals0, device)
                return {i: words[j] for j, i in enumerate(self.v_indices)}
            return {i: w.to(device)
                    for i, w in self.phase1_columns(challenges[0]).items()}

        return witness_fn, instances

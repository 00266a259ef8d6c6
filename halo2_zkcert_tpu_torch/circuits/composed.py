"""Composed circuits: GateBuilder trace + BigintTape lanes in ONE
ConstraintSystem -- the assembly layer for the aggregation circuit.

Counterpart of halo2_zkcert_tpu/circuits/composed.py.  Reference analog:
halo2-base's `BaseCircuitBuilder` packing multiple chip regions into one
circuit [dep Cargo.lock:1135].  The composed circuit is a static
CircuitData plus advice columns as (n, 8) canonical words; the
builder/tape record pass is host bookkeeping, its packing numpy
(`GateBuilder.pack`, `BigintTape.materialize`).

Witness protocol (the tape's phase-1 Horner evals depend on the challenge
tau, which only exists mid-proof):
  * build pass (keygen + phase-0 witness): run the program with a fixed
    dummy tau -- structure and all phase-0 (V-lane) values are
    tau-independent;
  * phase-1 replay: the A lanes and the builder columns at the real
    squeezed tau, from what the build pass recorded, as arrays: each
    'w'/'c' region's Horner accumulator over its limbs, its evaluation
    into the builder cell that mirrors it, and every builder gate that
    reads such a cell, level by level (`GateBuilder.dataflow`); every
    other builder cell keeps its build-pass value.  The program does not
    run again.  `record_phase1(tau)` is the full pass (the program run
    at tau, held to the build pass's structure and phase-0 values), the
    check the replay is held to word for word in tests and under
    H2T_SELFCHECK.
The last phase-1 columns are kept for their tau, so MockProver and a
check of the columns at one tau share one replay.
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..builder import GateBuilder, replay_gates
from ..ops import field
from ..ops.field import FR
from ..plonk import CircuitData, ConstraintSystem
from ..plonk.assignment import CopyArray
from ..utils import refcrypto as rc
from ..utils import trace
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
        a_vals, the builder's `pack`, copies); fills `fixed` unless
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
        return v_vals, a_vals, packed, copies

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
        v_vals, _, packed, copies = self._pack(p, fixed)
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
        self._packed0 = {key: packed[key] for key in
                         ("col", "row", "words", "advice", "lookup")}
        self._replay = None
        self.pass_seconds.append((t1 - t0, time.perf_counter() - t1))

    def rows_report(self) -> dict:
        return {"tape_rows": self._pass0.tape.rows_used(),
                "builder_cells": len(self._pass0.gb.values),
                "usable": self.cs.usable_rows(1 << self.k)}

    # ---- witness ------------------------------------------------------------

    def prepare_replay(self, device) -> "_Replay":
        """The phase-1 replay's record on `device`: made once (from the
        build pass) and kept; `witness` and `phase1_columns` make it at
        their first call where it was not made beforehand."""
        device = torch.device(device)
        if self._replay is None or self._replay.device != device:
            self._replay = _Replay(self, device)
            self._phase1 = None
        return self._replay

    def phase1_columns(self, tau: int, device="cpu") -> dict:
        """{column: (n, 8) words on `device`} of phase 1 at `tau`, replayed;
        the last ones are kept for their tau.  Under H2T_SELFCHECK the full
        pass at tau is compared word for word (`[selfcheck] phase-1 replay:
        OK` or `MISMATCH`)."""
        tau %= rc.FR
        rep = self.prepare_replay(device)
        if self._phase1 is not None and self._phase1[0] == tau:
            return self._phase1[1]
        out = rep.columns(tau)
        self._phase1 = (tau, out)
        if os.environ.get("H2T_SELFCHECK"):
            same = self.replay_matches(tau, out)
            print(f"[selfcheck] phase-1 replay: {'OK' if same else 'MISMATCH'}",
                  flush=True)
        return out

    def record_phase1(self, tau: int) -> dict:
        """{column: (n, 8) CPU words} of phase 1 at `tau` from a full pass
        of the program, held to the build pass's structure and phase-0
        values: what the replay must equal."""
        t0 = time.perf_counter()
        p = self._run(tau % rc.FR)
        t1 = time.perf_counter()
        assert self.fingerprint(p) == self._fp, \
            "tau-dependent circuit structure (program bug)"
        v_vals, a_vals, packed, _ = self._pack(p, None)
        assert np.array_equal(v_vals, self._v_vals0), \
            "phase-0 values changed with tau (program bug)"
        a_words = field.from_ints(FR, a_vals, "cpu")
        out = {i: a_words[j] for j, i in enumerate(self.a_indices)}
        for j, i in enumerate(self.b_indices):
            out[i] = packed["advice"][j]
        self.pass_seconds.append((t1 - t0, time.perf_counter() - t1))
        return out

    def replay_matches(self, tau: int, columns: dict | None = None) -> bool:
        """Whether the replayed phase-1 columns at `tau` (or `columns`)
        equal the full pass's word for word."""
        columns = columns or self.phase1_columns(tau)
        full = self.record_phase1(tau)
        return sorted(full) == sorted(columns) and all(
            torch.equal(full[i], columns[i].cpu()) for i in full)

    def witness(self, device="cuda"):
        """-> (witness_fn, instances) for create_proof / run_mock; the
        columns are (n, 8) int32 canonical words on `device`."""
        instances = self._pass0.instances
        rep = self.prepare_replay(device)

        def witness_fn(phase: int, challenges: dict):
            cols = rep.phase0 if phase == 0 else \
                self.phase1_columns(challenges[0], rep.device)
            with trace.span("witness_h2d", device=device):
                return {i: w.to(device) for i, w in cols.items()}

        return witness_fn, instances


class _Replay:
    """The build pass's record of phase 1, on one device: the tape's
    'w'/'c' limbs and Horner steps (`BigintTape.replay_plan`), the builder's
    words at the dummy tau and the gates that read a region's evaluation
    (`GateBuilder.dataflow`), where each replayed cell is placed, and the
    phase-0 columns.  `columns(tau)` is the replay."""

    def __init__(self, circ: ComposedCircuit, device: torch.device):
        p, packed = circ._pass0, circ._packed0
        n = 1 << circ.k
        self.device = device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        words = field.from_ints(FR, circ._v_vals0, device)
        self.phase0 = {i: words[j] for j, i in enumerate(circ.v_indices)}
        plan = p.tape.replay_plan()
        self.vals = field.from_ints(FR, plan["vals"], device)
        self.steps = [(put(at), put(at - 1)) for at in plan["steps"]]
        self.last, self.eval_cells = put(plan["last"]), put(plan["eval_cells"])
        self.lin_at = tuple(map(put, plan["lin_at"]))
        self.rel_at = tuple(map(put, plan["rel_at"]))
        self.rel_cells = put(plan["rel_cells"])
        levels = p.gb.dataflow(plan["eval_cells"])
        self.levels = [(put(g), put(src)) for g, src in levels]
        # the cells a replay rewrites and where the columns hold them
        cells = np.concatenate([plan["eval_cells"]] + [
            (g[None] + np.arange(4)[:, None]).reshape(-1) for g, _ in levels])
        assert not np.isin(p.gb.instance_cells, cells).any(), \
            "an instance depends on tau (program bug)"
        self.cells = put(cells)
        self.cells_at = (put(packed["col"][cells]), put(packed["row"][cells]))
        rc_idx, lk_cur = packed["lookup"]
        moved = np.isin(rc_idx, cells)
        usable = circ.cs.usable_rows(n)
        na = len(circ._bcols["adv"])
        self.lookup_cells = put(rc_idx[moved])
        self.lookup_at = (put(na + lk_cur[moved] // usable),
                          put(lk_cur[moved] % usable))
        self.words0 = packed["words"].to(device)
        self.advice0 = packed["advice"].to(device)
        self.lanes, self.n = circ.lanes, n
        self.a_indices, self.b_indices = circ.a_indices, circ.b_indices
        self.rows = int(self.vals.shape[0] + self.rel_cells.numel())

    def columns(self, tau: int) -> dict:
        """{column: (n, 8) words on the device} of phase 1 at `tau`."""
        with trace.span("replay"):
            tau_mont = field.const_mont(FR, tau, self.device)
            acc = self.vals.clone()
            for at, above in self.steps:
                acc[at] = field.add(FR, field.mul_mont(FR, acc[above],
                                                       tau_mont), acc[at])
            words = self.words0.clone()
            words[self.eval_cells] = acc[self.last]
            replay_gates(words, self.levels)
            lanes = torch.zeros((self.lanes, self.n, 8), dtype=torch.int32,
                                device=self.device)
            lanes[self.lin_at] = acc
            lanes[self.rel_at] = words[self.rel_cells]
            advice = self.advice0.clone()
            advice[self.cells_at] = words[self.cells]
            advice[self.lookup_at] = words[self.lookup_cells]
            trace.count(replay_rows=self.rows, replay_cells=self.cells.numel())
            out = {i: lanes[j] for j, i in enumerate(self.a_indices)}
            for j, i in enumerate(self.b_indices):
                out[i] = advice[j]
            return out

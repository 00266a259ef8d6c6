"""The quotient constraint forest as a tape, and kernel K4 (quotient_forest).

Counterpart of halo2_zkcert_tpu/plonk/quotient_pallas.py (the per-pk
Pallas kernel) and prover.py:_make_pointwise (its XLA form).  The forest of
one proving key -- every gate, the permutation chunks, the lookups, folded
by y and multiplied by 1/Z_H -- is lowered ONCE into a straight-line tape
over numbered slots:

    (LOAD, dst, column, row offset)   leaf column at (row + offset) mod ext_n
    (CONST, dst, index, 0)            field constant or challenge
    (ADD | SUB | MUL, dst, a, b)

`quotient_forest` runs the tape on every extended-domain row: on a CUDA
tensor it launches csrc/quotient_forest.cu, on a CPU tensor it runs
`quotient_forest_plain`, a torch interpreter of the same tape over whole
columns.  Rotations never enter the arithmetic: a rotated leaf is a row
offset.

Slots are allocated greedily, a value's slot freed after its last read.
The builder memoizes leaves and constants, so a leaf stays live from its
first read to its last; where that needs more than MEMO_SLOTS slots (the
SHA-256 forest: 241, the aggregation forest: 49) every LOAD and CONST is
emitted again just before each instruction that reads it, which keeps the
SHA-256 tape at 80 slots and the aggregation tape at 7.  The RSA tape (17
slots) is the memoized one.

Leaves, constants and the result are in MONTGOMERY form (x * R, R = 2^256;
`field.to_mont` / `field.from_mont`): a MUL is then one Montgomery product
and nothing is converted per row.  The prover keeps the pk's extended
columns so, takes the fresh ones so out of the coset transform
(`ntt.coset_ntt(out_mont=True)`) and hands the result so to the inverse one
(`ntt.coset_intt(in_mont=True)`); `Tape.const_table` converts the constants
once and the challenges per proof.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import field, kernels
from ..ops.field import FR
from ..utils import refcrypto as rc
from . import expression as ex
from .cs import ADVICE, DELTA, FIXED, INSTANCE

LOAD, CONST, ADD, SUB, MUL = 0, 1, 2, 3, 4
_CHAL = -1            # while lowering only: a challenge load, patched to CONST
# slot counts csrc/quotient_forest.cu is instantiated for; a tape runs on the
# smallest that holds it.  The last is TAPE_MAX_SLOTS of csrc/bn254.cuh.
SLOT_SIZES = (8, 12, 17, 24, 32, 48, 96)
MAX_SLOTS = SLOT_SIZES[-1]
# a memoized tape of more slots than this is rematerialized (`_rematerialize`)
MEMO_SLOTS = 48
AUX = ("l0", "llast", "lblind", "ident", "zh_inv")


class Tape:
    """A compiled forest: instructions (T, 4) int32, the slot holding the
    result, the constant pool (challenges are appended at run time), and
    the number of slots used."""

    def __init__(self, ins: np.ndarray, out_slot: int, consts: list,
                 num_slots: int, num_challenges: int):
        self.ins = ins
        self.out_slot = out_slot
        self.consts = consts
        self.num_slots = num_slots
        self.num_challenges = num_challenges
        self._dev: dict = {}

    def device_tables(self, device):
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = (torch.from_numpy(self.ins).to(device),
                 field.from_ints(FR, [c * FR.r for c in self.consts], device))
            self._dev[key] = t
        return t

    def const_table(self, chal: torch.Tensor) -> torch.Tensor:
        """Constants then the canonical challenges `chal`, all in Montgomery
        form, (num_consts + num_challenges, 8)."""
        _, consts = self.device_tables(chal.device)
        return torch.cat((consts, field.to_mont(FR, chal))).contiguous()


class _Builder:
    """SSA construction with memoized leaves, constants and operations."""

    def __init__(self):
        self.ins: list = []
        self.memo: dict = {}
        self.consts: list = []
        self.const_ix: dict = {}

    def _emit(self, op, a, b):
        key = (op, a, b)
        v = self.memo.get(key)
        if v is None:
            v = len(self.ins)
            self.ins.append([op, v, a, b])
            self.memo[key] = v
        return v

    def load(self, col: int, offset: int):
        return self._emit(LOAD, col, offset)

    def const(self, value: int):
        value %= rc.FR
        if value not in self.const_ix:
            self.const_ix[value] = len(self.consts)
            self.consts.append(value)
        return self._emit(CONST, self.const_ix[value], 0)

    def chal(self, i: int):
        return self._emit(_CHAL, i, 0)

    def add(self, a, b):
        return self._emit(ADD, a, b)

    def sub(self, a, b):
        return self._emit(SUB, a, b)

    def mul(self, a, b):
        return self._emit(MUL, a, b)

    def finish(self, out: int, num_challenges: int,
               rematerialize: bool | None = None) -> Tape:
        """`rematerialize`: None to rematerialize the leaves only where the
        memoized tape needs more than MEMO_SLOTS slots (and to require that
        the kernel holds the result); True or False to force either form,
        of any slot count (for the plain version)."""
        for ins in self.ins:
            if ins[0] == _CHAL:
                ins[0], ins[2] = CONST, len(self.consts) + ins[2]
        rows, out_slot, top = _allocate(self.ins, out)
        if rematerialize or (rematerialize is None and top > MEMO_SLOTS):
            rows, out_slot, top = _allocate(*_rematerialize(self.ins, out))
        assert rematerialize is not None or top <= MAX_SLOTS, \
            f"tape needs {top} slots > {MAX_SLOTS}"
        return Tape(np.asarray(rows, dtype=np.int32).reshape(-1, 4),
                    out_slot, list(self.consts), top, num_challenges)


def _rematerialize(ins: list, out: int) -> tuple:
    """The same program with every LOAD and CONST emitted again just before
    each instruction that reads it, so that no leaf stays live between its
    uses: (instructions, out)."""
    leaf = {dst: (op, a, b) for op, dst, a, b in ins if op in (LOAD, CONST)}
    res, rename = [], {}
    for op, dst, a, b in ins:
        if op not in (ADD, SUB, MUL):
            continue
        fresh = {}
        for v in (a, b):
            if v in leaf and v not in fresh:
                fresh[v] = len(res)
                res.append([leaf[v][0], len(res), *leaf[v][1:]])
        a, b = (fresh[v] if v in fresh else rename[v] for v in (a, b))
        rename[dst] = len(res)
        res.append([op, len(res), a, b])
    if out in leaf:
        rename[out] = len(res)
        res.append([leaf[out][0], len(res), *leaf[out][1:]])
    return res, rename[out]


def _allocate(ins: list, out: int) -> tuple:
    """Greedy slot allocation of an SSA program, an operand's slot freed
    after its last use: (rows, the result's slot, slots used)."""
    last = {}
    for t, (op, dst, a, b) in enumerate(ins):
        if op in (ADD, SUB, MUL):
            last[a] = t
            last[b] = t
    last[out] = len(ins)
    slot_of, free, top = {}, [], 0
    rows = []
    for t, (op, dst, a, b) in enumerate(ins):
        if op in (ADD, SUB, MUL):
            sa, sb = slot_of[a], slot_of[b]
            for v in {a, b}:
                if last[v] == t:
                    free.append(slot_of[v])
            a, b = sa, sb
        if free:
            s = free.pop()
        else:
            s, top = top, top + 1
        slot_of[dst] = s
        rows.append([op, s, a, b])
        if last.get(dst, -1) < t:        # never read again
            free.append(s)
    return rows, slot_of[out], top


def leaf_layout(csys) -> dict:
    """Leaf column order: fixed, sigma, aux, then per proof advice,
    instance, permutation Zs, lookup Z / permuted input / permuted table."""
    cols = {}
    for i in range(csys.num_fixed):
        cols[("f", i)] = len(cols)
    for i in range(len(csys.permutation_columns)):
        cols[("sigma", i)] = len(cols)
    for name in AUX:
        cols[("aux", name)] = len(cols)
    for i in range(csys.num_advice):
        cols[("a", i)] = len(cols)
    for i in range(csys.num_instance):
        cols[("i", i)] = len(cols)
    for c in range(csys.num_permutation_chunks()):
        cols[("permz", c)] = len(cols)
    for tag in ("lkz", "lka", "lks"):
        for li in range(len(csys.lookups)):
            cols[(tag, li)] = len(cols)
    return cols


def compile_tape(csys, n: int, ext_n: int,
                 rematerialize: bool | None = None) -> Tape:
    """Lower the quotient forest of `csys` (the same terms, in the same
    order, as the reference's make_kernel / pointwise); `rematerialize` as
    `_Builder.finish` takes it."""
    stride = ext_n // n
    cols = leaf_layout(csys)
    bld = _Builder()
    bf = csys.blinding_factors()
    u_row = n - bf - 1
    chunk_len = csys.permutation_chunk_len()
    perm_cols = csys.permutation_columns
    num_chunks = csys.num_permutation_chunks()

    def leaf(tag, idx, rot=0):
        return bld.load(cols[(tag, idx)], rot * stride)

    cache: dict = {}

    def go(e):
        hit = cache.get(e)
        if hit is not None:
            return hit
        if isinstance(e, ex.Constant):
            v = bld.const(e.value)
        elif isinstance(e, ex.Fixed):
            v = leaf("f", e.index, e.rotation)
        elif isinstance(e, ex.Advice):
            v = leaf("a", e.index, e.rotation)
        elif isinstance(e, ex.Instance):
            v = leaf("i", e.index, e.rotation)
        elif isinstance(e, ex.Challenge):
            v = bld.chal(4 + e.index)
        elif isinstance(e, ex.Sum):
            v = bld.add(go(e.a), go(e.b))
        elif isinstance(e, ex.Product):
            v = bld.mul(go(e.a), go(e.b))
        elif isinstance(e, ex.Scaled):
            v = bld.mul(go(e.a), bld.const(e.scalar))
        else:
            raise TypeError(e)
        cache[e] = v
        return v

    theta, beta, gamma, y = (bld.chal(i) for i in range(4))
    one = bld.const(1)
    l0, llast = leaf("aux", "l0"), leaf("aux", "llast")
    active = bld.sub(one, bld.add(llast, leaf("aux", "lblind")))
    h = None

    def acc(term):
        nonlocal h
        h = term if h is None else bld.add(bld.mul(h, y), term)

    for _, g in csys.gates:
        acc(go(g))
    if num_chunks:
        permz = [leaf("permz", c) for c in range(num_chunks)]
        acc(bld.mul(l0, bld.sub(one, permz[0])))
        acc(bld.mul(llast, bld.sub(bld.mul(permz[-1], permz[-1]), permz[-1])))
        for c in range(1, num_chunks):
            acc(bld.mul(l0, bld.sub(permz[c], leaf("permz", c - 1, u_row))))
        ident = leaf("aux", "ident")
        kind_tag = {ADVICE: "a", INSTANCE: "i", FIXED: "f"}
        for ci in range(num_chunks):
            left, right = leaf("permz", ci, 1), permz[ci]
            for pos, col in enumerate(perm_cols[ci * chunk_len:
                                                (ci + 1) * chunk_len]):
                gpos = ci * chunk_len + pos
                v = leaf(kind_tag[col.kind], col.index)
                left = bld.mul(left, bld.add(bld.add(
                    v, bld.mul(leaf("sigma", gpos), beta)), gamma))
                dg = bld.const(pow(DELTA, gpos, rc.FR))
                right = bld.mul(right, bld.add(bld.add(
                    v, bld.mul(ident, bld.mul(beta, dg))), gamma))
            acc(bld.mul(active, bld.sub(left, right)))
    for li, lk in enumerate(csys.lookups):
        z, z_next = leaf("lkz", li), leaf("lkz", li, 1)
        a_p, a_prev = leaf("lka", li), leaf("lka", li, -1)
        s_p = leaf("lks", li)
        a_comp = s_comp = None
        for p_in, _ in lk.pairs:
            v = go(p_in)
            a_comp = v if a_comp is None else bld.add(bld.mul(a_comp, theta), v)
        for _, p_tab in lk.pairs:
            v = go(p_tab)
            s_comp = v if s_comp is None else bld.add(bld.mul(s_comp, theta), v)
        acc(bld.mul(l0, bld.sub(one, z)))
        acc(bld.mul(llast, bld.sub(bld.mul(z, z), z)))
        lhs = bld.mul(bld.mul(z_next, bld.add(a_p, beta)), bld.add(s_p, gamma))
        rhs = bld.mul(bld.mul(z, bld.add(a_comp, beta)),
                      bld.add(s_comp, gamma))
        acc(bld.mul(active, bld.sub(lhs, rhs)))
        acc(bld.mul(l0, bld.sub(a_p, s_p)))
        acc(bld.mul(bld.mul(active, bld.sub(a_p, s_p)), bld.sub(a_p, a_prev)))
    out = bld.mul(h, leaf("aux", "zh_inv"))
    return bld.finish(out, 4 + csys.num_challenges, rematerialize)


# ---------------------------------------------------------------------------
# plain interpreter and K4 wrapper
# ---------------------------------------------------------------------------

def quotient_forest_plain(leaves: torch.Tensor, consts: torch.Tensor,
                          tape: Tape) -> torch.Tensor:
    """Run the tape over whole columns: leaves (L, ext_n, 8), consts
    (K, 8) -> (ext_n, 8), Montgomery form in and out."""
    slots: list = [None] * tape.num_slots
    for op, dst, a, b in tape.ins.tolist():
        if op == LOAD:
            v = torch.roll(leaves[a], -b, dims=0)
        elif op == CONST:
            v = consts[a]
        else:
            v = field.binop_plain(FR, {ADD: "add", SUB: "sub", MUL: "mulm"}[op],
                                  slots[a], slots[b])
        slots[dst] = v
    return slots[tape.out_slot].expand(leaves.shape[1:]).contiguous()


def quotient_forest(leaves: torch.Tensor, consts: torch.Tensor,
                    tape: Tape) -> torch.Tensor:
    if leaves.device.type == "cpu":
        return quotient_forest_plain(leaves, consts, tape)
    leaves, consts = leaves.contiguous(), consts.contiguous()
    ins, _ = tape.device_tables(leaves.device)
    kernels.require_cuda_int32("quotient_forest", leaves, consts, ins)
    L, n_rows = leaves.shape[:2]
    if leaves.shape[-1] != 8 or n_rows & (n_rows - 1):
        raise ValueError("quotient_forest: leaves must be (L, 2^k, 8)")
    if consts.shape[0] != len(tape.consts) + tape.num_challenges:
        raise ValueError("quotient_forest: constant table size mismatch")
    out = torch.empty((n_rows, 8), dtype=torch.int32, device=leaves.device)
    lib = kernels.lib("quotient_forest")
    kernels.launches["quotient_forest"] += 1
    kernels.check(lib.h2t_quotient_forest(
        leaves.data_ptr(), n_rows, consts.data_ptr(), ins.data_ptr(),
        ins.shape[0], tape.num_slots, tape.out_slot, out.data_ptr(),
        kernels.stream_ptr(leaves.device)), "quotient_forest")
    return out

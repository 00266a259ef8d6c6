"""MockProver: constraint satisfaction check without proving.

Counterpart of halo2_zkcert_tpu/plonk/mock.py (halo2_proofs `MockProver`):
evaluates every gate, lookup and copy constraint directly over the witness
table and reports failures with the JAX package's strings, in its order.

It runs on the advice tensor's device: gates through the expression
evaluator and the field ops (kernel K1 on the card), in row chunks of at
most `CHUNK` rows whose size bounds memory; lookups compare the rows of
the evaluated input and table tuples; copies gather both cells of every
copy at once and compare their words.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import field
from ..ops.field import FR
from ..utils import refcrypto as rc
from . import expression as ex
from .assignment import CircuitData, CopyArray, copy_table
from .prover import instance_lagrange

CHUNK = 1 << 19


class MockFailure(AssertionError):
    pass


def mock_challenges(csys) -> dict:
    """Deterministic pseudo-random challenges for MockProver runs (the
    real ones are transcript-derived; for constraint checking any
    unpredictable-to-the-circuit value works)."""
    out = {}
    for i in range(csys.num_challenges):
        d = rc.blake2b(b"mock-challenge" + i.to_bytes(4, "little"), 64)
        out[i] = rc.fr_from_u512_le(d[:32], d[32:])
    return out


def run_mock(data: CircuitData, advice, instances: list,
             raise_on_failure: bool = True) -> list:
    """Returns a list of failure strings (empty == satisfied).

    `advice` is an (num_advice, n, 8) tensor or a per-phase callable (the
    contract of create_proof); challenges are `mock_challenges`.  The
    fixed and instance columns go to the advice's device.
    """
    csys = data.cs
    n = data.n
    usable = csys.usable_rows(n)
    failures = []

    challenges = mock_challenges(csys)
    if callable(advice):
        cols: list = [None] * csys.num_advice
        for phase in range(csys.num_phases):
            # challenges of earlier phases are available (halo2 semantics)
            ch = {i: challenges[i] for i in range(csys.num_challenges)
                  if csys.challenge_phases[i] < phase}
            for i, colv in advice(phase, ch).items():
                cols[i] = colv
        advice = torch.stack(cols)
    dev = advice.device
    fixed = data.fixed_tensor(dev)
    inst = [instance_lagrange(col, n, dev) for col in instances]
    while len(inst) < csys.num_instance:
        inst.append(torch.zeros((n, 8), dtype=torch.int32, device=dev))

    def leaf_eval(e, off, length):
        idx = torch.arange(off, off + length, device=dev)

        def rot_take(col, r):
            return col[(idx + r) % n]

        def bcast(v):
            return field.const(FR, v, dev).expand(length, 8)

        return ex.evaluate(
            e,
            constant=bcast,
            fixed=lambda i, r: rot_take(fixed[i], r),
            advice=lambda i, r: rot_take(advice[i], r),
            instance=lambda i, r: rot_take(inst[i], r),
            challenge=lambda i: bcast(challenges[i]),
            add=lambda a, b: field.add(FR, a, b),
            mul=lambda a, b: field.mul(FR, a, b),
            scale=lambda a, s: field.mul_const(FR, a, s),
        )

    def eval_rows(e, upto):
        """The expression's words over rows [0, upto), on the host."""
        return np.concatenate([
            leaf_eval(e, off, min(CHUNK, upto - off)).cpu().numpy()
            for off in range(0, upto, CHUNK)], axis=0)

    # gates vanish on every usable row; the first five failing rows a gate
    for name, g in csys.gates:
        bad_count = 0
        for off in range(0, usable, CHUNK):
            length = min(CHUNK, usable - off)
            vals = leaf_eval(g, off, length)
            bad = torch.nonzero(vals.ne(0).any(dim=-1)).flatten().tolist()
            for row in bad[:5 - bad_count]:
                failures.append(
                    f"gate '{name}' not satisfied at row {off + row}")
            bad_count += len(bad)
            if bad_count >= 5:
                break

    # lookups: every input tuple appears among the table tuples
    for lk in csys.lookups:
        ins = np.stack([eval_rows(p[0], usable) for p in lk.pairs], axis=1)
        tbs = np.stack([eval_rows(p[1], usable) for p in lk.pairs], axis=1)
        width = ins.shape[1] * 32
        raw_t = tbs.tobytes()
        table = {raw_t[i:i + width] for i in range(0, usable * width, width)}
        raw = ins.tobytes()
        for r in range(usable):
            if raw[r * width:(r + 1) * width] not in table:
                tup = tuple(field.words_to_ints(ins[r]))
                failures.append(
                    f"lookup '{lk.name}' failure at row {r}: {tup} not in table")
                break

    # copy constraints, in the copy list's order
    tab = torch.from_numpy(copy_table(data.copies)).to(dev)
    if tab.shape[0]:
        columns = {CopyArray.CODES["fixed"]: fixed,
                   CopyArray.CODES["advice"]: advice,
                   CopyArray.CODES["instance"]: torch.stack(inst)
                   if inst else None}

        def words(side):
            out = torch.zeros((tab.shape[0], 8), dtype=torch.int32,
                              device=dev)
            for code, src in columns.items():
                sel = tab[:, side, 0] == code
                if src is not None and bool(sel.any()):
                    out[sel] = src[tab[sel, side, 1], tab[sel, side, 2]]
            return out

        wa, wb = words(0), words(1)
        bad = torch.nonzero(wa.ne(wb).any(dim=-1)).flatten().cpu().numpy()
        if bad.size:
            va, vb = field.words_to_ints(wa[bad]), field.words_to_ints(wb[bad])
            pairs = CopyArray(tab[bad].cpu().numpy())
            for (a, b), x, y in zip(pairs, va, vb):
                failures.append(
                    f"copy constraint violated: {a}={x} != {b}={y}")

    if failures and raise_on_failure:
        raise MockFailure("\n".join(failures[:20]))
    return failures

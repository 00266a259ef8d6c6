"""The verifying key of a circuit's layout, worked out in Python ints with
the SRS's secret: a commitment to a column of values v_r is
(sum_r v_r L_r(tau)) G, with L_r the Lagrange basis of the 2^k domain.

The permutation's sigma columns follow the copy cycles: the cells of a
connected component of the copy graph, ordered by their first appearance in
the copy list (a0, b0, a1, b1, ...), each mapped to the next (the last to
the first), every other cell to itself.  sum_r omega^r L_r(tau) = tau, so an
identity column commits to delta^c tau and only moved cells cost a term.
"""
from __future__ import annotations

from operator import mul

import numpy as np

from . import bn254 as B
from . import plonk
from .bn254 import FR
from .plonk import ADVICE, FIXED, INSTANCE, VerifyingKey

KIND_CODES = {ADVICE: 0, FIXED: 1, INSTANCE: 2}


def _pick(values: list, idx) -> list:
    return [values[i] for i in idx]


class Basis:
    """omega^r and L_r(tau) for r < 2^k."""

    def __init__(self, k: int, tau: int):
        n = 1 << k
        self.k, self.n, self.tau = k, n, tau
        w = B.root_of_unity(k)
        pw = [1] * n
        for i in range(1, n):
            pw[i] = pw[i - 1] * w % FR
        den = [(tau - x) % FR for x in pw]
        pre = [1] * (n + 1)
        for i, d in enumerate(den):
            pre[i + 1] = pre[i] * d % FR
        inv = B.finv(pre[n], FR)
        scale = (pow(tau, n, FR) - 1) * B.finv(n, FR) % FR
        lag = [0] * n
        for i in range(n - 1, -1, -1):
            lag[i] = scale * pw[i] % FR * (pre[i] * inv % FR) % FR
            inv = inv * den[i] % FR
        self.omega_pows, self.lagrange = pw, lag

    def commit(self, scalar: int):
        return B.g1_to_affine(B.g1_mul(B.g1_from_affine(B.G1_GEN), scalar))

    def column_scalar(self, rows, values=None) -> int:
        """sum v_r L_r(tau) over the given rows (values 1 where None)."""
        lag = _pick(self.lagrange, np.asarray(rows, dtype=np.int64).tolist())
        if values is None:
            return sum(lag) % FR
        return sum(map(mul, lag, [int(v) % FR for v in values])) % FR


def _components(count: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A root label for each node of an undirected graph: roots hooked onto
    the smaller root across each edge, then paths halved to a fixpoint."""
    parent = np.arange(count, dtype=np.int64)
    while True:
        pu, pv = parent[u], parent[v]
        lo, hi = np.minimum(pu, pv), np.maximum(pu, pv)
        moved = lo != hi
        if not moved.any():
            return parent
        np.minimum.at(parent, hi[moved], lo[moved])
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt


def sigma_moves(copies: np.ndarray, perm_columns: list, n: int):
    """(cells, targets) as column-position * n + row, for every cell that
    the permutation moves; `copies` is (m, 2, 3) (kind code, column, row)."""
    pos = {(KIND_CODES[c.kind], c.index): i for i, c in enumerate(perm_columns)}
    tab = np.asarray(copies, dtype=np.int64).reshape(-1, 2, 3)
    if not tab.shape[0]:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lut = np.full((3, int(tab[:, :, 1].max()) + 1), -1, dtype=np.int64)
    for (kind, col), i in pos.items():
        if col < lut.shape[1]:
            lut[kind, col] = i
    p = lut[tab[:, :, 0], tab[:, :, 1]]
    if (p < 0).any():
        raise ValueError("a copy names a column outside the permutation")
    seq = (p * n + tab[:, :, 2]).reshape(-1)
    cells, first, inv = np.unique(seq, return_index=True, return_inverse=True)
    edges = inv.reshape(-1, 2)
    label = _components(cells.size, edges[:, 0], edges[:, 1])
    order = np.lexsort((first, label))
    members, lab = cells[order], label[order]
    last = np.append(lab[1:] != lab[:-1], True)
    start = np.concatenate(([0], np.nonzero(last)[0][:-1] + 1))
    nxt = np.roll(members, -1)
    nxt[last] = members[start]
    keep = nxt != members
    return members[keep], nxt[keep]


def verifying_key(k: int, cs, fixed: dict, copies: np.ndarray,
                  num_instance: list, basis: Basis) -> VerifyingKey:
    """`fixed`: column index -> (rows, values or None for ones)."""
    n = 1 << k
    fixed_c = []
    for j in range(cs.num_fixed):
        rows, vals = fixed.get(j, ([], []))
        fixed_c.append(basis.commit(basis.column_scalar(rows, vals)))
    m = len(cs.permutation_columns)
    dpow = [pow(B.DELTA, c, FR) for c in range(m)]
    cells, targets = sigma_moves(copies, cs.permutation_columns, n)
    W, L = basis.omega_pows, basis.lagrange
    perm_c = []
    for c in range(m):
        sel = (cells // n) == c
        rows, tg = cells[sel] % n, targets[sel]
        lag = _pick(L, rows.tolist())
        s = dpow[c] * (basis.tau - sum(map(mul, _pick(W, rows.tolist()),
                                           lag))) % FR
        tcol = tg // n
        for c2 in np.unique(tcol).tolist():
            m2 = tcol == c2
            part = sum(map(mul, _pick(W, (tg[m2] % n).tolist()),
                           _pick(lag, np.nonzero(m2)[0].tolist())))
            s = (s + dpow[c2] * part) % FR
        perm_c.append(basis.commit(s))
    return VerifyingKey(k=k, cs=cs, fixed_commitments=fixed_c,
                        permutation_commitments=perm_c,
                        num_instance=list(num_instance))


class PlonkReference:
    """The reference of a circuit proved by the PLONK verifier above: its
    verifying key worked out from the layout (`cs`, `fixed`, `copies`,
    `num_instance`) with the SRS's secret, and `statement(job)`, the
    instance columns a job's proof has to prove."""

    def __init__(self, k: int, cs, fixed: dict, copies: np.ndarray,
                 num_instance: list, statement, tau: int):
        self.cs, self.tau, self.statement = cs, tau, statement
        self.vk = verifying_key(k, cs, fixed, copies, num_instance,
                                Basis(k, tau))

    def verify(self, job: int, proof: bytes) -> bool:
        return plonk.verify(self.vk, self.statement(job), proof, self.tau)

    def random_commitment(self, proof: bytes) -> bytes:
        return plonk.random_commitment(self.cs, proof)

    def key_differences(self, fixed: list, permutation: list) -> int:
        """How many of a verifying key's commitments differ from these."""
        mine = self.vk.fixed_commitments + self.vk.permutation_commitments
        theirs = [tuple(p) for p in fixed] + [tuple(p) for p in permutation]
        if len(mine) != len(theirs):
            return max(len(mine), len(theirs))
        return sum(a != b for a, b in zip(mine, theirs))

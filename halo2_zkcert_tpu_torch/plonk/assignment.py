"""Concrete circuit data: fixed columns, equality constraints, witness hooks,
and the deterministic blinding stream.

Counterpart of halo2_zkcert_tpu/plonk/assignment.py: a circuit is compiled
(host-side, once) into a `ConstraintSystem`, fixed-column values, the copy
list and a witness program producing the advice columns as tensors.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import field as fops
from ..ops.field import FR
from ..utils import refcrypto as rc
from ..utils import trace
from .cs import ADVICE, FIXED, INSTANCE, ConstraintSystem


@dataclass
class CircuitData:
    """Static circuit description + fixed assignment (the keygen input)."""
    cs: ConstraintSystem
    k: int
    # (num_fixed, n) object/int64 numpy of field values (host ints),
    # built host-side once
    fixed: np.ndarray
    # equality constraints: ((kind, col, row), (kind, col, row))
    copies: list = field(default_factory=list)
    # per instance column, how many leading rows carry public values
    num_instance: list = field(default_factory=list)
    # aggregation circuits: [(col, row)] of the 8 accumulator limb instances
    accumulator_indices: list | None = None

    @property
    def n(self) -> int:
        return 1 << self.k

    def cache_digest_bytes(self) -> bytes:
        """Digest that tells whether a saved pk was made from this circuit
        (sdk.gen_pk): the constraint system, k, the instance rows, and a
        deterministic sample of every fixed column (strided rows, the first
        and last 64) and of the copy list.  The same blake2b, persona
        `h2t-pkcache`, as the JAX package's, so a pk either package wrote
        is recognised by the other's gen_pk."""
        parts = [self.cs.digest_bytes(),
                 f"k={self.k};ninst={self.num_instance};"
                 f"acc={self.accumulator_indices}".encode()]
        n = self.n
        step = max(1, n // 2048)
        rows = sorted(set(range(0, n, step)) | set(range(min(64, n)))
                      | set(range(max(0, n - 64), n)))
        for col in self.fixed:
            parts.append(b"|col|")
            parts.extend((int(col[r]) % rc.FR).to_bytes(32, "little")
                         for r in rows)
        cp = self.copies
        parts.append(f"ncopies={len(cp)}".encode())
        cstep = max(1, len(cp) // 4096)
        sample = list(cp[:256]) + list(cp[-256:]) + list(cp[::cstep])
        parts.append(repr(sample).encode())
        return rc.blake2b(b"".join(parts), 32, persona=b"h2t-pkcache")

    def fixed_tensor(self, device) -> torch.Tensor:
        """(num_fixed, n, 8) canonical words of the fixed columns on
        `device`, reduced mod r on the host."""
        if not len(self.fixed):
            return torch.zeros((0, self.n, 8), dtype=torch.int32,
                               device=device)
        return fops.from_ints(FR, self.fixed, device)


class CopyArray(Sequence):
    """Copy constraints held as one (m, 2, 3) int64 array of (kind code,
    column, row) pairs: a list of ((kind, col, row), (kind, col, row))
    tuples to whoever reads it as one, without millions of tuples in
    memory (a gate-level circuit holds millions of copies)."""

    KINDS = (ADVICE, FIXED, INSTANCE)
    CODES = {k: i for i, k in enumerate(KINDS)}

    def __init__(self, table: np.ndarray):
        self.table = np.ascontiguousarray(table, dtype=np.int64).reshape(
            -1, 2, 3)

    def __len__(self) -> int:
        return self.table.shape[0]

    def _pairs(self, rows) -> list:
        kinds = self.KINDS
        return [((kinds[a[0]], a[1], a[2]), (kinds[b[0]], b[1], b[2]))
                for a, b in rows.tolist()]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._pairs(self.table[i])
        return self._pairs(self.table[i][None])[0]

    def __iter__(self):
        for start in range(0, len(self), 1 << 16):
            yield from self._pairs(self.table[start:start + (1 << 16)])


def copy_table(copies) -> np.ndarray:
    """(m, 2, 3) int64 (kind code, column, row) of a copy list or a
    `CopyArray`."""
    if isinstance(copies, CopyArray):
        return copies.table
    codes = CopyArray.CODES
    flat = [v for a, b in copies
            for v in (codes[a[0]], a[1], a[2], codes[b[0]], b[1], b[2])]
    return np.asarray(flat, dtype=np.int64).reshape(-1, 2, 3)


def permutation_mapping(data: CircuitData) -> np.ndarray:
    """Build the sigma mapping from the copy list.

    Returns `mapping` of shape (num_perm_columns, n, 2) where
    mapping[c, r] = (c', r'): the next cell in the cycle containing (c, r)
    (identity for unconstrained cells).  Cells are identified by their
    position in cs.permutation_columns.

    The JAX package's mapping exactly: its cycles are the connected
    components of the copy graph, each ordered by the first appearance of
    its cells in the copy list (a0, b0, a1, b1, ...).  Here the components
    come from scipy's connected_components and the ordering from one sort,
    where the JAX package runs a union-find in Python (45 s for the 4.8 M
    copies of the 970-byte gate-level SHA-256).

    Reference behavior: halo2_proofs permutation::keygen::Assembly [dep] —
    same cycle semantics, different (but equivalent) cycle orientation.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    csys = data.cs
    n = data.n
    cols = csys.permutation_columns
    m = len(cols)
    ident = np.arange(m * n, dtype=np.int64)
    tab = copy_table(data.copies)
    if tab.shape[0]:
        pos = np.full((len(CopyArray.KINDS),
                       1 + max(int(tab[:, :, 1].max()),
                               max((c.index for c in cols), default=0))),
                      -1, dtype=np.int64)
        for i, c in enumerate(cols):
            pos[CopyArray.CODES[c.kind], c.index] = i
        p = pos[tab[:, :, 0], tab[:, :, 1]]
        if (p < 0).any():
            kind, col = tab[:, :, :2][p < 0][0].tolist()
            raise ValueError(f"column ({CopyArray.KINDS[kind]},{col}) not "
                             f"enabled for permutation")
        rows = tab[:, :, 2]
        if ((rows < 0) | (rows >= n)).any():
            raise ValueError(f"copy row outside [0, {n})")
        seq = (p * n + rows).reshape(-1)       # a0, b0, a1, b1, ...
        cells, first, inv = np.unique(seq, return_index=True,
                                      return_inverse=True)
        edges = inv.reshape(-1, 2)
        graph = coo_matrix((np.ones(len(edges), dtype=np.int8),
                            (edges[:, 0], edges[:, 1])),
                           shape=(cells.size, cells.size))
        _, label = connected_components(graph, directed=False)
        order = np.lexsort((first, label))
        members, lab = cells[order], label[order]
        last = np.append(lab[1:] != lab[:-1], True)
        start = np.concatenate(([0], np.nonzero(last)[0][:-1] + 1))
        nxt = np.roll(members, -1)
        nxt[last] = members[start]
        ident[members] = nxt
    return np.stack([ident // n, ident % n], axis=-1).reshape(m, n, 2)


# ---------------------------------------------------------------------------
# Deterministic blinding RNG (SURVEY.md §5: reference uses OsRng; we use a
# seeded stream for cross-host determinism + reproducible debugging)
# ---------------------------------------------------------------------------

class BlindingRng:
    def __init__(self, seed: bytes = b"halo2-zkcert-tpu-blinding"):
        self.seed = seed
        self.ctr = 0

    def next_fr(self) -> int:
        d = rc.blake2b(self.seed + self.ctr.to_bytes(8, "little"), 64)
        self.ctr += 1
        return rc.fr_from_u512_le(d[:32], d[32:])

    def fill(self, count: int) -> list:
        return [self.next_fr() for _ in range(count)]

    @trace.traced("blinding")
    def fill_words(self, count: int, device) -> torch.Tensor:
        """Bulk blinding draw: (count, 8) canonical words on `device`.

        One blake2b-derived key expands through a counter-based Philox
        stream (numpy-specified, platform/version deterministic) into
        256-bit values, as the JAX package's `fill_limbs` draws them; those
        are not reduced mod r there, so they are reduced here: the same
        residues, the same commitments.  Advances `ctr` so interleaved
        scalar draws stay distinct."""
        d = rc.blake2b(self.seed + b"|bulk|" + self.ctr.to_bytes(8, "little"),
                       16)
        self.ctr += count
        key = np.frombuffer(d, dtype="<u8")   # 2 x u64 Philox key
        gen = np.random.Generator(np.random.Philox(key=key))
        raw = gen.integers(0, 256, size=(count, 32), dtype=np.uint8)
        limbs = np.zeros((count, 33), dtype=np.int32)
        limbs[:, :32] = raw
        return fops.from_resident(FR, torch.from_numpy(limbs).to(device))

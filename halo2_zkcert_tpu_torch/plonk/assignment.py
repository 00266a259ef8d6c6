"""Concrete circuit data: fixed columns, equality constraints, witness hooks,
and the deterministic blinding stream.

Counterpart of halo2_zkcert_tpu/plonk/assignment.py: a circuit is compiled
(host-side, once) into a `ConstraintSystem`, fixed-column values, the copy
list and a witness program producing the advice columns as tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import field as fops
from ..ops.field import FR
from ..utils import refcrypto as rc
from .cs import ConstraintSystem


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
        out = torch.empty((len(self.fixed), self.n, 8), dtype=torch.int32,
                          device=device)
        for i, col in enumerate(self.fixed):
            out[i] = fops.from_ints(FR, col, device)
        return out


def permutation_mapping(data: CircuitData) -> np.ndarray:
    """Build the sigma mapping from the copy list.

    Returns `mapping` of shape (num_perm_columns, n, 2) where
    mapping[c, r] = (c', r'): the next cell in the cycle containing (c, r)
    (identity for unconstrained cells).  Cells are identified by their
    position in cs.permutation_columns.

    Reference behavior: halo2_proofs permutation::keygen::Assembly [dep] —
    same cycle semantics, different (but equivalent) cycle orientation.
    """
    csys = data.cs
    n = data.n
    cols = csys.permutation_columns
    col_pos = {(c.kind, c.index): i for i, c in enumerate(cols)}
    m = len(cols)
    # union-find over m*n cells
    parent = np.arange(m * n, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def cell_id(kind: str, col: int, row: int) -> int:
        pos = col_pos.get((kind, col))
        if pos is None:
            raise ValueError(f"column ({kind},{col}) not enabled for permutation")
        assert 0 <= row < n
        return pos * n + row

    pairs = [(cell_id(*a), cell_id(*b)) for a, b in data.copies]
    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    # group members per root, then orient each group as one cycle
    groups: dict = {}
    seen = set()
    for a, b in pairs:
        for x in (a, b):
            if x not in seen:
                seen.add(x)
                groups.setdefault(find(x), []).append(x)
    mapping = np.stack(
        [np.tile(np.arange(m, dtype=np.int64)[:, None], (1, n)).reshape(m, n),
         np.tile(np.arange(n, dtype=np.int64)[None, :], (m, 1))], axis=-1)
    for members in groups.values():
        if len(members) < 2:
            continue
        for i, x in enumerate(members):
            y = members[(i + 1) % len(members)]
            mapping[x // n, x % n] = (y // n, y % n)
    return mapping


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

"""In-circuit Poseidon permutation/sponge over GateBuilder cells.
Counterpart of halo2_zkcert_tpu/circuits/poseidon_gadget.py.

The aggregation circuit (SURVEY.md §3.4) replays each inner proof's
Fiat-Shamir transcript inside the circuit; this gadget mirrors
`transcript.poseidon` exactly (same Grain constants, same duplex sponge
conventions), with field ops as vertical-gate rows.

Cost: one permutation = 8 full rounds (3 sboxes) + 57 partial (1 sbox) +
65 MDS applications ~ 1.1k trace cells.
"""
from __future__ import annotations

from ..builder import Cell, GateBuilder
from ..transcript.poseidon import R_F, R_P, RATE, T, poseidon_constants
from ..utils import refcrypto as rc


def permute_cells(gb: GateBuilder, state: list) -> list:
    """HADES permutation on T=3 cells (mirrors
    transcript.poseidon.permute_plain)."""
    rcs, mds = poseidon_constants(rc.FR)
    half = R_F // 2
    s = list(state)
    for r in range(R_F + R_P):
        s = [gb.add_const(s[i], rcs[r][i]) for i in range(T)]
        if half <= r < half + R_P:
            s[0] = gb.pow5(s[0])
        else:
            s = [gb.pow5(x) for x in s]
        new = []
        for i in range(T):
            acc = gb.mul_const(s[0], mds[i][0])
            for j in range(1, T):
                acc = gb.mul_add(s[j], gb.constant(mds[i][j]), acc)
            new.append(acc)
        s = new
    return s


class PoseidonSpongeGadget:
    """Duplex sponge over cells — bit-compatible with `PoseidonSponge`."""

    def __init__(self, gb: GateBuilder):
        self.gb = gb
        self.state = [gb.constant(1 << 64), gb.constant(0), gb.constant(0)]
        self.buf: list = []

    def update(self, cells: list) -> None:
        self.buf.extend(cells)

    def squeeze(self) -> Cell:
        gb = self.gb
        inputs = self.buf + [gb.constant(1)]
        self.buf = []
        for off in range(0, len(inputs), RATE):
            chunk = inputs[off:off + RATE]
            for i, c in enumerate(chunk):
                self.state[i + 1] = gb.add(self.state[i + 1], c)
            self.state = permute_cells(gb, self.state)
        return self.state[1]

"""SHA-256 PLONKish circuit in the bit-plane layout.

Counterpart of halo2_zkcert_tpu/circuits/sha256.py: prove
`digest = SHA256(message)` for a message of fixed length, the digest exposed
as two u128 public instances `[lo, hi]` (big-endian halves).  The layout,
the gates and the fixed columns are the JAX package's, so the constraint
system has the same digest and a key made by either package fits both:

* 32 shared bit columns + 3 carry/aux columns.  Rows come in round triplets
  [W, E, A]: round r of a block occupies rows 3(r+4)+{0,1,2} from the
  block's base; the first 4 triplets hold the incoming state (H0..H7 for
  block 0 through constants, the running H' for later blocks), so every
  state reference is a fixed rotation (round r-k <-> rotation -3k).
* The digest-update rows (H'_i = H_i + reg mod 2^32) double as the next
  block's state-history rows: one gate with rotations -204 / -12 chains the
  blocks with no copy constraints.
* e-row:  e_r = d + h + S1(e_{r-1}) + Ch(e_{r-1}, e_{r-2}, e_{r-3}) + K_r + W_r
* a-row:  a_r = e_r + (2^32 - d) + S0(a_{r-1}) + Maj(a_{r-1..3})
* schedule: W_r = s1(W_{r-2}) + W_{r-7} + s0(W_{r-15}) + W_{r-16}
  (XOR3 of bits as x+y+z-2(xy+yz+zx)+4xyz; carries are boolean aux cells).
* Padding: fully constant words are pinned by a value gate, the one
  message/padding boundary word byte by byte by 4 byte gates.
* The digest is packed into two u128 cells copied to the instance column.

Max gate degree 4 (selector x xor3), so the extended domain is 4n.

The JAX package's `_quotient_custom_fn` is not ported.  XLA could not
compile this circuit's expression forest as one program, so on the TPU a
vectorized evaluator of the same gate polynomials takes its place
(`CircuitData.quotient_custom`).  Here K4 (csrc/quotient_forest.cu) runs
the forest as a tape, as it does every key's: 6785 instructions, 80 slots
once plonk/quotient.py rematerializes the leaves.  The quotient values, and
so the proof bytes, are the same.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import field
from ..plonk import ADVICE, INSTANCE, CircuitData, Column, ConstraintSystem
from ..plonk import expression as ex

NBITS = 32
NADVICE = NBITS + 3          # 32 bit cols + carries c0, c1, c2
ROWS_PER_BLOCK = 204         # (4 history + 64 round) triplets * 3
DIG_REGION = 12              # final digest-update region
PACK_ROWS = 2                # lo / hi packing rows

K_CONST = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
H_INIT = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def num_blocks(msg_len: int) -> int:
    """SHA-256 block count after padding (msg_len in bytes)."""
    return (msg_len + 8) // 64 + 1


def min_k(msg_len: int) -> int:
    rows = num_blocks(msg_len) * ROWS_PER_BLOCK + DIG_REGION + PACK_ROWS
    k = 1
    # + generous blinding allowance; exact usable check done in build
    while (1 << k) < rows + 64:
        k += 1
    return k


# ---------------------------------------------------------------------------
# expression builders
# ---------------------------------------------------------------------------

def _bit(col: int, rot: int) -> ex.Advice:
    return ex.Advice(col, rot)


def _word_val(rot: int) -> ex.Expr:
    """sum_j 2^j bit_j at the given row rotation."""
    acc = None
    for j in range(NBITS):
        t = ex.Scaled(_bit(j, rot), 1 << j)
        acc = t if acc is None else ex.Sum(acc, t)
    return acc


def _xor2(x: ex.Expr, y: ex.Expr) -> ex.Expr:
    return x + y - 2 * (x * y)


def _xor3(x: ex.Expr, y: ex.Expr, z: ex.Expr) -> ex.Expr:
    s = x + y + z
    p = x * y + y * z + x * z
    return s - 2 * p + 4 * (x * y * z)


def _rotr_bit(col_of, j: int, sh: int) -> ex.Expr:
    """bit j of rotr(x, sh) = x bit (j + sh) % 32."""
    return col_of((j + sh) % NBITS)


def _sigma_val(rot: int, shs: tuple, shift_last: bool = False) -> ex.Expr:
    """sum_j 2^j (rotr_a ^ rotr_b ^ rotr_c|shr_c) of the word at `rot`."""
    acc = None
    for j in range(NBITS):
        x = _bit((j + shs[0]) % NBITS, rot)
        y = _bit((j + shs[1]) % NBITS, rot)
        if shift_last:
            # shr: bit j of (x >> s) = bit j+s if j+s < 32 else absent
            if j + shs[2] < NBITS:
                z = _bit(j + shs[2], rot)
                b = _xor3(x, y, z)
            else:
                b = _xor2(x, y)
        else:
            z = _bit((j + shs[2]) % NBITS, rot)
            b = _xor3(x, y, z)
        t = ex.Scaled(b, 1 << j)
        acc = t if acc is None else ex.Sum(acc, t)
    return acc


def _ch_val(re: int, rf: int, rg: int) -> ex.Expr:
    acc = None
    for j in range(NBITS):
        e, f, g = _bit(j, re), _bit(j, rf), _bit(j, rg)
        b = e * f + g - e * g
        t = ex.Scaled(b, 1 << j)
        acc = t if acc is None else ex.Sum(acc, t)
    return acc


def _maj_val(ra: int, rb: int, rc_: int) -> ex.Expr:
    acc = None
    for j in range(NBITS):
        a, b, c = _bit(j, ra), _bit(j, rb), _bit(j, rc_)
        m = a * b + b * c + a * c - 2 * (a * b * c)
        t = ex.Scaled(m, 1 << j)
        acc = t if acc is None else ex.Sum(acc, t)
    return acc


def _carry_val(nc: int = 3) -> ex.Expr:
    acc = None
    for j in range(nc):
        t = ex.Scaled(ex.Advice(NBITS + j, 0), 1 << (NBITS + j))
        acc = t if acc is None else ex.Sum(acc, t)
    return acc


@dataclass
class Sha256Layout:
    msg_len: int
    k: int
    nblocks: int

    @property
    def n(self):
        return 1 << self.k

    def block_base(self, b: int) -> int:
        return b * ROWS_PER_BLOCK

    def row(self, b: int, round_t: int, kind: int) -> int:
        """kind: 0=W, 1=E, 2=A; round_t in [-4, 64)."""
        return self.block_base(b) + 3 * (round_t + 4) + kind

    @property
    def dig_base(self) -> int:
        return self.nblocks * ROWS_PER_BLOCK

    @property
    def pack_hi_row(self) -> int:
        return self.dig_base + DIG_REGION

    @property
    def pack_lo_row(self) -> int:
        return self.dig_base + DIG_REGION + 1

    @property
    def rows_used(self) -> int:
        return self.pack_lo_row + 1


def build_cs() -> tuple:
    """Returns (cs, names) with names = dict of column handles."""
    cs = ConstraintSystem()
    bits = [cs.advice_column() for _ in range(NBITS)]
    carries = [cs.advice_column() for _ in range(3)]
    inst = cs.instance_column()
    q_bool = cs.fixed_column()
    q_e = cs.fixed_column()
    q_a = cs.fixed_column()
    q_ws = cs.fixed_column()
    q_init = cs.fixed_column()
    q_dig = cs.fixed_column()
    q_wconst = cs.fixed_column()
    f_const = cs.fixed_column()
    q_bytes = [cs.fixed_column() for _ in range(4)]
    f_bytes = [cs.fixed_column() for _ in range(4)]
    q_pack_hi = cs.fixed_column()
    q_pack_lo = cs.fixed_column()

    # booleanity on all bit + carry columns
    for col in bits + carries:
        cs.create_gate(f"bool{col.index}", q_bool * (col * col - col))

    # e-row gate
    e_rhs = (_word_val(-11)                      # d = a_{r-4}
             + _word_val(-12)                    # h = e_{r-4}
             + _sigma_val(-3, (6, 11, 25))       # S1(e_{r-1})
             + _ch_val(-3, -6, -9)               # Ch(e1,e2,e3)
             + f_const                           # K_r
             + _word_val(-1))                    # W_r
    cs.create_gate("e_row", q_e * (_word_val(0) + _carry_val(3) - e_rhs))

    # a-row gate
    a_rhs = (_word_val(-1)                       # e_r
             + (ex.Constant(1 << 32) - _word_val(-12))   # 2^32 - d
             + _sigma_val(-3, (2, 13, 22))       # S0(a_{r-1})
             + _maj_val(-3, -6, -9))
    cs.create_gate("a_row", q_a * (_word_val(0) + _carry_val(3) - a_rhs))

    # schedule gate
    ws_rhs = (_sigma_val(-6, (17, 19, 10), shift_last=True)    # s1(w_{r-2})
              + _word_val(-21)                                 # w_{r-7}
              + _sigma_val(-45, (7, 18, 3), shift_last=True)   # s0(w_{r-15})
              + _word_val(-48))                                # w_{r-16}
    cs.create_gate("w_sched", q_ws * (_word_val(0) + _carry_val(2) - ws_rhs))

    # init rows (block 0): word value pinned to constant
    cs.create_gate("init", q_init * (_word_val(0) - f_const))

    # digest-update rows: H'_i = H_i(rot -204) + reg(rot -12) mod 2^32
    dig_rhs = _word_val(-ROWS_PER_BLOCK) + _word_val(-12)
    cs.create_gate("digest", q_dig * (_word_val(0) + _carry_val(1) - dig_rhs))

    # constant words (padding/length)
    cs.create_gate("w_const", q_wconst * (_word_val(0) - f_const))

    # byte pinning for the boundary word (big-endian byte k = bits 24-8k..)
    for kk in range(4):
        acc = None
        for j in range(8):
            t = ex.Scaled(_bit(24 - 8 * kk + j, 0), 1 << j)
            acc = t if acc is None else ex.Sum(acc, t)
        cs.create_gate(f"byte{kk}", q_bytes[kk] * (acc - f_bytes[kk]))

    # digest packing: hi = sum 2^{32(3-i)} H_i' (A rows at -1,-4,-7,-10);
    #                 lo = same over H4..7' (E rows, same rotations after
    #                 placing pack_lo one row below pack_hi)
    pack_cell = ex.Advice(NBITS, 0)   # carry col 0 reused as the packed value
    hi_rhs = None
    for i in range(4):
        t = _word_val(-(1 + 3 * i))
        t = ex.Scaled(t, 1 << (32 * (3 - i)))
        hi_rhs = t if hi_rhs is None else ex.Sum(hi_rhs, t)
    cs.create_gate("pack_hi", q_pack_hi * (pack_cell - hi_rhs))
    lo_rhs = None
    for i in range(4):
        t = _word_val(-(3 + 3 * i))
        t = ex.Scaled(t, 1 << (32 * (3 - i)))
        lo_rhs = t if lo_rhs is None else ex.Sum(lo_rhs, t)
    cs.create_gate("pack_lo", q_pack_lo * (pack_cell - lo_rhs))

    cs.enable_permutation(Column(ADVICE, NBITS))
    cs.enable_permutation(Column(INSTANCE, inst.index))
    names = dict(bits=bits, carries=carries, inst=inst)
    return cs, names


def _pad_message(msg: bytes) -> bytes:
    L = len(msg)
    pad = b"\x80" + b"\x00" * ((55 - L) % 64) + (8 * L).to_bytes(8, "big")
    return msg + pad


def _sha_trace(msg: bytes):
    """Full round trace: per block, the schedule w[64] and its carries, the
    new e and a of each round with their carries, the state in and out and
    the digest-update carries; and the final state."""
    padded = _pad_message(msg)
    M32 = (1 << 32) - 1

    def rotr(x, s):
        return ((x >> s) | (x << (32 - s))) & M32

    H = list(H_INIT)
    blocks = []
    for b in range(len(padded) // 64):
        chunk = padded[64 * b:64 * b + 64]
        w = [int.from_bytes(chunk[4 * i:4 * i + 4], "big") for i in range(16)]
        wcarry = []
        for r in range(16, 64):
            s0 = rotr(w[r - 15], 7) ^ rotr(w[r - 15], 18) ^ (w[r - 15] >> 3)
            s1 = rotr(w[r - 2], 17) ^ rotr(w[r - 2], 19) ^ (w[r - 2] >> 10)
            tot = w[r - 16] + s0 + w[r - 7] + s1
            w.append(tot & M32)
            wcarry.append(tot >> 32)
        a, bb, c, d, e, f, g, h = H
        aseq, eseq, ecarry, acarry = [], [], [], []
        for r in range(64):
            S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + ch + K_CONST[r] + w[r]
            S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & bb) ^ (a & c) ^ (bb & c)
            e_tot = d + t1
            e_new = e_tot & M32
            a_tot = e_new + ((1 << 32) - d) + S0 + maj
            a_new = a_tot & M32
            eseq.append(e_new)
            ecarry.append(e_tot >> 32)
            aseq.append(a_new)
            acarry.append(a_tot >> 32)
            h, g, f, e = g, f, e, e_new
            d, c, bb, a = c, bb, a, a_new
        tots = [x + y for x, y in zip(H, (a, bb, c, d, e, f, g, h))]
        h_out = [t & M32 for t in tots]
        blocks.append(dict(w=w, wcarry=wcarry, e=eseq, a=aseq, ecarry=ecarry,
                           acarry=acarry, h_in=list(H), h_out=h_out,
                           hcarry=[t >> 32 for t in tots]))
        H = h_out
    digest = b"".join(int(x).to_bytes(4, "big") for x in H)
    assert digest == hashlib.sha256(msg).digest()
    return blocks, H


@dataclass
class Sha256Circuit:
    """Compiled circuit for messages of a fixed byte length."""
    data: CircuitData
    layout: Sha256Layout
    names: dict

    @staticmethod
    def build(msg_len: int, k: int | None = None) -> "Sha256Circuit":
        k = k or min_k(msg_len)
        nb = num_blocks(msg_len)
        lay = Sha256Layout(msg_len, k, nb)
        cs, names = build_cs()
        n = lay.n
        assert lay.rows_used <= cs.usable_rows(n), \
            f"k={k} too small: need {lay.rows_used}+blinding rows"

        NF = cs.num_fixed
        fixed = np.zeros((NF, n), dtype=object)
        # column indices match build_cs creation order:
        (Q_BOOL, Q_E, Q_A, Q_WS, Q_INIT, Q_DIG, Q_WCONST, F_CONST) = range(8)
        Q_BYTE = list(range(8, 12))
        F_BYTE = list(range(12, 16))
        Q_PACK_HI, Q_PACK_LO = 16, 17

        usable = cs.usable_rows(n)
        for r in range(usable):
            if r < lay.rows_used:
                fixed[Q_BOOL][r] = 1
        fixed[Q_BOOL][lay.pack_hi_row] = 0
        fixed[Q_BOOL][lay.pack_lo_row] = 0

        padded = _pad_message(b"\x00" * msg_len)  # structure only
        for b in range(nb):
            for r in range(64):
                fixed[Q_E][lay.row(b, r, 1)] = 1
                fixed[F_CONST][lay.row(b, r, 1)] = K_CONST[r]
                fixed[Q_A][lay.row(b, r, 2)] = 1
                if r >= 16:
                    fixed[Q_WS][lay.row(b, r, 0)] = 1
            if b == 0:
                # virtual round v = t-4 holds a_v = H[-v-1]: row t carries
                # H[3-t] (a-family) / H[7-t] (e-family)
                for t in range(4):
                    fixed[Q_INIT][lay.row(0, t - 4, 2)] = 1
                    fixed[F_CONST][lay.row(0, t - 4, 2)] = H_INIT[3 - t]
                    fixed[Q_INIT][lay.row(0, t - 4, 1)] = 1
                    fixed[F_CONST][lay.row(0, t - 4, 1)] = H_INIT[7 - t]
            else:
                for t in range(4):
                    fixed[Q_DIG][lay.row(b, t - 4, 2)] = 1
                    fixed[Q_DIG][lay.row(b, t - 4, 1)] = 1
        # final digest region rows (virtual block nb, rounds -4..-1)
        for t in range(4):
            fixed[Q_DIG][lay.dig_base + 3 * t + 2] = 1
            fixed[Q_DIG][lay.dig_base + 3 * t + 1] = 1
        fixed[Q_PACK_HI][lay.pack_hi_row] = 1
        fixed[Q_PACK_LO][lay.pack_lo_row] = 1

        # padding constraints on input word rows
        for b in range(nb):
            for r in range(16):
                wrow = lay.row(b, r, 0)
                byte_off = 64 * b + 4 * r
                nb_msg = max(0, min(4, msg_len - byte_off))  # message bytes here
                if nb_msg == 4:
                    continue                               # fully witness
                word_bytes = padded[byte_off:byte_off + 4]
                if nb_msg == 0:
                    fixed[Q_WCONST][wrow] = 1
                    fixed[F_CONST][wrow] = int.from_bytes(word_bytes, "big")
                else:
                    for kk in range(nb_msg, 4):
                        fixed[Q_BYTE[kk]][wrow] = 1
                        fixed[F_BYTE[kk]][wrow] = word_bytes[kk]

        copies = [
            ((ADVICE, NBITS, lay.pack_lo_row), (INSTANCE, 0, 0)),
            ((ADVICE, NBITS, lay.pack_hi_row), (INSTANCE, 0, 1)),
        ]
        data = CircuitData(cs=cs, k=k, fixed=fixed, copies=copies,
                           num_instance=[2])
        return Sha256Circuit(data=data, layout=lay, names=names)

    # ---- witness -------------------------------------------------------------

    def witness(self, msg: bytes, device="cuda"):
        """(advice (NADVICE, n, 8) canonical words on `device`, instances
        [[lo, hi]])."""
        lay = self.layout
        assert len(msg) == lay.msg_len
        blocks, H = _sha_trace(msg)
        n = lay.n
        grid = np.zeros((NADVICE, n), dtype=np.int32)
        shifts = np.arange(NBITS, dtype=np.uint64)

        def put_word(row: int, val: int):
            grid[:NBITS, row] = (np.uint64(val) >> shifts) & np.uint64(1)

        def put_carry(row: int, val: int, nc: int = 3):
            for j in range(nc):
                grid[NBITS + j, row] = (val >> j) & 1

        for b, blk in enumerate(blocks):
            # history rows: virtual round t-4 holds H[3-t] / H[7-t]
            for t in range(4):
                put_word(lay.row(b, t - 4, 2), blk["h_in"][3 - t])
                put_word(lay.row(b, t - 4, 1), blk["h_in"][7 - t])
                if b > 0:
                    prev = blocks[b - 1]
                    put_carry(lay.row(b, t - 4, 2), prev["hcarry"][3 - t], 1)
                    put_carry(lay.row(b, t - 4, 1), prev["hcarry"][7 - t], 1)
            for r in range(64):
                put_word(lay.row(b, r, 0), blk["w"][r])
                if r >= 16:
                    put_carry(lay.row(b, r, 0), blk["wcarry"][r - 16], 2)
                put_word(lay.row(b, r, 1), blk["e"][r])
                put_carry(lay.row(b, r, 1), blk["ecarry"][r], 3)
                put_word(lay.row(b, r, 2), blk["a"][r])
                put_carry(lay.row(b, r, 2), blk["acarry"][r], 3)
        last = blocks[-1]
        for t in range(4):
            put_word(lay.dig_base + 3 * t + 2, last["h_out"][3 - t])
            put_carry(lay.dig_base + 3 * t + 2, last["hcarry"][3 - t], 1)
            put_word(lay.dig_base + 3 * t + 1, last["h_out"][7 - t])
            put_carry(lay.dig_base + 3 * t + 1, last["hcarry"][7 - t], 1)

        digest = b"".join(int(x).to_bytes(4, "big") for x in H)
        hi = int.from_bytes(digest[:16], "big")
        lo = int.from_bytes(digest[16:], "big")

        # bits and carries are 0 / 1, the low word; the pack cells are u128
        adv = np.zeros((NADVICE, n, 8), dtype=np.int32)
        adv[:, :, 0] = grid
        adv[NBITS, [lay.pack_hi_row, lay.pack_lo_row]] = field.ints_to_words(
            [hi, lo])
        return torch.from_numpy(adv).to(device), [[lo, hi]]

"""The four-step number-theoretic transform over Fr on the int8 tensor cores,
along axis -2 of (..., n, 8), and the kernel dft_s8.

Counterpart of halo2_zkcert_tpu/ops/ntt_mxu.py (MXU matrix products there).
A transform of n = n1 * n2 points splits, as there, into DFTs of size n2 over
the columns j2 of x[j1 + n1 j2], a twiddle product, and DFTs of size n1:

    X[n2 k1 + k2] = sum_j1 w_n1^(j1 k1) * w^(j1 k2) * sum_j2 x[j1 + n1 j2] w_n2^(j2 k2)

recursively, until a DFT has at most 2^MAX_RADIX_LOG points.  The levels are
balanced (k = 17 splits as 5 + 6 + 6, k = 19 as 6 + 6 + 7): a level of radix
r costs int8 work in proportion to r, and every level one reduction.

A base DFT of radix r over m columns is ONE u8 x s8 -> s32 product.  The
data side is the 32 exact bytes d of each canonical element, unsigned, as
they lie in memory; the constant side holds the 33 balanced base-256 digits
of every W[k, j] with the limb convolution folded into its rows:

    lhs[(k, l), (j, l2)] = bal(W[k, j])[l - l2],   l < 64, l2 < 32

so the product's rows (k, 0..63) are the 64 limbs of output k.  Each limb is
at most 32 r * 255 * 128 in magnitude, exact in int32.  `corr[k, l]` adds
the digits of a multiple of p that keep every limb in [0, 2^31) (the same
row for every k); the limbs then carry into a number below 2^544, which is
reduced mod p in chunks of 253 bits (here two Montgomery products with
2^253 R and 2^506 R; the kernel, one Montgomery reduction of c0 2^256 + c1
2^253 R + c2 2^506 R, the same residue).  Coset powers, 1/n and a factor R
of Montgomery form in or out fold into the constants (the DFT is linear),
so every flavour costs the same.  The twiddles between levels are one K1 Montgomery product
(`field.mul_mont`) with a table stored times R.

`dft_s8` wraps csrc/ntt_mxu.cu on a CUDA tensor (wgmma u8 x s8, TMA or
cp.async loads, the carry and reduction fused; `dft_s8_plan` gives its
launch geometry); on a CPU tensor it runs `dft_s8_plain`, the same digit
product as a float64 matrix product (exact: every partial sum is below
2^53) and the same carry and reduction in int64.
The result equals the radix-2 transform's (ops/ntt.py) as canonical residues.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..utils import refcrypto as rc
from . import field, kernels
from .field import FR

NB = 32                    # exact bytes of a canonical element (data side)
L1 = 33                    # balanced digits of a canonical constant
LOUT = NB + L1 - 1         # 64 product limbs of an output element
MAX_RADIX_LOG = 7          # largest base DFT (depth 32 * 128 = 4096)
CHUNK_BITS = 253           # the reduction's chunks: each below 2^253 < p
# every limb after the correction lies in [OFFSET_LO - spread, OFFSET_HI +
# spread], spread = 255 * 128 * 32 r at most (a byte times a balanced
# digit), which stays in [0, 2^31)
OFFSET_LO, OFFSET_HI = 1 << 28, 1_800_000_000

_device: dict = {}


def balanced_digits(vals) -> np.ndarray:
    """Canonical values (< 2^256) -> (len, 33) balanced base-256 digits in
    [-128, 127], little-endian."""
    raw = np.frombuffer(b"".join(int(v).to_bytes(NB, "little") for v in vals),
                        dtype=np.uint8).reshape(-1, NB).astype(np.int64)
    out = np.zeros((raw.shape[0], L1), dtype=np.int64)
    carry = np.zeros(raw.shape[0], dtype=np.int64)
    for i in range(NB):
        d = raw[:, i] + carry
        carry = (d > 127).astype(np.int64)
        out[:, i] = d - 256 * carry
    out[:, NB] = carry
    return out.astype(np.int8)


def digits_value(digits) -> int:
    """The integer that base-256 digits (any sign) stand for."""
    return sum(int(d) << (8 * i) for i, d in enumerate(digits))


@lru_cache(maxsize=1)
def offset_digits() -> np.ndarray:
    """The 64 digits of a multiple of p, each in [OFFSET_LO, OFFSET_HI]:
    added to the signed limbs so that the carry sees nonnegative values (as
    halo2_zkcert_tpu/ops/ntt_mxu.py `_offset_digits`, at 64 limbs)."""
    p, width = FR.modulus, LOUT
    lo, hi = OFFSET_LO, OFFSET_HI
    target_lo = sum(lo << (8 * i) for i in range(width))
    rem = p * (-(-target_lo // p) + 1)
    digits = np.zeros(width, dtype=np.int64)
    for i in range(width - 1, -1, -1):
        base = 1 << (8 * i)
        lo_rest = sum(lo << (8 * j) for j in range(i))
        hi_rest = sum(hi << (8 * j) for j in range(i))
        d = max(lo, min(hi, (rem - lo_rest) // base))
        while d * base + hi_rest < rem:
            d += 1
        assert lo <= d <= hi, (i, d)
        digits[i] = d
        rem -= d * base
    assert rem == 0 and digits_value(digits) % p == 0
    return digits


def dft_matrix(r_log: int, w: int, in_scale: int, out_scale: int,
               const: int) -> list:
    """W[k][j] = const * out_scale^k * w^(j k) * in_scale^j mod p, the base
    DFT's matrix as ints (the JAX package's `_dft_consts` convention)."""
    r, p = 1 << r_log, FR.modulus
    in_pows = [1] * r
    for j in range(1, r):
        in_pows[j] = in_pows[j - 1] * in_scale % p
    rows, out_acc = [], const % p
    for k in range(r):
        step, wk, row = pow(w, k, p), out_acc, []
        for j in range(r):
            row.append(wk * in_pows[j] % p)
            wk = wk * step % p
        rows.append(row)
        out_acc = out_acc * out_scale % p
    return rows


@lru_cache(maxsize=64)
def dft_consts(r_log: int, w: int, in_scale: int, out_scale: int,
               const: int) -> tuple:
    """Host constants of one base DFT: (lhs (64 r, 32 r) int8, rows (k, l)
    output-major and limb-minor, columns (j, l2); corr (r, 64) int32, the
    offset digits on every row: the data's bytes enter unsigned)."""
    r = 1 << r_log
    W = dft_matrix(r_log, w % FR.modulus, in_scale % FR.modulus,
                   out_scale % FR.modulus, const % FR.modulus)
    bal = balanced_digits([v for row in W for v in row]).reshape(r, r, L1)
    lhs = np.zeros((r, LOUT, r, NB), dtype=np.int8)
    for l2 in range(NB):
        lhs[:, l2:l2 + L1, :, l2] = bal.transpose(0, 2, 1)
    lhs = lhs.reshape(LOUT * r, NB * r)
    corr = np.tile(offset_digits(), (r, 1))
    spread = 255 * 128 * NB * r
    assert OFFSET_LO - spread >= 0 and OFFSET_HI + spread < 2 ** 31, r
    assert corr.min() >= -2 ** 31 and corr.max() < 2 ** 31
    return lhs, corr.astype(np.int32)


def fold_consts() -> list:
    """2^253 R and 2^506 R mod p: a Montgomery product with them turns the
    reduction's second and third chunks into canonical residues."""
    p = FR.modulus
    return [(1 << CHUNK_BITS) * FR.r % p, (1 << (2 * CHUNK_BITS)) * FR.r % p]


def _consts(r_log: int, w: int, in_scale: int, out_scale: int, const: int,
            device) -> tuple:
    """(lhs, corr, fold, kernel_lhs(lhs)) of one base DFT on `device`,
    cached."""
    key = ("dft", r_log, w, in_scale, out_scale, const, str(device))
    t = _device.get(key)
    if t is None:
        lhs, corr = dft_consts(r_log, w, in_scale, out_scale, const)
        lhs = torch.from_numpy(lhs).to(device)
        t = (lhs, torch.from_numpy(corr).to(device),
             field.from_ints(FR, fold_consts(), device), kernel_lhs(lhs))
        _device[key] = t
    return t


# ---------------------------------------------------------------------------
# the base DFT: plain version and the kernel's wrapper
# ---------------------------------------------------------------------------

def _columns(x: torch.Tensor, r: int, cstride: int) -> torch.Tensor:
    """(m, r, 8) elements [column, row] of a (m / cstride, r, cstride) layout."""
    m = x.numel() // 8 // r
    return x.reshape(m // cstride, r, cstride, 8).permute(0, 2, 1, 3).reshape(
        m, r, 8)


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def reduce_limbs_plain(limbs: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """(..., 64) nonnegative int64 limbs (each < 2^31, base 256) -> canonical
    words of their value mod p: carried into 17 words, cut into chunks of
    253 bits, the upper two through a Montgomery product with `fold`."""
    M32 = 0xFFFFFFFF
    q = limbs.reshape(limbs.shape[:-1] + (16, 4))
    words = q[..., 0] + (q[..., 1] << 8) + (q[..., 2] << 16) + (q[..., 3] << 24)
    out, c = [], torch.zeros_like(words[..., 0])
    for i in range(16):
        s = words[..., i] + c
        out.append(s & M32)
        c = s >> 32
    out.append(c)
    low29 = (1 << 29) - 1
    c0 = out[:7] + [out[7] & low29]
    c1 = [(out[7 + i] >> 29) | ((out[8 + i] << 3) & M32) for i in range(8)]
    c1[7] = c1[7] & low29
    zero = torch.zeros_like(out[0])
    c2 = [(out[15] >> 26) | ((out[16] << 6) & M32), out[16] >> 26] + [zero] * 6
    c0, c1, c2 = (_to_int32(torch.stack(c, -1)) for c in (c0, c1, c2))
    t = field.binop_plain(FR, "add", field.mul_mont_plain(FR, c1, fold[0]),
                          field.mul_mont_plain(FR, c2, fold[1]))
    return field.binop_plain(FR, "add", c0, t)


def dft_s8_plain(x: torch.Tensor, r_log: int, consts: tuple, cin: int,
                 cout: int) -> torch.Tensor:
    """Y[k, col] = sum_j W[k, j] X[j, col] for every column of `x`, read in
    a (m / cin, r, cin) layout and written in a (m / cout, r, cout) one."""
    lhs, corr, fold = consts[:3]
    r = 1 << r_log
    m = x.numel() // 8 // r
    digits = _columns(x, r, cin).contiguous().view(torch.uint8).reshape(
        m, NB * r).to(torch.float64)
    prod = digits @ lhs.to(torch.float64).T                 # (m, 64 r), exact
    limbs = prod.to(torch.int64).reshape(m, r, LOUT) + corr.to(torch.int64)
    y = reduce_limbs_plain(limbs, fold)                      # (m, r, 8)
    return y.reshape(m // cout, cout, r, 8).permute(0, 2, 1, 3).reshape(
        x.shape)


def kernel_lhs(lhs: torch.Tensor) -> torch.Tensor:
    """lhs (64 r, 32 r) with its rows in csrc/ntt_mxu.cu's order: in groups
    of four output elements (zero rows up to whole groups), row
    256 g + 8 i + 2 e + b holds row (4 g + e, 2 i + b), so that lane q of
    each quad of the kernel's accumulator holds all 64 limbs of the group's
    element q."""
    rows, depth = lhs.shape
    groups = -(-rows // (4 * LOUT))
    out = torch.zeros((groups * 4 * LOUT, depth), dtype=lhs.dtype,
                      device=lhs.device)
    out[:rows] = lhs
    return out.reshape(groups, 4, LOUT // 2, 2, depth).permute(
        0, 2, 1, 3, 4).reshape(-1, depth).contiguous()


PLAN_KEYS = ("loader", "element_tiles", "column_tiles", "tiles", "steps",
             "blocks", "l2_bytes", "smem_bytes")
LOADERS = ("tma.columns", "tma.j", "cp.async")


def dft_s8_plan(m: int, r_log: int, cin: int) -> dict:
    """The launch geometry csrc/ntt_mxu.cu takes for m columns of radix
    2^r_log read at column stride cin (bn254.cuh `dft_plan`): its loader,
    tiles, blocks, and the bytes its boxes move from L2 to the SMs as the
    tile shape plans them (no counter reads them).  Asks
    the built library, so it needs the card."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    kernels.check(kernels.lib("ntt_mxu").h2t_dft_s8_plan(m, r_log, cin, out),
                  "ntt_mxu plan")
    plan = dict(zip(PLAN_KEYS, out))
    plan["loader"] = LOADERS[plan["loader"]]
    return plan


def dft_s8(x: torch.Tensor, r_log: int, consts: tuple, cin: int,
           cout: int) -> torch.Tensor:
    """One base DFT of radix 2^r_log over the columns of `x` (see
    `dft_s8_plain`), with the constant tables of `_consts`: csrc/ntt_mxu.cu
    on a CUDA tensor."""
    r = 1 << r_log
    total = x.numel() // 8
    if (x.shape[-1] != 8 or r_log < 1 or total % r or (total // r) % cin
            or (total // r) % cout):
        raise ValueError(f"dft_s8: {tuple(x.shape)} at radix {r}, column "
                         f"strides {cin}, {cout}")
    if x.device.type == "cpu":
        return dft_s8_plain(x, r_log, consts, cin, cout)
    lhs, corr, fold, klhs = consts
    x = x.contiguous()
    out = torch.empty_like(x)
    kernels.require_cuda_int32("ntt_mxu", x, corr, fold, out)
    if (lhs.shape != (LOUT * r, NB * r) or corr.shape != (r, LOUT)
            or klhs.dtype != torch.int8 or not klhs.is_cuda
            or not klhs.is_contiguous()
            or klhs.shape != (4 * LOUT * -(-r // 4), NB * r)):
        raise ValueError("dft_s8: bad constant tables")
    lib = kernels.lib("ntt_mxu")
    kernels.launches["ntt_mxu"] += 1
    kernels.check(lib.h2t_dft_s8(
        klhs.data_ptr(), corr.data_ptr(), fold.data_ptr(), x.data_ptr(),
        out.data_ptr(), total // r, r_log, cin, cout,
        kernels.stream_ptr(x.device)), "ntt_mxu")
    return out


# ---------------------------------------------------------------------------
# the four-step recursion
# ---------------------------------------------------------------------------

def outer_radix_log(k: int) -> int:
    """log2 of the last level's radix: the levels of a 2^k transform are
    as equal as MAX_RADIX_LOG allows."""
    levels = -(-k // MAX_RADIX_LOG)
    return -(-k // levels)


def levels(k: int) -> list:
    """The radix logs of a 2^k transform's base DFTs, in launch order."""
    if k <= MAX_RADIX_LOG:
        return [k]
    k1 = outer_radix_log(k)
    return levels(k - k1) + [k1]


def _twiddles(k2: int, k1: int, C: int, w: int, in_scale: int,
              out_scale: int, device) -> torch.Tensor:
    """(n2, n1, C, 8): w^(j1 k2) in_scale^j1 out_scale^k2 times R at
    [k2, j1, c], cached."""
    key = ("tw", k2, k1, C, w, in_scale, out_scale, str(device))
    t = _device.get(key)
    if t is None:
        p, n1, n2 = FR.modulus, 1 << k1, 1 << k2
        sp = [FR.r]
        for _ in range(1, n1):
            sp.append(sp[-1] * in_scale % p)
        vals, wk, ok = [], 1, 1
        for _ in range(n2):
            acc = ok
            for j1 in range(n1):
                vals.append(acc * sp[j1] % p)
                acc = acc * wk % p
            wk = wk * w % p
            ok = ok * out_scale % p
        t = field.from_ints(FR, vals, device).reshape(n2, n1, 1, 8)
        t = t.expand(n2, n1, C, 8).contiguous()
        _device[key] = t
    return t


def _transform(x: torch.Tensor, k: int, w: int, in_scale: int,
               out_scale: int, const: int, C: int) -> torch.Tensor:
    """X[g, t, c] = const out_scale^t sum_j x[g, j, c] w^(j t) in_scale^j
    over a contiguous (G, 2^k, C) layout of (total, 8) words."""
    p = FR.modulus
    if k <= MAX_RADIX_LOG:
        return dft_s8(x, k, _consts(k, w, in_scale, out_scale, const,
                                    x.device), C, C)
    k1 = outer_radix_log(k)
    k2 = k - k1
    n1, n2 = 1 << k1, 1 << k2
    # j = j1 + n1 j2: DFT_n2 over j2, the columns (j1, c) as one block
    y = _transform(x, k2, pow(w, n1, p), pow(in_scale, n1, p), 1, 1, n1 * C)
    tw = _twiddles(k2, k1, C, w, in_scale, out_scale, x.device)
    y = field.mul_mont(FR, y.reshape(-1, n2, n1, C, 8), tw).reshape(-1, 8)
    # DFT_n1 over j1: read [g, k2, j1, c], write X[g, n2 k1 + k2, c]
    return dft_s8(y, k1, _consts(k1, pow(w, n2, p), 1, pow(out_scale, n2, p),
                                 const, x.device), C, n2 * C)


def _run(a: torch.Tensor, k: int, w: int, in_scale: int, out_scale: int,
         const: int) -> torch.Tensor:
    n = 1 << k
    if a.shape[-2] > n or a.shape[-1] != 8:
        raise ValueError(f"ntt_mxu: expected (..., n <= {n}, 8), got "
                         f"{tuple(a.shape)}")
    if a.shape[-2] < n:
        a = torch.nn.functional.pad(a, (0, 0, 0, n - a.shape[-2]))
    if k == 0:
        return field.mul_const(FR, a, const)
    lead = a.shape[:-2]
    x = a.contiguous().reshape(math.prod(lead) * n, 8)
    return _transform(x, k, w, in_scale, out_scale, const, 1).reshape(
        lead + (n, 8))


def _inv(v: int) -> int:
    return pow(v, FR.modulus - 2, FR.modulus)


def ntt(a: torch.Tensor, k: int) -> torch.Tensor:
    """Forward NTT over axis -2: X[i] = sum_j a[j] w^(ij)."""
    return _run(a, k, rc.fr_root_of_unity(k), 1, 1, 1)


def intt(a: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse NTT, 1/n folded into the last level's constants."""
    return _run(a, k, _inv(rc.fr_root_of_unity(k)), 1, 1, _inv(1 << k))


def coset_ntt(a: torch.Tensor, k: int, g: int,
              out_mont: bool = False) -> torch.Tensor:
    """Values of the coefficients `a` (zero-padded to 2^k) on g*H; the
    powers g^j and, with `out_mont`, the factor R fold into the constants."""
    return _run(a, k, rc.fr_root_of_unity(k), g % FR.modulus, 1,
                FR.r if out_mont else 1)


def coset_intt(a: torch.Tensor, k: int, g: int,
               in_mont: bool = False) -> torch.Tensor:
    """Coefficients from values on g*H (in Montgomery form with `in_mont`);
    g^-t, 1/n and R^-1 fold into the constants."""
    const = _inv(1 << k) * (_inv(FR.r) if in_mont else 1) % FR.modulus
    return _run(a, k, _inv(rc.fr_root_of_unity(k)), 1, _inv(g % FR.modulus),
                const)

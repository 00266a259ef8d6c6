"""BN254 Fr and Fq on tensors of canonical words, and kernel K1.

A field element is a canonical value (< p) stored as 8 little-endian 32-bit
words in an int32 tensor, shape (..., 8).  Canonical values make the
transcript, serialization and equality trivial; the JAX package's lazy
33 x 8-bit limbs (halo2_zkcert_tpu/ops/limbs.py) existed only because the
TPU has no fast integer multiply.

`binop` is the wrapper of kernel K1 (csrc/field_binop.cu, replacing the
TPU's fused_mul / fused_add / fused_sub): on a CUDA tensor it launches the
kernel, on a CPU tensor it runs `binop_plain`, the same function written as
limb arithmetic in int64 tensors (16-bit limbs, Montgomery reduction).

A canonical product is two Montgomery products.  Where one operand is known
beforehand (a table, a host constant) it is kept in Montgomery form, v * R
with R = 2^256, and `mul_mont` (K1's fourth operation, "mulm") gives the
canonical product in one: `mul_const` does so with its host integer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import refcrypto as rc
from . import kernels

OP_MUL, OP_ADD, OP_SUB, OP_MULM = 0, 1, 2, 3
_OPS = {"mul": OP_MUL, "add": OP_ADD, "sub": OP_SUB, "mulm": OP_MULM}
OP_NAMES = {v: k for k, v in _OPS.items()}
M16 = 0xFFFF
M32 = 0xFFFFFFFF


class Field:
    """Static data of one BN254 field for the plain (int64) arithmetic."""

    def __init__(self, name: str, modulus: int, fid: int):
        self.name = name
        self.modulus = modulus
        self.fid = fid
        self.p16 = [(modulus >> (16 * i)) & M16 for i in range(16)]
        self.p32 = [(modulus >> (32 * i)) & M32 for i in range(8)]
        self.pinv16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.r = pow(2, 256, modulus)
        self.r2 = pow(2, 512, modulus)
        self._dev: dict = {}

    def tables(self, device) -> dict:
        """Per-device int64 constant tensors for the plain arithmetic."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            r2 = [(self.r2 >> (16 * i)) & M16 for i in range(16)]
            t = {"p16": torch.tensor(self.p16 + [0], dtype=torch.int64,
                                     device=device),
                 "r2": torch.tensor(r2, dtype=torch.int64, device=device)}
            self._dev[key] = t
        return t

    def __repr__(self) -> str:
        return f"Field({self.name})"


FR = Field("Fr", rc.FR, 0)
FQ = Field("Fq", rc.FQ, 1)


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def ints_to_words(xs) -> np.ndarray:
    """Iterable of ints in [0, 2^256) -> (N, 8) int32 words."""
    blob = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(blob, dtype="<i4").reshape(-1, 8).copy()


def words_to_ints(arr) -> list:
    """(N, 8) words (numpy or tensor) -> list of ints."""
    a = np.ascontiguousarray(np.asarray(
        arr.cpu() if isinstance(arr, torch.Tensor) else arr,
        dtype=np.int32).reshape(-1, 8))
    raw = a.astype("<i4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(a.shape[0])]


def from_ints(F: Field, xs, device) -> torch.Tensor:
    """Ints -> (N, 8) canonical tensor (reduced mod p)."""
    xs = [int(x) % F.modulus for x in xs]
    if not xs:
        return torch.zeros((0, 8), dtype=torch.int32, device=device)
    return torch.from_numpy(ints_to_words(xs)).to(device)


def const(F: Field, v: int, device) -> torch.Tensor:
    """One element as an (8,) tensor."""
    return from_ints(F, [v], device)[0]


def to_ints(a: torch.Tensor) -> list:
    return words_to_ints(a)


def to_int(a: torch.Tensor) -> int:
    return words_to_ints(a.reshape(1, 8))[0]


def one(device, shape=()) -> torch.Tensor:
    t = torch.zeros(tuple(shape) + (8,), dtype=torch.int32, device=device)
    t[..., 0] = 1
    return t


# ---------------------------------------------------------------------------
# plain arithmetic: int64 tensors, 16-bit limbs, Montgomery with R = 2^256
# ---------------------------------------------------------------------------

def _to16(a: torch.Tensor) -> torch.Tensor:
    w = a.to(torch.int64) & M32
    return torch.stack((w & M16, w >> 16), dim=-1).flatten(-2)


def _product(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of limb vectors, unnormalized, width La+Lb+2."""
    a16, b16 = torch.broadcast_tensors(
        a16[..., :, None], b16[..., None, :])
    La, Lb = a16.shape[-2], b16.shape[-1]
    outer = (a16 * b16).flatten(-2)
    idx = (torch.arange(La, device=outer.device)[:, None]
           + torch.arange(Lb, device=outer.device)[None, :]).flatten()
    t = torch.zeros(outer.shape[:-1] + (La + Lb + 2,), dtype=torch.int64,
                    device=outer.device)
    return t.index_add_(-1, idx, outer)


def _redc(F: Field, t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of t (value < p * 2^256) by 2^256: returns the
    upper limbs, unnormalized, whose value is t * 2^-256 mod p and < 2p."""
    p16 = F.tables(t.device)["p16"]
    for i in range(16):
        m = ((t[..., i] & M16) * F.pinv16) & M16
        t[..., i:i + 17] += m[..., None] * p16
        t[..., i + 1] += t[..., i] >> 16
    return t[..., 16:]


def _canon_from_limbs(F: Field, hi: torch.Tensor) -> torch.Tensor:
    """Unnormalized 16-bit limbs (< 2^60) of a value < 2p -> canonical
    words.  One relaxation pass first, so the 32-bit pairing cannot
    overflow int64."""
    hi = torch.nn.functional.pad(hi, (0, 2 - hi.shape[-1] % 2))
    hi = (hi & M16) + torch.nn.functional.pad((hi >> 16)[..., :-1], (1, 0))
    W = hi[..., 0::2] + (hi[..., 1::2] << 16)
    cols = list(W.unbind(-1))
    words = []
    c = torch.zeros_like(cols[0])
    for x in cols:
        x = x + c
        words.append(x & M32)
        c = x >> 32
    while len(words) < 9:
        words.append(c)
        c = torch.zeros_like(c)
    return _canon_words(F, torch.stack(words[:9], -1))


def _mont(F: Field, a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    return _redc(F, _product(a16, b16))


def mul_plain(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = _mont(F, _to16(a), _to16(b))                   # a b R^-1, lazy
    return _canon_from_limbs(F, _mont(F, x, F.tables(x.device)["r2"]))


def mul_mont_plain(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1: one Montgomery product, canonical words out."""
    return _canon_from_limbs(F, _mont(F, _to16(a), _to16(b)))


def _addsub_words(F: Field, a: torch.Tensor, b: torch.Tensor, sub: bool):
    a64 = a.to(torch.int64) & M32
    b64 = b.to(torch.int64) & M32
    a64, b64 = torch.broadcast_tensors(a64, b64)
    s = a64 - b64 if sub else a64 + b64
    cols = list(s.unbind(-1))
    words = []
    c = torch.zeros_like(cols[0])
    for x in cols:
        x = x + c
        words.append(x & M32)
        c = x >> 32                 # -1, 0 or 1
    if sub:
        # a < b: add p back (the final carry is -1 exactly then)
        neg = c < 0
        out, c2 = [], torch.zeros_like(c)
        for i in range(8):
            x = words[i] + torch.where(neg, F.p32[i], 0) + c2
            out.append(x & M32)
            c2 = x >> 32
        words = out
        res = torch.stack(words, -1)
    else:
        words.append(c)
        hi = torch.stack(words, -1)
        return _canon_words(F, hi)
    return torch.where(res >= 2 ** 31, res - 2 ** 32, res).to(torch.int32)


def _canon_words(F: Field, w9: torch.Tensor) -> torch.Tensor:
    """9 normalized words of a value < 2p -> canonical int32 words."""
    words = list(w9.unbind(-1))
    d = []
    borrow = torch.zeros_like(words[0])
    for i in range(8):
        x = words[i] - F.p32[i] - borrow
        borrow = (x < 0).to(torch.int64)
        d.append(x & M32)
    keep = (words[8] - borrow) < 0
    out = torch.stack([torch.where(keep, w, dw)
                       for w, dw in zip(words[:8], d)], dim=-1)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def binop_plain(F: Field, op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 with torch broadcasting over the leading axes."""
    op = _OPS.get(op, op)
    if op == OP_MUL:
        return mul_plain(F, a, b)
    if op == OP_MULM:
        return mul_mont_plain(F, a, b)
    return _addsub_words(F, a, b, sub=(op == OP_SUB))


def from_resident(F: Field, limbs: torch.Tensor) -> torch.Tensor:
    """JAX resident limbs (..., 33) int32 (limbs <= 511, value < 2^264) ->
    canonical words (..., 8), reduced mod p."""
    x = limbs.to(torch.int64)
    x = torch.nn.functional.pad(x, (0, 1))             # 34 byte limbs
    l16 = x[..., 0::2] + (x[..., 1::2] << 8)           # 17 unnormalized limbs
    t = torch.nn.functional.pad(l16, (0, 17))
    hi = _redc(F, t)                                   # x R^-1, lazy
    return _canon_from_limbs(F, _mont(F, hi, F.tables(hi.device)["r2"]))


# ---------------------------------------------------------------------------
# K1 wrapper
# ---------------------------------------------------------------------------

def binop(F: Field, op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a (op) b over canonical words.  `b` may broadcast;
    the kernel reads a `b` whose words repeat with a period in place (a
    scalar, or the trailing axes of `a`), anything else is expanded."""
    op = _OPS.get(op, op)
    if a.device.type == "cpu":
        return binop_plain(F, op, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.shape != shape:
        if op != OP_SUB and b.shape == shape:      # the products commute
            a, b = b, a
        else:
            a = a.expand(shape)
    a = a.contiguous()
    tail = b.shape[:-1]
    while tail and tail[0] == 1:
        tail = tail[1:]
    if shape[len(shape) - 1 - len(tail):-1] != tail:
        b = b.expand(shape)
    b = b.contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    kernels.require_cuda_int32("field_binop", a, b, out)
    if a.shape[-1] != 8 or b.shape[-1] != 8:
        raise ValueError("field_binop: bad shapes")
    n, nb = a.numel() // 8, max(b.numel() // 8, 1)
    lib = kernels.lib("field_binop")
    kernels.launches[f"field_binop.{OP_NAMES[op]}"] += 1
    kernels.check(lib.h2t_field_binop(
        F.fid, op, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, nb,
        kernels.stream_ptr(a.device)), "field_binop")
    return out


def mul(F, a, b):
    return binop(F, OP_MUL, a, b)


def add(F, a, b):
    return binop(F, OP_ADD, a, b)


def sub(F, a, b):
    return binop(F, OP_SUB, a, b)


def neg(F, a):
    return binop(F, OP_SUB, torch.zeros_like(a), a)


def sqr(F, a):
    return binop(F, OP_MUL, a, a)


def mul_mont(F, a: torch.Tensor, b_mont: torch.Tensor) -> torch.Tensor:
    """a * b for a `b_mont` that holds b * R: one Montgomery product."""
    return binop(F, OP_MULM, a, b_mont)


def const_mont(F: Field, v: int, device) -> torch.Tensor:
    """One element times R as an (8,) tensor, converted on the host."""
    return const(F, v * F.r, device)


def to_mont(F, a: torch.Tensor) -> torch.Tensor:
    """a -> a * R, what a kernel that takes Montgomery form wants."""
    return binop(F, OP_MULM, a, const(F, F.r2, a.device))


def from_mont(F, a: torch.Tensor) -> torch.Tensor:
    """a * R -> a."""
    return binop(F, OP_MULM, a, const(F, 1, a.device))


def mul_const(F, a: torch.Tensor, v: int) -> torch.Tensor:
    """a * v for a host int v (mul_small of the JAX package included)."""
    return mul_mont(F, a, const_mont(F, v, a.device))


def pow_const(F, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise, square-and-multiply over the bits of e."""
    result = one(a.device, a.shape[:-1])
    base = a
    while e:
        if e & 1:
            result = mul(F, result, base)
        e >>= 1
        if e:
            base = sqr(F, base)
    return result


def inv(F, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse by Fermat; 0 -> 0."""
    return pow_const(F, a, F.modulus - 2)


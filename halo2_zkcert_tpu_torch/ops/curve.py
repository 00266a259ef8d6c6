"""BN254 G1 on tensors, and kernels K2 (point_add), K3 (point_double) and
K5 (point_add_mixed).

Points are homogeneous projective (X, Y, Z) stored as one int32 tensor of
shape (..., 3, 8): three canonical Fq elements; the identity is (0, 1, 0).
Affine points are (..., 2, 8) with (0, 0) standing for the identity.  The
group law is the complete Renes-Costello-Batina formulas for a = 0 (eprint
2015/1060, Algorithms 7, 8 and 9, b3 = 9), with no case analysis.

`add`, `double` and `add_mixed` wrap the kernels (csrc/point_ops.cu,
replacing the TPU's fused_point_add, fused_point_double and
fused_point_add_mixed): a CUDA tensor launches the kernel, a CPU tensor runs
`add_plain` / `double_plain` / `add_mixed_plain`, the same formulas over the
plain field arithmetic of ops/field.py.
"""
from __future__ import annotations

import torch

from ..utils import refcrypto as rc
from . import field, kernels
from .field import FQ

B3 = 9   # 3 * b for y^2 = x^3 + 3


def identity(shape=(), device="cpu") -> torch.Tensor:
    P = torch.zeros(tuple(shape) + (3, 8), dtype=torch.int32, device=device)
    P[..., 1, 0] = 1
    return P


def from_affine(xy: torch.Tensor) -> torch.Tensor:
    """(..., 2, 8) affine ((0, 0) = identity) -> (..., 3, 8) projective."""
    x, y = xy[..., 0, :], xy[..., 1, :]
    inf = ((x == 0).all(-1) & (y == 0).all(-1))[..., None]
    one = torch.zeros_like(x)
    one[..., 0] = 1
    z = torch.where(inf, torch.zeros_like(x), one)
    y = torch.where(inf, one, y)
    return torch.stack((x, y, z), dim=-2)


def neg(P: torch.Tensor) -> torch.Tensor:
    X, Y, Z = P.unbind(-2)
    return torch.stack((X, field.neg(FQ, Y), Z), dim=-2)


# ---------------------------------------------------------------------------
# plain versions: the RCB16 formulas with independent products batched
# ---------------------------------------------------------------------------

def _fq(op, a, b):
    return field.binop_plain(FQ, op, a, b)


def add_plain(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """RCB16 Algorithm 7 (complete, a = 0): 12 products."""
    P, Q = torch.broadcast_tensors(P, Q)
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2, Z2 = Q.unbind(-2)
    s = _fq("add", torch.stack((X1, Y1, X1, X2, Y2, X2)),
            torch.stack((Y1, Z1, Z1, Y2, Z2, Z2)))
    m = _fq("mul", torch.stack((X1, Y1, Z1, s[0], s[1], s[2])),
            torch.stack((X2, Y2, Z2, s[3], s[4], s[5])))
    t0, t1, t2 = m[0], m[1], m[2]
    sums = _fq("add", torch.stack((t0, t1, t0)), torch.stack((t1, t2, t2)))
    t3, t4, y3 = _fq("sub", m[3:6], sums)          # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1
    x2 = _fq("add", torch.stack((t0, t2, y3)), torch.stack((t0, t2, y3)))
    x3 = _fq("add", x2, torch.stack((t0, t2, y3)))  # 3 t0, 3 t2, 3 y3
    t0 = x3[0]
    x6 = _fq("add", x3[1:], x3[1:])
    t2, y3 = _fq("add", x6, x3[1:])                 # 9 t2, 9 y3
    z3 = _fq("add", t1, t2)
    t1 = _fq("sub", t1, t2)
    p = _fq("mul", torch.stack((t3, t4, t1, y3, z3, t0)),
            torch.stack((t1, y3, z3, t0, t4, t3)))
    X3 = _fq("sub", p[0], p[1])
    Y3, Z3 = _fq("add", torch.stack((p[2], p[4])), torch.stack((p[3], p[5])))
    return torch.stack((X3, Y3, Z3), dim=-2)


def add_mixed_plain(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """RCB16 Algorithm 8 (complete in P, a = 0): P (..., 3, 8) projective
    plus Q (..., 2, 8) affine with Z2 = 1, never the identity; 11 products.
    The same projective triple as `add_plain(P, (x2, y2, 1))`."""
    lead = torch.broadcast_shapes(P.shape[:-2], Q.shape[:-2])
    X1, Y1, Z1 = P.expand(lead + (3, 8)).unbind(-2)
    X2, Y2 = Q.expand(lead + (2, 8)).unbind(-2)
    s = _fq("add", torch.stack((X1, X2)), torch.stack((Y1, Y2)))
    m = _fq("mul", torch.stack((X1, Y1, s[0], X2, Y2)),
            torch.stack((X2, Y2, s[1], Z1, Z1)))
    t0, t1 = m[0], m[1]
    t3 = _fq("sub", m[2], _fq("add", t0, t1))      # X1Y2 + X2Y1
    t4, t5 = _fq("add", m[3:5], torch.stack((X1, Y1)))  # X1Z2+X2Z1, Y1Z2+Y2Z1
    v = torch.stack((t0, Z1, t4))
    x3 = _fq("add", _fq("add", v, v), v)            # 3 t0, 3 Z1, 3 t4
    t0 = x3[0]
    x6 = _fq("add", x3[1:], x3[1:])
    t2, y3 = _fq("add", x6, x3[1:])                 # 9 Z1, 9 t4
    z3 = _fq("add", t1, t2)
    t1 = _fq("sub", t1, t2)
    p = _fq("mul", torch.stack((t3, t5, t1, y3, z3, t0)),
            torch.stack((t1, y3, z3, t0, t5, t3)))
    X3 = _fq("sub", p[0], p[1])
    Y3, Z3 = _fq("add", torch.stack((p[2], p[4])), torch.stack((p[3], p[5])))
    return torch.stack((X3, Y3, Z3), dim=-2)


def double_plain(P: torch.Tensor) -> torch.Tensor:
    """RCB16 Algorithm 9 (complete, a = 0): 6 products + 2 squares."""
    X, Y, Z = P.unbind(-2)
    t0, t1, zz, xy = _fq("mul", torch.stack((Y, Y, Z, X)),
                         torch.stack((Y, Z, Z, Y)))
    v = torch.stack((t0, zz))
    v2 = _fq("add", v, v)
    v4 = _fq("add", v2, v2)
    v8 = _fq("add", v4, v4)
    z3 = v8[0]                                      # 8 Y^2
    t2 = _fq("add", v8[1], zz)                      # 9 Z^2
    y3a = _fq("add", t0, t2)
    t2x3 = _fq("add", _fq("add", t2, t2), t2)
    t0 = _fq("sub", t0, t2x3)
    x3, z3, y3b, x3b = _fq("mul", torch.stack((t2, t1, t0, t0)),
                           torch.stack((z3, z3, y3a, xy)))
    Y3 = _fq("add", x3, y3b)
    X3 = _fq("add", x3b, x3b)
    return torch.stack((X3, Y3, z3), dim=-2)


# ---------------------------------------------------------------------------
# K2 / K3 / K5 wrappers
# ---------------------------------------------------------------------------

def _check_points(name, *ts, coords=3):
    kernels.require_cuda_int32(name, *ts)
    for t in ts:
        if t.shape[-2:] != (coords, 8):
            raise ValueError(f"{name}: expected (..., {coords}, 8) points, "
                             f"got {tuple(t.shape)}")


def add(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition P + Q (broadcasting)."""
    if P.device.type == "cpu":
        return add_plain(P, Q)
    if P.shape != Q.shape:
        P, Q = torch.broadcast_tensors(P, Q)
    P, Q = P.contiguous(), Q.contiguous()
    out = torch.empty_like(P)
    _check_points("point_add", P, Q, out)
    n = P.numel() // 24
    lib = kernels.lib("point_ops")
    kernels.launches["point_add"] += 1
    kernels.check(lib.h2t_point_add(P.data_ptr(), Q.data_ptr(),
                                    out.data_ptr(), n,
                                    kernels.stream_ptr(P.device)),
                  "point_add")
    return out


def add_mixed(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Mixed addition P + Q: P (..., 3, 8) projective, any point; Q
    (..., 2, 8) affine and never the identity (broadcasting over the
    leading axes)."""
    if P.device.type == "cpu":
        return add_mixed_plain(P, Q)
    lead = torch.broadcast_shapes(P.shape[:-2], Q.shape[:-2])
    P = P.expand(lead + P.shape[-2:]).contiguous()
    Q = Q.expand(lead + Q.shape[-2:]).contiguous()
    out = torch.empty_like(P)
    _check_points("point_add_mixed", P, out)
    _check_points("point_add_mixed", Q, coords=2)
    lib = kernels.lib("point_ops")
    kernels.launches["point_add_mixed"] += 1
    kernels.check(lib.h2t_point_add_mixed(P.data_ptr(), Q.data_ptr(),
                                          out.data_ptr(), P.numel() // 24,
                                          kernels.stream_ptr(P.device)),
                  "point_add_mixed")
    return out


def double(P: torch.Tensor) -> torch.Tensor:
    """Complete projective doubling 2P."""
    if P.device.type == "cpu":
        return double_plain(P)
    P = P.contiguous()
    out = torch.empty_like(P)
    _check_points("point_double", P, out)
    lib = kernels.lib("point_ops")
    kernels.launches["point_double"] += 1
    kernels.check(lib.h2t_point_double(P.data_ptr(), out.data_ptr(),
                                       P.numel() // 24,
                                       kernels.stream_ptr(P.device)),
                  "point_double")
    return out


def sub(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    return add(P, neg(Q))


def select(cond: torch.Tensor, P: torch.Tensor, Q: torch.Tensor):
    """Pointwise select: cond (...,) bool."""
    return torch.where(cond[..., None, None], P, Q)


def scalar_mul(P: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Batched double-and-add: P (..., 3, 8), scalars (..., 8) canonical
    words (LSB first); 256 steps of one add and one double each."""
    acc = identity(P.shape[:-2], P.device)
    base = P
    words = scalars.to(torch.int64) & 0xFFFFFFFF
    for i in range(256):
        bit = ((words[..., i // 32] >> (i % 32)) & 1).bool()
        acc = select(bit, add(acc, base), acc)
        if i < 255:
            base = double(base)
    return acc


def to_affine(P: torch.Tensor) -> torch.Tensor:
    """Projective (..., 3, 8) -> affine (..., 2, 8); identity -> (0, 0).
    One batched Fq inversion over all points."""
    from .frops import batch_inv
    X, Y, Z = P.unbind(-2)
    inf = (Z == 0).all(-1)[..., None]
    safe_z = torch.where(inf, field.one(P.device, Z.shape[:-1]), Z)
    zinv = batch_inv(safe_z.reshape(-1, 8), FQ).reshape(Z.shape)
    xy = field.mul(FQ, torch.stack((X, Y)), torch.stack((zinv, zinv)))
    xy = torch.where(inf, torch.zeros_like(xy), xy)
    return torch.stack((xy[0], xy[1]), dim=-2)


# ---------------------------------------------------------------------------
# host converters
# ---------------------------------------------------------------------------

def points_to_device(pts_affine, device) -> torch.Tensor:
    """List of (x, y) int affine points -> (N, 2, 8) tensor."""
    flat = [c for pt in pts_affine for c in pt]
    return field.from_ints(FQ, flat, device).reshape(-1, 2, 8)


def points_from_device(arr: torch.Tensor) -> list:
    """(N, 2, 8) affine tensor -> list of (x, y) ints."""
    vals = field.words_to_ints(arr.reshape(-1, 8))
    return [(vals[2 * i] % rc.FQ, vals[2 * i + 1] % rc.FQ)
            for i in range(len(vals) // 2)]

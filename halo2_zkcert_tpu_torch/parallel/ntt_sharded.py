"""The number-theoretic transform with its rows split over a process group.

Counterpart of halo2_zkcert_tpu/parallel/ntt_sharded.py, where XLA's SPMD
partitioner placed the exchanges.  Here they are spelled out with the
four-step factorization of ops/ntt_mxu.py: for n = D m (D ranks, rank r
holding the rows r m .. r m + m - 1, w the root of order n),

    X[t2 D + t1] = sum_i w_m^(i t2) * w^(i t1) * sum_r x[r m + i] w_D^(r t1)

so a transform is three `all_to_all`s around two batched local transforms
(ops/ntt.py: size D over r, then size m over i) and one K1 twiddle product;
it needs n divisible by D^2.  The inverse takes w^-1, and the two inverse
transforms' 1/D and 1/m make 1/n.

`transform_gathered` is what plonk/domain.py calls: the whole transform of a
replicated input, each rank transforming its block (coset powers and a
factor R on the block before or after) and the blocks all-gathered, so that
the rest of the prover runs as before.  `counts` tells the transforms
split over the mesh ("sharded") from those whose length does not divide and
ran replicated ("replicated").
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from ..ops import field, ntt
from ..ops.field import FR
from ..utils import refcrypto as rc

counts: Counter = Counter()
_tables: dict = {}


def _twiddles(k: int, D: int, s: int, inverse: bool, device) -> torch.Tensor:
    """(m / D, D, 8): w^((s m / D + i) t1) times R at [i, t1], for the
    rank s that holds the i-quarter s after the first exchange."""
    key = ("tw", k, D, s, inverse, str(device))
    t = _tables.get(key)
    if t is None:
        p, h = rc.FR, (1 << k) // D // D
        w = rc.fr_root_of_unity(k)
        if inverse:
            w = pow(w, p - 2, p)
        vals = [pow(w, (s * h + i) * t1, p) * FR.r % p
                for i in range(h) for t1 in range(D)]
        t = field.from_ints(FR, vals, device).reshape(h, D, 8)
        _tables[key] = t
    return t


def ntt_sharded(a_local: torch.Tensor, k: int, mesh,
                inverse: bool = False) -> torch.Tensor:
    """a_local (..., 2^k / D, 8): this rank's contiguous block of rows.
    Returns this rank's block of the transform (the inverse, with 1/n, when
    `inverse`)."""
    D, n = mesh.size, 1 << k
    fn = ntt.intt if inverse else ntt.ntt
    m = n // D
    if n % (D * D) or a_local.shape[-2] != m:
        raise ValueError(f"ntt_sharded: {tuple(a_local.shape)} at k={k} over "
                         f"{D} ranks")
    h = m // D
    lead = a_local.shape[:-2]
    B = math.prod(lead)
    x = a_local.reshape(B, D, h, 8)
    # 1: rank s receives x[r m + s h + i] from every rank r
    u = mesh.all_to_all(x.transpose(0, 1).contiguous())       # [r, b, i]
    u = fn(u.permute(1, 2, 0, 3).contiguous(), D.bit_length() - 1)
    u = field.mul_mont(FR, u, _twiddles(k, D, mesh.rank, inverse,
                                        u.device))            # [b, i, t1]
    # 2: rank t1 receives u[., s h + i, t1] from every rank s
    v = mesh.all_to_all(u.permute(2, 0, 1, 3).contiguous())   # [s, b, i]
    v = fn(v.permute(1, 0, 2, 3).reshape(B, m, 8).contiguous(),
           m.bit_length() - 1)                                # [b, t2]
    # 3: rank r receives X[t2 D + t1] for t2 in [r h, r h + h) from rank t1
    y = mesh.all_to_all(v.reshape(B, D, h, 8).transpose(0, 1).contiguous())
    return y.permute(1, 2, 0, 3).reshape(lead + (m, 8))


def _scale(name: str, base: int, k: int, mont: bool, times_r: bool,
           device) -> torch.Tensor:
    """base^j (times R with `mont`, times R once more with `times_r`),
    j < 2^k, cached: the operand of one `field.mul_mont`."""
    key = (name, base, k, mont, times_r, str(device))
    t = _tables.get(key)
    if t is None:
        t = ntt.power_table(base, 1 << k, device, mont=mont)
        if times_r:
            t = field.to_mont(FR, t)
        _tables[key] = t
    return t


def transform_gathered(a: torch.Tensor, k: int, mesh, inverse: bool,
                       g: int | None = None, mont: bool = False
                       ) -> torch.Tensor:
    """The whole transform of the replicated `a` (..., <= 2^k, 8) over the
    mesh: forward (a coset transform onto g*H with `g`, Montgomery form out
    with `mont`) or inverse (from g*H with `g`, Montgomery form in with
    `mont`), equal to ops/ntt.py's on every rank."""
    n, D, r = 1 << k, mesh.size, mesh.rank
    M = n // D
    lead = a.shape[:-2]
    x = a.reshape((-1,) + a.shape[-2:])
    x = x[:, r * M:(r + 1) * M]
    if x.shape[1] < M:                      # zero coefficients past the input
        x = torch.nn.functional.pad(x, (0, 0, 0, M - x.shape[1]))
    if g is not None and not inverse:       # x g^j (R): g^j R (R), one product
        x = field.mul_mont(FR, x, _scale("coset", g, k, True, mont, x.device)
                           [r * M:(r + 1) * M])
    y = ntt_sharded(x.contiguous(), k, mesh, inverse)
    if g is not None and inverse:           # y g^-j (R^-1)
        y = field.mul_mont(FR, y, _scale(
            "coset_inv", pow(g, rc.FR - 2, rc.FR), k, not mont, False,
            y.device)[r * M:(r + 1) * M])
    full = mesh.all_gather(y)               # (D, B, M, 8)
    return full.transpose(0, 1).reshape(lead + (n, 8))

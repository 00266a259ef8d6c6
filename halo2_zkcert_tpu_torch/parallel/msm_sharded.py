"""Multi-scalar multiplication with its points split over a process group.

Counterpart of halo2_zkcert_tpu/parallel/msm_sharded.py (shard_map there).
Every rank holds the same points and scalars (the prover runs replicated);
each runs the variable-base ops/msm.msm_many on its contiguous slice of
them, the ranks all-gather the D projective partial sums ((D, m, 3, 8)
words: 96 bytes a column and rank) and every rank folds them in rank order
with K2 (`curve.add`).  The result is the same on every rank; group addition
is exact, so `curve.to_affine` of it equals the single-device MSM's.
"""
from __future__ import annotations

import torch

from ..ops import curve, msm


def msm_sharded(points_affine: torch.Tensor, scalars: torch.Tensor,
                mesh) -> torch.Tensor:
    """points_affine (N, 2, 8), scalars (m, N, 8) or (N, 8), N divisible by
    the mesh size.  Returns the (m, 3, 8) (or (3, 8)) projective sums."""
    one = scalars.dim() == 2
    if one:
        scalars = scalars[None]
    n, D = points_affine.shape[0], mesh.size
    if n % D or scalars.shape[1] != n:
        raise ValueError(f"msm_sharded: {n} points, scalars "
                         f"{tuple(scalars.shape)}, mesh of {D}")
    lo, s = mesh.rank * (n // D), n // D
    local = msm.msm_many(points_affine[lo:lo + s].contiguous(),
                         scalars[:, lo:lo + s].contiguous())
    parts = mesh.all_gather(local)                       # (D, m, 3, 8)
    acc = parts[0]
    for d in range(1, D):
        acc = curve.add(acc, parts[d])
    return acc[0] if one else acc


def msm_sharded_affine(points_affine: torch.Tensor, scalars: torch.Tensor,
                       mesh) -> torch.Tensor:
    """The same, as affine (x, y) words ((0, 0) the identity)."""
    return curve.to_affine(msm_sharded(points_affine, scalars, mesh))

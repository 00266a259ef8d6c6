"""Prefix scans of G1 points under the group law, as the fixed-base MSM
needs them.

Counterpart of the part of halo2_zkcert_tpu/ops/scan.py that ops/msm_fb.py
uses.  A local scan returns `(local, offsets, C)`: `local` (B, n, 3, 8) holds
prefixes local to each C-sized row, `offsets` (B, n / C, 3, 8) the exclusive
row offsets, and the true prefix at flat index i is
`offsets[i // C] + local[i]`; a caller that reads the prefix at few positions
adds the offset there only.  The scans are log-depth Hillis-Steele sweeps
(ops/frops.hillis_steele), one kernel launch a level for all rows at once;
the TPU package's sequential grid loop has no counterpart here.
"""
from __future__ import annotations

import torch

from . import curve, field
from .frops import hillis_steele


def _add(x, y):
    return (curve.add(x[0], y[0]),)


def _add_first(x, y):
    # level 1: the later operand is still an original point (x, y, 1)
    return (curve.add_mixed(x[0], y[0][..., :2, :]),)


def lift_affine(xy: torch.Tensor) -> torch.Tensor:
    """(..., 2, 8) affine points, none the identity -> (..., 3, 8) with
    Z = 1 (no test for the (0, 0) identity, unlike curve.from_affine)."""
    one = field.one(xy.device, xy.shape[:-2] + (1,))
    return torch.cat((xy, one), dim=-2)


def prefix_scan_batched(P: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along axis 1 of projective points
    (B, n, 3, 8), every row on its own."""
    return hillis_steele((P,), _add)[0]


def prefix_scan_batched_local(xy: torch.Tensor):
    """Local scan of affine points (B, n, 2, 8), none the identity, for any
    width n: level by level, the first level a mixed addition (K5) because
    its right operand is an original affine point, the others full
    additions (K2).  One row spans the whole width, so the offsets are a
    single identity a batch row and C = n."""
    B, n = xy.shape[:2]
    local = hillis_steele((lift_affine(xy),), _add, _add_first)[0]
    return local, curve.identity((B, 1), xy.device), n

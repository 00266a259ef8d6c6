"""Variable-base multi-scalar multiplication (Pippenger), batched over
columns.

Counterpart of halo2_zkcert_tpu/ops/msm.py, same data flow: 8-bit windows
(the scalar bytes), per window the points sorted by digit, an inclusive
group-law prefix scan over the sorted points (K2, one launch per level for
all windows and columns at once), bucket sums as differences of the scan at
segment ends, the running-suffix combine sum_d d * B_d (log-depth: a suffix
scan and a tree sum), and Horner over the windows with 8 doublings (K3) per
step.  Only the resulting point has to equal the reference's.
"""
from __future__ import annotations

import torch

from . import curve
from .frops import hillis_steele

NWINDOWS = 32
NBUCKETS = 256


def _add_pairs(x, y):
    return (curve.add(x[0], y[0]),)


def _tree_sum_points(P: torch.Tensor) -> torch.Tensor:
    """(B, k, 3, 8) -> (B, 3, 8) group sums, pairwise halving."""
    while P.shape[1] > 1:
        if P.shape[1] % 2:
            P = torch.cat((P, curve.identity((P.shape[0], 1), P.device)), 1)
        P = curve.add(P[:, 0::2].contiguous(), P[:, 1::2].contiguous())
    return P[:, 0]


def msm_many(points_affine: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """points_affine (n, 2, 8); scalars (m, n, 8) canonical Fr words.
    Returns (m, 3, 8) projective sums sum_i scalars[j, i] * points[i]."""
    m, n = scalars.shape[:2]
    dev = scalars.device
    pts = curve.from_affine(points_affine)                  # (n, 3, 8)
    digits = scalars.contiguous().view(torch.uint8).reshape(m, n, 32)
    digits = digits.permute(0, 2, 1).to(torch.int64).reshape(
        m * NWINDOWS, n)                                    # (B, n)
    dsort, order = torch.sort(digits, dim=1)
    psort = pts[order]                                      # (B, n, 3, 8)
    prefix = hillis_steele((psort,), _add_pairs)[0]

    # bucket d = prefix[last index with digit <= d] - prefix[last with < d]
    ends = torch.searchsorted(
        dsort.contiguous(), torch.arange(NBUCKETS, device=dev).expand(dsort.shape[0], -1)
        .contiguous(), right=True) - 1                      # (B, 256)
    prev = torch.cat((torch.full_like(ends[:, :1], -1), ends[:, :-1]), 1)
    present = ends > prev
    B = prefix.shape[0]
    flat = prefix.reshape(B * n, 3, 8)
    rowoff = (torch.arange(B, device=dev) * n)[:, None]
    at_end = flat[(ends.clamp(0, n - 1) + rowoff).flatten()]
    at_prev = flat[(prev.clamp(0, n - 1) + rowoff).flatten()]
    ident = curve.identity((B * NBUCKETS,), dev)
    at_prev = curve.select((prev >= 0).flatten(), at_prev, ident)
    bucket = curve.sub(at_end, at_prev)
    bucket = curve.select(present.flatten(), bucket, ident)
    bucket = bucket.reshape(B, NBUCKETS, 3, 8)

    # sum_{d>=1} d * B_d = sum_{d>=1} S_d with S_d = sum_{j>=d} B_j
    rev = bucket[:, 1:].flip(1).contiguous()                # B_255 .. B_1
    suffix = hillis_steele((rev,), _add_pairs)[0]
    window_sums = _tree_sum_points(suffix).reshape(m, NWINDOWS, 3, 8)

    acc = window_sums[:, NWINDOWS - 1].contiguous()
    for w in range(NWINDOWS - 2, -1, -1):
        for _ in range(8):
            acc = curve.double(acc)
        acc = curve.add(acc, window_sums[:, w].contiguous())
    return acc


def msm(points_affine: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """One MSM: scalars (n, 8) -> affine (2, 8)."""
    return curve.to_affine(msm_many(points_affine, scalars[None]))[0]

"""Variable-base multi-scalar multiplication (Pippenger), batched over
columns.

Counterpart of halo2_zkcert_tpu/ops/msm.py, same data flow: 8-bit windows
(the scalar bytes), per window the points sorted by digit, an inclusive
group-law prefix scan over the sorted affine points (ops/scan
.point_scan_affine, mixed additions, all windows and columns at once),
bucket sums as differences of the scan at segment ends, the running-suffix
combine sum_d d * B_d (a reverse scan and a row sum), and Horner over the
windows with 8 doublings a step (curve.horner, one launch).  Only the
resulting point has to equal the reference's.
"""
from __future__ import annotations

import torch

from . import curve, scan

NWINDOWS = 32
NBUCKETS = 256


def msm_many(points_affine: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """points_affine (n, 2, 8); scalars (m, n, 8) canonical Fr words.
    Returns (m, 3, 8) projective sums sum_i scalars[j, i] * points[i]."""
    m, n = scalars.shape[:2]
    dev = scalars.device
    digits = scalars.contiguous().view(torch.uint8).reshape(m, n, 32)
    digits = digits.permute(0, 2, 1).to(torch.int64).reshape(
        m * NWINDOWS, n)                                    # (B, n)
    dsort, order = torch.sort(digits, dim=1)
    prefix = scan.point_scan_affine(points_affine[order])   # (B, n, 3, 8)

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
    suffix = scan.point_scan(bucket[:, 1:], reverse=True)   # bucket 0 dropped
    window_sums = scan.point_row_sum(suffix).reshape(m, NWINDOWS, 3, 8)

    return curve.horner(window_sums, 8)


def msm(points_affine: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """One MSM: scalars (n, 8) -> affine (2, 8)."""
    return curve.to_affine(msm_many(points_affine, scalars[None]))[0]

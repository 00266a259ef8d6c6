"""Prefix scans and row sums of G1 points under the group law, and the
kernels point_scan / point_row_sum / point_scan_affine.

Counterpart of the part of halo2_zkcert_tpu/ops/scan.py that the MSMs use.
`point_scan` and `point_row_sum` wrap the kernels of csrc/point_scan.cu, the
scan form of K2 (the TPU's fused_point_add under a scan), and
`point_scan_affine` its affine form, a scan form of K5 (fused_point_add_mixed:
the points come in as affine pairs and are added by mixed additions): a CUDA
tensor launches them, two launches a scan or a row sum at most whatever the
row length, a CPU tensor runs `point_scan_plain` / `point_row_sum_plain` /
`point_scan_affine_plain`, log-depth sweeps over the plain group law.  The
kernels add in another order than the plain versions, so the two agree as
group elements (compare after `curve.to_affine`), not as projective triples.

A local scan returns `(local, offsets, C)`: `local` (B, n, 3, 8) holds
prefixes local to each C-sized row, `offsets` (B, n / C, 3, 8) the exclusive
row offsets, and the true prefix at flat index i is
`offsets[i // C] + local[i]`; a caller that reads the prefix at few positions
adds the offset there only.
"""
from __future__ import annotations

import torch

from . import curve, field, kernels
from .frops import hillis_steele

# points a block of k_point_scan holds in shared memory (128 threads x 8); the
# blocks of a launch that fill the card (132 SMs x 2 resident blocks, four
# times over), beyond which a block takes several tiles instead; and the most
# blocks a row is cut into, since every block adds up the totals of the blocks
# before it
TILE = 1024
BLOCKS_WANTED = 1024
MAX_BLOCKS_A_ROW = 1024


def _add(x, y):
    return (curve.add_plain(x[0], y[0]),)


def _add_first(x, y):
    # level 1: the later operand is still an original point, (x, y, 1) or the
    # identity (0, 1, 0), which the mixed addition must not be given
    later = y[0]
    inf = (later[..., 2, :] == 0).all(-1)
    return (curve.select(inf, x[0],
                         curve.add_mixed_plain(x[0], later[..., :2, :])),)


def lift_affine(xy: torch.Tensor) -> torch.Tensor:
    """(..., 2, 8) affine points, none the identity -> (..., 3, 8) with
    Z = 1 (no test for the (0, 0) identity, unlike curve.from_affine)."""
    one = field.one(xy.device, xy.shape[:-2] + (1,))
    return torch.cat((xy, one), dim=-2)


# ---------------------------------------------------------------------------
# point_scan / point_row_sum
# ---------------------------------------------------------------------------

def point_scan_plain(P: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain version of `point_scan`: a Hillis-Steele sweep over the plain
    addition."""
    if reverse:
        return point_scan_plain(P.flip(1)).flip(1)
    return hillis_steele((P,), _add)[0]


def point_scan_affine_plain(xy: torch.Tensor,
                            reverse: bool = False) -> torch.Tensor:
    """Plain version of `point_scan_affine`: a Hillis-Steele sweep whose
    first level is a mixed addition (its later operand is still an input
    point) and whose others are full additions."""
    if reverse:
        return point_scan_affine_plain(xy.flip(1)).flip(1)
    return hillis_steele((curve.from_affine(xy),), _add, _add_first)[0]


def point_row_sum_plain(P: torch.Tensor) -> torch.Tensor:
    """Plain version of `point_row_sum`: pairwise halving."""
    while P.shape[1] > 1:
        if P.shape[1] % 2:
            P = torch.cat((P, curve.identity((P.shape[0], 1), P.device)), 1)
        P = curve.add_plain(P[:, 0::2], P[:, 1::2])
    return P[:, 0]


def _span(B: int, n: int) -> int:
    """Points of a row that one block takes: one tile; several where the
    launch would otherwise have more than BLOCKS_WANTED blocks (a block that
    walks its tiles in order pays once for the totals before it) or a row
    more than MAX_BLOCKS_A_ROW."""
    tiles = -(-n // TILE)
    return TILE * max(1, B * tiles // BLOCKS_WANTED,
                      -(-tiles // MAX_BLOCKS_A_ROW))


def _rows(name: str, P: torch.Tensor, coords: int = 3):
    """Check (B, n, coords, 8) CUDA points; returns the tensor (copied only
    if its rows are not dense runs of points on 16-byte boundaries, so a
    slice along axis 1 is read in place) and the distance between rows in
    words."""
    words = 8 * coords
    if P.dim() != 4 or P.shape[-2:] != (coords, 8) or 0 in P.shape:
        raise ValueError(f"{name}: expected nonempty (B, n, {coords}, 8) "
                         f"points, got {tuple(P.shape)}")
    if not P.is_cuda or P.dtype != torch.int32:
        raise ValueError(f"{name}: expected CUDA int32 words, got "
                         f"{P.dtype} on {P.device}")
    B, n = P.shape[:2]
    dense = (P.stride(3) == 1 and P.stride(2) == 8
             and (n == 1 or P.stride(1) == words)
             and (B == 1 or (P.stride(0) >= words * n
                             and P.stride(0) % 4 == 0))
             and P.data_ptr() % 16 == 0)
    if not dense:
        P = P.contiguous()
    return P, (P.stride(0) if B > 1 else words * n)


def _reduce(name: str, P: torch.Tensor, row_words: int, span: int,
            reverse: bool) -> torch.Tensor:
    """One k_point_reduce launch (k_point_reduce_affine for (B, n, 2, 8)
    points): (B, n) -> (B, ceil(n / span)) projective totals."""
    B, n = P.shape[:2]
    out = torch.empty((B, -(-n // span), 3, 8), dtype=torch.int32,
                      device=P.device)
    lib = kernels.lib("point_scan")
    fn = lib.h2t_point_reduce_affine if P.shape[2] == 2 \
        else lib.h2t_point_reduce
    kernels.launches[name] += 1
    kernels.check(fn(P.data_ptr(), row_words, out.data_ptr(), B, n, span,
                     int(reverse), kernels.stream_ptr(P.device)), name)
    return out


def _scan(name: str, P: torch.Tensor, row_words: int, totals, span: int,
          reverse: bool) -> torch.Tensor:
    """One k_point_scan launch (k_point_scan_affine for (B, n, 2, 8)
    points); `totals` what `_reduce` gives for the same span, or None where a
    row is one block."""
    B, n = P.shape[:2]
    out = torch.empty((B, n, 3, 8), dtype=torch.int32, device=P.device)
    lib = kernels.lib("point_scan")
    fn = lib.h2t_point_scan_affine if P.shape[2] == 2 else lib.h2t_point_scan
    kernels.launches[name] += 1
    kernels.check(fn(P.data_ptr(), row_words, out.data_ptr(),
                     None if totals is None else totals.data_ptr(), B, n,
                     span, int(reverse), kernels.stream_ptr(P.device)), name)
    return out


def point_scan(P: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix sums along axis 1 of projective points
    (B, n, 3, 8), every row on its own; from the row's end with `reverse`
    (out[:, i] = P[:, i] + ... + P[:, n - 1]).  The identity may stand
    anywhere.  Only the group element of a result is specified."""
    if P.device.type == "cpu":
        return point_scan_plain(P, reverse)
    return _scan_rows("point_scan", P, 3, reverse)


def _scan_rows(name: str, P: torch.Tensor, coords: int,
               reverse: bool) -> torch.Tensor:
    P, row_words = _rows(name, P, coords)
    B, n = P.shape[:2]
    span = _span(B, n)
    totals = None if n <= span else _reduce(name, P, row_words, span,
                                            reverse)
    return _scan(name, P, row_words, totals, span, reverse)


def point_scan_affine(xy: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix sums along axis 1 of affine points (B, n, 2, 8),
    (0, 0) read as the identity, every row on its own -> (B, n, 3, 8)
    projective; from the row's end with `reverse`.  Two launches at most
    whatever n is.  Only the group element of a result is specified."""
    if xy.device.type == "cpu":
        return point_scan_affine_plain(xy, reverse)
    return _scan_rows("point_scan_affine", xy, 2, reverse)


def point_row_sum(P: torch.Tensor) -> torch.Tensor:
    """(B, n, 3, 8) -> (B, 3, 8): the group sum of every row."""
    if P.device.type == "cpu":
        return point_row_sum_plain(P)
    P, row_words = _rows("point_row_sum", P)
    part = _reduce("point_row_sum", P, row_words, _span(*P.shape[:2]), False)
    if part.shape[1] > 1:
        part = _reduce("point_row_sum", part, 24 * part.shape[1],
                       part.shape[1], False)
    return part[:, 0]


def prefix_scan_batched_local(xy: torch.Tensor):
    """Local scan of affine points (B, n, 2, 8) for any width n: the whole
    row through `point_scan_affine`.  One row spans the whole width, so the
    offsets are a single identity a batch row and C = n."""
    B, n = xy.shape[:2]
    return point_scan_affine(xy), curve.identity((B, 1), xy.device), n

"""Fixed-base MSM: flattened Pippenger over precomputed window tables, and
kernel K6 (scan_madd).

Counterpart of halo2_zkcert_tpu/ops/msm_fb.py.  Every prover commitment is
an MSM over the FIXED SRS bases, so per basis the tables
T[w][i] = 2^(wbits * w) * G_i are built once (the doubling chains of
curve.windows, one batched affine normalization) and kept as canonical
affine words, 64 B a point.  An
MSM then has no window structure: it is one flat bucket accumulation over
the nwin * n (digit, table point) pairs:

* sort the pairs of each chunk by digit and gather their table points;
* local prefix scan of the sorted points under the mixed group law: rows of
  C points through K6 (one thread a row, the running sum in registers), C
  picked for each launch so that the rows fill the card, and a scan of the
  row totals (ops/scan.point_scan); a width that is not whole
  SCAN_ROW_MAX-point rows through ops/scan.point_scan_affine;
* bucket sums are differences of the prefix at the segment ends, added
  across chunks;
* sum_d d * B_d = sum_{d >= 1} S_d with S the suffix scan of the buckets
  (point_scan from the row's end, then point_row_sum).

Pairs with digit 0 land in bucket 0, which is discarded, so padding pairs
(digit 0, table row 0) contribute nothing.

Scalars are canonical 8 x 32-bit words, so 256 / wbits windows cover them
(16 at the default 16-bit windows).  Only each bucket sum as a group element
and the final point equal the TPU package's; sort order and chunking are
this port's own.

`scan_madd` wraps K6 (csrc/scan_madd.cu, replacing the TPU's
fused_scan_madd): a CUDA tensor launches the kernel, a CPU tensor runs
`scan_madd_plain`.  Given the sorted digits it writes only the prefixes that
are read afterwards (`scan_madd_defined`).

For the span recorder (utils/trace.py) each evaluation counts, from shapes
alone, its columns, the pairs it schedules (padding left out) and its
buckets (2^wbits a column), and each gather of table points is the span
`msm_gather` with its device interval.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import trace
from . import curve, kernels, scan

# flat (window, point) pairs per sort + scan round: one full 2^17-row column
# at 16-bit windows is one chunk
CHUNK = 1 << 21
# points a K6 row scans (a launch argument of the kernel): the longest row,
# to whose multiple a chunk's pairs are padded, and the shortest.  Shorter
# rows put more threads in flight (rows = pairs / C, one thread each) but
# leave more row totals to scan; `scan_row_length` picks between the two from
# the launch's pair count
SCAN_ROW_MAX = 64
SCAN_ROW_MIN = 8
# rows at which the card counts as full: 132 SMs x 512 threads
SCAN_ROWS_WANTED = 1 << 16
# columns per batched sort + scan + extract round
GROUP = 4
# bounded-value columns carry about nwin times fewer pairs each
GROUP_SMALL = 16


def _nwin(wbits: int) -> int:
    return 256 // wbits


def _digits(scalars: torch.Tensor, wbits: int) -> torch.Tensor:
    """(..., 8) canonical words -> (..., 256 / wbits) int32 window digits,
    least significant first."""
    s = scalars.contiguous()
    if wbits == 8:
        return s.view(torch.uint8).to(torch.int32)
    assert wbits == 16
    return s.view(torch.int16).to(torch.int32) & 0xFFFF


def build_tables(base_affine: torch.Tensor, wbits: int) -> torch.Tensor:
    """(n, 2, 8) affine points, none the identity -> (nwin * n, 2, 8) window
    tables, window-major: T[w * n + i] = 2^(wbits * w) * base[i].  Windows
    come projective out of one `curve.windows` launch (the `wbits`
    doublings a step of every window in registers) and are normalized in one
    batched inversion per 2^17-point slice of the base."""
    nwin = _nwin(wbits)
    n = base_affine.shape[0]
    step = min(n, 1 << 17)
    out = torch.empty((nwin, n, 2, 8), dtype=torch.int32,
                      device=base_affine.device)
    for off in range(0, n, step):
        P = scan.lift_affine(base_affine[off:off + step])
        out[:, off:off + step] = curve.to_affine(curve.windows(P, wbits, nwin))
    return out.reshape(nwin * n, 2, 8)


def tables_from_reference(table_u8, n: int, wbits: int) -> torch.Tensor:
    """The TPU package's window tables, (nwin_ref * n, 2, 33) uint8
    canonical byte limbs over 272-bit scalars, as this port's
    (nwin * n, 2, 8) words: the windows above 256 bits are dropped."""
    t = np.asarray(table_u8).astype(np.uint8)
    t = t.reshape(-1, n, 2, t.shape[-1])[:_nwin(wbits), :, :, :32]
    words = np.ascontiguousarray(t).view("<i4")
    return torch.from_numpy(words.reshape(-1, 2, 8).copy())


def load_or_build_tables(base_affine: torch.Tensor, wbits: int,
                         cache_path: str | None) -> torch.Tensor:
    """The tables of one basis, read from `cache_path` (a .npy beside the
    SRS file) when it is there, else built and written to it."""
    if cache_path and os.path.exists(cache_path):
        t = torch.from_numpy(np.load(cache_path)).to(base_affine.device)
        if t.shape != (_nwin(wbits) * base_affine.shape[0], 2, 8):
            raise ValueError(f"{cache_path}: window tables of shape "
                             f"{tuple(t.shape)} do not match this basis")
        return t
    t = build_tables(base_affine, wbits)
    if cache_path:
        np.save(cache_path, t.cpu().numpy())
    return t


# ---------------------------------------------------------------------------
# K6: the mixed-add row scan
# ---------------------------------------------------------------------------

def scan_madd_plain(xy: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: C - 1 sequential mixed additions over all rows
    at once.  (R, C, 2, 8) -> (R, C, 3, 8), every slot written."""
    acc = scan.lift_affine(xy[:, 0])
    out = [acc]
    for j in range(1, xy.shape[1]):
        acc = curve.add_mixed_plain(acc, xy[:, j])
        out.append(acc)
    return torch.stack(out, dim=1)


def scan_madd_defined(dsort: torch.Tensor) -> torch.Tensor:
    """(R, C) sorted digits -> (R, C) bool: the slots `scan_madd` writes when
    it is given the digits: a pair that is the last of its digit in the row,
    and the row's last."""
    last = torch.ones_like(dsort[:, :1], dtype=torch.bool)
    return torch.cat((dsort[:, 1:] != dsort[:, :-1], last), dim=1)


def scan_madd(xy: torch.Tensor, dsort=None) -> torch.Tensor:
    """Per row, the inclusive prefix sums of C affine points, none the
    identity: (R, C, 2, 8) -> (R, C, 3, 8) projective, prefix 0 being the
    point itself with Z = 1.  With `dsort`, the rows' digits (R, C) int32 in
    ascending order, only the slots of `scan_madd_defined(dsort)` are
    defined: the kernel leaves the others unwritten."""
    if xy.device.type == "cpu":
        return scan_madd_plain(xy)
    xy = xy.contiguous()
    if xy.dim() != 4 or xy.shape[-2:] != (2, 8):
        raise ValueError(f"scan_madd: expected (R, C, 2, 8) affine points, "
                         f"got {tuple(xy.shape)}")
    R, C = xy.shape[:2]
    out = torch.empty((R, C, 3, 8), dtype=torch.int32, device=xy.device)
    kernels.require_cuda_int32("scan_madd", xy, out)
    digits = None
    if dsort is not None:
        dsort = dsort.contiguous()
        if dsort.shape != (R, C):
            raise ValueError(f"scan_madd: expected ({R}, {C}) digits, got "
                             f"{tuple(dsort.shape)}")
        kernels.require_cuda_int32("scan_madd", dsort)
        digits = dsort.data_ptr()
    lib = kernels.lib("scan_madd")
    kernels.launches["scan_madd"] += 1
    kernels.check(lib.h2t_scan_madd(xy.data_ptr(), digits, out.data_ptr(), R,
                                    C, kernels.stream_ptr(xy.device)),
                  "scan_madd")
    return out


def scan_row_length(pairs: int) -> int:
    """Points a K6 row scans in a launch over `pairs` pairs: the longest
    power of two from SCAN_ROW_MAX down to SCAN_ROW_MIN that still gives
    SCAN_ROWS_WANTED rows, else the shortest."""
    C = SCAN_ROW_MAX
    while C > SCAN_ROW_MIN and pairs // C < SCAN_ROWS_WANTED:
        C //= 2
    return C


def _scan_local(pts_sorted: torch.Tensor, dsort: torch.Tensor):
    """Local scan of sorted table points (B, chunk, 2, 8) with their digits
    (B, chunk) -> (local, off, C) with the contract of
    scan.prefix_scan_batched_local, except that `local` is defined only
    where a pair is the last of its digit or of its row.  A chunk of whole
    SCAN_ROW_MAX rows goes through K6 at the row length of
    `scan_row_length` and a scan of the row totals; any other width through
    the scan of affine points (scan.prefix_scan_batched_local)."""
    B, chunk = pts_sorted.shape[:2]
    if chunk % SCAN_ROW_MAX or chunk // SCAN_ROW_MAX < 2:
        return scan.prefix_scan_batched_local(pts_sorted)
    C = scan_row_length(B * chunk)
    R = chunk // C
    local = scan_madd(pts_sorted.reshape(B * R, C, 2, 8),
                      dsort.reshape(B * R, C))
    totals = local.reshape(B, R, C, 3, 8)[:, :, -1]
    tot_scan = scan.point_scan(totals)
    off = torch.cat((curve.identity((B, 1), local.device), tot_scan[:, :-1]),
                    dim=1)
    return local.reshape(B, chunk, 3, 8), off, C


def _extract_buckets_batched(local, off, C: int, dsort, wbits: int):
    """Segment-end differences of the sorted prefix: local (B, chunk, 3, 8),
    off (B, chunk / C, 3, 8), dsort (B, chunk) sorted digits ->
    (B, 2^wbits, 3, 8) bucket sums of every chunk row."""
    B, chunk = dsort.shape
    nb = 1 << wbits
    dev = dsort.device
    keys = torch.arange(nb, dtype=dsort.dtype, device=dev).expand(B, nb)
    ends = torch.searchsorted(dsort.contiguous(), keys.contiguous(),
                              right=True) - 1                 # (B, nb)
    prev = torch.cat((torch.full_like(ends[:, :1], -1), ends[:, :-1]), dim=1)
    present = (ends > prev).flatten()
    flat_local = local.reshape(B * chunk, 3, 8)
    nrows = off.shape[1]
    flat_off = off.reshape(B * nrows, 3, 8)
    row = torch.arange(B, device=dev)[:, None]

    def prefix_at(idx):
        safe = idx.clamp(0, chunk - 1)
        return curve.add(flat_off[(row * nrows + safe // C).flatten()],
                         flat_local[(row * chunk + safe).flatten()])

    ident = curve.identity((B * nb,), dev)
    at_prev = curve.select((prev >= 0).flatten(), prefix_at(prev), ident)
    part = curve.sub(prefix_at(ends), at_prev)
    return curve.select(present, part, ident).reshape(B, nb, 3, 8)


def _tree_reduce_chunks(part: torch.Tensor, G: int, Bc: int) -> torch.Tensor:
    """(G * Bc, nb, 3, 8) chunk partials -> (G, nb, 3, 8), pairwise."""
    acc = part.reshape(G, Bc, *part.shape[1:])
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        s = curve.add(acc[:, :half].contiguous(),
                      acc[:, half:2 * half].contiguous())
        acc = torch.cat((s, acc[:, 2 * half:]), dim=1)
    return acc[:, 0]


def _chunk_buckets(table_flat, digits, rows, wbits: int) -> torch.Tensor:
    """One sort + scan + extract round: digits and the table index of each
    pair, both (B, chunk) -> (B, 2^wbits, 3, 8) bucket sums."""
    dsort, order = torch.sort(digits, dim=1)
    rows_sorted = torch.gather(rows, 1, order)
    with trace.span("msm_gather", device=rows_sorted.device):
        pts = table_flat[rows_sorted]
    local, off, C = _scan_local(pts, dsort)
    del pts                         # not held through the extraction
    return _extract_buckets_batched(local, off, C, dsort, wbits)


def _pad_pairs(digits, rows, multiple: int):
    """Pad the pair axis with (digit 0, table row 0) to a multiple."""
    pad = -digits.shape[1] % multiple
    if pad:
        digits = torch.nn.functional.pad(digits, (0, pad))
        rows = torch.nn.functional.pad(rows, (0, pad))
    return digits, rows


def _buckets_cols(table_flat, digits_cols, rows_cols, wbits: int):
    """Bucket sums of a group of columns in one round: digits_cols (G, T)
    window digits, rows_cols (1, T) the table index each pair multiplies ->
    (G, 2^wbits, 3, 8)."""
    G, total = digits_cols.shape
    Bc = -(-total // CHUNK)
    digits_cols, rows_cols = _pad_pairs(digits_cols, rows_cols, Bc)
    chunk = digits_cols.shape[1] // Bc
    part = _chunk_buckets(
        table_flat, digits_cols.reshape(G * Bc, chunk),
        rows_cols.expand(G, -1).reshape(G * Bc, chunk), wbits)
    return _tree_reduce_chunks(part, G, Bc)


def _combine_buckets_cols(buckets: torch.Tensor) -> torch.Tensor:
    """sum_{d >= 1} d * B_d per column, as the sum of the suffix sums
    S_d = sum_{j >= d} B_j: (G, 2^wbits, 3, 8) -> (G, 3, 8)."""
    suffix = scan.point_scan(buckets[:, 1:], reverse=True)  # bucket 0 dropped
    return scan.point_row_sum(suffix)


class FixedBaseMsm:
    """The window tables of one basis and the flat-Pippenger evaluator."""

    # Above this many flat pairs a column, columns stream CHUNK-sized slices
    # one at a time, so live memory stays O(CHUNK + 2^wbits) whatever n is.
    STREAM_PAIRS = 1 << 23

    def __init__(self, base_affine: torch.Tensor, wbits: int = 16,
                 cache_path: str | None = None):
        assert wbits in (8, 16)
        self.n = base_affine.shape[0]
        self.wbits = wbits
        self.nwin = _nwin(wbits)
        self.cache_path = cache_path
        self.table_flat = load_or_build_tables(base_affine, wbits, cache_path)

    def park(self) -> None:
        """Free the tables' device memory until `unpark`: dropped where
        their file holds them, else moved to the host."""
        if self.cache_path and os.path.exists(self.cache_path):
            self.table_flat = None
        else:
            self.table_flat = self.table_flat.cpu()

    def unpark(self, base_affine: torch.Tensor) -> None:
        """The tables back on `base_affine`'s device: read from their file,
        or copied from the host."""
        if self.table_flat is None:
            self.table_flat = load_or_build_tables(base_affine, self.wbits,
                                                   self.cache_path)
        else:
            self.table_flat = self.table_flat.to(base_affine.device)

    def __call__(self, scalars: torch.Tensor) -> torch.Tensor:
        """scalars (n, 8) canonical Fr words -> projective point (3, 8)."""
        return self.msm_many(scalars[None])[0]

    def _count(self, columns: int, pairs: int) -> None:
        """The recorder's counters of `columns` columns of `pairs` pairs."""
        trace.count(columns=columns, pairs=columns * pairs,
                    buckets=columns << self.wbits)

    def _rows_full(self, device) -> torch.Tensor:
        """(1, nwin * n) window-major table indices of full-width scalars."""
        return torch.arange(self.nwin * self.n, device=device)[None]

    def _digits_window_major(self, cols: torch.Tensor) -> torch.Tensor:
        """(g, n, 8) -> (g, nwin, n) digits."""
        return _digits(cols, self.wbits).permute(0, 2, 1)

    def msm_many(self, cols: torch.Tensor, group: int = GROUP) -> torch.Tensor:
        """(m, n, 8) -> (m, 3, 8) projective sums, `group` columns a
        round."""
        assert cols.shape[1] == self.n, (cols.shape, self.n)
        self._count(cols.shape[0], self.nwin * self.n)
        if self.nwin * self.n > self.STREAM_PAIRS:
            return self._msm_many_streamed(cols)
        rows = self._rows_full(cols.device)
        outs = []
        for base in range(0, cols.shape[0], group):
            grp = cols[base:base + group]
            d = self._digits_window_major(grp).reshape(grp.shape[0], -1)
            buckets = _buckets_cols(self.table_flat, d, rows, self.wbits)
            outs.append(_combine_buckets_cols(buckets))
        return torch.cat(outs)

    def _msm_many_streamed(self, cols: torch.Tensor) -> torch.Tensor:
        """Large-domain path: per column, CHUNK-sized slices of the flat
        pair stream go through one sort + scan round each and their bucket
        sums are accumulated."""
        rows = self._rows_full(cols.device)
        outs = []
        for j in range(cols.shape[0]):
            d = self._digits_window_major(cols[j:j + 1]).reshape(1, -1)
            d, r = _pad_pairs(d, rows, CHUNK)
            buckets = None
            for off in range(0, d.shape[1], CHUNK):
                part = _chunk_buckets(self.table_flat, d[:, off:off + CHUNK],
                                      r[:, off:off + CHUNK], self.wbits)
                buckets = part if buckets is None \
                    else curve.add(buckets, part)
            outs.append(_combine_buckets_cols(buckets))
        return torch.cat(outs)

    def _small_layout(self, value_windows: int, blind_lo: int, device):
        """(1, T) table indices of a bounded-value column: every row with
        its low `value_windows` windows, the rows >= blind_lo (the blinding
        tail) also with the windows above.  Padded with (digit 0, row 0)
        pairs to whole SCAN_ROW_MAX rows, so the scan takes K6; returns the
        rows and the unpadded pair count."""
        n = self.n
        idx = torch.arange(n, device=device)
        main = [w * n + idx for w in range(value_windows)]
        blind = [w * n + idx[blind_lo:]
                 for w in range(value_windows, self.nwin)]
        rows = torch.cat(main + blind)
        total = rows.shape[0]
        pad = -total % SCAN_ROW_MAX
        return torch.nn.functional.pad(rows, (0, pad))[None], total

    def msm_many_bounded(self, cols: torch.Tensor, value_bits: int,
                         blind_lo: int) -> torch.Tensor:
        """(m, n, 8) -> (m, 3, 8) for columns whose rows < blind_lo are
        < 2^value_bits (range-checked witness columns, lookup tables): only
        ceil(value_bits / wbits) windows of bucket work a row instead of
        nwin.  Rows >= blind_lo (blinding) keep every window."""
        vw = max(1, -(-value_bits // self.wbits))
        if vw >= self.nwin:
            return self.msm_many(cols)
        assert cols.shape[1] == self.n, (cols.shape, self.n)
        rows, total = self._small_layout(vw, blind_lo, cols.device)
        self._count(cols.shape[0], total)
        outs = []
        for base in range(0, cols.shape[0], GROUP_SMALL):
            grp = cols[base:base + GROUP_SMALL]
            g = grp.shape[0]
            d = self._digits_window_major(grp)            # (g, nwin, n)
            dflat = torch.cat((d[:, :vw].reshape(g, -1),
                               d[:, vw:, blind_lo:].reshape(g, -1)), dim=1)
            dflat = torch.nn.functional.pad(
                dflat, (0, rows.shape[1] - total))
            buckets = _buckets_cols(self.table_flat, dflat, rows, self.wbits)
            outs.append(_combine_buckets_cols(buckets))
        return torch.cat(outs)

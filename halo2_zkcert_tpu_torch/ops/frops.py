"""Batched Fr vector primitives the prover is assembled from, and the kernels
field_scan / field_row_sum.

Counterpart of halo2_zkcert_tpu/ops/frops.py: prefix products (grand
products), the affine recurrence scan (RSA witness), batched inversion,
power tables, row sums, barycentric evaluation, division by a linear factor
and the lookup permutation.  Elementwise field operations go through K1
(ops/field.binop).  `field_scan` and `field_row_sum` wrap the kernels of
csrc/field_scan.cu, the scan form of K1 (the TPU's fused_mul / fused_add
under a scan): a CUDA tensor launches them, two launches a scan or a row sum
at most whatever the row length; a CPU tensor runs the plain versions,
log-depth Hillis-Steele sweeps with one K1 launch a level.
"""
from __future__ import annotations

import math

import torch

from . import field, kernels
from .field import FR

NL = 8

FS_PROD, FS_SUM, FS_AFFINE = 0, 1, 2
_FS_OPS = {"mul": FS_PROD, "add": FS_SUM, "affine": FS_AFFINE}

# elements a block of k_field_scan holds in shared memory (128 threads x 8);
# the blocks of a launch beyond which a block takes several tiles instead;
# and the most blocks a row is cut into, since every block combines the
# totals of the blocks before it
TILE = 1024
BLOCKS_WANTED = 2048
MAX_BLOCKS_A_ROW = 1024


def _mul(a, b, F=FR):
    return field.mul(F, a, b)


def hillis_steele(state: tuple, combine, combine_first=None) -> tuple:
    """Inclusive scan along axis 1 of (B, n, ...) tensors.

    Level d combines element i with element i - d.  The combine runs on
    the flat contiguous views `x[d:]` and `x[:-d]` of all rows at once; the
    first d elements of each row, where that pairing crosses a row, are then
    restored.  `combine(earlier, later)` must be associative.
    `combine_first`, if given, replaces it at level 1, where the later
    operand is always an original input element."""
    B, n = state[0].shape[:2]
    d = 1
    while d < n:
        flat = [s.reshape((B * n,) + s.shape[2:]) for s in state]
        op = combine_first if d == 1 and combine_first else combine
        new = op(tuple(f[:-d] for f in flat), tuple(f[d:] for f in flat))
        nxt = []
        for s, f, v in zip(state, flat, new):
            o = torch.empty_like(f)
            o[d:] = v
            o = o.reshape(s.shape)
            o[:, :d] = s[:, :d]
            nxt.append(o)
        state = tuple(nxt)
        d *= 2
    return state


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def prefix_product_batched_plain(a: torch.Tensor, F=FR) -> torch.Tensor:
    return hillis_steele((a,), lambda x, y: (_mul(x[0], y[0], F),))[0]


def prefix_sum_batched_plain(a: torch.Tensor, F=FR) -> torch.Tensor:
    return hillis_steele((a,), lambda x, y: (field.add(F, x[0], y[0]),))[0]


def affine_scan_plain(m: torch.Tensor, b: torch.Tensor, F=FR) -> torch.Tensor:
    def combine(x, y):
        (m1, b1), (m2, b2) = x, y
        prod = _mul(torch.stack((m2, m2)), torch.stack((m1, b1)), F)
        return prod[0], field.add(F, prod[1], b2)

    return hillis_steele((m, b), combine)[1]


def field_scan_plain(a: torch.Tensor, op: str, reverse: bool = False,
                     b: torch.Tensor | None = None, F=FR) -> torch.Tensor:
    """Plain version of `field_scan`: a Hillis-Steele sweep over K1."""
    if reverse:
        return field_scan_plain(a.flip(1), op, False,
                                None if b is None else b.flip(1), F).flip(1)
    if op == "affine":
        return affine_scan_plain(a, b, F)
    return (prefix_product_batched_plain if op == "mul"
            else prefix_sum_batched_plain)(a, F)


def tree_sum_batched_plain(a: torch.Tensor, F=FR) -> torch.Tensor:
    """Plain version of `field_row_sum`: pairwise halving."""
    x = a
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat((x, torch.zeros_like(x[:, :1])), dim=1)
        x = field.add(F, x[:, 0::2], x[:, 1::2])
    return x[:, 0]


# ---------------------------------------------------------------------------
# field_scan / field_row_sum
# ---------------------------------------------------------------------------

def _span(B: int, n: int) -> int:
    """Elements of a row that one block takes: one tile; several where the
    launch would otherwise have more than BLOCKS_WANTED blocks or a row more
    than MAX_BLOCKS_A_ROW."""
    tiles = -(-n // TILE)
    return TILE * max(1, B * tiles // BLOCKS_WANTED,
                      -(-tiles // MAX_BLOCKS_A_ROW))


def _rows(name: str, *tensors: torch.Tensor):
    """Check nonempty (B, n, 8) rows of one shape; contiguous copies."""
    shape = tensors[0].shape
    for t in tensors:
        if t.dim() != 3 or t.shape[-1] != 8 or 0 in t.shape or t.shape != shape:
            raise ValueError(f"{name}: expected nonempty (B, n, 8) rows of one "
                             f"shape, got {tuple(t.shape)}")
    out = [t.contiguous() for t in tensors]
    kernels.require_cuda_int32(name, *out)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _reduce(name: str, F, op: int, a, b, span: int, reverse: bool):
    """One k_field_reduce launch: (B, n) -> (B, ceil(n / span)) canonical
    totals (for the affine maps their m and their b)."""
    B, n = a.shape[:2]
    shape = (B, -(-n // span), 8)
    tot_a = torch.empty(shape, dtype=torch.int32, device=a.device)
    tot_b = torch.empty_like(tot_a) if op == FS_AFFINE else None
    kernels.launches[name] += 1
    kernels.check(kernels.lib("field_scan").h2t_field_reduce(
        F.fid, op, a.data_ptr(), _ptr(b), tot_a.data_ptr(), _ptr(tot_b), B, n,
        span, int(reverse), kernels.stream_ptr(a.device)), name)
    return tot_a, tot_b


def field_scan(a: torch.Tensor, op: str, reverse: bool = False,
               b: torch.Tensor | None = None, F=FR) -> torch.Tensor:
    """Inclusive scan along axis 1 of canonical (B, n, 8) rows, every row on
    its own; from the row's end with `reverse`.  `op` is "mul" (prefix
    products), "add" (prefix sums) or "affine": the rows of `a` and `b` are
    the maps A -> a A + b, composed along the row, and the result is
    A[i] = a[i] A[i-1] + b[i] from A[-1] = 0."""
    if (op == "affine") != (b is not None):
        raise ValueError("field_scan: `b` goes with the affine scan")
    if a.device.type == "cpu":
        return field_scan_plain(a, op, reverse, b, F)
    a, *rest = _rows("field_scan", a, *([] if b is None else [b]))
    b = rest[0] if rest else None
    fs = _FS_OPS[op]
    B, n = a.shape[:2]
    span = _span(B, n)
    tot_a = tot_b = None
    if n > span:
        tot_a, tot_b = _reduce("field_scan", F, fs, a, b, span, reverse)
    out = torch.empty_like(a)
    kernels.launches["field_scan"] += 1
    kernels.check(kernels.lib("field_scan").h2t_field_scan(
        F.fid, fs, a.data_ptr(), _ptr(b), out.data_ptr(), _ptr(tot_a),
        _ptr(tot_b), B, n, span, int(reverse),
        kernels.stream_ptr(a.device)), "field_scan")
    return out


def field_row_sum(a: torch.Tensor, F=FR) -> torch.Tensor:
    """(B, n, 8) -> (B, 8): the sum of every row."""
    if a.device.type == "cpu":
        return tree_sum_batched_plain(a, F)
    (a,) = _rows("field_row_sum", a)
    part, _ = _reduce("field_row_sum", F, FS_SUM, a, None,
                      _span(*a.shape[:2]), False)
    if part.shape[1] > 1:
        part, _ = _reduce("field_row_sum", F, FS_SUM, part, None,
                          TILE * -(-part.shape[1] // TILE), False)
    return part[:, 0]


# ---------------------------------------------------------------------------
# what the prover calls
# ---------------------------------------------------------------------------

def prefix_product_batched(a: torch.Tensor, F=FR) -> torch.Tensor:
    """(m, n, 8) -> inclusive prefix products along axis 1."""
    return field_scan(a, "mul", F=F)


def prefix_product(a: torch.Tensor, F=FR) -> torch.Tensor:
    """Inclusive prefix product over axis 0: out[i] = prod_{j<=i} a[j]."""
    return prefix_product_batched(a[None], F)[0]


def affine_scan(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A[i] = m[i] * A[i-1] + b[i], A[-1] = 0, over axis 0 of (n, 8).
    (m1, b1) then (m2, b2) composes to (m2 m1, m2 b1 + b2)."""
    return field_scan(m[None], "affine", b=b[None])[0]


def batch_inv(a: torch.Tensor, F=FR) -> torch.Tensor:
    """Inverse of every row of a (N, 8) with nonzero entries: prefix and
    suffix products and one inversion of the total (done on the host)."""
    prefix = field_scan(a[None], "mul", F=F)[0]
    suffix = field_scan(a[None], "mul", reverse=True, F=F)[0]
    total = field.to_int(prefix[-1])
    total_inv = pow(total, F.modulus - 2, F.modulus)
    one = field.one(a.device, (1,))
    pre = torch.cat((one, prefix[:-1]))
    suf = torch.cat((suffix[1:], one))
    return field.mul_const(F, _mul(pre, suf, F), total_inv)


def powers(x: torch.Tensor, n: int) -> torch.Tensor:
    """(8,) element -> (n, 8) table [1, x, x^2, ..., x^(n-1)]."""
    xs = x.expand(n, NL).contiguous()
    scan = prefix_product(xs)
    return torch.cat((field.one(x.device, (1,)), scan[:-1]))


def tree_sum_batched(a: torch.Tensor) -> torch.Tensor:
    """(q, n, 8) -> (q, 8) sums mod r."""
    return field_row_sum(a)


def tree_sum(a: torch.Tensor) -> torch.Tensor:
    return tree_sum_batched(a[None])[0]


def poly_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return tree_sum(_mul(coeffs, powers(x, coeffs.shape[0])))


def poly_eval_many(polys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """polys (p, n, 8) coefficients, xs (p, 8) -> (p, 8)."""
    return torch.stack([poly_eval(polys[i], xs[i])
                        for i in range(polys.shape[0])])


def bary_weights(omega_pows: torch.Tensor, xs: torch.Tensor,
                 scales: torch.Tensor,
                 omega_pows_mont: torch.Tensor | None = None) -> torch.Tensor:
    """w_j[i] = scale_j * omega^i / (x_j - omega^i): (p, n, 8).  Given the
    table of powers times R as well, the product by it is one `mul_mont`."""
    p, n = xs.shape[0], omega_pows.shape[0]
    denom = field.sub(FR, xs[:, None].expand(p, n, NL), omega_pows[None])
    dinv = batch_inv(denom.reshape(p * n, NL)).reshape(p, n, NL)
    if omega_pows_mont is None:
        num = _mul(dinv, omega_pows[None])
    else:
        num = field.mul_mont(FR, dinv, omega_pows_mont[None])
    return _mul(num, scales[:, None])


def eval_lagrange_many(values: torch.Tensor, weights: torch.Tensor,
                       widx: torch.Tensor) -> torch.Tensor:
    """values (q, n, 8), weights (p, n, 8), widx (q,) -> (q, 8)."""
    return tree_sum_batched(_mul(values, weights[widx]))


def poly_divide_linear(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """q with p(X) = q(X) (X - z) + rem; same length, top coefficient 0.
    q_i = z^-(i+1) * sum_{j>i} a_j z^j; z != 0."""
    n = coeffs.shape[0]
    pw = powers(z, n)
    s = _mul(coeffs, pw)
    suffix = field_scan(s[None], "add", reverse=True)[0]
    tail = torch.cat((suffix[1:], torch.zeros_like(suffix[:1])))
    inv_pw = batch_inv(_mul(pw, z))
    return _mul(tail, inv_pw)


# ---------------------------------------------------------------------------
# lookup permutation (halo2 permuted-lookup shape; the order enters the proof)
# ---------------------------------------------------------------------------

def _key_words(vals: torch.Tensor, nw: int) -> torch.Tensor:
    """Canonical words as nonnegative int64 sort keys (n, nw), LSW first."""
    return vals[:, :nw].to(torch.int64) & 0xFFFFFFFF


def lookup_permute_device(a: torch.Tensor, s: torch.Tensor, usable: int,
                          max_bits: int | None = None):
    """a, s: (n, 8) compressed input / table columns.  Rows >= usable are
    ignored.  Returns (a_perm, s_perm, ok): a_perm sorted; s_perm equal to
    a_perm at each first occurrence, the leftover table rows in sorted order
    elsewhere.  `ok` is False iff some input value is missing from the
    table.  `max_bits` bounds every value, so fewer key words are sorted."""
    n = a.shape[0]
    dev = a.device
    mask = torch.arange(n, device=dev) < usable
    nw = 8 if max_bits is None else max(1, -(-min(max_bits, 231) // 32))
    top = 0xFFFFFFFF

    def sort_perm(vals):
        words = torch.where(mask[:, None], _key_words(vals, nw),
                            torch.full((1, nw), top, device=dev))
        perm = torch.arange(n, device=dev)
        for w in range(nw):                       # LSW-first stable passes
            order = torch.sort(words[perm, w], stable=True).indices
            perm = perm[order]
        return perm, words[perm]

    pa, ka = sort_perm(a)
    ps, ks = sort_perm(s)
    a_sorted, s_sorted = a[pa], s[ps]

    prev = torch.cat((torch.full((1, nw), top, device=dev), ka[:-1]))
    first = (ka != prev).any(dim=1) & mask

    def less_than(i_s, q):
        row = ks[i_s.clamp(0, n - 1)]
        lt = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
        decided = torch.zeros_like(lt)
        for wi in range(nw - 1, -1, -1):
            lt_w = row[:, wi] < q[:, wi]
            gt_w = row[:, wi] > q[:, wi]
            lt = torch.where(~decided & lt_w, True, lt)
            decided = decided | lt_w | gt_w
        return lt

    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = torch.full((n,), n, dtype=torch.int64, device=dev)
    for _ in range(int(math.ceil(math.log2(n + 1))) + 1):
        mid = (lo + hi) // 2
        active = lo < hi
        go_right = less_than(mid, ka) & active
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    pos = lo.clamp(max=n - 1)
    found = (ks[pos] == ka).all(dim=1) & (pos < usable)
    ok = bool((~first | found).all())

    consumed = torch.zeros(n, dtype=torch.bool, device=dev)
    consumed[pos[first]] = True
    keep = ~consumed & mask
    slots = torch.nonzero(~first & mask).flatten()
    lidx = torch.nonzero(keep).flatten()
    m = min(slots.numel(), lidx.numel())
    s_perm = torch.zeros_like(s_sorted)
    s_perm[slots[:m]] = s_sorted[lidx[:m]]
    s_perm = torch.where(first[:, None], a_sorted, s_perm)
    return a_sorted, s_perm, ok

"""The port's scans and row sums of projective points (ops/scan.py:
point_scan, point_row_sum) against the Python-int oracle and the JAX
package's ops/scan.py prefix_scan_batched over its curve.add (the XLA route,
run here on the CPU), forward and from the row's end.  The kernels run by
their plain versions here.  Results are compared as affine points, exactly
(integers, no tolerance): the packages add in different orders, so only the
group element of a prefix is common to them.

Rows hold the identity, runs of one repeated point and a point next to its
inverse, with random Z; inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import curve as jcurve
from halo2_zkcert_tpu.ops import scan as jscan
from halo2_zkcert_tpu.ops.field import Fq as JFq
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import curve, field, scan
from halo2_zkcert_tpu_torch.ops.field import FQ

torch.set_num_threads(2)

SIZES = [1, 2, 31, 255, 1000]
ROWS = 2


def _rows_of_points(n: int):
    """ROWS rows of n affine points ((0, 0) = identity) and a Z for each."""
    rng = np.random.default_rng(100 + n)
    G = rc.g1_from_affine(rc.G1_GEN)
    base = [rc.g1_to_affine(rc.g1_mul(G, int(s)))
            for s in rng.integers(1, 1 << 40, size=6)]
    base.append(rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(base[0]))))
    base.append((0, 0))
    rows = []
    for r in range(ROWS):
        pick = rng.integers(0, len(base), size=n)
        if n >= 31:
            pick[3:9] = 2                   # a run of one repeated point
            pick[10:12] = (0, 6)            # P next to -P
            pick[12] = pick[-1] = 7         # identities, one at the row's end
            pick[0] = 7 if r else pick[0]   # and one at its start
        rows.append([base[i] for i in pick])
    zs = [[int.from_bytes(rng.bytes(32), "little") % (rc.FQ - 1) + 1
           for _ in range(n)] for _ in range(ROWS)]
    return rows, zs


def _projective(rows, zs):
    """Affine rows and Z values -> rows of (X, Y, Z) ints."""
    out = []
    for row, zrow in zip(rows, zs):
        out.append([(0, z, 0) if p == (0, 0)
                    else (p[0] * z % rc.FQ, p[1] * z % rc.FQ, z)
                    for p, z in zip(row, zrow)])
    return out


def _oracle_prefix(row, reverse):
    order = row[::-1] if reverse else row
    acc, out = rc.g1_from_affine((0, 0)), []
    for p in order:
        acc = rc.g1_add(acc, rc.g1_from_affine(p))
        out.append(rc.g1_to_affine(acc))
    return out[::-1] if reverse else out


def _affine(P: torch.Tensor) -> list:
    return curve.points_from_device(curve.to_affine(P).reshape(-1, 2, 8))


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(n):
        if n not in made:
            rows, zs = _rows_of_points(n)
            proj = _projective(rows, zs)
            flat = [c for row in proj for pt in row for c in pt]
            P = field.from_ints(FQ, flat, "cpu").reshape(ROWS, n, 3, 8)
            jP = tuple(JFq.from_ints([pt[c] for row in proj for pt in row])
                       .reshape(ROWS, n, -1) for c in range(3))
            made[n] = dict(rows=rows, P=P, jP=jP)
        return made[n]

    return get


def _jax_scan(jP, reverse):
    """The JAX package's batched scan; from the row's end as its
    _combine_buckets_cols does it, by flipping around the scan."""
    if reverse:
        jP = tuple(c[:, ::-1] for c in jP)
    out = jscan.prefix_scan_batched(jcurve.add, lambda: jcurve.identity((1,)),
                                    jP)
    if reverse:
        out = tuple(c[:, ::-1] for c in out)
    limbs = np.asarray(jnp.stack(out, axis=2)).astype(np.int32)
    return field.from_resident(FQ, torch.from_numpy(limbs))   # (B, n, 3, 8)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", SIZES)
def test_point_scan_matches_oracle_and_jax(cases, n, reverse):
    c = cases(n)
    got = scan.point_scan(c["P"], reverse=reverse)
    assert got.shape == (ROWS, n, 3, 8) and got.dtype == torch.int32
    want = [p for row in c["rows"] for p in _oracle_prefix(row, reverse)]
    assert _affine(got) == want
    assert _affine(_jax_scan(c["jP"], reverse)) == want
    assert torch.equal(got, scan.point_scan_plain(c["P"], reverse))


@pytest.mark.parametrize("n", SIZES)
def test_point_row_sum_matches_oracle_and_scan(cases, n):
    c = cases(n)
    got = scan.point_row_sum(c["P"])
    assert got.shape == (ROWS, 3, 8)
    want = [_oracle_prefix(row, False)[-1] for row in c["rows"]]
    assert _affine(got) == want
    assert _affine(scan.point_scan(c["P"])[:, -1]) == want
    assert _affine(scan.point_scan(c["P"], reverse=True)[:, 0]) == want
    assert torch.equal(got, scan.point_row_sum_plain(c["P"]))


def test_scan_of_a_slice_equals_scan_of_its_copy(cases):
    """Dropping the first point by a view (as the bucket combine drops
    bucket 0) changes nothing."""
    P = cases(31)["P"]
    assert torch.equal(scan.point_scan(P[:, 1:], reverse=True),
                       scan.point_scan(P[:, 1:].contiguous(), reverse=True))


@pytest.mark.parametrize("B,n", [(1, 1), (4, 1024), (4, 1025), (4, 65535),
                                 (128, 1 << 17), (1, (1 << 20) + 1),
                                 (2, 1 << 27)])
def test_blocks_of_a_launch_are_bounded(B, n):
    """A block takes whole tiles: one while the launch has few blocks, more
    once the card is full, and a row is cut into at most MAX_BLOCKS_A_ROW
    blocks, so a scan is two launches whatever n is and a block adds up at
    most that many totals."""
    span = scan._span(B, n)
    assert span % scan.TILE == 0 and span >= scan.TILE
    blocks = -(-n // span)
    assert 1 <= blocks <= scan.MAX_BLOCKS_A_ROW
    assert (blocks - 1) * span < n
    tiles = -(-n // scan.TILE)
    if B * tiles <= scan.BLOCKS_WANTED:
        assert span == scan.TILE
    else:
        assert B * blocks <= 2 * scan.BLOCKS_WANTED


def test_rows_check_rejects_wrong_shape_and_device():
    """The wrappers' own check, before anything is launched: points are
    (B, n, 3, 8), and a tensor that reaches it lies on the card."""
    with pytest.raises(ValueError):
        scan._rows("point_scan", torch.zeros((2, 3, 2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        scan._rows("point_scan", torch.zeros((2, 3, 3, 8), dtype=torch.int32))


def _affine_rows(rows):
    """Rows of affine ints -> (ROWS, n, 2, 8) words, and the JAX package's
    projective tuple of the same points (its from_affine: (0, 0) is the
    identity)."""
    n = len(rows[0])
    xy = curve.points_to_device([p for row in rows for p in row],
                                "cpu").reshape(ROWS, n, 2, 8)
    flat = [c for row in rows for p in row for c in p]
    jxy = JFq.from_ints(flat).reshape(ROWS, n, 2, -1)
    return xy, jcurve.from_affine(jxy)


def _jax_madd_first(p, c):
    """Level 1 of the JAX package's local scan in its MSM (msm_fb.py:182):
    a mixed addition of the later operand, an input point; the identity,
    which the mixed addition must not be given, leaves p as it is."""
    inf = jcurve.is_identity(c)[..., None]
    s = jcurve.add_mixed(p, (c[0], c[1]))
    return tuple(jnp.where(inf, a, b) for a, b in zip(p, s))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", SIZES)
def test_point_scan_affine_matches_oracle_and_jax(cases, n, reverse):
    """The scan of affine points with (0, 0) among them: its plain version
    against the oracle's prefixes, and the JAX package's
    prefix_scan_batched_local with the mixed addition at level 1, as
    affine points; equal as group elements to the projective scan of the
    same points."""
    c = cases(n)
    xy, jxs = _affine_rows(c["rows"])
    got = scan.point_scan_affine(xy, reverse=reverse)
    assert got.shape == (ROWS, n, 3, 8) and got.dtype == torch.int32
    want = [p for row in c["rows"] for p in _oracle_prefix(row, reverse)]
    assert _affine(got) == want
    if reverse:
        jxs = tuple(a[:, ::-1] for a in jxs)
    local, off, C = jscan.prefix_scan_batched_local(
        jcurve.add, lambda: jcurve.identity((1,)), jxs,
        combine_first=_jax_madd_first)
    assert C == n and not np.asarray(off[2]).any()      # one identity offset
    if reverse:
        local = tuple(a[:, ::-1] for a in local)
    limbs = np.asarray(jnp.stack(local, axis=2)).astype(np.int32)
    assert _affine(field.from_resident(FQ, torch.from_numpy(limbs))) == want
    assert torch.equal(got, scan.point_scan_affine_plain(xy, reverse))
    assert _affine(scan.point_scan(curve.from_affine(xy), reverse)) == want


def test_local_scan_is_the_affine_scan(cases):
    """prefix_scan_batched_local: the affine scan over the whole width, one
    identity offset a row."""
    xy, _ = _affine_rows(cases(31)["rows"])
    local, off, C = scan.prefix_scan_batched_local(xy)
    assert C == 31 and torch.equal(local, scan.point_scan_affine(xy))
    assert torch.equal(off, curve.identity((ROWS, 1)))


def test_affine_rows_check_rejects_projective_points():
    with pytest.raises(ValueError):
        scan._rows("point_scan_affine",
                   torch.zeros((2, 3, 3, 8), dtype=torch.int32), 2)

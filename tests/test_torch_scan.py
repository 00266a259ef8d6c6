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

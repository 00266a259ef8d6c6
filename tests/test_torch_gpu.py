"""Kernels K1-K6, the blocked scans of points and of field elements, the
transform passes and the chains of the group law on the card against their
plain versions, at small, ragged and main-path shapes.

Marked `gpu`: each test decides inside itself whether a CUDA device exists
and skips without one.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import (curve, field, frops, kernels, msm_fb,
                                        ntt, scan)
from halo2_zkcert_tpu_torch.ops.field import FQ, FR
from halo2_zkcert_tpu_torch.plonk import quotient
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

pytestmark = pytest.mark.gpu


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(F, seed, count, device):
    rng = np.random.default_rng(seed)
    vals = [0, 1, F.modulus - 1] + [
        int.from_bytes(rng.bytes(32), "little") % F.modulus
        for _ in range(count - 3)]
    return field.from_ints(F, vals, device)


@pytest.mark.parametrize("fname", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub", "mulm"])
def test_field_binop_kernel(fname, op):
    dev = _device()
    F = FR if fname == "Fr" else FQ
    a, b = _rand(F, 1, 1000, dev), _rand(F, 2, 1000, dev).flip(0)
    before = kernels.launches[f"field_binop.{op}"]
    got = field.binop(F, op, a, b)
    assert kernels.launches[f"field_binop.{op}"] == before + 1
    assert torch.equal(got, field.binop_plain(F, op, a, b))
    row = b[:7].contiguous()                       # a periodic operand
    got = field.binop(F, op, a[:7 * 100].reshape(100, 7, 8), row)
    want = field.binop_plain(F, op, a[:700].reshape(100, 7, 8), row)
    assert torch.equal(got, want)


def test_point_kernels():
    dev = _device()
    G = rc.g1_from_affine(rc.G1_GEN)
    pts = [rc.g1_to_affine(rc.g1_mul(G, s)) for s in range(1, 65)]
    P = curve.from_affine(curve.points_to_device(pts, dev))
    Q = P.roll(1, 0).contiguous()
    Q[:2] = P[:2]
    assert torch.equal(curve.add(P, Q), curve.add_plain(P, Q))
    assert torch.equal(curve.double(P), curve.double_plain(P))


def _multiples(count, dev):
    G = rc.g1_from_affine(rc.G1_GEN)
    return curve.points_to_device(
        [rc.g1_to_affine(rc.g1_mul(G, s)) for s in range(1, count + 1)], dev)


def test_point_add_mixed_kernel():
    """K5 against its plain version: P = identity, P = Q, P = -Q, random."""
    dev = _device()
    Q = _multiples(64, dev)
    P = curve.from_affine(Q.roll(1, 0)).contiguous()
    P[0] = curve.identity((), dev)
    P[1:3] = curve.from_affine(Q[1:3])
    P[3:5] = curve.neg(curve.from_affine(Q[3:5]))
    before = kernels.launches["point_add_mixed"]
    got = curve.add_mixed(P, Q)
    assert kernels.launches["point_add_mixed"] == before + 1
    assert torch.equal(got, curve.add_mixed_plain(P, Q))
    assert torch.equal(got, curve.add_plain(P, curve.from_affine(Q)))


@pytest.mark.parametrize("digits", [False, True], ids=["dense", "digits"])
@pytest.mark.parametrize("R,C", [(5, 64), (300, 7), (2, 1), (129, 2),
                                 (16400, 8)])
def test_scan_madd_kernel(R, C, digits):
    """K6 against its plain version, C a launch argument; one row repeats a
    point, so the scan doubles inside.  With the rows' sorted digits only
    the slots of `scan_madd_defined` are compared."""
    dev = _device()
    base = _multiples(97, dev)
    rng = np.random.default_rng(R)
    idx = torch.from_numpy(rng.integers(0, 97, size=(R, C))).to(dev)
    idx[0] = 3
    xy = base[idx]
    dsort = None
    if digits:
        dsort = torch.from_numpy(np.sort(rng.integers(
            0, max(2, R * C // 3), size=R * C)).astype(np.int32)
            .reshape(R, C)).to(dev)
    before = kernels.launches["scan_madd"]
    got = msm_fb.scan_madd(xy, dsort)
    assert kernels.launches["scan_madd"] == before + 1
    want = msm_fb.scan_madd_plain(xy)
    if digits:
        mask = msm_fb.scan_madd_defined(dsort)
        got, want = got[mask], want[mask]
    assert torch.equal(got, want)


def _projective_rows(seed, B, n, dev):
    """(B, n, 3, 8): multiples of G with random Z, a third identities, a run
    of one repeated point and a point next to its inverse."""
    rng = np.random.default_rng(seed)
    P = curve.from_affine(_multiples(33, dev))
    P = torch.cat((P, curve.neg(P[:1]), curve.identity((16,), dev)))
    pick = rng.integers(0, P.shape[0], size=(B, n))
    if n >= 31:
        pick[:, 2:8] = 1
        pick[:, 9:11] = (0, 33)
    z = _rand(FQ, seed + 1, 64, dev)[3:]               # nonzero
    zi = torch.from_numpy(rng.integers(0, z.shape[0], size=(B, n))).to(dev)
    P = P[torch.from_numpy(pick).to(dev)]
    return field.binop_plain(FQ, "mul", P, z[zi][:, :, None, :]).contiguous()


SCAN_SHAPES = [(3, 1), (2, 2), (2, 255), (5, 1000), (2, 1024), (2, 1025),
               (3, 5001), (4, 65535), (1, (1 << 17) + 3)]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("B,n", SCAN_SHAPES)
def test_point_scan_kernel(B, n, reverse):
    """The blocked scan against its plain version as affine points; one
    launch for a row of one tile, two for any longer one."""
    dev = _device()
    P = _projective_rows(n, B, n, dev)
    before = kernels.launches["point_scan"]
    got = scan.point_scan(P, reverse=reverse)
    assert kernels.launches["point_scan"] - before == (1 if n <= scan.TILE
                                                       else 2)
    want = scan.point_scan_plain(P, reverse)
    assert torch.equal(curve.to_affine(got), curve.to_affine(want))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("limit,blocks", [("MAX_BLOCKS_A_ROW", 2),
                                          ("BLOCKS_WANTED", 4)])
def test_point_scan_kernel_spans_of_several_tiles(monkeypatch, limit, blocks,
                                                  reverse):
    """Rows whose blocks walk several tiles and carry their running sum
    (forced by lowering either limit on the number of blocks: two blocks of
    three and two tiles, or three of two, two and one), read in place from
    a slice that drops the first point."""
    dev = _device()
    monkeypatch.setattr(scan, limit, blocks)
    P = _projective_rows(9, 2, 5002, dev)[:, 1:]
    assert scan._span(2, 5001) == (3 if blocks == 2 else 2) * scan.TILE
    assert not P.is_contiguous()
    got = scan.point_scan(P, reverse=reverse)
    want = scan.point_scan_plain(P.contiguous(), reverse)
    assert torch.equal(curve.to_affine(got), curve.to_affine(want))
    assert torch.equal(curve.to_affine(scan.point_row_sum(P)),
                       curve.to_affine(scan.point_row_sum_plain(P)))


@pytest.mark.parametrize("B,n", SCAN_SHAPES)
def test_point_row_sum_kernel(B, n):
    dev = _device()
    P = _projective_rows(n + 1, B, n, dev)
    before = kernels.launches["point_row_sum"]
    got = scan.point_row_sum(P)
    assert kernels.launches["point_row_sum"] - before == (1 if n <= scan.TILE
                                                          else 2)
    assert torch.equal(curve.to_affine(got),
                       curve.to_affine(scan.point_row_sum_plain(P)))


def test_fixed_base_msm_on_card():
    """Both scan branches of the fixed-base MSM on the card (whole
    SCAN_ROW_MAX rows through K6, a ragged width through the scan of affine
    points, two launches) against the variable-base MSM of the same points
    and scalars."""
    dev = _device()
    from halo2_zkcert_tpu_torch.ops import msm
    for n in (64, 37):
        base = _multiples(n, dev)
        cols = torch.stack([_rand(FR, 10 + j, n, dev) for j in range(3)])
        fb = msm_fb.FixedBaseMsm(base, wbits=8)
        kernels.reset_launches()
        got = curve.to_affine(fb.msm_many(cols))
        if n == 64:
            assert kernels.launches["scan_madd"] > 0
        else:
            assert kernels.launches["point_scan_affine"] == 2
            assert kernels.launches["point_add_mixed"] == 0
        assert torch.equal(got, curve.to_affine(msm.msm_many(base, cols)))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("B,n", SCAN_SHAPES + [(2, 80016)])
def test_point_scan_affine_kernel(B, n, reverse):
    """The blocked scan of affine points, (0, 0) among them, against its
    plain version as affine points; one launch for a row of one tile, two
    for any longer one."""
    dev = _device()
    rng = np.random.default_rng(n + 7)
    base = torch.cat((_multiples(40, dev), torch.zeros((8, 2, 8),
                      dtype=torch.int32, device=dev)))
    pick = rng.integers(0, base.shape[0], size=(B, n))
    if n >= 31:
        pick[:, 2:8] = 3
    xy = base[torch.from_numpy(pick).to(dev)]
    before = kernels.launches["point_scan_affine"]
    got = scan.point_scan_affine(xy, reverse=reverse)
    assert kernels.launches["point_scan_affine"] - before == (
        1 if n <= scan.TILE else 2)
    want = scan.point_scan_affine_plain(xy, reverse)
    assert torch.equal(curve.to_affine(got), curve.to_affine(want))


def test_point_scan_affine_kernel_reads_a_slice_in_place(monkeypatch):
    """Rows whose blocks walk several tiles, read in place from a slice."""
    dev = _device()
    monkeypatch.setattr(scan, "MAX_BLOCKS_A_ROW", 2)
    xy = _multiples(64, dev)[torch.from_numpy(np.random.default_rng(3)
                                              .integers(0, 64, size=(2, 5002)))
                             .to(dev)][:, 1:]
    assert not xy.is_contiguous()
    got = scan.point_scan_affine(xy)
    want = scan.point_scan_affine_plain(xy.contiguous())
    assert torch.equal(curve.to_affine(got), curve.to_affine(want))


@pytest.mark.parametrize("n,c,nwin", [(1, 16, 16), (129, 3, 5), (1000, 8, 2),
                                      (1 << 12, 16, 16)])
def test_point_windows_kernel(n, c, nwin):
    """The doubling chains of the window tables: word for word the plain
    loop over double_plain, one launch."""
    dev = _device()
    P = _projective_rows(n, 1, n, dev)[0]
    before = kernels.launches["point_windows"]
    got = curve.windows(P, c, nwin)
    assert kernels.launches["point_windows"] == before + 1
    assert torch.equal(got, curve.windows_plain(P, c, nwin))


@pytest.mark.parametrize("m,c,nwin", [(1, 8, 32), (4, 8, 32), (33, 2, 5)])
def test_point_horner_kernel(m, c, nwin):
    """The Horner chain: word for word its plain version, one launch."""
    dev = _device()
    W = _projective_rows(m + 50, m, nwin, dev)
    before = kernels.launches["point_horner"]
    got = curve.horner(W, c)
    assert kernels.launches["point_horner"] == before + 1
    assert torch.equal(got, curve.horner_plain(W, c))


def test_point_fixed_mul_kernel():
    """s * G from the window table of G: word for word the plain digit loop
    (zero bytes, 0, 1 and r - 1 among the scalars), one launch, and the
    oracle's points."""
    dev = _device()
    from halo2_zkcert_tpu_torch.plonk import kzg
    table = kzg.g1_window_table(dev)
    s = _rand(FR, 77, 1000, dev)
    s[3] = field.from_ints(FR, [0x0100FF00000000FF], dev)[0]
    before = kernels.launches["point_fixed_mul"]
    got = curve.fixed_mul(s, table)
    assert kernels.launches["point_fixed_mul"] == before + 1
    assert torch.equal(got, curve.fixed_mul_plain(s, table))
    G = rc.g1_from_affine(rc.G1_GEN)
    vals = field.to_ints(s[:8])
    assert curve.points_from_device(curve.to_affine(got[:8])) == [
        rc.g1_to_affine(rc.g1_mul(G, v)) for v in vals]


def test_setup_on_card_equals_setup_on_cpu():
    """The SRS built on the card (fixed-base multiplication) equals the one
    built by the plain versions, and takes no doubling or addition
    launch."""
    dev = _device()
    from halo2_zkcert_tpu_torch.plonk import kzg
    kernels.reset_launches()
    got = kzg.setup(8, device=dev)
    assert kernels.launches["point_fixed_mul"] == 1
    assert kernels.launches["point_double"] == 0
    assert kernels.launches["point_add"] == 0
    want = kzg.setup(8, device="cpu")
    assert torch.equal(got.g.cpu(), want.g)
    assert torch.equal(got.g_lagrange.cpu(), want.g_lagrange)


@pytest.mark.parametrize("k", [0, 1, 3, 8, 10, 11, 13, 17])
def test_ntt_kernel(k):
    """Every transform against its plain version, three columns at once: one
    launch up to 2^LOG_TILE, two above; the zero padding, and Montgomery
    form out of the coset transform and into its inverse."""
    dev = _device()
    n, g = 1 << k, rc.FR_GENERATOR
    a = _rand(FR, k, 3 * n, dev).reshape(3, n, 8)
    before = kernels.launches["ntt"]
    got = ntt.ntt(a, k)
    assert kernels.launches["ntt"] - before == len(ntt.passes(k)) == (
        1 if k <= ntt.LOG_TILE else 2)
    assert torch.equal(got, ntt.ntt_plain(a, k))
    assert torch.equal(ntt.intt(a, k), ntt.intt_plain(a, k))
    short = a[:, :max(1, n // 4 + 1)]
    ext = ntt.coset_ntt(short, k, g)
    assert torch.equal(ext, ntt.coset_ntt_plain(short, k, g))
    ext_m = ntt.coset_ntt(short, k, g, out_mont=True)
    assert torch.equal(ext_m, field.to_mont(FR, ext))
    assert torch.equal(ntt.coset_intt(ext, k, g),
                       ntt.coset_intt_plain(ext, k, g))
    back = ntt.coset_intt(ext_m, k, g, in_mont=True)
    assert torch.equal(back[:, :short.shape[1]], short)
    assert not back[:, short.shape[1]:].any()


FIELD_SCAN_SHAPES = [(3, 1), (2, 5), (2, 33), (2, 1024), (2, 1025),
                     (3, 5001), (3, 1 << 17), (1, 3 << 17)]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("fname", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "affine"])
@pytest.mark.parametrize("B,n", FIELD_SCAN_SHAPES)
def test_field_scan_kernel(B, n, op, fname, reverse):
    """The blocked field scan against its plain version, exactly; one launch
    for a row of one tile, two for any longer one."""
    dev = _device()
    F = FR if fname == "Fr" else FQ
    a = _rand(F, n, B * n, dev).reshape(B, n, 8)
    b = _rand(F, n + 1, B * n, dev).reshape(B, n, 8) if op == "affine" \
        else None
    if op != "add":
        a[0, 0] = a[0, -1]          # no zero: the products stay telling
    before = kernels.launches["field_scan"]
    got = frops.field_scan(a, op, reverse, b, F)
    assert kernels.launches["field_scan"] - before == (
        1 if n <= frops.TILE else 2)
    assert torch.equal(got, frops.field_scan_plain(a, op, reverse, b, F))


@pytest.mark.parametrize("limit,blocks", [("MAX_BLOCKS_A_ROW", 2),
                                          ("BLOCKS_WANTED", 4)])
@pytest.mark.parametrize("op", ["mul", "affine"])
def test_field_scan_kernel_spans_of_several_tiles(monkeypatch, limit, blocks,
                                                  op):
    """Rows whose blocks walk several tiles and carry what came before."""
    dev = _device()
    monkeypatch.setattr(frops, limit, blocks)
    a = _rand(FR, 9, 2 * 5001, dev)[3:].reshape(1, -1, 8)[:, :9998] \
        .reshape(2, 4999, 8)
    b = a.flip(1).contiguous() if op == "affine" else None
    assert frops._span(2, 4999) == (3 if blocks == 2 else 2) * frops.TILE
    for reverse in (False, True):
        assert torch.equal(frops.field_scan(a, op, reverse, b),
                           frops.field_scan_plain(a, op, reverse, b))
    assert torch.equal(frops.field_row_sum(a),
                       frops.tree_sum_batched_plain(a))


@pytest.mark.parametrize("B,n", FIELD_SCAN_SHAPES + [(16, 1 << 17)])
def test_field_row_sum_kernel(B, n):
    dev = _device()
    a = _rand(FR, n + 2, B * n, dev).reshape(B, n, 8)
    before = kernels.launches["field_row_sum"]
    got = frops.field_row_sum(a)
    assert kernels.launches["field_row_sum"] - before == (
        1 if n <= frops.TILE else 2)
    assert torch.equal(got, frops.tree_sum_batched_plain(a))


def test_batch_inv_and_powers_on_card():
    """What the prover builds on the scans: inverses in both fields and a
    power table, against the integers."""
    dev = _device()
    for F in (FR, FQ):
        a = _rand(F, 5, 3000, dev)[3:]
        inv = frops.batch_inv(a, F)
        assert torch.equal(field.mul(F, a, inv),
                           field.one(dev, (a.shape[0],)))
    x = _rand(FR, 6, 4, dev)[3]
    assert field.to_ints(frops.powers(x, 2000)) == [
        pow(field.to_int(x), i, rc.FR) for i in range(2000)]


def test_quotient_kernel():
    dev = _device()
    from halo2_zkcert_tpu_torch.plonk import ADVICE, Column, ConstraintSystem
    cs = ConstraintSystem()
    q, tbl = cs.fixed_column(), cs.fixed_column()
    a, b = cs.advice_column(), cs.advice_column()
    cs.create_gate("mul", q * (a * b - a))
    cs.add_lookup("t", [(a, tbl)])
    cs.enable_permutation(Column(ADVICE, 0))
    cs.enable_permutation(Column(ADVICE, 1))
    tape = quotient.compile_tape(cs, 16, 64)
    L = len(quotient.leaf_layout(cs))
    leaves = _rand(FR, 3, L * 64, dev).reshape(L, 64, 8)
    consts = tape.const_table(_rand(FR, 4, tape.num_challenges, dev))
    before = kernels.launches["quotient_forest"]
    got = quotient.quotient_forest(leaves, consts, tape)
    assert kernels.launches["quotient_forest"] == before + 1
    assert torch.equal(got, quotient.quotient_forest_plain(leaves, consts,
                                                           tape))
    # every instantiated slot count runs the same tape
    for slots in quotient.SLOT_SIZES:
        if slots >= tape.num_slots:
            wide = quotient.Tape(tape.ins, tape.out_slot, tape.consts, slots,
                                 tape.num_challenges)
            assert torch.equal(quotient.quotient_forest(leaves, consts, wide),
                               got)

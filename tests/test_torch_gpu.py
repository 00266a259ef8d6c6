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


def test_quotient_kernel_sha256_tape():
    """The SHA-256 forest's tape (leaves rematerialized, 80 slots) runs on
    the kernel's 96-slot instantiation and equals its plain version."""
    dev = _device()
    from halo2_zkcert_tpu_torch.circuits.sha256 import build_cs
    cs, _ = build_cs()
    tape = quotient.compile_tape(cs, 16, 64)
    assert quotient.SLOT_SIZES[-2] < tape.num_slots <= quotient.SLOT_SIZES[-1]
    L = len(quotient.leaf_layout(cs))
    leaves = _rand(FR, 7, L * 64, dev).reshape(L, 64, 8)
    consts = tape.const_table(_rand(FR, 8, tape.num_challenges, dev))
    before = kernels.launches["quotient_forest"]
    got = quotient.quotient_forest(leaves, consts, tape)
    assert kernels.launches["quotient_forest"] == before + 1
    assert torch.equal(got, quotient.quotient_forest_plain(leaves, consts,
                                                           tape))


def test_quotient_kernel_stride1_tape():
    """The RSA key's forest on the stride-1 tape (rotations one row: the
    coset-separated quotient's launch) over one coset's 2^17 rows equals
    its plain version."""
    import json
    import os
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "build", "rsa_1.pk.vk")) as f:
        vk = vk_from_dict(json.load(f))
    n = vk.n
    tape = quotient.compile_tape(vk.cs, n, n)
    L = len(quotient.leaf_layout(vk.cs))
    leaves = _rand(FR, 11, L * n, dev).reshape(L, n, 8)
    consts = tape.const_table(_rand(FR, 12, tape.num_challenges, dev))
    before = kernels.launches["quotient_forest"]
    got = quotient.quotient_forest(leaves, consts, tape)
    assert kernels.launches["quotient_forest"] == before + 1
    assert torch.equal(got, quotient.quotient_forest_plain(leaves, consts,
                                                           tape))


@pytest.mark.parametrize("tables_in_files", [True, False])
def test_forced_big_domain_toy_proof_on_the_card(monkeypatch, tmp_path,
                                                 tables_in_files):
    """The toy proof (k=6) on the card forced onto the big-domain path
    (coset quotient and residency), commitments on the fixed base, equals the JAX
    package's bytes (tests/data/toy_reference.npz) and verifies; K4 runs
    once a coset; the key's columns are back on the card, and the window
    tables wait in their files or on the host."""
    import json
    import os
    from halo2_zkcert_tpu_torch.plonk import (create_proof, from_reference_pk,
                                              setup, verify_proof)
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    z = np.load(os.path.join(root, "tests", "data", "toy_reference.npz"))
    pk = from_reference_pk(
        {k: z[k] for k in ("fixed_lagrange", "fixed_coeff", "sigma_lagrange",
                           "sigma_coeff")},
        json.loads(z["vk_json"].tobytes()), dev)
    instances = json.loads(z["instances_json"].tobytes())
    advice = field.from_resident(FR, torch.from_numpy(z["advice"]).to(dev))
    for name, v in (("H2T_EXT_BUDGET_BYTES", "1"), ("H2T_U8_MIN_N", "1"),
                    ("H2T_FB_MSM", "1"),
                    ("PARAMS_DIR", str(tmp_path if tables_in_files
                                       else tmp_path / "absent"))):
        monkeypatch.setenv(name, v)
    params = setup(pk.vk.k, device=dev)
    kernels.reset_launches()
    proof = create_proof(params, pk, advice, instances, PoseidonTranscript())
    stride = pk.domain().extended_n // pk.vk.n
    assert kernels.launches["quotient_forest"] == stride
    assert proof == z["proof_poseidon"].tobytes()
    assert verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    assert pk.fixed_lagrange.device == dev and pk.device == dev
    parked = params.__dict__["_parked_fb_monomial"]
    assert (parked.table_flat is None) == tables_in_files
    table = params.fixed_base(lagrange=False).table_flat
    assert table.device == dev and "_parked_fb_monomial" not in params.__dict__


@pytest.mark.parametrize("fb", ["0", "1"])
def test_keygen_on_the_card(fb, monkeypatch):
    """keygen of the SHA-256 circuit at a short message (k=9) on the card,
    through either MSM, equals the JAX key of tests/data/sha256_reference.npz:
    columns, commitments and the vk's transcript hash."""
    import json
    import os
    from halo2_zkcert_tpu_torch.circuits.sha256 import Sha256Circuit
    from halo2_zkcert_tpu_torch.plonk import from_reference_pk, keygen, setup
    from halo2_zkcert_tpu_torch.sdk import PK_ARRAYS
    dev = _device()
    monkeypatch.setenv("H2T_FB_MSM", fb)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PARAMS_DIR", os.path.join(root, "no-such-dir"))
    z = np.load(os.path.join(root, "tests", "data", "sha256_reference.npz"))
    circuit = Sha256Circuit.build(101)
    ref = from_reference_pk({k: z[k] for k in PK_ARRAYS},
                            json.loads(z["vk_json"].tobytes()), dev)
    kernels.reset_launches()
    pk = keygen(setup(circuit.data.k, device=dev), circuit.data)
    assert kernels.launches["field_binop.mul"] and kernels.launches["ntt"]
    for name in PK_ARRAYS:
        assert torch.equal(getattr(pk, name), getattr(ref, name)), name
    assert pk.vk.fixed_commitments == ref.vk.fixed_commitments
    assert pk.vk.permutation_commitments == ref.vk.permutation_commitments
    assert pk.vk.transcript_repr() == ref.vk.transcript_repr()


def _gate_level_proof(dev, data, advice, instances, fixture):
    """keygen and a proof on the card, held to a fixture of the JAX
    package (vk commitments, instances, proof bytes)."""
    import json
    import os
    from halo2_zkcert_tpu_torch.plonk import (create_proof, keygen, setup,
                                              verify_proof)
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    z = np.load(os.path.join(root, "tests", "data", fixture))
    ref_vk = json.loads(z["vk_json"].tobytes())
    assert instances == json.loads(z["instances_json"].tobytes())
    params = setup(data.k, device=dev)
    pk = keygen(params, data)
    assert vk_to_dict(pk.vk) == ref_vk
    kernels.reset_launches()
    proof = create_proof(params, pk, advice, instances, PoseidonTranscript())
    assert kernels.launches["quotient_forest"] == 1
    assert proof == z["proof_poseidon"].tobytes()
    assert verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
    return z


def test_builder_sample_on_the_card(monkeypatch):
    """The builder's sample at k=8 on the card: its key and proof equal
    tests/data/builder_reference.npz, and MockProver on CUDA tensors runs
    its gates on K1 and gives the JAX package's verdicts."""
    import json
    import os
    from halo2_zkcert_tpu_torch.builder import GateBuilder
    from halo2_zkcert_tpu_torch.plonk import run_mock
    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, "tests", "data"))
    from make_builder_reference import CORRUPT, K, build_sample
    data, advice, instances = build_sample(GateBuilder).finalize(K,
                                                                 device=dev)
    assert advice.is_cuda
    z = _gate_level_proof(dev, data, advice, instances,
                          "builder_reference.npz")
    kernels.reset_launches()
    assert run_mock(data, advice, instances) == []
    assert kernels.launches["field_binop.mul"]
    bad = advice.clone()
    bad[CORRUPT[0], CORRUPT[1], 0] += 1
    assert run_mock(data, bad, instances, raise_on_failure=False) == \
        json.loads(z["mock_corrupted_json"].tobytes())


def test_sha256_gate_short_on_the_card(monkeypatch):
    """The gate-level SHA-256 of b"abc" at k=15 on the card: key and proof
    equal tests/data/sha256_gate_reference.npz; MockProver satisfied."""
    import os
    from halo2_zkcert_tpu_torch.circuits.sha256_gate import Sha256GateCircuit
    from halo2_zkcert_tpu_torch.plonk import run_mock
    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, "tests", "data"))
    from make_sha256_gate_reference import K, MSG
    circ = Sha256GateCircuit(MSG, k=K, device=dev)
    assert run_mock(circ.data, circ.advice, circ.instances) == []
    _gate_level_proof(dev, circ.data, circ.advice, circ.instances,
                      "sha256_gate_reference.npz")


def _agg_on_the_card(monkeypatch, inner: str, universal: bool):
    """The k=19 aggregation circuit over a toy snark of
    tests/data/aggregation_reference.npz, its key made on the card."""
    import json
    import os
    from halo2_zkcert_tpu_torch import sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import (
        AggregationCircuit, InnerSnark)
    from halo2_zkcert_tpu_torch.plonk import setup
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, "tests", "data"))
    monkeypatch.setenv("PARAMS_DIR", os.path.join(root, "no-such-dir"))
    import make_aggregation_reference as ref
    with np.load(ref.OUT) as z:
        snark = InnerSnark(
            vk=vk_from_dict(json.loads(z[f"{inner}_vk_json"].tobytes())),
            instances=json.loads(z[f"{inner}_instances_json"].tobytes()),
            proof=z[f"{inner}_proof"].tobytes())
    circ = AggregationCircuit([snark], k=ref.K_AGG, lanes=ref.LANES_AGG,
                              na=ref.NA_AGG, nl=1, universal=universal)
    params = setup(ref.K_AGG, device=dev)
    return dev, snark, circ, params, sdk.gen_pk(params, circ.data)


def test_aggregation_on_the_card(monkeypatch):
    """Fixed-vk aggregation of the toy snark at k=19 on the card: keygen,
    MockProver satisfied, `sdk.gen_snark`, `verify_aggregated` true, and
    false for a proof with one byte flipped."""
    from halo2_zkcert_tpu_torch import sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import verify_aggregated
    from halo2_zkcert_tpu_torch.plonk import run_mock
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    dev, _, circ, params, pk = _agg_on_the_card(monkeypatch, "toy", False)
    fn, inst = circ.witness(dev)
    kernels.reset_launches()
    assert run_mock(circ.data, fn, inst) == []
    assert kernels.launches["field_binop.mul"]
    kernels.reset_launches()
    snark = sdk.gen_snark(params, pk, fn, inst)
    assert kernels.launches["quotient_forest"] == 1
    assert verify_aggregated(params, pk.vk, inst, snark.proof,
                             PoseidonTranscript)
    bad = bytearray(snark.proof)
    bad[len(bad) // 2] ^= 1
    try:
        ok = verify_aggregated(params, pk.vk, inst, bytes(bad),
                               PoseidonTranscript)
    except ValueError:
        ok = False
    assert not ok


def test_universal_aggregation_on_the_card(monkeypatch):
    """Universal mode: one key (made from the c = 5 snark's circuit) proves
    the aggregation of the c = 7 snark too; `verify_aggregated` holds each
    proof to its own inner vk and refuses the other's."""
    from halo2_zkcert_tpu_torch import sdk
    from halo2_zkcert_tpu_torch.circuits.aggregation import verify_aggregated
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    dev, s5, c5, params, pk = _agg_on_the_card(monkeypatch, "c5", True)
    _, s7, c7, _, _ = _agg_on_the_card(monkeypatch, "c7", True)
    assert c7.data.cache_digest_bytes() == c5.data.cache_digest_bytes()
    for circ, own, other in ((c5, s5, s7), (c7, s7, s5)):
        fn, inst = circ.witness(dev)
        snark = sdk.gen_snark(params, pk, fn, inst)
        assert verify_aggregated(params, pk.vk, inst, snark.proof,
                                 PoseidonTranscript, inner_vks=[own.vk])
        assert not verify_aggregated(params, pk.vk, inst, snark.proof,
                                     PoseidonTranscript, inner_vks=[other.vk])


@pytest.mark.parametrize("good", [True, False], ids=["good", "bad"])
def test_evm_accumulator_toy_on_the_card(monkeypatch, good):
    """The accumulator toy (tests/data/make_evm_reference.py) keyed and
    proved on the card with `sdk.gen_evm_proof`: `verify_proof` accepts the
    proof of either pair; the EVM and `execute_ir` accept the good pair
    (P, tau P) and reject the bad one (P, (tau + 1) P)."""
    import os
    from halo2_zkcert_tpu_torch import evm, sdk
    from halo2_zkcert_tpu_torch.plonk import keygen, setup, verify_proof
    from halo2_zkcert_tpu_torch.transcript import KeccakTranscript
    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, "tests", "data"))
    import make_evm_reference as ref
    data, advice, instances = ref.acc_toy(ref.acc_pair(good), dev)
    params = setup(data.k, device=dev)
    pk = keygen(params, data)
    kernels.reset_launches()
    proof = sdk.gen_evm_proof(params, pk, advice, instances)
    assert kernels.launches["quotient_forest"] == 1
    assert verify_proof(params, pk.vk, instances, proof, KeccakTranscript)
    assert sdk.evm_verify(params, pk.vk, instances, proof) == good
    ops, _ = evm.build_verifier_ir(pk.vk, [8])
    assert evm.execute_ir(ops, instances, proof, params) == good


def _canonical_words(seed, count, device):
    """`count` random canonical Fr elements made on the card (each below
    2^253 < p), for inputs too large for Python ints."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-2 ** 31, 2 ** 31, (count, 8), generator=g,
                      device=device, dtype=torch.int64)
    w[:, 7] &= 0x1FFFFFFF
    return w.to(torch.int32)


@pytest.mark.parametrize("r_log,G,C,cout", [
    (1, 2, 1, 1), (3, 5, 3, 3), (5, 2, 70, 140), (6, 3, 129, 387),
    (7, 2, 64, 64), (6, 64, 64, 4096),
    # the main path's launches (chip_smoke.py phase 13, PERF.md rows 9-9e)
    (5, 8, 4096, 4096), (6, 256, 64, 2048), (6, 16384, 1, 2048),
    (6, 8, 8192, 8192), (6, 512, 128, 8192), (7, 32768, 1, 4096),
    # every radix over three column tiles
    (1, 3, 128, 384), (2, 3, 128, 384), (3, 3, 128, 384), (4, 3, 128, 384),
    (5, 3, 128, 384), (6, 3, 128, 384), (7, 3, 128, 384)])
def test_dft_s8_kernel(r_log, G, C, cout):
    """csrc/ntt_mxu.cu against its plain version word for word: small radices,
    a ragged column count (not whole 128-column tiles), input and output
    column strides that differ, the largest radix, the main path's six
    launch shapes at their full column counts, and every radix; one launch
    each, by TMA where every box lies inside its tensor, else cp.async."""
    from halo2_zkcert_tpu_torch.ops import ntt_mxu
    dev = _device()
    r = 1 << r_log
    count = G * r * C
    x = (_rand(FR, r_log * 7 + C, count, dev) if count <= 262144
         else _canonical_words(r_log * 7 + C, count, dev))
    tma = r >= 4 and (G * C) % 128 == 0 and (C % 128 == 0 or 128 % C == 0)
    assert ntt_mxu.dft_s8_plan(G * C, r_log, C)["loader"] == (
        ("tma.j" if C == 1 else "tma.columns") if tma else "cp.async")
    consts = ntt_mxu._consts(r_log, rc.fr_root_of_unity(r_log), 5, 3, FR.r,
                             dev)
    before = kernels.launches["ntt_mxu"]
    got = ntt_mxu.dft_s8(x, r_log, consts, C, cout)
    assert kernels.launches["ntt_mxu"] == before + 1
    assert torch.equal(got, ntt_mxu.dft_s8_plain(x, r_log, consts, C, cout))


@pytest.mark.parametrize("k", [1, 7, 10, 13, 17])
def test_ntt_mxu_on_the_card(k):
    """The four-step on the card equals the radix-2 kernel's transforms,
    every flavour, three columns, a short input."""
    from halo2_zkcert_tpu_torch.ops import ntt_mxu
    dev = _device()
    n, g = 1 << k, rc.FR_GENERATOR
    a = _rand(FR, 50 + k, 3 * n, dev).reshape(3, n, 8)
    short = a[:, :max(1, n // 4 + 1)]
    assert torch.equal(ntt_mxu.ntt(a, k), ntt.ntt(a, k))
    assert torch.equal(ntt_mxu.intt(a, k), ntt.intt(a, k))
    assert torch.equal(ntt_mxu.coset_ntt(short, k, g, out_mont=True),
                       ntt.coset_ntt(short, k, g, out_mont=True))
    assert torch.equal(ntt_mxu.coset_intt(a, k, g, in_mont=True),
                       ntt.coset_intt(a, k, g, in_mont=True))

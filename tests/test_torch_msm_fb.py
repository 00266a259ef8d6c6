"""The port's fixed-base commitment path (ops/msm_fb.py, ops/scan.py,
curve.add_mixed, plonk/kzg.py) against the JAX package and the Python-int
oracle, exactly: mixed additions and scan prefixes equal as residues, window
tables equal word for word, MSM results and commitments equal as affine
points.  Kernels K5 and K6 run by their plain versions here.

The JAX package's Pallas kernels in interpret mode and its fixed-base MSM
programs take tens of minutes on a CPU, so their outputs for seeded inputs
are read from tests/data/msm_fb_reference.npz (written by
tests/data/make_msm_fb_reference.py); the slow test at the end regenerates
the file's arrays with the JAX package and compares.  The JAX package's XLA
route of the mixed addition is fast and runs here directly.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import curve as jcurve
from halo2_zkcert_tpu.ops.field import Fq as JFq
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import curve, field, msm, msm_fb, scan
from halo2_zkcert_tpu_torch.ops.field import FQ, FR
from halo2_zkcert_tpu_torch.plonk import kzg

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "msm_fb_reference.npz")
BLIND_LO = 12


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_msm_fb_reference", os.path.join(DATA,
                                              "make_msm_fb_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    z = np.load(FIXTURE)
    return {k: z[k] for k in z.files}


def _ints(arr) -> list:
    a = np.asarray(arr).reshape(-1, 32)
    return [int.from_bytes(bytes(r), "little") for r in a]


def _words(F, arr) -> torch.Tensor:
    """(..., 32) byte integers of the fixture -> (..., 8) canonical words."""
    a = np.asarray(arr)
    return field.from_ints(F, _ints(a), "cpu").reshape(a.shape[:-1] + (8,))


def _resident(limbs) -> torch.Tensor:
    """JAX limbs (..., 33) -> canonical words (..., 8), reduced mod q."""
    return field.from_resident(FQ, torch.from_numpy(
        np.asarray(limbs).astype(np.int32)))


def _pairs(arr) -> list:
    """(m, 2, 32) affine byte integers -> [(x, y)]."""
    v = _ints(arr)
    return [(v[2 * i], v[2 * i + 1]) for i in range(len(v) // 2)]


def _affine(accs: torch.Tensor) -> list:
    return curve.points_from_device(
        curve.to_affine(accs).reshape(-1, 2, 8))


def _oracle_add(p, q):
    return rc.g1_to_affine(rc.g1_add(rc.g1_from_affine(p), rc.g1_from_affine(q)))


# ---------------------------------------------------------------------------
# K5: the mixed addition
# ---------------------------------------------------------------------------

MADD_CASES = {"identity": 0, "double": 1, "inverse": 2, "affine_z1": 3,
              "random_z_a": 4, "random_z_b": 7}


@pytest.fixture(scope="module")
def madd(ref):
    P = _words(FQ, ref["madd_P"])                       # (8, 3, 8)
    Q = _words(FQ, ref["madd_Q"])                       # (8, 2, 8)
    jP = tuple(JFq.from_ints(_ints(ref["madd_P"][:, c])) for c in range(3))
    jQ = tuple(JFq.from_ints(_ints(ref["madd_Q"][:, c])) for c in range(2))
    live = np.asarray(jnp.stack(jcurve.add_mixed(jP, jQ)))   # XLA route
    return dict(P=P, Q=Q, got=curve.add_mixed(P, Q), live=_resident(live))


@pytest.mark.parametrize("case", sorted(MADD_CASES))
def test_add_mixed_matches_jax_and_oracle(ref, madd, case):
    """The projective triple equals the JAX package's, from its XLA route
    (run here) and from fused_point_add_mixed in interpret mode (fixture),
    coordinate for coordinate; the affine point equals the oracle's."""
    i = MADD_CASES[case]
    got = madd["got"][i]
    assert torch.equal(got, madd["live"][:, i])
    assert torch.equal(got, _resident(ref["madd_pallas"])[:, i])
    assert torch.equal(_resident(ref["madd_xla"])[:, i], madd["live"][:, i])
    p = curve.points_from_device(curve.to_affine(madd["P"][i:i + 1]))[0]
    q = curve.points_from_device(madd["Q"][i][None])[0]
    assert _affine(got[None]) == [_oracle_add(p, q)]


def test_add_mixed_equals_full_add_and_broadcasts(madd):
    P, Q = madd["P"], madd["Q"]
    assert torch.equal(madd["got"], curve.add_plain(P, curve.from_affine(Q)))
    one_q = curve.add_mixed(P, Q[5])                   # Q broadcast over P
    assert torch.equal(one_q[5], madd["got"][5])
    assert torch.equal(one_q, curve.add_mixed_plain(P, Q[5].expand(8, 2, 8)))


# ---------------------------------------------------------------------------
# K6: the mixed-add row scan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scanned(ref):
    xy = _words(FQ, ref["scan_xy"])                     # (3, 64, 2, 8)
    return xy, msm_fb.scan_madd(xy)


@pytest.mark.parametrize("row", [0, 1, 2])
def test_scan_madd_matches_pallas_interpret(ref, scanned, row):
    """Every prefix of the row as a projective triple equals
    fused_scan_madd's in interpret mode (row 1 repeats one point)."""
    _, got = scanned
    want = _resident(ref["scan_pallas"])                # (3, R, C, 8)
    assert torch.equal(got[row], want[:, row].permute(1, 0, 2))
    assert field.to_ints(got[row, 0, 2:]) == [1]


def test_scan_madd_matches_chained_oracle_adds(scanned):
    xy, got = scanned
    pts = curve.points_from_device(xy[0])
    acc, want = (0, 0), []
    for p in pts:                                       # 63 chained adds
        acc = _oracle_add(acc, p)
        want.append(acc)
    assert _affine(got[0]) == want


def test_scan_madd_defined_slots_match_pallas_interpret(ref, scanned):
    """Given the rows' sorted digits, the slots the contract defines (a pair
    that is the last of its digit in the row, and the row's last) equal
    fused_scan_madd's prefixes; the others are not looked at."""
    xy, _ = scanned
    rng = np.random.default_rng(6)
    dsort = torch.from_numpy(np.sort(rng.integers(0, 9, size=(3, 64)),
                                     axis=1).astype(np.int32))
    dsort[1] = 4                                        # one digit a row
    mask = msm_fb.scan_madd_defined(dsort)
    assert mask[:, -1].all() and mask[1].sum() == 1
    assert mask.sum() == sum(len(set(r.tolist())) for r in dsort)
    got = msm_fb.scan_madd(xy, dsort)
    want = _resident(ref["scan_pallas"]).permute(1, 2, 0, 3)   # (R, C, 3, 8)
    assert torch.equal(got[mask], want[mask])


def _chained(flat):
    acc, want = (0, 0), []
    for p in curve.points_from_device(flat):
        acc = _oracle_add(acc, p)
        want.append(acc)
    return want


def test_local_scan_contract_on_both_branches(scanned):
    """offsets[i // C] + local[i] is the true prefix: whole SCAN_ROW_MAX rows
    through scan_madd at the row length picked for the launch, with row
    totals; a ragged width level by level with the mixed addition first."""
    xy, _ = scanned
    flat = xy.reshape(1, -1, 2, 8)
    want = _chained(flat[0])
    dsort = (torch.arange(192, dtype=torch.int32) // 5)[None]
    for width in (192, 70):
        local, off, C = msm_fb._scan_local(flat[:, :width], dsort[:, :width])
        assert C == (msm_fb.scan_row_length(192) if width == 192 else width)
        assert off.shape == (1, width // C, 3, 8)
        full = curve.add(off[0].repeat_interleave(C, dim=0), local[0])
        assert _affine(full) == want[:width]
    full = scan.point_scan(scan.lift_affine(flat[:, :70]))
    assert _affine(full[0]) == want[:70]


def test_scan_row_length_follows_the_pair_count():
    """Long rows when the pairs alone fill the card, shorter ones down to
    SCAN_ROW_MIN when they do not; always a divisor of SCAN_ROW_MAX."""
    lo, hi, rows = (msm_fb.SCAN_ROW_MIN, msm_fb.SCAN_ROW_MAX,
                    msm_fb.SCAN_ROWS_WANTED)
    assert msm_fb.scan_row_length(4 << 21) == hi
    assert msm_fb.scan_row_length(hi * rows) == hi
    assert msm_fb.scan_row_length(hi * rows - 1) == hi // 2
    assert msm_fb.scan_row_length(192) == lo
    for pairs in (1, 1 << 17, (1 << 17) + 64, 1 << 21, 1 << 23):
        C = msm_fb.scan_row_length(pairs)
        assert lo <= C <= hi and hi % C == 0


@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_scan_local_row_lengths_give_the_same_buckets(fbs, monkeypatch, C):
    """One sort + scan + extract round with each row length the launch may
    pick: the bucket sums equal the oracle's sums of each digit's table
    points."""
    fb = fbs["fb16"]
    table = curve.points_from_device(fb.table_flat)
    rng = np.random.default_rng(8)
    digits = torch.from_numpy(rng.integers(0, 256, size=(2, 128))
                              .astype(np.int32))
    digits[1, :40] = 7                                  # one crowded bucket
    rows = torch.from_numpy(rng.integers(0, len(table), size=(2, 128)))
    seen = []
    monkeypatch.setattr(msm_fb, "scan_row_length",
                        lambda pairs: seen.append(pairs) or C)
    got = _affine(msm_fb._chunk_buckets(fb.table_flat, digits, rows, 8))
    assert seen == [256]
    for b in range(2):
        want = [rc.g1_from_affine((0, 0))] * 256
        for d, r in zip(digits[b].tolist(), rows[b].tolist()):
            want[d] = rc.g1_add(want[d], rc.g1_from_affine(table[r]))
        assert got[256 * b:256 * (b + 1)] == [rc.g1_to_affine(w)
                                              for w in want]


# ---------------------------------------------------------------------------
# digits and tables
# ---------------------------------------------------------------------------

def test_digits_16_bit_windows(ref):
    vals = _ints(ref["digit_vals"])
    assert vals[:3] == [0, 1, rc.FR - 1]
    d = msm_fb._digits(field.from_ints(FR, vals, "cpu"), 16)
    assert d.shape == (4, 16) and d.dtype == torch.int32
    for i, v in enumerate(vals):
        assert d[i].tolist() == [(v >> (16 * w)) & 0xFFFF for w in range(16)]
    jd = ref["digits16"]                 # the JAX package's 17 windows
    assert np.array_equal(jd[:, :16], d.numpy()) and not jd[:, 16].any()
    d8 = msm_fb._digits(field.from_ints(FR, vals, "cpu"), 8)
    assert d8[2].tolist() == list((rc.FR - 1).to_bytes(32, "little"))


def test_build_tables_matches_reference(ref):
    base = _words(FQ, ref["base16"])[:8]
    want = msm_fb.tables_from_reference(ref["table8_n8"], 8, 8)
    got = msm_fb.build_tables(base, 8)
    assert got.shape == (32 * 8, 2, 8) and torch.equal(got, want)
    pts = curve.points_from_device(base)
    assert curve.points_from_device(got[3 * 8 + 5][None]) == [
        rc.g1_to_affine(rc.g1_mul(rc.g1_from_affine(pts[5]), 1 << 24))]


def test_build_tables_matches_jax_build_tables():
    """The window tables out of curve.windows (the doubling chains, by
    their plain version here) against the JAX package's build_tables run
    live over three points, byte for byte after conversion."""
    from halo2_zkcert_tpu.ops import msm_fb as jmsm_fb
    rng = np.random.default_rng(23)
    G = rc.g1_from_affine(rc.G1_GEN)
    pts = [rc.g1_to_affine(rc.g1_mul(G, int(s)))
           for s in rng.integers(1, 1 << 62, size=3)]
    got = msm_fb.build_tables(curve.points_to_device(pts, "cpu"), 8)
    want = jmsm_fb.build_tables(jcurve.points_to_device(pts), 8)
    assert torch.equal(got, msm_fb.tables_from_reference(want, 3, 8))


def test_tables_cache_roundtrip_and_stale_shape(ref, tmp_path):
    base = _words(FQ, ref["base16"])[:4]
    path = str(tmp_path / "tab.npy")
    t = msm_fb.load_or_build_tables(base, 8, path)
    assert os.path.exists(path)
    assert torch.equal(msm_fb.load_or_build_tables(base, 8, path), t)
    with pytest.raises(ValueError):
        msm_fb.load_or_build_tables(base[:2], 8, path)


# ---------------------------------------------------------------------------
# FixedBaseMsm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fbs(ref):
    base = _words(FQ, ref["base16"])
    pts = curve.points_from_device(base)
    tab8 = msm_fb.tables_from_reference(ref["table8_n8"], 8, 8)
    fb8 = msm_fb.FixedBaseMsm(base[:8], wbits=8)
    assert torch.equal(fb8.table_flat, tab8)
    return dict(pts=pts, fb8=fb8, fb16=msm_fb.FixedBaseMsm(base, wbits=8),
                fb5=msm_fb.FixedBaseMsm(base[:5], wbits=8))


def test_call_matches_jax_and_oracle(ref, fbs):
    """One column through __call__; scalar 0 and r - 1 among them."""
    sc = _ints(ref["call8"])
    assert sc[0] == 0 and sc[1] == rc.FR - 1
    got = _affine(fbs["fb8"](_words(FR, ref["call8"]))[None])
    assert got == _pairs(ref["fb_call8"][None])
    assert got == [rc.g1_msm(fbs["pts"][:8], sc)]


def test_msm_many_matches_jax_and_oracle(ref, fbs):
    cols = _words(FR, ref["many8"])
    got = _affine(fbs["fb8"].msm_many(cols))
    assert got == _pairs(ref["fb_many8"])
    assert got == [rc.g1_msm(fbs["pts"][:8], _ints(c)) for c in ref["many8"]]
    assert _affine(fbs["fb8"].msm_many(cols, group=1)) == got


def test_msm_many_bounded_matches_jax_and_oracle(ref, fbs):
    """16-bit rows and a full-width blinding tail; one window's worth of
    pairs a row, padded to whole scan rows."""
    cols = _words(FR, ref["bounded16"])
    fb = fbs["fb16"]
    got = _affine(fb.msm_many_bounded(cols, value_bits=16, blind_lo=BLIND_LO))
    assert got == _pairs(ref["fb_bounded16"])
    assert got == [rc.g1_msm(fbs["pts"], _ints(c)) for c in ref["bounded16"]]
    rows, total = fb._small_layout(2, BLIND_LO, "cpu")
    assert total == 2 * 16 + 30 * 4 and rows.shape == (1, 192)
    assert not rows[0, total:].any()
    # a bound as wide as the scalars is the full path
    assert _affine(fb.msm_many_bounded(cols[:1], 256, BLIND_LO)) == got[:1]


def test_streamed_path_matches_jax_and_oracle(ref, fbs, monkeypatch):
    """The large-domain path, forced by the pair threshold: two slices."""
    fb = fbs["fb16"]
    monkeypatch.setattr(fb, "STREAM_PAIRS", 1, raising=False)
    monkeypatch.setattr(msm_fb, "CHUNK", (32 * 16) // 2)
    cols = _words(FR, ref["streamed16"])
    got = _affine(fb.msm_many(cols))
    assert got == _pairs(ref["fb_streamed16"])
    assert got == [rc.g1_msm(fbs["pts"], _ints(c)) for c in ref["streamed16"]]
    assert _affine(fb(cols[0])[None]) == _pairs(
        ref["fb_streamed_call16"][None])
    # a chunk that does not divide the pair stream is padded with digit 0
    monkeypatch.setattr(msm_fb, "CHUNK", 200)
    assert _affine(fb.msm_many(cols[:1])) == got[:1]


def test_ragged_pair_count_takes_the_mixed_add_branch(ref, fbs, monkeypatch):
    """5 points x 32 windows = 160 pairs, not whole SCAN_ROW_MAX rows: one
    scan of the affine points, which adds them by mixed additions."""
    calls = []
    real = scan.point_scan_affine
    monkeypatch.setattr(scan, "point_scan_affine",
                        lambda xy, *a: calls.append(xy.shape) or real(xy, *a))
    got = _affine(fbs["fb5"](_words(FR, ref["ragged5"]))[None])
    assert calls == [(1, 160, 2, 8)]
    assert got == _pairs(ref["fb_ragged5"][None])
    assert got == [rc.g1_msm(fbs["pts"][:5], _ints(ref["ragged5"]))]


def test_several_chunks_a_column(ref, fbs, monkeypatch):
    """More than one chunk a column in the batched path: bucket sums are
    added across the chunks."""
    monkeypatch.setattr(msm_fb, "CHUNK", 128)
    cols = _words(FR, ref["many8"])
    assert _affine(fbs["fb8"].msm_many(cols)) == _pairs(ref["fb_many8"])


# ---------------------------------------------------------------------------
# commitments
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def srs4():
    return kzg.setup(4, device="cpu")


@pytest.fixture()
def toy_srs(srs4, monkeypatch, tmp_path):
    """A fresh params object (no tables yet) over the k=4 SRS, 8-bit
    windows, and a table cache directory of the test's own."""
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path))
    monkeypatch.setattr(kzg, "FB_WBITS", 8)
    monkeypatch.delenv("H2T_FB_BOUNDED", raising=False)
    return kzg.ParamsKZG(srs4.k, srs4.g, srs4.g_lagrange, srs4.g2,
                         srs4.s_g2), tmp_path


def _columns(seed, m, n, bounded_below=None):
    rng = np.random.default_rng(seed)
    cols = [[int.from_bytes(rng.bytes(32), "little") % rc.FR
             for _ in range(n)] for _ in range(m)]
    if bounded_below is not None:
        for c in cols:
            c[:bounded_below] = [int(v) for v in rng.integers(
                0, 1 << 16, size=bounded_below)]
    return field.from_ints(FR, sum(cols, []), "cpu").reshape(m, n, 8)


def test_fb_wanted_reads_the_knob_at_call_time(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.delenv("H2T_FB_MSM", raising=False)
    assert not kzg._fb_wanted(1 << 17, cpu)
    assert kzg._fb_wanted(4096, cuda) and not kzg._fb_wanted(2048, cuda)
    monkeypatch.setenv("H2T_FB_MSM", "1")
    assert kzg._fb_wanted(16, cpu)
    monkeypatch.setenv("H2T_FB_MSM", "0")
    assert not kzg._fb_wanted(1 << 17, cuda)


@pytest.mark.parametrize("hint", ["none", "bounded", "bounded_off"])
def test_commit_many_lagrange_fixed_equals_variable(toy_srs, monkeypatch,
                                                    hint):
    params, tmp = toy_srs
    cols = _columns(21, 3, 16, bounded_below=None if hint == "none" else 11)
    kw = {} if hint == "none" else dict(value_bits=16, blind_lo=11)
    if hint == "bounded_off":
        monkeypatch.setenv("H2T_FB_BOUNDED", "0")
    monkeypatch.setenv("H2T_FB_MSM", "0")
    want = kzg.commit_many_lagrange(params, cols, **kw)
    assert "_fb_lagrange" not in params.__dict__
    monkeypatch.setenv("H2T_FB_MSM", "1")
    called = []
    real = msm_fb.FixedBaseMsm.msm_many_bounded
    monkeypatch.setattr(msm_fb.FixedBaseMsm, "msm_many_bounded",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    assert kzg.commit_many_lagrange(params, list(cols), **kw) == want
    assert called == ([1] if hint == "bounded" else [])
    assert want == [rc.g1_msm(curve.points_from_device(params.g_lagrange),
                              field.to_ints(c)) for c in cols]
    assert os.path.exists(tmp / "kzg_bn254_4.fbtab8_lag.torch.npy")
    assert kzg.commit_many_lagrange(params, []) == []


def test_commit_many_fixed_equals_variable(toy_srs, monkeypatch):
    """Monomial basis: the fixed base only for full-length polynomials;
    the table file written by one params object serves the next."""
    params, tmp = toy_srs
    polys = _columns(22, 2, 16)
    monkeypatch.setenv("H2T_FB_MSM", "0")
    want = kzg.commit_many(params, polys)
    want_short = kzg.commit_many(params, polys[:, :9])
    monkeypatch.setenv("H2T_FB_MSM", "1")
    assert kzg.commit_path(params) == "fixed_base"
    assert kzg.commit_many(params, polys) == want
    assert kzg.commit_many(params, polys[:, :9]) == want_short
    assert "_fb_lagrange" not in params.__dict__
    cache = tmp / "kzg_bn254_4.fbtab8_mono.torch.npy"
    assert cache.exists()
    again = kzg.ParamsKZG(params.k, params.g, params.g_lagrange, params.g2,
                          params.s_g2)
    monkeypatch.setattr(msm_fb, "build_tables", None)   # must read the file
    assert torch.equal(again.fixed_base(False).table_flat,
                       params.fixed_base(False).table_flat)
    assert kzg.commit_many(again, polys) == want


def test_variable_base_msm_agrees_on_the_fixture_columns(ref, fbs):
    base = _words(FQ, ref["base16"])
    cols = _words(FR, ref["streamed16"])
    assert _affine(msm.msm_many(base, cols)) == _pairs(ref["fb_streamed16"])


@pytest.mark.slow
def test_reference_fixture_is_current():
    """Regenerate the fixture with the JAX package: same arrays."""
    fresh = _maker().reference()
    z = np.load(FIXTURE)
    assert sorted(fresh) == sorted(z.files)
    for k in z.files:
        assert np.array_equal(fresh[k], z[k]), k

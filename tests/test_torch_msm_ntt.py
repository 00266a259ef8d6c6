"""Port NTT, variable-base MSM and KZG parameters against the JAX package:
transforms equal as residues, MSM results and commitments equal as affine
points, setup(6) equal point for point with the same file bytes, the MSM's
Horner step equal to the JAX package's word for word, and the fixed-base
multiplication that setup runs equal to the JAX package's fixed_base_msm."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import curve as jcurve
from halo2_zkcert_tpu.ops import msm as jmsm
from halo2_zkcert_tpu.ops import ntt as jntt
from halo2_zkcert_tpu.ops.field import Fq as JFq
from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu.plonk import kzg as jkzg
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import curve, field, msm, ntt
from halo2_zkcert_tpu_torch.ops.field import FQ, FR
from halo2_zkcert_tpu_torch.plonk import kzg

torch.set_num_threads(2)

G = rc.g1_from_affine(rc.G1_GEN)


def _rand(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(count)]


def _ints(jarr):
    return [int(v) for v in JFr.to_ints(jarr)]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_ntt_intt_coset_match_jax(k):
    vals = _rand(np.random.default_rng(k), 1 << k)
    t, j = field.from_ints(FR, vals, "cpu"), JFr.from_ints(vals)
    assert field.to_ints(ntt.ntt(t, k)) == _ints(jntt.ntt(j, k))
    assert field.to_ints(ntt.intt(t, k)) == _ints(jntt.intt(j, k))
    g = rc.FR_GENERATOR
    assert field.to_ints(ntt.coset_ntt(t, k, g)) == _ints(jntt.coset_ntt(j, k, g))
    assert field.to_ints(ntt.coset_intt(t, k, g)) == _ints(
        jntt.coset_intt(j, k, g))
    assert field.to_ints(ntt.intt(ntt.ntt(t, k), k)) == vals


def test_ntt_is_the_dft_and_batches_over_columns():
    k = 4
    n = 1 << k
    rng = np.random.default_rng(9)
    cols = [_rand(rng, n) for _ in range(3)]
    t = field.from_ints(FR, sum(cols, []), "cpu").reshape(3, n, 8)
    out = ntt.ntt(t, k)
    w = rc.fr_root_of_unity(k)
    for c, col in enumerate(cols):
        want = [sum(a * pow(w, i * j, rc.FR) for j, a in enumerate(col)) % rc.FR
                for i in range(n)]
        assert field.to_ints(out[c]) == want
    got = field.to_ints(ntt.scale_by_powers(t[0], 5, n))
    assert got == [a * pow(5, i, rc.FR) % rc.FR for i, a in enumerate(cols[0])]


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_ntt_batched_padded_mont_match_jax(k):
    """Two columns at once against the JAX package's transforms (its batch
    axis is the middle one); a short input stands for its zero-padded self;
    `out_mont` gives x * R and `in_mont` takes it back."""
    n, g = 1 << k, rc.FR_GENERATOR
    rng = np.random.default_rng(20 + k)
    cols = [_rand(rng, n) for _ in range(2)]
    t = field.from_ints(FR, cols[0] + cols[1], "cpu").reshape(2, n, 8)
    j = jnp.stack([JFr.from_ints(c) for c in cols], axis=1)
    for mine, ref in ((ntt.ntt(t, k), jntt.ntt(j, k)),
                      (ntt.intt(t, k), jntt.intt(j, k)),
                      (ntt.coset_ntt(t, k, g), jntt.coset_ntt(j, k, g)),
                      (ntt.coset_intt(t, k, g), jntt.coset_intt(j, k, g))):
        for c in range(2):
            assert field.to_ints(mine[c]) == _ints(ref[:, c])
    short = max(1, n // 2 - 1)
    padded = [c[:short] + [0] * (n - short) for c in cols]
    jp = jnp.stack([JFr.from_ints(c) for c in padded], axis=1)
    ext = ntt.coset_ntt(t[:, :short], k, g)
    want = jntt.coset_ntt(jp, k, g)
    for c in range(2):
        assert field.to_ints(ext[c]) == _ints(want[:, c])
    ext_m = ntt.coset_ntt(t[:, :short], k, g, out_mont=True)
    assert field.to_ints(ext_m.reshape(-1, 8)) == [
        x * FR.r % rc.FR for x in field.to_ints(ext.reshape(-1, 8))]
    back = ntt.coset_intt(ext_m, k, g, in_mont=True)
    assert field.to_ints(back.reshape(-1, 8)) == padded[0] + padded[1]


def test_passes_cover_every_stage_once():
    """The pass plan of the transform kernel: every stage in exactly one
    pass, a tile never above 2^log_tile elements, two passes at the prover's
    sizes."""
    for k in range(0, 24):
        for log_tile in (2, 5, 10):
            plan = ntt.passes(k, log_tile)
            assert [s0 for s0, _, _ in plan] == [
                sum(t for _, t, _ in plan[:i]) for i in range(len(plan))]
            assert sum(t for _, t, _ in plan) == k
            assert all(t + a <= log_tile and a <= s0 for s0, t, a in plan)
    assert len(ntt.passes(17)) == len(ntt.passes(19)) == 2


def _msm_inputs(seed, n):
    rng = np.random.default_rng(seed)
    pts = [rc.g1_to_affine(rc.g1_mul(G, s)) for s in _rand(rng, n)]
    pts[1] = (0, 0)
    sc = _rand(rng, n)
    sc[0], sc[2] = 0, rc.FR - 1
    return pts, sc


@pytest.mark.parametrize("n", [64, 256])
def test_msm_matches_jax_and_oracle(n):
    pts, sc = _msm_inputs(n, n)
    got = curve.points_from_device(msm.msm(
        curve.points_to_device(pts, "cpu"), field.from_ints(FR, sc, "cpu"))[None])
    want_jax = jcurve.points_from_device(jmsm.msm(
        jcurve.points_to_device(pts), JFr.from_ints(sc))[None])
    assert got == want_jax
    if n <= 64:
        assert got == [rc.g1_msm(pts, sc)]


def test_msm_many_repeated_digits():
    """Many equal digits in one window (long segments, empty buckets)."""
    n = 32
    pts, _ = _msm_inputs(3, n)
    sc = [7, 7, 7, 0, 1, 1, 255, 256, 65535, 1 << 200] * 3 + [5, 5]
    got = curve.points_from_device(curve.to_affine(msm.msm_many(
        curve.points_to_device(pts, "cpu"),
        field.from_ints(FR, sc, "cpu")[None])))
    assert got == [rc.g1_msm(pts, sc)]


@pytest.fixture(scope="module")
def srs6():
    return kzg.setup(6, device="cpu"), jkzg.setup(6)


def test_setup_matches_jax_and_file_bytes(srs6, tmp_path):
    params, jparams = srs6
    jg = field.from_resident(FQ, torch.from_numpy(
        np.asarray(jparams.g).astype(np.int32)))
    assert curve.points_from_device(params.g) == [
        (x, y) for x, y in jcurve.points_from_device(jparams.g)]
    assert curve.points_from_device(params.g_lagrange) == \
        jcurve.points_from_device(jparams.g_lagrange)
    assert torch.equal(jg, params.g)
    assert params.g2 == jparams.g2 and params.s_g2 == jparams.s_g2
    mine, ref = tmp_path / "port.srs", tmp_path / "jax.srs"
    params.write(str(mine))
    jparams.write(str(ref))
    assert mine.read_bytes() == ref.read_bytes()
    back = kzg.ParamsKZG.read(str(ref), device="cpu")
    assert torch.equal(back.g, params.g)
    assert torch.equal(back.g_lagrange, params.g_lagrange)
    assert back.s_g2 == params.s_g2


def test_gen_srs_caches_under_params_dir(tmp_path):
    p1 = kzg.gen_srs(3, str(tmp_path), device="cpu")
    assert os.path.exists(tmp_path / "kzg_bn254_3.srs")
    p2 = kzg.gen_srs(3, str(tmp_path), device="cpu")
    assert torch.equal(p1.g, p2.g) and p1.s_g2 == p2.s_g2


def test_commit_many_matches_jax(srs6):
    params, jparams = srs6
    rng = np.random.default_rng(12)
    cols = [_rand(rng, 64) for _ in range(3)]
    cols[1][:40] = [int(x) for x in rng.integers(0, 1 << 16, size=40)]
    t = field.from_ints(FR, sum(cols, []), "cpu").reshape(3, 64, 8)
    j = jnp.stack([JFr.from_ints(c) for c in cols])
    assert kzg.commit_many_lagrange(params, t) == \
        jkzg.commit_many_lagrange(jparams, j)
    assert kzg.commit_many(params, t) == jkzg.commit_many(jparams, j)
    short = t[0, :20]
    assert kzg.commit_many(params, short[None]) == [rc.g1_msm(
        curve.points_from_device(params.g[:20]), field.to_ints(short))]
    # a Lagrange commitment equals the monomial commitment of its iNTT
    assert kzg.commit_many_lagrange(params, t[:1]) == kzg.commit_many(
        params, ntt.intt(t[:1], 6))


def _window_sums(seed: int, m: int) -> tuple:
    """(m, 32, 3, 8) projective window sums with random Z, one of them the
    identity, and the same as affine ints."""
    rng = np.random.default_rng(seed)
    pts = [rc.g1_to_affine(rc.g1_mul(G, s)) for s in _rand(rng, 32 * m)]
    pts[5] = (0, 0)
    flat = []
    for x, y in pts:
        z = int.from_bytes(rng.bytes(32), "little") % (rc.FQ - 1) + 1
        flat += [0, z, 0] if (x, y) == (0, 0) else [x * z % rc.FQ,
                                                     y * z % rc.FQ, z]
    return field.from_ints(FQ, flat, "cpu").reshape(m, 32, 3, 8), pts


def test_horner_matches_jax_horner_windows():
    """curve.horner (one launch on the card, its plain version here) adds
    in the order of the JAX package's _horner_windows, from the identity: the
    same projective words, and sum_w 256^w W_w as an affine point."""
    m = 2
    W, pts = _window_sums(31, m)
    got = curve.horner(W, 8)
    jW = tuple(JFq.from_ints(field.to_ints(
        W[:, :, c].permute(1, 0, 2).reshape(-1, 8))).reshape(32, m, -1)
        for c in range(3))
    want = jmsm._horner_windows(jW)
    limbs = np.asarray(jnp.stack(want, axis=1)).astype(np.int32)
    assert torch.equal(got, field.from_resident(FQ, torch.from_numpy(limbs)))
    assert curve.points_from_device(curve.to_affine(got)) == [
        rc.g1_msm(pts[32 * j:32 * (j + 1)], [1 << (8 * w) for w in range(32)])
        for j in range(m)]


def _fixed_scalars(seed: int, count: int) -> list:
    """Random scalars, and 0, 1, r - 1, scalars with zero bytes among
    nonzero ones and one byte alone."""
    rng = np.random.default_rng(seed)
    sc = _rand(rng, count)
    sc[:6] = [0, 1, rc.FR - 1, 0x0100FF00000000FF, 0x2B << 248, 5]
    sc[6] = int.from_bytes(bytes(b if i % 3 else 0 for i, b in
                                 enumerate(rng.bytes(31))), "little")
    return sc


def test_fixed_mul_matches_jax_fixed_base_msm():
    """curve.fixed_mul over kzg.g1_window_table (the chain kernel by its
    plain version here) against the JAX package's fixed-base multiplication
    (kzg.py:87 fixed_base_msm, whose setup takes the SRS from it) and the
    oracle; the table itself equals the JAX package's window table of G.
    The JAX side is its chunk program (_fbm_chunk) step for step: its
    table, its digits, its 32 additions and its normalization; the
    additions are compiled one at a time (jmsm._jac_add), since compiling
    all 32 as one program takes the CPU more than ten minutes."""
    table = kzg.g1_window_table(torch.device("cpu"))
    jtable = jnp.asarray(jkzg._window_table_cache())
    assert torch.equal(field.from_mont(FQ, table), field.from_resident(
        FQ, torch.from_numpy(np.asarray(jtable).astype(np.int32))))
    sc = _fixed_scalars(40, 24)
    got = curve.to_affine(curve.fixed_mul(field.from_ints(FR, sc, "cpu"),
                                          table))
    digits = jkzg._digits_of(JFr.from_ints(sc))
    acc = jcurve.identity((len(sc),))
    for w in range(32):
        acc = jmsm._jac_add(acc, jcurve.from_affine(jtable[w][digits[:, w]]))
    want = np.asarray(jcurve.to_affine(acc)).astype(np.int32)
    assert torch.equal(got, field.from_resident(FQ, torch.from_numpy(want)))
    assert curve.points_from_device(got) == [
        rc.g1_to_affine(rc.g1_mul(G, s)) for s in sc]


def test_fixed_mul_takes_leading_axes():
    """Scalars with leading axes: the same as the flat call."""
    table = kzg.g1_window_table(torch.device("cpu"))
    s = field.from_ints(FR, _fixed_scalars(41, 8), "cpu")
    assert torch.equal(curve.fixed_mul(s.reshape(2, 4, 8), table),
                       curve.fixed_mul(s, table).reshape(2, 4, 3, 8))

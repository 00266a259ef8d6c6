"""Port NTT, variable-base MSM and KZG parameters against the JAX package:
transforms equal as residues, MSM results and commitments equal as affine
points, and setup(6) equal point for point with the same file bytes."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import curve as jcurve
from halo2_zkcert_tpu.ops import msm as jmsm
from halo2_zkcert_tpu.ops import ntt as jntt
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

"""Port G1 group law (halo2_zkcert_tpu_torch.ops.curve, kernels K2/K3 by
their plain versions) against the JAX package's curve ops (XLA path) and the
Python-int oracle: equal as affine points, including the identity, P + (-P)
and P + P."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import curve as jcurve
from halo2_zkcert_tpu.ops.field import Fq as JFq
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import curve, field
from halo2_zkcert_tpu_torch.ops.field import FQ, FR

torch.set_num_threads(2)

G = rc.g1_from_affine(rc.G1_GEN)


def _points(seed: int, count: int) -> list:
    rng = np.random.default_rng(seed)
    return [rc.g1_to_affine(rc.g1_mul(G, int.from_bytes(rng.bytes(32), "little")
                                      % rc.FR)) for _ in range(count)]


def _pair_lists():
    """(P list, Q list) affine, covering the exceptional cases."""
    ps = _points(1, 8)
    qs = _points(2, 8)
    qs[1] = ps[1]                                    # P + P
    qs[2] = rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(ps[2])))  # P + (-P)
    ps[3] = (0, 0)                                   # O + Q
    qs[4] = (0, 0)                                   # P + O
    ps[5] = qs[5] = (0, 0)                           # O + O
    return ps, qs


def _port(pts):
    return curve.from_affine(curve.points_to_device(pts, "cpu"))


def _jax(pts):
    return jcurve.from_affine(jcurve.points_to_device(pts))


def _oracle_add(p, q):
    return rc.g1_to_affine(rc.g1_add(rc.g1_from_affine(p), rc.g1_from_affine(q)))


def test_add_matches_jax_and_oracle():
    ps, qs = _pair_lists()
    got = curve.points_from_device(curve.to_affine(curve.add(_port(ps),
                                                             _port(qs))))
    want_jax = jcurve.points_from_device(jcurve.to_affine(
        jcurve.add(_jax(ps), _jax(qs))))
    assert got == [_oracle_add(p, q) for p, q in zip(ps, qs)]
    assert got == want_jax


def test_double_matches_jax_and_oracle():
    ps, _ = _pair_lists()
    got = curve.points_from_device(curve.to_affine(curve.double(_port(ps))))
    want_jax = jcurve.points_from_device(jcurve.to_affine(
        jcurve.double(_jax(ps))))
    assert got == [rc.g1_to_affine(rc.g1_double(rc.g1_from_affine(p)))
                   for p in ps]
    assert got == want_jax


def test_projective_coordinates_equal_jax():
    """Not only the affine results: the RCB16 formulas give the same
    projective triple as the JAX package's, coordinate for coordinate."""
    ps, qs = _pair_lists()
    P = curve.add(_port(ps), _port(qs))
    JP = jcurve.add(_jax(ps), _jax(qs))
    for c in range(3):
        want = [int(v) for v in JFq.to_ints(JP[c])]
        assert field.to_ints(P[:, c]) == want


def test_neg_sub_identity():
    ps = _points(3, 6)
    P = _port(ps)
    zero = curve.to_affine(curve.sub(P, P))
    assert curve.points_from_device(zero) == [(0, 0)] * 6
    assert curve.points_from_device(curve.to_affine(
        curve.identity((4,)))) == [(0, 0)] * 4
    got = curve.points_from_device(curve.to_affine(
        curve.add(P, curve.identity((6,)))))
    assert got == ps
    assert curve.points_from_device(curve.to_affine(curve.neg(P))) == [
        rc.g1_to_affine(rc.g1_neg(rc.g1_from_affine(p))) for p in ps]


def test_to_affine_of_scaled_projective():
    """(X z, Y z, Z z) is the same point for any nonzero z."""
    ps = _points(4, 5)
    rng = np.random.default_rng(4)
    zs = [int.from_bytes(rng.bytes(32), "little") % (rc.FQ - 1) + 1
          for _ in ps]
    P = field.mul(FQ, _port(ps), field.from_ints(FQ, zs, "cpu")[:, None, :])
    assert curve.points_from_device(curve.to_affine(P)) == ps


def test_scalar_mul_matches_jax_and_oracle():
    ps = _points(5, 4) + [(0, 0)]
    rng = np.random.default_rng(5)
    ss = [int.from_bytes(rng.bytes(32), "little") % rc.FR for _ in ps]
    ss[1], ss[2] = 0, rc.FR - 1
    got = curve.points_from_device(curve.to_affine(curve.scalar_mul(
        _port(ps), field.from_ints(FR, ss, "cpu"))))
    want = [rc.g1_to_affine(rc.g1_mul(rc.g1_from_affine(p), s))
            for p, s in zip(ps, ss)]
    assert got == want
    digits = jnp.asarray(np.stack([np.frombuffer(s.to_bytes(32, "little"),
                                                 np.uint8) for s in ss])
                         .astype(np.int32))
    want_jax = jcurve.points_from_device(jcurve.to_affine(
        jcurve.scalar_mul(_jax(ps), digits)))
    assert got == want_jax


@pytest.mark.parametrize("shape", [(3,), (2, 3)])
def test_add_broadcasts_over_leading_axes(shape):
    count = int(np.prod(shape))
    ps, qs = _points(6, count), _points(7, count)
    P = _port(ps).reshape(shape + (3, 8))
    Q = _port(qs).reshape(shape + (3, 8))
    got = curve.points_from_device(curve.to_affine(curve.add(P, Q))
                                   .reshape(-1, 2, 8))
    assert got == [_oracle_add(p, q) for p, q in zip(ps, qs)]


def _random_z(P: torch.Tensor, seed: int) -> torch.Tensor:
    """Each projective point scaled by its own nonzero Z from a numpy seed."""
    rng = np.random.default_rng(seed)
    lead = P.shape[:-2]
    zs = [int.from_bytes(rng.bytes(32), "little") % (rc.FQ - 1) + 1
          for _ in range(int(np.prod(lead)))]
    z = field.from_ints(FQ, zs, "cpu").reshape(lead + (1, 8))
    return field.mul(FQ, P, z)


def _jax_points(P: torch.Tensor) -> tuple:
    """Canonical (..., 3, 8) words -> the JAX package's coordinate tuple."""
    lead = P.shape[:-2]
    return tuple(JFq.from_ints(field.to_ints(P[..., c, :].reshape(-1, 8)))
                 .reshape(lead + (-1,)) for c in range(3))


def _from_jax(JP) -> torch.Tensor:
    limbs = np.asarray(jnp.stack(JP, axis=-2)).astype(np.int32)
    return field.from_resident(FQ, torch.from_numpy(limbs))


@pytest.mark.parametrize("c,nwin", [(1, 3), (3, 4), (8, 2)])
def test_windows_match_jax_doublings_and_oracle(c, nwin):
    """curve.windows (the chain kernel by its plain version): window w is
    the JAX package's curve.double applied c * w times, projective word for
    word, and 2^(c w) P as an affine point; the identity stays the
    identity."""
    ps = _points(8, 5) + [(0, 0)]
    P = _random_z(_port(ps), 8)
    got = curve.windows(P, c, nwin)
    assert got.shape == (nwin, len(ps), 3, 8)
    assert torch.equal(got[0], P)
    JP = _jax_points(P)
    for w in range(1, nwin):
        for _ in range(c):
            JP = jcurve.double(JP)
        assert torch.equal(got[w], _from_jax(JP))
        assert curve.points_from_device(curve.to_affine(got[w])) == [
            rc.g1_to_affine(rc.g1_mul(rc.g1_from_affine(p), 1 << (c * w)))
            for p in ps]

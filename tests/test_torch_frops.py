"""Port Fr vector primitives (halo2_zkcert_tpu_torch.ops.frops) against the
JAX package's frops, exactly: scans, batched inversion, powers, tree sums,
barycentric evaluation, division by a linear factor and the lookup
permutation, whose row order enters the proof bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import frops as jfrops
from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import field, frops
from halo2_zkcert_tpu_torch.ops.field import FR

torch.set_num_threads(2)


def _rand(rng, count, nonzero=False):
    out = []
    for _ in range(count):
        v = int.from_bytes(rng.bytes(32), "little") % rc.FR
        out.append(v or 1 if nonzero else v)
    return out


def _t(vals):
    return field.from_ints(FR, vals, "cpu")


def _j(vals):
    return JFr.from_ints(vals)


def _ints(jarr):
    return [int(v) for v in JFr.to_ints(jarr)]


@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_prefix_product(n):
    vals = _rand(np.random.default_rng(n), n)
    got = field.to_ints(frops.prefix_product(_t(vals)))
    assert got == _ints(jfrops.prefix_product(_j(vals)))


def test_prefix_product_batched():
    rng = np.random.default_rng(2)
    vals = [_rand(rng, 12) for _ in range(3)]
    got = frops.prefix_product_batched(_t(sum(vals, [])).reshape(3, 12, 8))
    want = jfrops.prefix_product_batched(jnp.stack([_j(v) for v in vals]))
    assert field.to_ints(got.reshape(-1, 8)) == _ints(want.reshape(-1, 33))


def test_affine_scan():
    rng = np.random.default_rng(3)
    m = _rand(rng, 40)
    m[:4] = [0, 1, 1, 0]
    b = [int(x) for x in rng.integers(0, 1 << 17, size=40)]
    got = field.to_ints(frops.affine_scan(_t(m), _t(b)))
    assert got == _ints(jfrops.affine_scan(_j(m), _j(b)))
    acc, want = 0, []
    for mi, bi in zip(m, b):
        acc = (mi * acc + bi) % rc.FR
        want.append(acc)
    assert got == want


@pytest.mark.parametrize("n", [1, 7, 32])
def test_batch_inv_and_powers(n):
    rng = np.random.default_rng(10 + n)
    vals = _rand(rng, n, nonzero=True)
    got = field.to_ints(frops.batch_inv(_t(vals)))
    assert got == [rc.finv(v, rc.FR) for v in vals]
    assert got == _ints(jfrops.batch_inv(_j(vals)))
    x = vals[0]
    got = field.to_ints(frops.powers(_t([x])[0], n))
    assert got == _ints(jfrops.powers(_j([x])[0], n))
    assert got == [pow(x, i, rc.FR) for i in range(n)]


def test_tree_sum_and_poly_eval_many():
    rng = np.random.default_rng(4)
    polys = [_rand(rng, 16) for _ in range(3)]
    xs = _rand(rng, 3)
    got = field.to_ints(frops.poly_eval_many(
        _t(sum(polys, [])).reshape(3, 16, 8), _t(xs)))
    want = _ints(jfrops.poly_eval_many(jnp.stack([_j(p) for p in polys]),
                                       _j(xs)))
    assert got == want
    assert got == [sum(c * pow(x, i, rc.FR) for i, c in enumerate(p)) % rc.FR
                   for p, x in zip(polys, xs)]
    odd = _rand(rng, 7)
    assert field.to_int(frops.tree_sum(_t(odd))) == sum(odd) % rc.FR


def test_bary_weights_and_eval_lagrange_many():
    k = 4
    n = 1 << k
    omega = rc.fr_root_of_unity(k)
    om = [pow(omega, i, rc.FR) for i in range(n)]
    rng = np.random.default_rng(5)
    xs = _rand(rng, 2)
    scales = [(pow(x, n, rc.FR) - 1) * rc.finv(n, rc.FR) % rc.FR for x in xs]
    cols = [_rand(rng, n) for _ in range(3)]
    widx = [0, 1, 1]
    w = frops.bary_weights(_t(om), _t(xs), _t(scales))
    jw = jfrops.bary_weights(_j(om), _j(xs), _j(scales))
    assert field.to_ints(w.reshape(-1, 8)) == _ints(jw.reshape(-1, 33))
    got = field.to_ints(frops.eval_lagrange_many(
        _t(sum(cols, [])).reshape(3, n, 8), w, torch.tensor(widx)))
    want = _ints(jfrops.eval_lagrange_many(
        jnp.stack([_j(c) for c in cols]), jw, jnp.asarray(widx)))
    assert got == want
    # against the polynomial through the values, evaluated directly
    from halo2_zkcert_tpu_torch.ops import ntt
    for c, wi, g in zip(cols, widx, got):
        coeffs = field.to_ints(ntt.intt(_t(c), k))
        assert g == sum(a * pow(xs[wi], i, rc.FR)
                        for i, a in enumerate(coeffs)) % rc.FR


def test_poly_divide_linear():
    rng = np.random.default_rng(6)
    coeffs = _rand(rng, 16)
    z = _rand(rng, 1, nonzero=True)[0]
    got = field.to_ints(frops.poly_divide_linear(_t(coeffs), _t([z])[0]))
    assert got == _ints(jfrops.poly_divide_linear(_j(coeffs), _j([z])[0]))
    # q (X - z) + p(z) == p
    pz = sum(c * pow(z, i, rc.FR) for i, c in enumerate(coeffs)) % rc.FR
    back = [(-z * got[0] + pz) % rc.FR] + [
        (got[i - 1] - z * got[i]) % rc.FR for i in range(1, 16)]
    assert back == coeffs


@pytest.mark.parametrize("max_bits", [None, 16])
def test_lookup_permute_matches_jax(max_bits):
    n, usable = 64, 57
    rng = np.random.default_rng(7 if max_bits else 8)
    table = [int(x) for x in rng.integers(0, 20, size=n)]
    if max_bits is None:                       # wide values: all 8 key words
        big = [int.from_bytes(rng.bytes(32), "little") % rc.FR
               for _ in range(20)]
        table = [big[v] for v in table]
    inputs = [table[int(i)] for i in rng.integers(0, usable, size=n)]
    a, s, ok = frops.lookup_permute_device(_t(inputs), _t(table), usable,
                                           max_bits)
    ja, js, jok = jfrops.lookup_permute_device(_j(inputs), _j(table), usable,
                                               max_bits)
    assert ok and bool(jok)
    assert field.to_ints(a[:usable]) == _ints(ja[:usable])
    assert field.to_ints(s[:usable]) == _ints(js[:usable])


def test_lookup_permute_reports_missing_value():
    n, usable = 32, 28
    table = list(range(n))
    inputs = [3] * n
    inputs[5] = 1000
    _, _, ok = frops.lookup_permute_device(_t(inputs), _t(table), usable, 16)
    assert not ok

"""The port's quotient tape (plonk/quotient.py, kernel K4 by its plain
interpreter) against the JAX package's pointwise quotient evaluator
(plonk/prover.py `_make_pointwise`), on the toy circuit of
tests/test_plonk_e2e.py with the same seeded extended-domain inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu.plonk import prover as jprover
from halo2_zkcert_tpu.plonk.domain import Domain as JDomain
from halo2_zkcert_tpu.utils import refcrypto as rc
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import quotient
from halo2_zkcert_tpu_torch.plonk.cs import ConstraintSystem
from test_plonk_e2e import K, build_toy

torch.set_num_threads(2)


class _RefPk:
    """The two things `_make_pointwise` reads of a JAX proving key."""

    def __init__(self, k, quotient_degree):
        self._dom = JDomain(k, quotient_degree)

    def domain(self):
        return self._dom


@pytest.fixture(scope="module")
def toy_cs():
    data, _, _ = build_toy()
    jcs = data.cs
    return jcs, ConstraintSystem.from_dict(jcs.to_dict())


def test_cs_roundtrip_digest(toy_cs):
    jcs, cs = toy_cs
    assert cs.digest_bytes() == jcs.digest_bytes()
    assert cs.to_dict() == jcs.to_dict()
    assert cs.blinding_factors() == jcs.blinding_factors()
    assert cs.quotient_degree == jcs.quotient_degree


@pytest.mark.parametrize("seed", [0, 1])
def test_tape_matches_jax_pointwise(toy_cs, seed):
    jcs, cs = toy_cs
    n = 1 << K
    jdom = JDomain(K, jcs.quotient_degree)
    ext_n = jdom.extended_n
    layout = quotient.leaf_layout(cs)
    L = len(layout)
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(L * ext_n)]
    chal_vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
                 for _ in range(4 + cs.num_challenges)]

    tape = quotient.compile_tape(cs, n, ext_n)
    leaves = field.from_ints(FR, vals, "cpu").reshape(L, ext_n, 8)
    chal = field.from_ints(FR, chal_vals, "cpu")
    got = field.to_ints(quotient.quotient_forest(
        leaves, tape.const_table(chal), tape))

    cols = [JFr.from_ints(vals[i * ext_n:(i + 1) * ext_n]) for i in range(L)]

    def pick(tag, count):
        return [cols[layout[(tag, i)]] for i in range(count)]

    nl = len(jcs.lookups)
    nc = jcs.num_permutation_chunks()
    pointwise = jprover._make_pointwise(jcs, _RefPk(K, jcs.quotient_degree),
                                        ext_n, ext_n // n)
    want = pointwise(
        jnp.stack(pick("a", jcs.num_advice) + pick("i", jcs.num_instance)),
        pick("permz", nc), pick("lkz", nl), pick("lka", nl), pick("lks", nl),
        JFr.from_ints(chal_vals),
        jnp.stack(pick("f", jcs.num_fixed)),
        jnp.stack(pick("sigma", len(jcs.permutation_columns))),
        *[cols[layout[("aux", a)]] for a in quotient.AUX])
    assert got == [int(v) for v in JFr.to_ints(want)]


def test_rsa_tape_fits_the_kernel():
    """The RSA k=17 forest lowers to a tape within the kernel's slot
    budget, with its rotations as row offsets of the extended domain."""
    import json
    import os
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "build", "rsa_1.pk.vk")) as f:
        vk = vk_from_dict(json.load(f))
    dom = vk.domain("cpu")
    tape = quotient.compile_tape(vk.cs, dom.n, dom.extended_n)
    assert tape.num_slots <= quotient.MAX_SLOTS
    assert tape.ins.dtype == np.int32 and tape.ins.shape[1] == 4
    loads = tape.ins[tape.ins[:, 0] == quotient.LOAD]
    assert set((loads[:, 3] % (dom.extended_n // dom.n)).tolist()) == {0}


def test_permutation_mapping_matches_jax(toy_cs):
    from halo2_zkcert_tpu.plonk.assignment import \
        permutation_mapping as jmapping
    from halo2_zkcert_tpu_torch.plonk import CircuitData
    from halo2_zkcert_tpu_torch.plonk.assignment import permutation_mapping
    data, _, _ = build_toy()
    _, cs = toy_cs
    mine = CircuitData(cs=cs, k=data.k, fixed=data.fixed, copies=data.copies,
                       num_instance=data.num_instance)
    assert np.array_equal(permutation_mapping(mine), jmapping(data))

"""The port's quotient tape (plonk/quotient.py, kernel K4 by its plain
interpreter) against the JAX package's pointwise quotient evaluator
(plonk/prover.py `_make_pointwise`), on the toy circuit of
tests/test_plonk_e2e.py with the same seeded extended-domain inputs.  The
tape's leaves, constants and result are in Montgomery form; the JAX side's
are plain residues.

The tapes of the committed keys: the RSA tape is the memoized one, pinned;
the SHA-256 and aggregation tapes, rematerialized, fit the kernel and equal
their memoized forms; the SHA-256 tape equals the JAX package's vectorized
SHA-256 quotient (`_quotient_custom_fn`)."""
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
    consts = tape.const_table(chal)
    assert field.to_ints(consts) == [
        v * FR.r % rc.FR for v in tape.consts + chal_vals]
    got_mont = quotient.quotient_forest(field.to_mont(FR, leaves), consts, tape)
    assert torch.equal(got_mont, quotient.quotient_forest_plain(
        field.to_mont(FR, leaves), consts, tape))
    got = field.to_ints(field.from_mont(FR, got_mont))

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
    budget, with its rotations as row offsets of the extended domain; its
    own numbers are pinned, so a change of the lowering that moves the
    kernel's work a row (74 products) or its slots is seen."""
    import json
    import os
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "build", "rsa_1.pk.vk")) as f:
        vk = vk_from_dict(json.load(f))
    dom = vk.domain("cpu")
    tape = quotient.compile_tape(vk.cs, dom.n, dom.extended_n)
    assert tape.num_slots <= quotient.MAX_SLOTS == quotient.SLOT_SIZES[-1]
    ops = tape.ins[:, 0].tolist()
    assert (len(ops), tape.num_slots) == (184, 17)
    assert tape.num_slots in quotient.SLOT_SIZES
    assert [ops.count(o) for o in (quotient.LOAD, quotient.CONST, quotient.ADD,
                                   quotient.SUB, quotient.MUL)] == [
        43, 12, 44, 11, 74]
    assert len(quotient.leaf_layout(vk.cs)) == 28
    assert len(tape.consts) + tape.num_challenges == 12
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


def _committed_vk(name):
    import json
    import os
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "build", f"{name}.pk.vk")) as f:
        return vk_from_dict(json.load(f))


def test_rsa_tape_is_the_memoized_one():
    """The RSA k=17 tape keeps its memoized leaves: instruction for
    instruction the tape it was before leaves could be rematerialized (the
    hash of its (184, 4) instructions), and the forced memoized form."""
    import hashlib
    vk = _committed_vk("rsa_1")
    dom = vk.domain("cpu")
    tape = quotient.compile_tape(vk.cs, dom.n, dom.extended_n)
    memo = quotient.compile_tape(vk.cs, dom.n, dom.extended_n,
                                 rematerialize=False)
    assert np.array_equal(tape.ins, memo.ins)
    assert (tape.out_slot, tape.num_slots) == (memo.out_slot, memo.num_slots)
    assert hashlib.sha256(tape.ins.tobytes()).hexdigest() == (
        "d9525ce0be808b2b24e1362ac4f36bc5fdeae064a52d86150495e9652cafdc88")


@pytest.mark.parametrize("name, slots, instructions, loads, products", [
    ("sha256_1", 80, 6785, 2044, 1904),
    ("x509_agg", 7, 1810, 503, 539),
])
def test_large_tapes_fit_the_kernel(name, slots, instructions, loads,
                                    products):
    """The SHA-256 and aggregation forests need 241 and 49 slots with
    memoized leaves; rematerialized they fit the kernel's largest
    instantiation, with the products of the memoized tape."""
    vk = _committed_vk(name)
    dom = vk.domain("cpu")
    memo = quotient.compile_tape(vk.cs, dom.n, dom.extended_n,
                                 rematerialize=False)
    assert memo.num_slots > quotient.MEMO_SLOTS
    tape = quotient.compile_tape(vk.cs, dom.n, dom.extended_n)
    ops = tape.ins[:, 0].tolist()
    assert tape.num_slots <= quotient.MAX_SLOTS
    assert (tape.num_slots, len(ops), ops.count(quotient.LOAD),
            ops.count(quotient.MUL)) == (slots, instructions, loads, products)
    assert (memo.ins[:, 0] == quotient.MUL).sum() == products
    assert tape.consts == memo.consts


@pytest.mark.parametrize("name", ["rsa_1", "sha256_1", "x509_agg"])
def test_rematerialized_tape_equals_memoized(name):
    """On random Montgomery-form leaves at a small extended domain, the
    plain version of the rematerialized tape equals that of the memoized
    one, word for word."""
    vk = _committed_vk(name)
    n, ext_n = 8, 8 << (vk.cs.quotient_degree - 1).bit_length()
    L = len(quotient.leaf_layout(vk.cs))
    rng = np.random.default_rng(len(name))
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(L * ext_n)]
    leaves = field.from_ints(FR, vals, "cpu").reshape(L, ext_n, 8)
    memo = quotient.compile_tape(vk.cs, n, ext_n, rematerialize=False)
    remat = quotient.compile_tape(vk.cs, n, ext_n, rematerialize=True)
    assert remat.num_slots < memo.num_slots
    chal = field.from_ints(FR, [int.from_bytes(rng.bytes(32), "little")
                                % rc.FR for _ in range(memo.num_challenges)],
                           "cpu")
    consts = memo.const_table(chal)
    assert torch.equal(quotient.quotient_forest_plain(leaves, consts, remat),
                       quotient.quotient_forest_plain(leaves, consts, memo))


def test_sha256_tape_matches_jax_custom_quotient():
    """The SHA-256 forest through the tape equals the JAX package's
    quotient with its vectorized gate evaluator (`_quotient_custom_fn`,
    handed to `_make_pointwise` as the pk's `quotient_custom`) on the same
    seeded columns of a small extended domain."""
    from halo2_zkcert_tpu.circuits import sha256 as jsha
    jcs, _ = jsha.build_cs()
    cs = ConstraintSystem.from_dict(jcs.to_dict())
    k = 3
    n = 1 << k
    jdom = JDomain(k, jcs.quotient_degree)
    ext_n = jdom.extended_n
    layout = quotient.leaf_layout(cs)
    L = len(layout)
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(L * ext_n)]
    chal_vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
                 for _ in range(4 + cs.num_challenges)]
    tape = quotient.compile_tape(cs, n, ext_n)
    assert np.array_equal(tape.ins, quotient.compile_tape(
        cs, n, ext_n, rematerialize=True).ins)
    leaves = field.to_mont(FR, field.from_ints(FR, vals, "cpu")
                           .reshape(L, ext_n, 8))
    got = field.to_ints(field.from_mont(FR, quotient.quotient_forest(
        leaves, tape.const_table(field.from_ints(FR, chal_vals, "cpu")),
        tape)))

    cols = [JFr.from_ints(vals[i * ext_n:(i + 1) * ext_n]) for i in range(L)]

    def pick(tag, count):
        return [cols[layout[(tag, i)]] for i in range(count)]

    ref_pk = _RefPk(k, jcs.quotient_degree)
    ref_pk.__dict__["quotient_custom"] = jsha._quotient_custom_fn()
    nc = jcs.num_permutation_chunks()
    pointwise = jprover._make_pointwise(jcs, ref_pk, ext_n, ext_n // n)
    want = pointwise(
        jnp.stack(pick("a", jcs.num_advice) + pick("i", jcs.num_instance)),
        pick("permz", nc), [], [], [], JFr.from_ints(chal_vals),
        jnp.stack(pick("f", jcs.num_fixed)),
        jnp.stack(pick("sigma", len(jcs.permutation_columns))),
        *[cols[layout[("aux", a)]] for a in quotient.AUX])
    assert got == [int(v) for v in JFr.to_ints(want)]

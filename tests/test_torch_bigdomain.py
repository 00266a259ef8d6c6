"""The port's big-domain prover path (plonk/prover.py: the coset-separated
quotient `_QuotientCoset` and the big-domain residency) on the CPU, against
the JAX package.

* The stride-1 tape, K4's program on one coset, equals the JAX package's
  pointwise quotient at stride 1 (`_make_pointwise(cs, pk, n, 1)`).
* `CosetSplit`'s way back from per-coset values equals `extended_to_coeff`
  on seeded random values, exactly.
* The coset pieces on the toy key equal the one-shot `_Quotient`'s and the
  JAX package's `_quotient_fn_coset`'s (tests/data/bigdomain_reference.npz,
  written by tests/data/make_bigdomain_reference.py; the JAX programs take
  about 75 s to compile, so the regeneration is the slow test at the end).
* The toy proof (k=6), forced onto the path, equals
  the JAX package's bytes (tests/data/toy_reference.npz) and verifies; the
  key's columns and both window tables are back and unchanged after it,
  from their files and from the host.  Commitments go through the fixed
  base (8-bit windows), which is what the tables are parked from.
* Under the default knobs the committed circuits' constraint systems keep
  the one-shot path and the residency they had on an 80 GB H100; under the
  JAX package's defaults the k=20 aggregation takes the coset path.  The
  default budget follows the device's memory, and choosing the coset path
  drops a one-shot pipeline built before.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import (create_proof, from_reference_pk,
                                          prover, quotient, setup,
                                          verify_proof)
from halo2_zkcert_tpu_torch.plonk.domain import Domain
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, DATA)
import make_bigdomain_reference as ref  # noqa: E402

PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
# the path forced: coset quotient and big-domain residency
FORCED = {"H2T_EXT_BUDGET_BYTES": "1", "H2T_U8_MIN_N": "1"}
KNOBS = tuple(FORCED)
# an H100 80GB HBM3's memory as torch reports it (79.18 GiB)
H100_BYTES = 85_020_000_000


@pytest.fixture(autouse=True)
def default_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def toy():
    z = np.load(os.path.join(DATA, "toy_reference.npz"))
    pk = from_reference_pk({k: z[k] for k in PK_ARRAYS},
                           json.loads(z["vk_json"].tobytes()), "cpu")
    return dict(
        pk=pk, proof=z["proof_poseidon"].tobytes(),
        instances=json.loads(z["instances_json"].tobytes()),
        advice=field.from_resident(FR, torch.from_numpy(z["advice"])))


def _rand(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(count)]


def test_stride1_tape_matches_jax_pointwise(toy):
    """K4's tape for one coset against the JAX pointwise at stride 1, on
    seeded leaves over n rows (plain residues there, Montgomery form
    here)."""
    import jax.numpy as jnp
    from halo2_zkcert_tpu.ops.field import Fr as JFr
    from halo2_zkcert_tpu.plonk import prover as jprover
    from halo2_zkcert_tpu.plonk.domain import Domain as JDomain
    from test_plonk_e2e import K, build_toy

    data, _, _ = build_toy()
    jcs, cs = data.cs, toy["pk"].vk.cs
    assert jcs.digest_bytes() == cs.digest_bytes()
    n = 1 << K
    layout = quotient.leaf_layout(cs)
    L = len(layout)
    rng = np.random.default_rng(7)
    vals = _rand(rng, L * n)
    chal_vals = _rand(rng, 4 + cs.num_challenges)
    tape = quotient.compile_tape(cs, n, n)
    ext_n = JDomain(K, jcs.quotient_degree).extended_n
    ext = quotient.compile_tape(cs, n, ext_n)
    loads = tape.ins[:, 0] == quotient.LOAD
    assert np.array_equal(tape.ins[~loads], ext.ins[~loads])
    assert np.array_equal(tape.ins[loads, 3] * (ext_n // n),
                          ext.ins[loads, 3])
    leaves = field.to_mont(FR, field.from_ints(FR, vals, "cpu")
                           .reshape(L, n, 8))
    got = field.to_ints(field.from_mont(FR, quotient.quotient_forest(
        leaves, tape.const_table(field.from_ints(FR, chal_vals, "cpu")),
        tape)))

    class RefPk:
        def domain(self):
            return JDomain(K, jcs.quotient_degree)

    cols = [JFr.from_ints(vals[i * n:(i + 1) * n]) for i in range(L)]

    def pick(tag, count):
        return [cols[layout[(tag, i)]] for i in range(count)]

    nl, nc = len(jcs.lookups), jcs.num_permutation_chunks()
    want = jprover._make_pointwise(jcs, RefPk(), n, 1)(
        jnp.stack(pick("a", jcs.num_advice) + pick("i", jcs.num_instance)),
        pick("permz", nc), pick("lkz", nl), pick("lka", nl), pick("lks", nl),
        JFr.from_ints(chal_vals), jnp.stack(pick("f", jcs.num_fixed)),
        jnp.stack(pick("sigma", len(jcs.permutation_columns))),
        *[cols[layout[("aux", a)]] for a in quotient.AUX])
    assert got == [int(v) for v in JFr.to_ints(want)]


@pytest.mark.parametrize("k,qd", [(4, 3), (5, 2), (3, 5), (4, 1)])
def test_coset_split_equals_extended_to_coeff(k, qd):
    """Values on the extended coset, dealt to the cosets and brought back
    by `CosetSplit`, give the first qd pieces of `extended_to_coeff`."""
    dom = Domain(k, qd, "cpu")
    n, ext_n = dom.n, dom.extended_n
    stride = ext_n // n
    assert len(prover.CosetSplit(dom).g_cosets) == stride
    vals = field.from_ints(FR, _rand(np.random.default_rng(k * 10 + qd),
                                     ext_n), "cpu")
    split = prover.CosetSplit(dom)
    pieces = None
    for c in range(stride):
        pieces = split.add(pieces, c, field.to_mont(FR, vals[c::stride]))
    want = dom.extended_to_coeff(vals).reshape(stride, n, 8)[:qd]
    assert torch.equal(pieces, want)


def _pieces_inputs(pk, seed):
    cs, n = pk.vk.cs, pk.vk.n
    cols, chal = ref.inputs(cs, n, seed)
    return ([field.from_ints(FR, c, "cpu") for c in cols],
            field.from_ints(FR, chal, "cpu"))


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_coset_pieces_equal_one_shot_and_jax(toy, seed):
    """On the toy key: the coset pipeline's pieces, the one-shot
    pipeline's and the JAX package's `_quotient_fn_coset`'s are the
    same."""
    pk = toy["pk"]
    want = np.load(os.path.join(DATA, "bigdomain_reference.npz"))[
        f"pieces_{seed}"]
    fresh, chal = _pieces_inputs(pk, seed)
    staged = []
    coset = prover._QuotientCoset(pk)(pk, list(fresh), chal,
                                      lambda: staged.append(1))
    assert staged == [1]
    assert coset.shape == (pk.vk.cs.quotient_degree, pk.vk.n, 8)
    assert ref.to_bytes(field.to_ints(coset)).reshape(want.shape).tobytes() \
        == want.tobytes()
    assert torch.equal(prover._Quotient(pk)(pk, list(fresh), chal), coset)


def test_coset_choice_drops_the_one_shot_pipeline(toy, monkeypatch):
    """The one-shot pipeline kept on the pk is dropped, extended columns
    and all, once the budget sends a proof down the coset path; and each
    path's pipeline is built once a pk."""
    pk = toy["pk"]
    for key in ("_quotient", "_quotient_coset"):
        pk.__dict__.pop(key, None)
    one_shot = prover.quotient_pipeline(pk)
    assert isinstance(one_shot, prover._Quotient)
    assert prover.quotient_pipeline(pk) is one_shot
    monkeypatch.setenv("H2T_EXT_BUDGET_BYTES", "1")
    coset = prover.quotient_pipeline(pk)
    assert isinstance(coset, prover._QuotientCoset)
    assert "_quotient" not in pk.__dict__
    assert prover.quotient_pipeline(pk) is coset
    pk.__dict__.pop("_quotient_coset")


@pytest.mark.parametrize("memory,budget", [(H100_BYTES, 37_786_666_666),
                                           (16 << 30, 7_635_497_415)])
def test_default_budget_follows_device_memory(monkeypatch, memory, budget):
    """Unset, the budget is the device's memory over the one-shot proof's
    measured peak per leaf byte; H2T_EXT_BUDGET_BYTES overrides it."""
    assert prover.device_memory("cpu") > 0
    monkeypatch.setattr(prover, "device_memory", lambda device: memory)
    assert prover.ext_budget_bytes("cuda") == budget
    monkeypatch.setenv("H2T_EXT_BUDGET_BYTES", str(2 << 30))
    assert prover.ext_budget_bytes("cuda") == 2 << 30


def _forced_proof(toy, monkeypatch, params):
    """The toy proof on the forced path, commitments on the fixed base at
    8-bit windows; returns the proof and what each K4 launch saw of the
    residency."""
    from halo2_zkcert_tpu_torch.plonk import kzg
    for name, v in FORCED.items():
        monkeypatch.setenv(name, v)
    monkeypatch.setenv("H2T_FB_MSM", "1")
    monkeypatch.setattr(kzg, "FB_WBITS", 8)
    pk = toy["pk"]
    seen = []
    real = prover.quotient_forest

    def k4(leaves, consts, tape):
        seen.append(dict(rows=leaves.shape[1],
                         key_parked=pk.fixed_lagrange is None,
                         tables=sorted(k for k in params.__dict__
                                       if "_fb_" in k)))
        return real(leaves, consts, tape)

    monkeypatch.setattr(prover, "quotient_forest", k4)
    proof = create_proof(params, pk, toy["advice"], toy["instances"],
                         PoseidonTranscript())
    return proof, seen


def _tables(params):
    return {lag: params.fixed_base(lagrange=lag).table_flat.clone()
            for lag in (True, False)}


@pytest.mark.parametrize("tables_in_files,selfcheck", [(True, None),
                                                       (False, "4")])
def test_forced_proof_equals_jax_bytes(toy, monkeypatch, tmp_path,
                                       tables_in_files, selfcheck):
    """The toy proof through the coset quotient and the big-domain residency
    equals the JAX package's proof and verifies;
    K4 runs once a coset over n rows with the key's Lagrange columns and
    the Lagrange table parked; afterwards the key's columns and both
    window tables are back, unchanged: read from their files, or from the
    host.  Under H2T_SELFCHECK=4 (no witness stash) the exact oracle holds
    K4's output on the first coset."""
    from halo2_zkcert_tpu_torch.plonk import kzg
    monkeypatch.setattr(kzg, "FB_WBITS", 8)
    if selfcheck:
        monkeypatch.setenv("H2T_SELFCHECK", selfcheck)
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path) if tables_in_files
                       else str(tmp_path / "absent"))
    pk = toy["pk"]
    p = setup(pk.vk.k, device="cpu")
    params = kzg.ParamsKZG(p.k, p.g, p.g_lagrange, p.g2, p.s_g2)
    tables = _tables(params)
    assert bool(list(tmp_path.glob("*.npy"))) == tables_in_files
    columns = {k: getattr(pk, k).clone() for k in PK_ARRAYS}
    proof, seen = _forced_proof(toy, monkeypatch, params)
    assert proof == toy["proof"]
    assert verify_proof(params, pk.vk, toy["instances"], proof,
                        PoseidonTranscript)
    assert prover.LAST_SELFCHECK == ({} if selfcheck is None else {
        "quotient window": "OK", "quotient identity": "OK"})
    stride = pk.domain().extended_n // pk.vk.n
    assert seen == [dict(rows=pk.vk.n, key_parked=True,
                         tables=["_fb_monomial", "_parked_fb_lagrange"])
                    ] * stride
    assert "_quotient" not in pk.__dict__
    assert pk.device == torch.device("cpu")
    for k in PK_ARRAYS:
        assert torch.equal(getattr(pk, k), columns[k]), k
    parked = params.__dict__["_parked_fb_monomial"]
    assert (parked.table_flat is None) == tables_in_files
    after = _tables(params)
    for lag in (True, False):
        assert torch.equal(after[lag], tables[lag])
    assert not [k for k in params.__dict__ if k.startswith("_parked")]


def _committed_cs(name):
    if name == "sha256_gate":
        z = np.load(os.path.join(DATA, "sha256_gate_reference.npz"))
        return vk_from_dict(json.loads(z["vk_json"].tobytes())).cs, 19
    with open(os.path.join(ROOT, "build", f"{name}.pk.vk")) as f:
        vk = vk_from_dict(json.load(f))
    return vk.cs, vk.k


@pytest.mark.parametrize("name,k,leaves", [
    ("rsa_1", 17, 28), ("sha256_gate", 19, None), ("x509_agg", 20, 157)])
def test_default_selection_keeps_the_one_shot_path(name, k, leaves,
                                                   monkeypatch):
    """RSA k=17, the gate-level SHA-256 at k=19 (the CLI's constraint
    system) and the k=20 aggregation keep the one-shot quotient and their
    residency under the port's defaults on an 80 GB H100; the
    aggregation's leaves are 19.6 GiB.  Under the JAX package's defaults (2 GiB, 2^19) both k >= 19
    circuits take the big-domain residency and the aggregation the coset
    path (the k=19 circuit's 63 leaves over 2^20 rows are 1.97 GiB)."""
    cs, got_k = _committed_cs(name)
    assert got_k == k
    dom = Domain(k, cs.quotient_degree, "cpu")
    if leaves is not None:
        assert len(quotient.leaf_layout(cs)) == leaves
    assert prover.leaf_bytes(cs, dom.extended_n) \
        == len(quotient.leaf_layout(cs)) * dom.extended_n * 32
    monkeypatch.setattr(prover, "device_memory", lambda device: H100_BYTES)
    assert prover.leaf_bytes(cs, dom.extended_n) \
        < prover.ext_budget_bytes("cuda")
    assert not prover.coset_quotient_wanted(cs, dom.extended_n, "cuda")
    assert not prover.big_domain(dom.n)
    if name == "x509_agg":
        assert prover.leaf_bytes(cs, dom.extended_n) / 2**30 == \
            pytest.approx(19.625)
    monkeypatch.setenv("H2T_EXT_BUDGET_BYTES", str(2 << 30))
    monkeypatch.setenv("H2T_U8_MIN_N", str(1 << 19))
    assert prover.big_domain(dom.n) == (k >= 19)
    assert prover.coset_quotient_wanted(cs, dom.extended_n, "cuda") \
        == (name == "x509_agg")


@pytest.mark.slow
def test_reference_fixture_is_current():
    """Regenerate the fixture with the JAX package: the same pieces."""
    want = np.load(os.path.join(DATA, "bigdomain_reference.npz"))
    got = ref.reference()
    assert sorted(got) == sorted(want.files)
    for key in got:
        assert np.array_equal(got[key], want[key]), key

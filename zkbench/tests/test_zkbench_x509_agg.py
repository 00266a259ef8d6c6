"""The X.509 aggregation's circuit kind: found by name, its reference's
layouts equal the program's (the bit-plane SHA-256 inner circuit, the
aggregation circuit at the smallest shape the program's tests build), its
inner keys equal the committed ones and accept the committed inner proofs,
and it rejects an inner proof that fails and an accumulator off by one.  On
a card it also accepts the program's aggregation proof under the key it
works out, and rejects it with a byte flipped."""
import importlib
import json
import os
import sys

import numpy as np
import pytest

from zkbench import harness
from zkbench.reference import (agg_circuit, bn254, keys, plonk, sha256_bits,
                               x509_agg)

ROOT = harness.ROOT
CELL = "x509_agg_k20.oneshot"
NEW = ("witness_ms.replay", "idle_ms.replay", "device_ms.witness_h2d")


def test_the_kind_is_found_by_name():
    cell, config, counts = harness.load_cell(CELL)
    assert config["circuit"] == "x509_agg" and cell["chips"] == 1
    for part in ("drivers", "traffic", "reference"):
        mod = importlib.import_module(f"zkbench.{part}.x509_agg")
        assert mod.__file__.startswith(os.path.join(ROOT, "zkbench", part))
    assert counts["quotient_products_per_row"] > 0
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    mine = [m["name"] for m in harness.metric_entries(bench, CELL, True)]
    assert set(NEW) <= set(mine)
    for other in ("rsa2048_k17.solo", "sha256_gate_k19.solo"):
        names = [m["name"] for m in harness.metric_entries(bench, other, True)]
        assert not set(NEW) & set(names)


def _cert(name):
    from halo2_zkcert_tpu_torch.cert import (extract_public_key,
                                             extract_tbs_and_sig, parse_pem)
    with open(os.path.join(ROOT, "testdata", name), "rb") as f:
        cert = parse_pem(f.read())
    return extract_public_key(cert), extract_tbs_and_sig(cert)[0]


def _chain():
    """The committed snarks' chain: cert 3 under cert 2, cert 2 under 1."""
    n2, tbs3 = _cert("example_cert_2.pem")[0], _cert("example_cert_3.pem")[1]
    n1, tbs2 = _cert("example_cert_1.pem")[0], _cert("example_cert_2.pem")[1]
    return {"links": [{"modulus": n2, "tbs": tbs3},
                      {"modulus": n1, "tbs": tbs2}], "jobs": 1}


def _committed():
    out = []
    for stem, name in zip(("rsa_1", "sha256_1", "rsa_2", "sha256_2"),
                          x509_agg.STEMS):
        with open(os.path.join(ROOT, "build", f"{stem}.proof")) as f:
            snark = json.load(f)
        with open(os.path.join(ROOT, "build", f"{stem}.pk.vk")) as f:
            vk = json.load(f)
        out.append(({"name": name, "proof": bytes.fromhex(snark["proof"]),
                     "instances": [[int(v) for v in c]
                                   for c in snark["instances"]]}, vk))
    return out


CONFIG = {"k": 20, "lanes": 8, "na": 8, "inner_k": 17}


def test_bit_plane_layout_equals_the_programs():
    from halo2_zkcert_tpu_torch.circuits.sha256 import Sha256Circuit, min_k
    from halo2_zkcert_tpu_torch.plonk.assignment import copy_table
    for length in (3, 700, 1277):
        k = min_k(length)
        assert sha256_bits.min_k(length) == k
        cs, fixed, copies, ninst = sha256_bits.layout(length, k)
        data = Sha256Circuit.build(length, k).data
        assert data.cs.digest_bytes() == cs.digest_bytes()
        assert ninst == data.num_instance
        assert np.array_equal(copy_table(data.copies), copies)
        for j in range(data.cs.num_fixed):
            rows, vals = fixed[j]
            dense = np.zeros(data.n, dtype=object)
            dense[np.asarray(rows, dtype=np.int64)] = vals
            assert all(int(a) == int(b) for a, b in zip(data.fixed[j], dense))


def test_inner_keys_equal_the_committed_and_accept_their_proofs():
    tau = bn254.default_tau()
    inner = x509_agg.inner_keys(CONFIG, _chain(), tau)
    for (vk, stmt), (snark, want) in zip(inner, _committed()):
        assert [list(p) for p in vk.fixed_commitments] == \
            want["fixed_commitments"]
        assert [list(p) for p in vk.permutation_commitments] == \
            want["permutation_commitments"]
        assert stmt == snark["instances"]
        assert plonk.verify(vk, stmt, snark["proof"], tau)


@pytest.mark.parametrize("fault", ["flipped_byte", "other_statement",
                                   "missing"])
def test_a_failing_inner_proof_rejects_every_proof(fault):
    snarks = [s for s, _ in _committed()]
    if fault == "flipped_byte":
        bad = bytearray(snarks[1]["proof"])
        bad[len(bad) // 2] ^= 1
        snarks[1]["proof"] = bytes(bad)
    elif fault == "other_statement":
        snarks[2]["instances"][0][3] ^= 1
    else:
        snarks = snarks[:3]
    ref = x509_agg.reference(CONFIG, _chain(), {"snarks": snarks},
                             bn254.default_tau())
    assert not ref.inner_ok and ref.outer is None
    assert not ref.verify(0, b"\x00" * 64)
    assert ref.key_differences([(1, 2)], [(1, 2)]) == 2


def _limbs(pt_pair) -> list:
    out = []
    for x, y in pt_pair:
        for c in (x, y):
            out += [c & ((1 << 128) - 1), c >> 128]
    return [out]


def test_the_accumulator_check():
    tau = bn254.default_tau()
    G = bn254.g1_from_affine(bn254.G1_GEN)
    lhs = bn254.g1_to_affine(bn254.g1_mul(G, 12345))
    rhs = bn254.g1_to_affine(bn254.g1_mul(G, 12345 * tau % bn254.FR))
    good = _limbs((lhs, rhs))
    assert x509_agg.accumulator_holds(good, tau)
    assert x509_agg.decode_accumulator(good) == (lhs, rhs)
    for i in range(8):
        off = [list(good[0])]
        off[0][i] += 1
        assert not x509_agg.accumulator_holds(off, tau), i
    assert not x509_agg.accumulator_holds(_limbs((lhs, lhs)), tau)
    assert not x509_agg.accumulator_holds(_limbs(((0, 0), rhs)), tau)


def _toy():
    """The program's smallest aggregation in its tests: one toy inner snark
    at k=19 (tests/data/aggregation_reference.npz), lanes 4, na 2; and the
    reference's view of that snark's key."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "data"))
    import make_aggregation_reference as fx
    from halo2_zkcert_tpu_torch.circuits.aggregation import (
        AggregationCircuit, InnerSnark)
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
    with np.load(fx.OUT) as z:
        vk = vk_from_dict(json.loads(z["toy_vk_json"].tobytes()))
        inst = json.loads(z["toy_instances_json"].tobytes())
        proof = z["toy_proof"].tobytes()
    circ = AggregationCircuit([InnerSnark(vk, inst, proof)], k=fx.K_AGG,
                              lanes=fx.LANES_AGG, na=fx.NA_AGG, nl=1)
    return circ, (_reference_vk(vk), inst, proof), fx


def _reference_vk(vk) -> plonk.VerifyingKey:
    from halo2_zkcert_tpu_torch.plonk import expression as ex
    memo = {}

    def conv(e):
        if e not in memo:
            if isinstance(e, ex.Constant):
                memo[e] = plonk.Constant(e.value)
            elif isinstance(e, ex.Fixed):
                memo[e] = plonk.Fixed(e.index, e.rotation)
            elif isinstance(e, ex.Advice):
                memo[e] = plonk.Advice(e.index, e.rotation, e.phase)
            elif isinstance(e, ex.Instance):
                memo[e] = plonk.Instance(e.index, e.rotation)
            elif isinstance(e, ex.Challenge):
                memo[e] = plonk.Challenge(e.index, e.phase)
            elif isinstance(e, ex.Scaled):
                memo[e] = plonk.Scaled(conv(e.a), e.scalar)
            else:
                memo[e] = (plonk.Sum if isinstance(e, ex.Sum)
                           else plonk.Product)(conv(e.a), conv(e.b))
        return memo[e]

    cs = vk.cs
    rcs = plonk.ConstraintSystem(
        num_fixed=cs.num_fixed, num_advice=cs.num_advice,
        num_instance=cs.num_instance, num_challenges=cs.num_challenges,
        advice_phases=list(cs.advice_phases),
        challenge_phases=list(cs.challenge_phases),
        gates=[(name, conv(g)) for name, g in cs.gates],
        lookups=[plonk.Lookup(lk.name, [(conv(a), conv(b))
                                        for a, b in lk.pairs])
                 for lk in cs.lookups],
        permutation_columns=[plonk.Column(c.kind, c.index)
                             for c in cs.permutation_columns])
    assert rcs.digest_bytes() == cs.digest_bytes()
    out = plonk.VerifyingKey(vk.k, rcs,
                             [tuple(p) for p in vk.fixed_commitments],
                             [tuple(p) for p in vk.permutation_commitments],
                             list(vk.num_instance))
    assert out.transcript_repr() == vk.transcript_repr()
    return out


def test_outer_layout_equals_the_programs():
    """Constraint system, fixed columns, copies (in order: the permutation's
    cycles follow it) and instances of the aggregation circuit."""
    from halo2_zkcert_tpu_torch.plonk.assignment import copy_table
    circ, snark, fx = _toy()
    cs, fixed, copies, ninst, instances = agg_circuit.layout(
        [snark], fx.K_AGG, fx.LANES_AGG, fx.NA_AGG)
    data = circ.data
    assert cs.digest_bytes() == data.cs.digest_bytes()
    assert ninst == data.num_instance
    assert instances == [[int(v) for v in c] for c in circ.witness("cpu")[1]]
    assert np.array_equal(copy_table(data.copies), copies)
    for j in range(data.cs.num_fixed):
        rows, vals = fixed[j]
        dense = np.zeros(data.n, dtype=object)
        dense[np.asarray(rows, dtype=np.int64)] = vals
        assert all(int(a) % bn254.FR == int(b) % bn254.FR
                   for a, b in zip(data.fixed[j], dense)), j


def test_the_programs_proof_is_accepted_on_a_card(card):
    """The toy aggregation keyed and proved on the card: the reference's key
    equals the program's, it accepts the proof and its accumulator, and
    rejects the proof with a byte flipped or the accumulator off by one."""
    from halo2_zkcert_tpu_torch.plonk import create_proof, keygen
    from halo2_zkcert_tpu_torch.plonk.assignment import BlindingRng
    from halo2_zkcert_tpu_torch.plonk.kzg import setup
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    circ, snark, fx = _toy()
    params = setup(fx.K_AGG, device=card)
    pk = keygen(params, circ.data)
    fn, inst = circ.witness(card)
    proof = create_proof(params, pk, fn, inst, PoseidonTranscript(),
                         BlindingRng(b"zkbench|toy aggregation"))
    tau = bn254.default_tau()
    cs, fixed, copies, ninst, instances = agg_circuit.layout(
        [snark], fx.K_AGG, fx.LANES_AGG, fx.NA_AGG)
    ref = keys.PlonkReference(fx.K_AGG, cs, fixed, copies, ninst,
                              lambda job: instances, tau)
    assert ref.key_differences(pk.vk.fixed_commitments,
                               pk.vk.permutation_commitments) == 0
    assert ref.verify(0, proof)
    assert x509_agg.accumulator_holds(instances, tau)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not ref.verify(0, bytes(bad))
    off = [list(instances[0])]
    off[0][0] += 1
    assert not plonk.verify(ref.vk, off, proof, tau)
    assert not x509_agg.accumulator_holds(off, tau)

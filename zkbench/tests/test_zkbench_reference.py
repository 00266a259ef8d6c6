"""The plain reference against the repository's committed artifacts: the
verifying keys it works out from the certificates' moduli equal the
committed ones, it accepts the committed proofs, and it rejects a flipped
byte and another leaf's statement.  Its gate-level layout equals the
program's at a short message, and the judge counts what it should."""
import json
import os

import numpy as np
import pytest

from zkbench import harness
from zkbench.loop import Proof
from zkbench.judge import judge
from zkbench.reference import bn254, keys, plonk, rsa, sha256_gate

ROOT = harness.ROOT


def _modulus(pem):
    from halo2_zkcert_tpu_torch.cert import extract_public_key, parse_pem
    with open(os.path.join(ROOT, "testdata", pem), "rb") as f:
        return extract_public_key(parse_pem(f.read()))


@pytest.fixture(scope="module")
def basis():
    return keys.Basis(17, bn254.default_tau())


@pytest.mark.parametrize("tag,pem", [("rsa_1", "example_cert_2.pem"),
                                     ("rsa_2", "example_cert_1.pem")])
def test_rsa_key_and_proof(tag, pem, basis):
    cs, fixed, copies, ninst = rsa.layout(_modulus(pem), 17)
    vk = keys.verifying_key(17, cs, fixed, copies, ninst, basis)
    with open(os.path.join(ROOT, "build", f"{tag}.pk.vk")) as f:
        ref = json.load(f)
    assert [list(p) for p in vk.fixed_commitments] == ref["fixed_commitments"]
    assert [list(p) for p in vk.permutation_commitments] == \
        ref["permutation_commitments"]
    with open(os.path.join(ROOT, "build", f"{tag}.proof")) as f:
        snark = json.load(f)
    proof = bytes.fromhex(snark["proof"])
    inst = [[int(v) for v in col] for col in snark["instances"]]
    assert plonk.verify(vk, inst, proof, basis.tau)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not plonk.verify(vk, inst, bytes(bad), basis.tau)
    other = [list(inst[0])]
    other[0][5] ^= 1
    assert not plonk.verify(vk, other, proof, basis.tau)
    assert not plonk.verify(vk, inst, proof[:-32], basis.tau)


def test_gate_layout_equals_the_programs():
    from halo2_zkcert_tpu_torch.circuits.sha256_gate import Sha256GateCircuit
    from halo2_zkcert_tpu_torch.plonk.assignment import copy_table
    msg = bytes(range(40))
    cs, fixed, copies, ninst = sha256_gate.layout(msg, 17)
    data = Sha256GateCircuit(msg, 17, "cpu").data
    assert data.cs.digest_bytes() == cs.digest_bytes()
    assert ninst == data.num_instance
    assert np.array_equal(copy_table(data.copies), copies)
    for j in range(data.cs.num_fixed):
        rows, vals = fixed[j]
        dense = np.zeros(data.n, dtype=object)
        dense[np.asarray(rows, dtype=np.int64)] = 1 if vals is None else vals
        assert all(int(a) % bn254.FR == int(b) % bn254.FR
                   for a, b in zip(data.fixed[j], dense))


def test_components_and_cycles():
    # two components: {0, 1, 2} linked 0-1, 2-1 and {3, 4}; cells ordered by
    # first appearance, each mapped to the next
    copies = np.array([[[0, 0, 0], [0, 0, 1]], [[0, 0, 2], [0, 0, 1]],
                       [[0, 0, 4], [0, 0, 3]]])
    cols = [plonk.Column(plonk.ADVICE, 0)]
    cells, targets = keys.sigma_moves(copies, cols, 8)
    assert dict(zip(cells.tolist(), targets.tolist())) == \
        {0: 1, 1: 2, 2: 0, 4: 3, 3: 4}


def test_judge_counts_reused_blinding_and_missing(basis):
    with open(os.path.join(ROOT, "build", "rsa_1.proof")) as f:
        proof = bytes.fromhex(json.load(f)["proof"])

    class Fake:
        cs = rsa.layout(_modulus("example_cert_2.pem"), 17)[0]
        verify = staticmethod(lambda job, p: p == proof)
        random_commitment = keys.PlonkReference.random_commitment
        key_differences = staticmethod(lambda f, p: 0)

    recs = [Proof(i, float(i), i + 0.5, proof=proof) for i in range(3)]
    recs.append(Proof(3, 3.0))
    v = judge(Fake(), recs, ([], []), 4, 1)
    assert v["checks"] == {"rejected": 0, "missing": 1, "reused_blinding": 2,
                           "key_mismatch": 0}
    assert not v["correct"] and v["checked"] == 3

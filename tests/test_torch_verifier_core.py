"""The port's loader-generic verifier (halo2_zkcert_tpu_torch/plonk/
verifier_core.py) with its NativeLoader, against the port's own
`verify_proof` and the JAX package's `verify_proof_core`, on the toy
proofs of tests/data/toy_reference.npz (Poseidon and Keccak transcripts)
and the committed build/sha256_1.proof: all three verifiers accept each,
and all three reject each with one byte flipped.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from halo2_zkcert_tpu.plonk.verifier_core import \
    verify_proof_core as jverify_proof_core
from halo2_zkcert_tpu.sdk import _vk_from_dict as jvk_from_dict
from halo2_zkcert_tpu.transcript import KeccakTranscript as JKeccak
from halo2_zkcert_tpu.transcript import PoseidonTranscript as JPoseidon
from halo2_zkcert_tpu_torch.plonk import kzg, verify_proof
from halo2_zkcert_tpu_torch.plonk.keygen import vk_from_dict
from halo2_zkcert_tpu_torch.plonk.verifier_core import verify_proof_core
from halo2_zkcert_tpu_torch.transcript import (KeccakTranscript,
                                               PoseidonTranscript)
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _g2_pair():
    """(g2, [tau] g2) of the default SRS: all a verifier reads of it."""
    g2 = (rc.G2_GEN_X, rc.G2_GEN_Y)
    return g2, rc.g2_mul_affine(g2, kzg._default_tau())


def _toy(transcript: str) -> dict:
    z = np.load(os.path.join(ROOT, "tests", "data", "toy_reference.npz"))
    return {"vk": json.loads(z["vk_json"].tobytes()),
            "instances": json.loads(z["instances_json"].tobytes()),
            "proof": z[f"proof_{transcript}"].tobytes()}


def _sha256_1() -> dict:
    with open(os.path.join(ROOT, "build", "sha256_1.proof")) as f:
        blob = json.load(f)
    return {"vk": blob["vk"],
            "instances": [[int(v) for v in c] for c in blob["instances"]],
            "proof": bytes.fromhex(blob["proof"])}


CASES = {"toy_poseidon": (lambda: _toy("poseidon"), "poseidon"),
         "toy_keccak": (lambda: _toy("keccak"), "keccak"),
         "sha256_1": (_sha256_1, "poseidon")}
TRANSCRIPTS = {"poseidon": (PoseidonTranscript, JPoseidon),
               "keccak": (KeccakTranscript, JKeccak)}


@pytest.fixture(scope="module")
def g2_pair():
    return _g2_pair()


def _verdicts(case, g2_pair, proof) -> tuple:
    """(port core, port verify_proof, JAX core) on `proof`; an undecodable
    proof is a rejection."""
    make, tname = CASES[case]
    d = make()
    g2, s_g2 = g2_pair
    vk = vk_from_dict(d["vk"])
    params = kzg.ParamsKZG(vk.k, None, None, g2, s_g2)
    T, JT = TRANSCRIPTS[tname]
    core = verify_proof_core(params, vk, d["instances"], proof, T)
    try:
        plain = verify_proof(params, vk, d["instances"], proof, T)
    except ValueError:
        plain = False
    jcore = jverify_proof_core(SimpleNamespace(g2=g2, s_g2=s_g2),
                               jvk_from_dict(d["vk"]), d["instances"], proof,
                               JT)
    return core, plain, jcore


@pytest.mark.parametrize("case", sorted(CASES))
def test_accepts(case, g2_pair):
    assert _verdicts(case, g2_pair, CASES[case][0]()["proof"]) == (
        True, True, True)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("where", ["point", "scalar"])
def test_rejects_flipped_byte(case, where, g2_pair):
    """A byte of the first commitment, or of the first evaluation, flipped:
    every verifier rejects the proof."""
    d = CASES[case][0]()
    vk = vk_from_dict(d["vk"])
    cs = vk.cs
    # commitments before the evaluations: advice, lookup permuted pairs,
    # permutation and lookup grand products, random, quotient pieces
    points = (cs.num_advice + 3 * len(cs.lookups) + 1
              + cs.num_permutation_chunks() + cs.quotient_degree)
    at = 3 if where == "point" else 32 * points + 3
    bad = bytearray(d["proof"])
    bad[at] ^= 1
    assert _verdicts(case, g2_pair, bytes(bad)) == (False, False, False)

"""The port's create_proof / verify_proof on the toy circuit (k=6) against
the JAX package: from the same proving key (carried across with
`from_reference_pk`), witness, instances and blinding seed, the port's proof
equals the JAX proof byte for byte, for the Poseidon and the Keccak
transcript.

One more Poseidon proof takes every full-length commitment through the
fixed-base MSM (forced on the CPU, window tables at 8 bits) and must give the
same bytes.

The JAX side is read from tests/data/toy_reference.npz (written by
tests/data/make_toy_reference.py); the slow test at the end regenerates it
with the JAX package and compares.
"""
import json
import os

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import (create_proof, from_reference_pk,
                                          prover, setup, verify_proof)
from halo2_zkcert_tpu_torch.transcript import (KeccakTranscript,
                                               PoseidonTranscript)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "toy_reference.npz")
PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
TRANSCRIPTS = {"poseidon": PoseidonTranscript, "keccak": KeccakTranscript}


def _load(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def toy():
    ref = _load(FIXTURE)
    vk_dict = json.loads(ref["vk_json"].tobytes())
    instances = json.loads(ref["instances_json"].tobytes())
    pk = from_reference_pk({k: ref[k] for k in PK_ARRAYS}, vk_dict, "cpu")
    advice = field.from_resident(FR, torch.from_numpy(ref["advice"]))
    params = setup(pk.vk.k, device="cpu")
    return dict(ref=ref, pk=pk, advice=advice, instances=instances,
                params=params, proofs={})


def _proof(toy, name):
    """The port's proof for one transcript, made once per module."""
    if name not in toy["proofs"]:
        toy["proofs"][name] = create_proof(
            toy["params"], toy["pk"], toy["advice"], toy["instances"],
            TRANSCRIPTS[name]())
        toy["stages"] = dict(prover.LAST_STAGE_TIMES)
    return toy["proofs"][name]


@pytest.mark.parametrize("name", ["poseidon", "keccak"])
def test_proof_bytes_equal_reference(toy, name):
    assert _proof(toy, name) == toy["ref"][f"proof_{name}"].tobytes()


def test_proof_on_the_fixed_base_equals_reference(toy, monkeypatch, tmp_path):
    """Commitments through ops/msm_fb.py (advice, lookup, Z, h and multiopen
    columns) change no byte of the proof."""
    from halo2_zkcert_tpu_torch.ops import msm_fb
    from halo2_zkcert_tpu_torch.plonk import kzg
    monkeypatch.setenv("H2T_FB_MSM", "1")
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path))
    monkeypatch.setattr(kzg, "FB_WBITS", 8)
    used = []
    real = msm_fb.FixedBaseMsm.msm_many
    monkeypatch.setattr(msm_fb.FixedBaseMsm, "msm_many",
                        lambda *a, **k: used.append(1) or real(*a, **k))
    p = toy["params"]
    params = kzg.ParamsKZG(p.k, p.g, p.g_lagrange, p.g2, p.s_g2)
    proof = create_proof(params, toy["pk"], toy["advice"], toy["instances"],
                         PoseidonTranscript())
    assert used and "_fb_lagrange" in params.__dict__ \
        and "_fb_monomial" in params.__dict__
    assert proof == toy["ref"]["proof_poseidon"].tobytes()


def test_stage_times_recorded(toy):
    _proof(toy, "poseidon")
    assert list(toy["stages"]) == [
        "phase commits", "lookup permute+commit", "grand products+random",
        "quotient+commit", "evals", "multiopen"]
    assert all(v >= 0 for v in toy["stages"].values())


@pytest.mark.parametrize("name", ["poseidon", "keccak"])
def test_verifier_accepts_reference_and_own(toy, name):
    vk, params = toy["pk"].vk, toy["params"]
    ref_proof = toy["ref"][f"proof_{name}"].tobytes()
    assert verify_proof(params, vk, toy["instances"], ref_proof,
                        TRANSCRIPTS[name])
    assert verify_proof(params, vk, toy["instances"], _proof(toy, name),
                        TRANSCRIPTS[name])


def test_verifier_rejects_wrong_instance(toy):
    bad = [[(toy["instances"][0][0] + 1)]]
    assert not verify_proof(toy["params"], toy["pk"].vk, bad,
                            _proof(toy, "poseidon"), PoseidonTranscript)


@pytest.mark.parametrize("where", [0.25, 0.75])
def test_verifier_rejects_flipped_byte(toy, where):
    proof = bytearray(_proof(toy, "poseidon"))
    i = int(len(proof) * where) // 32 * 32 + 3    # inside a scalar or point
    proof[i] ^= 1
    try:
        ok = verify_proof(toy["params"], toy["pk"].vk, toy["instances"],
                          bytes(proof), PoseidonTranscript)
    except (AssertionError, ValueError):
        ok = False                                # undecodable point
    assert not ok


def test_from_reference_pk_roundtrips_vk(toy):
    from halo2_zkcert_tpu_torch.plonk.keygen import vk_to_dict
    vk_dict = json.loads(toy["ref"]["vk_json"].tobytes())
    assert vk_to_dict(toy["pk"].vk) == vk_dict
    assert toy["pk"].fixed_lagrange.shape == (2, 64, 8)
    assert toy["pk"].sigma_coeff.shape == (4, 64, 8)


@pytest.mark.slow
def test_reference_fixture_is_current():
    """Regenerate the fixture with the JAX package: same arrays and bytes."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_toy_reference", os.path.join(DATA, "make_toy_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.reference()
    ref = _load(FIXTURE)
    assert sorted(fresh) == sorted(ref)
    for k in ref:
        assert np.array_equal(fresh[k], ref[k]), k

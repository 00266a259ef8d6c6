"""The prover's debugging knobs (H2T_SELFCHECK 1-5, H2T_EVAL_MODE=coeff,
H2T_PROFILE, H2T_PROFILE2) on the toy circuit (k=6), against the JAX
package.

Under each setting the port's Poseidon proof, from the key, witness,
instances and blinding seed of tests/data/toy_reference.npz, equals the
fixture's bytes, every verdict is OK, and the lines it prints equal the
JAX package's (times in seconds replaced by `<s>`), which
tests/data/make_selfcheck_reference.py wrote into
tests/data/selfcheck_reference.json; so do keygen's ticks under
H2T_PROFILE.  A Z value changed before its commitment (a hook patched in
here) is reported as a quotient identity MISMATCH at level 1 and as a
VIOLATED recurrence at level 3; a row of K4's output changed (on the CPU
its plain version) as a window MISMATCH at level 4.  Tolerance: exact.

The commitments are the same in every run of a setting, so this module
keeps the variable-base MSM's results by their input (`_commit` memoized):
the first proof computes them, the others read them.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import (CircuitData, create_proof,
                                          from_reference_pk, keygen, kzg,
                                          prover, setup)
from halo2_zkcert_tpu_torch.plonk.cs import ConstraintSystem
from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
from test_plonk_e2e import build_toy

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
sys.path.insert(0, DATA)
import make_selfcheck_reference as ref  # noqa: E402

torch.set_num_threads(2)

PK_ARRAYS = ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff")
Z_ROW = 5          # a row of the first permutation Z before u_row
K4_ROW = 20        # a row inside the level-4 window [17, 25)


class _Stop(Exception):
    """Ends a corrupted run once its verdicts are in."""


@pytest.fixture(scope="module")
def toy():
    z = np.load(os.path.join(DATA, "toy_reference.npz"))
    pk = from_reference_pk({k: z[k] for k in PK_ARRAYS},
                           json.loads(z["vk_json"].tobytes()), "cpu")
    with open(ref.OUT) as f:
        want = json.load(f)
    memo, real = {}, kzg._commit

    def commit(base, cols):
        key = (base.data_ptr(), base.shape[0],
               cols.contiguous().numpy().tobytes())
        if key not in memo:
            memo[key] = real(base, cols)
        return memo[key]

    kzg._commit = commit
    yield dict(pk=pk, proof=z["proof_poseidon"].tobytes(),
               advice=field.from_resident(FR, torch.from_numpy(z["advice"])),
               instances=json.loads(z["instances_json"].tobytes()),
               params=setup(pk.vk.k, device="cpu"), want=want)
    kzg._commit = real


def _prove(toy, setting):
    with ref.knobs(setting):
        return ref.printed(lambda: create_proof(
            toy["params"], toy["pk"], toy["advice"], toy["instances"],
            PoseidonTranscript()))


@pytest.mark.parametrize("name", list(ref.SETTINGS))
def test_knob_keeps_the_proof_and_prints_the_jax_lines(toy, name):
    proof, lines = _prove(toy, ref.SETTINGS[name])
    assert proof == toy["proof"]
    assert lines == toy["want"]["proofs"][name]
    verdicts = dict(prover.LAST_SELFCHECK)
    assert all(v == "OK" for v in verdicts.values()), verdicts
    level = ref.SETTINGS[name].get("H2T_SELFCHECK")
    assert ("quotient identity" in verdicts) == bool(level)
    assert ("perm_z0 recurrence" in verdicts) == (level == "3")
    assert ("quotient window" in verdicts) == (level in ("4", "5"))
    assert ("horner(h_collapsed, x)" in verdicts) == (level == "2")


def test_keygen_ticks_under_profile(toy):
    data, _, _ = build_toy()
    mine = CircuitData(cs=ConstraintSystem.from_dict(data.cs.to_dict()),
                       k=data.k, fixed=data.fixed, copies=data.copies,
                       num_instance=data.num_instance)
    with ref.knobs({"H2T_PROFILE": "1"}):
        pk, lines = ref.printed(lambda: keygen(toy["params"], mine))
    assert lines == toy["want"]["keygen_profile"]
    for k in PK_ARRAYS:
        assert torch.equal(getattr(pk, k), getattr(toy["pk"], k)), k


def _corrupt_z(monkeypatch):
    real = prover._grand_products

    def hooked(*args, **kwargs):
        zs, num, den = real(*args, **kwargs)
        zs[0] = zs[0].clone()
        zs[0][Z_ROW] = field.add(FR, zs[0][Z_ROW], field.one("cpu"))
        return zs, num, den

    monkeypatch.setattr(prover, "_grand_products", hooked)


def _stop_at(monkeypatch, name):
    def stop(*args, **kwargs):
        raise _Stop
    monkeypatch.setattr(prover, name, stop)


@pytest.mark.parametrize("level", ["3", "1"])
def test_corrupted_z_is_reported(toy, monkeypatch, level):
    """Level 3 also runs level 1's check: VIOLATED and MISMATCH at once."""
    _corrupt_z(monkeypatch)
    _stop_at(monkeypatch, "open_shplonk")
    with pytest.raises(_Stop):
        _prove(toy, {"H2T_SELFCHECK": level})
    verdicts = prover.LAST_SELFCHECK
    assert verdicts["quotient identity"] == "MISMATCH"
    if level == "3":
        assert verdicts["perm_z0 recurrence"] == "VIOLATED"
        others = {k: v for k, v in verdicts.items()
                  if k not in ("perm_z0 recurrence", "quotient identity")}
        assert others and all(v == "OK" for v in others.values()), verdicts


def test_corrupted_quotient_output_is_reported(toy, monkeypatch):
    real = prover.quotient_forest

    def hooked(leaves, consts, tape):
        h = real(leaves, consts, tape).clone()
        h[K4_ROW] = field.add(FR, h[K4_ROW], field.one("cpu"))
        return h

    monkeypatch.setattr(prover, "quotient_forest", hooked)
    _stop_at(monkeypatch, "commit_many")
    with pytest.raises(_Stop):
        _prove(toy, {"H2T_SELFCHECK": "4"})
    assert prover.LAST_SELFCHECK == {"quotient window": "MISMATCH"}


@pytest.mark.slow
def test_reference_fixture_is_current():
    """Regenerate with the JAX package (several minutes) and compare."""
    with open(ref.OUT) as f:
        assert ref.reference() == json.load(f)

"""The plain reference that decides whether a run's proofs are correct.

One module a circuit kind, found by a configuration's `circuit` name:
reference/<circuit>.py defines `reference(config, inputs, artifacts, tau)`,
which returns an object with
  verify(job, proof) -> bool      whether `proof` proves job `job`'s
                                  statement under the verifying key the
                                  reference works out itself;
  random_commitment(proof) -> bytes
                                  the bytes of the proof's vanishing
                                  argument's random commitment;
  key_differences(fixed, permutation) -> int
                                  how many of the program's verifying-key
                                  commitments differ from the reference's.
`inputs` are those the benchmark made from the seed; `tau` is the SRS's
secret.  `artifacts` is what the driver handed over after the window
(`Driver.artifacts()`, {} where it has none): plain data that a statement
rests on and that the reference cannot make in a run, such as inner proofs
and their instances.  Each artifact is a claim: the reference verifies every
proof among them against a key it works out itself before it uses it, and a
job whose statement rests on an artifact that fails is rejected.

The reference imports nothing of the program and takes nothing it made but
the proofs it judges.  keys.PlonkReference does the work of a circuit proved
by the PLONK verifier in plonk.py.
"""
from __future__ import annotations

import importlib

from . import bn254


def Reference(config: dict, inputs: dict, artifacts: dict):
    """The reference of the configuration's circuit kind."""
    mod = importlib.import_module(f"{__name__}.{config['circuit']}")
    return mod.reference(config, inputs, artifacts, bn254.default_tau())

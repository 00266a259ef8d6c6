"""On the card: runs of each cell at its own sizes (a short window) in which
`correct` has to come out false.

- The control breaks a guarantee the configurations state: every proof
  drawing its own blinding.  One blinding stream for every proof is what a
  later change that caches the random polynomial's commitment would do;
  run on three seeds, each must read reused_blinding > 0.
- The faults the cells can have, planted under the timed path: a proof's
  byte altered where it is produced (flip), the prover handing back its last
  proof again (stale), the second half of each witness column's filled
  rows left out (half).
A sound run on the same sizes comes out correct.

    python -m pytest zkbench/tests/test_zkbench_controls.py -m gpu -s
"""
import time

import pytest

from zkbench import harness

CELLS = ["rsa2048_k17.solo", "sha256_gate_k19.solo", "rsa4096_k17.solo"]
SECONDS = 4
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


def _run(cell, seed, fault):
    harness.use_params_dir()
    out = harness.run(cell, seed, SECONDS, False, time.perf_counter(),
                      fault=fault)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    print(f"\n[controls] {cell} seed {seed} fault {fault}: "
          f"correct {out['correct']} checks {checks}", flush=True)
    return out, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(card, cell):
    out, checks = _run(cell, SEEDS[0] + 7, None)
    assert out["correct"] and checks["checked"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_one_blinding_stream_fails(card, cell, seed):
    out, checks = _run(cell, seed, "reuse_blinding")
    assert not out["correct"] and checks["reused_blinding"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("fault,caught_by", [
    ("flip", ("rejected",)), ("stale", ("reused_blinding",)),
    ("half", ("rejected", "missing"))])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails(card, cell, fault, caught_by):
    out, checks = _run(cell, SEEDS[1] + 11, fault)
    assert not out["correct"] and sum(checks[c] for c in caught_by) > 0

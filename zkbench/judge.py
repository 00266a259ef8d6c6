"""Whether a run's proofs are correct, by the plain reference, once the
window has closed and the program's state is freed.

Numbers compared, each with its limit (exact comparisons, limit 0):
  rejected        sampled proofs the reference's verifier rejects for their
                  own job's statement under the key it works out itself,
                  those whose statement rests on an artifact it refused
                  among them;
  missing         proofs started in the window that never came, or raised;
  reused_blinding proofs whose vanishing argument's random commitment equals
                  another proof's: each proof has to draw fresh blinding;
  key_mismatch    commitments of the program's verifying key that differ
                  from the reference's.
The sample is drawn from the seed among every finished proof, with the
slowest in it; a run with no proof to check is not correct.
"""
from __future__ import annotations

import random
import time

LIMITS = {"rejected": 0, "missing": 0, "reused_blinding": 0,
          "key_mismatch": 0}


def judge(reference, proofs: list, vk: tuple, sample: int, seed: int) -> dict:
    t0 = time.perf_counter()
    done = [p for p in proofs if p.proof is not None]
    missing = len(proofs) - len(done)
    seen, reused = {}, 0
    for p in done:
        key = reference.random_commitment(p.proof)
        reused += key in seen
        seen[key] = True
    pick = []
    if done:
        slowest = max(done, key=lambda p: p.end - p.start)
        rest = [p for p in done if p is not slowest]
        rng = random.Random(f"zkbench-sample|{seed}")
        pick = [slowest] + rng.sample(rest, min(len(rest), sample - 1))
    rejected = sum(not reference.verify(p.job, p.proof) for p in pick)
    checks = {"rejected": rejected, "missing": missing,
              "reused_blinding": reused,
              "key_mismatch": reference.key_differences(*vk)}
    return {"checks": checks, "checked": len(pick),
            "correct": bool(pick) and all(checks[k] <= LIMITS[k]
                                          for k in LIMITS),
            "seconds": time.perf_counter() - t0}

"""The closed loop of one prover process on one card.

Set-up proves one warm-up job.  From the window's opening the prover proves
the jobs of its queue back to back, each as soon as the last one returned.
A proof starts at the driver's first call (the witness for RSA) and ends at
its proof bytes, which the program hands back only once the card is done
with them.  No proof starts after the window closes; the one in flight then
finishes and is recorded, with its end after the close.  Only this process
uses the card: a second one would take memory and time from it.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import torch


@dataclass
class Proof:
    job: int
    start: float
    end: float | None = None
    witness_s: float | None = None
    stages: dict = field(default_factory=dict)
    proof: bytes | None = None
    error: str | None = None


def blinding(tag: str, i: int, fault: str | None = None) -> bytes:
    """The i-th proof's blinding seed (-1: the warm-up's)."""
    if fault == "reuse_blinding":
        return b"zkbench|one blinding stream for every proof"
    return f"zkbench|{tag}|{i}".encode()


def warm(driver, jobs: list, tag: str) -> None:
    driver.prove(jobs[0], blinding(tag, -1))
    torch.cuda.synchronize()


def window(driver, jobs: list, tag: str, t_close: float, fault=None,
           tracer=None) -> list:
    """Prove until `t_close` on the host clock; every proof started."""
    proofs, last, i = [], None, 0
    while time.perf_counter() < t_close:
        if tracer is not None:
            tracer.between()
            if time.perf_counter() >= t_close:
                break
        rec = Proof(jobs[i % len(jobs)], time.perf_counter())
        proofs.append(rec)
        try:
            proof, rec.witness_s, rec.stages = driver.prove(
                rec.job, blinding(tag, i, fault),
                fault if fault == "half" else None)
            if fault == "flip":
                b = bytearray(proof)
                b[len(b) // 2] ^= 1
                proof = bytes(b)
            elif fault == "stale" and last is not None:
                proof = last
            rec.proof, last = proof, proof
        except Exception:
            rec.error = traceback.format_exc(limit=4)
        rec.end = time.perf_counter()
        i += 1
    if tracer is not None:
        tracer.stop()
    return proofs

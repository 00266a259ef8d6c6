"""The traced run's `breakdown`: the device operations that took most time
in the traced stretch, and its idle gaps summed by what the prover was
doing at each gap's midpoint (the witness, a prover stage by the program's
stage times laid end to end from the witness's end, or between proofs)."""
from __future__ import annotations

TOP = 10


def _phase(p, t: float) -> str:
    if p.end is None or not p.start <= t < p.end:
        return ""
    cur = p.start + (p.witness_s or 0.0)
    if t < cur:
        return "witness"
    for stage, secs in p.stages.items():
        cur += secs
        if t < cur:
            return stage
    return "proof bytes"


def label(run, t: float) -> str:
    doing = sorted(filter(None, (_phase(p, t) for p in run.proofs)))
    return " + ".join(doing) if doing else "between proofs"


def breakdown(run) -> dict:
    tr = run.trace
    ops = sorted(tr.device_s.items(), key=lambda kv: -kv[1])[:TOP]
    by = {}
    for s, e in tr.idle:
        k = label(run, (s + e) / 2)
        tot, n, longest = by.get(k, (0.0, 0, 0.0))
        by[k] = (tot + e - s, n + 1, max(longest, e - s))
    idle = sorted(by.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[name[:120], secs] for name, secs in ops],
            "idle_gaps": [[f"{k} ({n} gaps, longest {lg * 1e3:.3f} ms)", t]
                          for k, (t, n, lg) in idle]}

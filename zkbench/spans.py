"""The program's own spans and counters (halo2_zkcert_tpu_torch/utils/trace.py
`records()`) over the proofs wholly inside the traced stretch, for the
readers that read them, and the stretch's idle gaps cut at those spans'
boundaries.

The program records while torch's profiler collects, so its records cover
the traced stretch and the proof that the profiler's start stalled.  A span
counts where it lies within the start and end of a proof of `run.traced`;
a proof's counters count where its `prove` span does.  Each idle piece is
charged to the innermost span open over it, or to no span (between
proofs).  A program without the recorder gives no records: every reader
then reads nothing.
"""
from __future__ import annotations

import bisect


def records():
    """The program's records, or None where the program has no recorder."""
    try:
        from halo2_zkcert_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def traced(run):
    """(spans, counters) of the proofs wholly inside the traced stretch:
    the spans that lie within one of them, by start, and the counters of
    each proof id whose `prove` span does.  None where there is nothing to
    read."""
    if run.trace is None or not run.traced:
        return None
    recs = records()
    if recs is None:
        return None
    proofs = sorted((p.start, p.end) for p in run.traced)
    starts = [s for s, _ in proofs]

    def inside(sp) -> bool:
        i = bisect.bisect_right(starts, sp.start) - 1
        return i >= 0 and sp.end <= proofs[i][1]

    spans = [sp for sp in recs.spans if inside(sp)]
    ids = {sp.proof for sp in spans if sp.name == "prove"}
    if not ids:
        return None
    return spans, [recs.proofs.get(i, {}) for i in sorted(ids)]


def names(sp) -> set:
    """The names of a span and of every span that holds it."""
    out = set()
    while sp is not None:
        out.add(sp.name)
        sp = sp.parent
    return out


def idle_pieces(run, spans: list) -> list:
    """[(seconds, innermost span or None)]: each idle gap of the stretch cut
    at the boundaries of `spans`, each piece with the innermost of them open
    over it (None: outside all of them)."""
    marks = sorted({t for sp in spans for t in (sp.start, sp.end)})
    # the innermost span over each stretch between two marks
    inner, opened, ends, open_now = [], {}, {}, []
    for sp in spans:
        opened.setdefault(sp.start, []).append(sp)
        ends.setdefault(sp.end, []).append(sp)
    depth = {}
    for sp in spans:
        d, p = 0, sp.parent
        while p is not None:
            d, p = d + 1, p.parent
        depth[id(sp)] = d
    for t in marks:             # opened first: a span may end where it began
        open_now.extend(opened.get(t, ()))
        for sp in ends.get(t, ()):
            open_now.remove(sp)
        inner.append(max(open_now, key=lambda s: depth[id(s)])
                     if open_now else None)
    out = []
    for s, e in run.trace.idle:
        i = bisect.bisect_right(marks, s) - 1
        cur = s
        while cur < e:
            nxt = marks[i + 1] if i + 1 < len(marks) else float("inf")
            stop = min(e, nxt)
            if stop > cur:
                out.append((stop - cur, inner[i] if i >= 0 else None))
            cur, i = stop, i + 1
    return out


def idle_split(run) -> dict | None:
    """Idle seconds of the stretch by the innermost span's name, the part
    outside every span of a traced proof under "between proofs"."""
    got = traced(run)
    if got is None:
        return None
    out: dict = {}
    for secs, sp in idle_pieces(run, got[0]):
        key = "between proofs" if sp is None else sp.name
        out[key] = out.get(key, 0.0) + secs
    return out

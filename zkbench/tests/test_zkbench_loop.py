"""The closed loop on a stand-in driver: proofs back to back until the
close, the one in flight finished after it, the planted faults, and the
tracer opening its stretch one proof after the profiler's start and closing
it at a proof boundary."""
import time

import pytest

from zkbench import loop
from zkbench.trace import Tracer


class Driver:
    def __init__(self, secs=0.01):
        self.secs, self.calls = secs, []

    def prove(self, job, blinding, fault=None):
        self.calls.append((job, blinding, fault))
        time.sleep(self.secs)
        return f"{job}|{blinding.decode()}".encode(), 0.001, {"s": 0.002}


def test_proofs_back_to_back_until_the_close():
    d = Driver()
    t_close = time.perf_counter() + 0.2
    proofs = loop.window(d, [3, 4, 5], "tag", t_close)
    assert len(proofs) >= 5
    assert all(p.start < t_close for p in proofs)
    assert proofs[-1].end >= t_close
    assert all(a.end <= b.start for a, b in zip(proofs, proofs[1:]))
    assert [p.job for p in proofs[:4]] == [3, 4, 5, 3]
    assert len({p.proof for p in proofs}) == len(proofs)


@pytest.mark.parametrize("fault", ["flip", "stale", "reuse_blinding"])
def test_faults(fault):
    d = Driver(0.001)
    proofs = loop.window(d, [0, 1], "tag", time.perf_counter() + 0.05,
                         fault)
    blindings = {c[1] for c in d.calls}
    if fault == "reuse_blinding":
        assert len(blindings) == 1
    elif fault == "stale":
        assert proofs[1].proof == proofs[0].proof
    else:
        assert proofs[0].proof != b"0|zkbench|tag|0"


class FakeProfile:
    entered = exited = 0

    def __init__(self, activities):
        pass

    def __enter__(self):
        FakeProfile.entered = time.perf_counter()
        return self

    def __exit__(self, *exc):
        FakeProfile.exited = time.perf_counter()


def test_tracer_stretch_holds_whole_proofs(monkeypatch):
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    d = Driver(0.01)
    t0 = time.perf_counter()
    tr = Tracer(t0 + 0.05, 0.1)
    proofs = loop.window(d, [0], "tag", t0 + 0.3, tracer=tr)
    assert tr.stopped and tr.lo is not None and tr.hi is not None
    assert tr.lo >= FakeProfile.entered and tr.hi <= FakeProfile.exited
    assert tr.hi - tr.lo >= 0.1
    inside = [p for p in proofs if tr.lo <= p.start and p.end <= tr.hi]
    # the first proof under the profiler lies before the stretch
    first = next(p for p in proofs if p.start >= FakeProfile.entered)
    assert first not in inside and first.end <= tr.lo
    assert inside and all(p.end <= tr.hi for p in inside)

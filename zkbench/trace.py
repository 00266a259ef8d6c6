"""The device trace of part of the window: torch.profiler (CUPTI) over every
stream of the process, from which the per-layer readers take device time by
kernel name, the card's busy time and the idle gaps.

The profiler starts and stops only between two proofs.  Its start stalls
the first proof under it for seconds, so the traced stretch opens at that
proof's end and closes at the first proof boundary `seconds` later: it holds
whole proofs only.  The trace's clock is the Unix time in nanoseconds (its
start, `trace_start_ns`, plus each event's offset); the host's perf_counter
and time_ns read together at the stretch's ends place every event on the
host's clock, where the proofs' records are.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .stats import gaps, union_length


@dataclass
class Trace:
    lo: float                 # the traced stretch on the host clock (s)
    hi: float
    busy_s: float             # union of device activity inside it
    device_s: dict            # kernel or copy name -> summed device seconds
    launches: dict            # name -> count of device operations
    idle: list                # (start, end) on the host clock
    read_s: float = 0.0

    @property
    def window_s(self) -> float:
        return self.hi - self.lo


class Tracer:
    """Called at each proof boundary (`between`); starts the profiler at
    the first boundary past `start_at` on the host clock."""

    def __init__(self, start_at: float, seconds: float):
        self.start_at, self.seconds = start_at, seconds
        self.prof = None
        self.lo = self.hi = None
        self.stopped = False

    def between(self) -> None:
        if self.stopped:
            return
        t = time.perf_counter()
        if self.prof is None:
            if t >= self.start_at:
                from torch.profiler import ProfilerActivity, profile
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
        elif self.lo is None:
            self.lo, self.lo_ns = t, time.time_ns()
        elif t >= self.lo + self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.stopped:
            return
        if self.lo is not None:
            self.hi, self.hi_ns = time.perf_counter(), time.time_ns()
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def read(self) -> Trace | None:
        """The stretch's reduction, or None where it holds no proof."""
        if self.hi is None:
            return None
        t0 = time.perf_counter()
        start_ns = self.prof.profiler.kineto_results.trace_start_ns()
        a = (self.lo_ns - start_ns) * 1e-3          # us
        b = (self.hi_ns - start_ns) * 1e-3

        def host(us: float) -> float:
            return self.lo + (us - a) * 1e-6

        spans, device_s, launches = [], {}, {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            if e.device_type != cuda:
                continue
            s, t = max(e.time_range.start, a), min(e.time_range.end, b)
            if t <= s:
                continue
            spans.append((s, t))
            device_s[e.name] = device_s.get(e.name, 0.0) + (t - s) * 1e-6
            launches[e.name] = launches.get(e.name, 0) + 1
        if not spans:
            raise RuntimeError("the profiler saw no device activity")
        idle = [(host(s), host(t)) for s, t in gaps(spans, a, b)]
        return Trace(self.lo, self.hi, union_length(spans) * 1e-6, device_s,
                     launches, idle, time.perf_counter() - t0)

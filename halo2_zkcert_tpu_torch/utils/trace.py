"""The prover's span recorder: what the host was doing, on the clock on which
the benchmark places the device trace's idle gaps (`time.perf_counter`).

A span is a name, the proof it belongs to, its start and end on that clock,
optional counters and an optional device interval: two CUDA events recorded
on the device's current stream, resolved only when the records are read, so
nothing synchronises on the way.  Its parent (the innermost span that holds
it) and its self time (its seconds less its children's) are worked out when
the records are read.  Proof ids count `create_proof` calls: the id advances
when a call returns, so a span opened between two calls (the RSA witness
tape) belongs to the proof it feeds.

Recording is on while torch's profiler collects (the benchmark's traced
stretch) or while H2T_PROFILE or H2T_PROFILE2 is set; where it is off, a site
costs one check of that.  Spans are kept in a bounded buffer and read with
`records()`.  A span with an `echo` prints `[<tag>] <label>: <s>` when it
ends under its knob, H2T_PROFILE's lines indented two spaces and
H2T_PROFILE2's four: the prover's and keygen's stage ticks, the witness
phases, the commitments and the quotient's sub-stages.

A composed circuit's witness (circuits/composed.py) records `replay`, one
phase-1 replay from the build pass's record, with the counters
`replay_rows` (tape rows re-evaluated) and `replay_cells` (builder cells
re-evaluated), and `witness_h2d`, the hand-over of a phase's columns to the
proving device, with a device interval; both sit inside the prover's
`witness` span.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import deque
from typing import NamedTuple

import torch

MAX_SPANS = 1 << 16
MAX_PROOFS = 1 << 12
_INDENT = {"H2T_PROFILE": "  ", "H2T_PROFILE2": "    "}

_spans: deque = deque(maxlen=MAX_SPANS)   # ended spans
_open: list = []                          # open `with` spans, innermost last
_proofs: dict = {}                        # proof id -> its counters
_proof = 0                                # the current or next proof's id
_timing = False                           # inside a `timed` call


def on() -> bool:
    """Whether the recorder records now."""
    return (torch.autograd._profiler_enabled()
            or bool(os.environ.get("H2T_PROFILE"))
            or bool(os.environ.get("H2T_PROFILE2")))


class Span:
    """One span; used as a `with` block (see `span`)."""
    __slots__ = ("name", "proof", "start", "end", "echo", "counters",
                 "events", "device_ms", "parent", "self_s")

    def __init__(self, name: str, echo=None, events=None):
        self.name, self.echo, self.events = name, echo, events
        self.proof = _proof
        self.start = self.end = None
        self.counters = self.device_ms = self.parent = self.self_s = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self):
        if self.events is not None:
            self.events[0].record()
        _open.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        if _open and _open[-1] is self:
            _open.pop()
        _end(self, t)
        return False


def _end(s: Span, t: float) -> None:
    s.end = t
    _spans.append(s)
    if s.echo is not None:
        knob, tag, label = s.echo
        if os.environ.get(knob):
            print(f"{_INDENT[knob]}[{tag}] {label}: {t - s.start:.3f}s",
                  flush=True)


_OFF = contextlib.nullcontext()


def span(name: str, echo: tuple | None = None, device=None):
    """A `with` block recorded as the span `name` (a no-op where recording
    is off).  echo: (knob, tag, label), the line printed at its end under
    the knob; device: a device whose current stream gets the span's device
    interval, where it is a CUDA device."""
    if not on():
        return _OFF
    events = None
    if device is not None and torch.device(device).type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    return Span(name, echo, events)


def traced(name: str):
    """Decorate a function so that each call is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def proving():
    """`create_proof`'s body as the span `prove`; the proof id advances at
    its end, whether recording or not."""
    global _proof
    try:
        with span("prove"):
            yield
    finally:
        _proof += 1


class Ticks:
    """Adjacent spans, one clock reading at each boundary: `tick(name)` ends
    the span begun at the last tick (or at construction), records it as
    `name` and returns its seconds; `[tag] name: <s>` prints under the
    knob.  Before the reading, `sync()` is called where it is given (the
    prover's stages), else `device` is synchronised under the knob."""

    def __init__(self, tag: str, knob: str, device=None, sync=None):
        self.tag, self.knob, self.sync = tag, knob, sync
        self.device = torch.device(device) if device is not None else None
        self.t = time.perf_counter()

    def __call__(self, name: str) -> float:
        if self.sync is not None:
            self.sync()
        elif (self.device is not None and self.device.type == "cuda"
              and os.environ.get(self.knob)):
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        secs = t - self.t
        if on():
            s = Span(name, (self.knob, self.tag, name))
            s.start = self.t
            _end(s, t)
        self.t = t
        return secs


def _add(d: dict, counts: dict) -> None:
    for k, v in counts.items():
        d[k] = d.get(k, 0) + v


def _proof_counters() -> dict:
    mine = _proofs.get(_proof)
    if mine is None:
        mine = _proofs[_proof] = {}
        if len(_proofs) > MAX_PROOFS:
            del _proofs[next(iter(_proofs))]
    return mine


def count(**counts) -> None:
    """Add to the current proof's counters and to the innermost open
    span's, where recording is on."""
    if not on():
        return
    _add(_proof_counters(), counts)
    if _open:
        if _open[-1].counters is None:
            _open[-1].counters = {}
        _add(_open[-1].counters, counts)


def timed(counter: str):
    """Decorate a function so that, where recording is on, the host seconds
    of each outermost call of a timed function add to the proof's
    `counter`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            global _timing
            if _timing or not on():
                return fn(*args, **kwargs)
            _timing = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _timing = False
                _add(_proof_counters(),
                     {counter: time.perf_counter() - t0})
        return inner
    return wrap


class Records(NamedTuple):
    spans: list       # Span, by start, with `parent`, `self_s`, `device_ms`
    proofs: dict      # proof id -> {counter: value}


def records() -> Records:
    """The spans in the buffer and each proof's counters.  Device intervals
    are resolved here (waiting for their end events), and their events
    dropped."""
    spans = sorted(_spans, key=lambda s: (s.start, -s.end))
    stack: list = []
    for s in spans:
        if s.events is not None:
            a, b = s.events
            b.synchronize()
            s.device_ms, s.events = a.elapsed_time(b), None
        while stack and stack[-1].end < s.end:
            stack.pop()
        s.parent = stack[-1] if stack else None
        s.self_s = s.seconds
        if s.parent is not None:
            s.parent.self_s -= s.seconds
        stack.append(s)
    return Records(spans, {k: dict(v) for k, v in _proofs.items()})


def reset() -> None:
    """Forget every span and counter; proof ids start again at 0."""
    global _proof
    _spans.clear()
    _open.clear()
    _proofs.clear()
    _proof = 0

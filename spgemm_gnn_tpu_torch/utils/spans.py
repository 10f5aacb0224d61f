"""Spans and counters of the program: where a train step's time goes, on the
host's clock and on the device's.

A span (`span(name)`) is a named interval of the program. It records its
start and end on the host clock (`time.perf_counter`), its parent and the
train step it belongs to (the `step` given, else its parent's). The parent
is the innermost span open on the span's thread; on a thread with none open
(autograd's worker thread, which runs the backward on the card) it is the
innermost span open on another thread: the one whose caller waits in
`backward`.

While recording, a span also enters `torch.autograd.profiler.
record_function(name)`, so that the profiler's Chrome trace shows it on the
device trace's own clock, and places a pair of timing events on the
current CUDA stream (none while the stream captures a CUDA graph). Their
interval is the span's device time, `device_ms`, read when the record is
(`record()`) if the end event is complete by then: after the program's
closing synchronise, outside the traced call, and with no synchronise of
this module's own.

Recording is on while `torch.profiler` records, or inside `recording()`.
When it is off, `span` returns a shared null context after one check, and
`count` does nothing. Set-up spans (`setup(name)`) record the host clock
always, so that a traced run can read the set-up it followed.

Counters (`count(name)`) count where the work happens, while recording:
`host_syncs` is every wait of the program on the device. The kernels'
launches are counted apart, always, by `kernels/_build.py::launches`.

The record: `record()` the finished spans, `counters`, `reset()` to clear
both; `device_ms(name)` and `host_s(name)` sum a span name's device
milliseconds or host seconds (`own=True`: its self time, the part of its
interval that no child span covers).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch

_profiler = torch.autograd.profiler
if hasattr(_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _profiler._is_profiler_enabled
else:
    _profiling = torch.autograd._profiler_enabled

_forced = 0                      # depth of `recording()` blocks
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_ids = itertools.count()
_open: list[Span] = []           # open spans of every thread, in order
_done: list[Span] = []           # finished spans, in order of ending
_pending: list[Span] = []        # finished spans whose events are unread
counters: collections.Counter = collections.Counter()


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    id: int
    parent: int | None           # the parent span's id
    step: int | None             # the train step it belongs to
    thread: int
    start: float                 # host clock, s
    end: float | None = None
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


def recording_now() -> bool:
    return bool(_forced) or _profiling()


@contextlib.contextmanager
def recording():
    """Record every span and counter inside the block, as under the
    profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def span(name: str, step: int | None = None):
    """A span of `name` while recording; otherwise a null context."""
    if not (_forced or _profiling()):
        return _OFF
    return _Open(name, step, True)


def setup(name: str):
    """A set-up span: its host clock always, the rest while recording."""
    return _Open(name, None, recording_now())


def count(name: str) -> None:
    if _forced or _profiling():
        with _lock:
            counters[name] += 1


def _cuda_events() -> bool:
    """Whether a span can place events: CUDA in use, and its current
    stream not capturing a graph."""
    return (torch.cuda.is_initialized()
            and not torch.cuda.is_current_stream_capturing())


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Open:
    __slots__ = ("name", "step", "full", "rec", "fn", "start_event")

    def __init__(self, name: str, step: int | None, full: bool):
        self.name, self.step, self.full = name, step, full
        self.fn = self.start_event = None

    def __enter__(self) -> Span:
        tid = threading.get_ident()
        with _lock:
            parent = next((s for s in reversed(_open) if s.thread == tid),
                          _open[-1] if _open else None)
            step = self.step
            if step is None and parent is not None:
                step = parent.step
            self.rec = Span(self.name, next(_ids),
                            None if parent is None else parent.id, step, tid,
                            0.0)
            _open.append(self.rec)
        if self.full:
            self.fn = _profiler.record_function(self.name)
            self.fn.__enter__()
            if _cuda_events():
                self.start_event = _event()
        self.rec.start = time.perf_counter()
        return self.rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        if self.start_event is not None:
            rec.events = (self.start_event, _event())
        rec.end = time.perf_counter()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        with _lock:
            _open.remove(rec)
            _done.append(rec)
            if rec.events is not None:
                _pending.append(rec)


def _resolve() -> None:
    """Read the device interval of each finished span whose end event is
    complete (no wait: `Event.query`)."""
    with _lock:
        still = []
        for s in _pending:
            start, end = s.events
            if end.query():
                s.device_ms = start.elapsed_time(end)
                s.events = None
            else:
                still.append(s)
        _pending[:] = still


def record() -> list[Span]:
    """The finished spans, in order of ending, their complete events
    read."""
    _resolve()
    with _lock:
        return list(_done)


def reset() -> None:
    """Forget the finished spans and the counters."""
    with _lock:
        _done.clear()
        _pending.clear()
        counters.clear()


def device_ms(name: str, spans: list[Span] | None = None) -> float | None:
    """The summed device ms of the spans named `name`, or None where none
    has a device interval."""
    got = [s.device_ms for s in (record() if spans is None else spans)
           if s.name == name and s.device_ms is not None]
    return sum(got) if got else None


def host_s(name: str, own: bool = False,
           spans: list[Span] | None = None) -> float | None:
    """The summed host seconds of the spans named `name` (with `own`,
    their self time), or None where there is none."""
    spans = record() if spans is None else spans
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    children = collections.defaultdict(list)
    if own:
        for s in spans:
            children[s.parent].append(s)
    total = 0.0
    for s in mine:
        total += s.end - s.start
        clipped = [(max(c.start, s.start), min(c.end, s.end))
                   for c in children[s.id]]
        total -= sum(b - a for a, b in _union([(a, b) for a, b in clipped
                                               if b > a]))
    return total


def _union(intervals):
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def under(spans: list[Span], *names: str) -> list[Span]:
    """The spans that have an ancestor named one of `names`."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        p = by_id.get(s.parent)
        while p is not None and p.name not in names:
            p = by_id.get(p.parent)
        if p is not None:
            out.append(s)
    return out

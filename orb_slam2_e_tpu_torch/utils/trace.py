"""Spans of the port's stages, stamped on the profiler's clock.

While a `torch.profiler` session records, `span(name)` keeps one record of
the stage it encloses: its name, its start and end (`time.time_ns()`, the
wall clock the profiler's events carry), the enclosing span and the id of
the frame the work is for. Otherwise it returns a shared no-op context
after one attribute read, so a run that nobody profiles pays nothing more.

The records stay in this module's memory and never enter the profiler's
event list. A `record_function` range would: the profiler mirrors it onto
the device's timeline, where a reader of the trace takes it for device
work. Laid over the profiler's events by time, a span tells which stage
issued each launch and each synchronizing call.

Names are dotted under the layer (`track.pose_lm` inside `track`); a
`wait.<site>` span encloses one explicit read of the device's results on
the host. The frame loop runs on one thread, and so do the spans.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18      # records kept; the oldest half goes when full


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: Optional[int]    # None while the span is open
    parent: int             # index in `spans()` of the enclosing span, or -1
    frame: int              # id of the frame the work is for, or -1


_records = []       # Span, in the order they opened
_base = 0           # the index of _records[0] since the recording began
_open = []          # (index, frame) of the open spans, innermost last
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "frame", "index", "parent", "t0_ns")

    def __init__(self, name: str, frame: Optional[int]):
        self.name = name
        self.frame = frame

    def __enter__(self):
        global _base
        if len(_records) >= CAPACITY:
            del _records[:CAPACITY // 2]
            _base += CAPACITY // 2
        self.parent, frame = _open[-1] if _open else (-1, -1)
        if self.frame is None:
            self.frame = frame
        self.index = _base + len(_records)
        _open.append((self.index, self.frame))
        self.t0_ns = time.time_ns()
        _records.append(Span(self.name, self.t0_ns, None, self.parent,
                             self.frame))
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _open.pop()
        k = self.index - _base
        if k >= 0:          # not dropped or cleared while it ran
            _records[k] = Span(self.name, self.t0_ns, t1, self.parent,
                               self.frame)
        return False


def span(name: str, frame: Optional[int] = None):
    """A context that records the stage `name` while a profiler records.
    `frame`: the id of the frame the work is for; None takes the enclosing
    span's (-1 outside every span)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, frame)


def spans() -> list:
    """The records, in the order the spans opened."""
    if not _base:
        return list(_records)
    return [s._replace(parent=max(s.parent - _base, -1)) for s in _records]


def clear():
    """Forget the records (spans open now are not recorded when they
    close)."""
    global _base
    _base += len(_records)
    del _records[:]


def within(t0_ns: int, t1_ns: int) -> list:
    """The closed records that lie wholly inside [t0_ns, t1_ns]; `parent`
    still indexes `spans()`, so -1 marks a root."""
    return [s for s in spans() if s.t1_ns is not None
            and t0_ns <= s.t0_ns and s.t1_ns <= t1_ns]


def _covered_ns(intervals, lo: int, hi: int) -> int:
    """The length of [lo, hi] that the union of `intervals` covers."""
    total, cur = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, cur), min(e, hi)
        if e > s:
            total += e - s
            cur = e
    return total


def summary(t0_ns: int = 0, t1_ns: int = 2 ** 63) -> dict:
    """{name: (count, total ms, self ms)} over the records that `within`
    gives; self ms is a span's time less what its child spans cover."""
    recs = spans()
    children = [[] for _ in recs]
    for s in recs:
        if s.parent >= 0 and s.t1_ns is not None:
            children[s.parent].append((s.t0_ns, s.t1_ns))
    out = {}
    for s, ch in zip(recs, children):
        if s.t1_ns is None or s.t0_ns < t0_ns or s.t1_ns > t1_ns:
            continue
        dt = s.t1_ns - s.t0_ns
        n, tot, own = out.get(s.name, (0, 0.0, 0.0))
        out[s.name] = (n + 1, tot + dt / 1e6,
                       own + (dt - _covered_ns(ch, s.t0_ns, s.t1_ns)) / 1e6)
    return out

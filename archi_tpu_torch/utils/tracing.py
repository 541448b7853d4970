"""Spans of the port's query path, kept in memory.

A span names one step of a layer (``store.bm25``, ``embed.readback``, ...)
and records its wall time on ``time.perf_counter_ns`` (the host clock a
benchmark's slice is taken on), the CPU time its thread spent inside it
(``time.thread_time_ns``: wall time minus CPU time is time off the CPU:
the interpreter lock, a blocking copy, sleep), its parent (the span open
on the same thread when it began) and attributes.  A span that blocks the
host until the device has finished carries ``wait=True``::

    from archi_tpu_torch.utils import tracing

    with tracing.span("embed.encode") as s:
        if s.recording:          # attributes that cost something
            s.set(lengths=[len(i) for i in id_lists])
        ...

Spans record

- after ``enable()`` (``enable(False)`` stops them);
- from import on when the environment sets ``ARCHI_TRACE=1``, for an
  operator who wants the spans of a whole run (read them with ``spans()``;
  the ring holds the newest ``CAPACITY``);
- while a ``torch.profiler`` records (torch's own flag
  ``torch.autograd.profiler._is_profiler_enabled``).  Then each span also
  enters ``torch.profiler.record_function("archi." + name)``, so it shows in
  the device trace on the profiler's clock.

Otherwise ``span`` reads two flags and returns one shared object that does
nothing: no clock read, no record, no ``record_function``.

Finished spans go to a bounded ring that counts what it drops.  Counts
stay in ``utils/metrics.METRICS``; this module has no exporter.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler

#: finished spans the ring holds: twice those of a 10 s slice of the hybrid
#: cell (about 16 batches a second of about 210 spans) and more
CAPACITY = 1 << 17


class Span(NamedTuple):
    """One finished span; times in ``perf_counter_ns`` nanoseconds."""

    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]   # the thread's CPU time inside; None if not taken
    attrs: dict

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def wait(self) -> bool:
        return bool(self.attrs.get("wait"))


class _Ring:
    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.added = 0

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.added = 0

    def add(self, record: Span) -> None:
        with self._lock:
            self.records.append(record)
            self.added += 1

    def dropped(self) -> int:
        with self._lock:
            return self.added - len(self.records)

    def snapshot(self) -> list:
        with self._lock:
            return list(self.records)


_RING = _Ring(CAPACITY)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_ON = os.environ.get("ARCHI_TRACE") == "1"


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Off:
    """What ``span`` returns while nothing records."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Live:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_cpu0",
                 "_annotation")
    recording = True

    def __init__(self, name: str, wait: bool, profiling: bool):
        self.name = name
        self.attrs = {"wait": True} if wait else {}
        self._annotation = (torch.profiler.record_function("archi." + name)
                            if profiling else None)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        # the wall clock's interval holds the annotation, whose time under
        # a profiler is the span's too, and the CPU clock's interval
        self.start_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__enter__()
        self._cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        cpu = time.thread_time_ns() - self._cpu0
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        end = time.perf_counter_ns()
        _stack().pop()
        _RING.add(Span(self.name, self.id, self.parent, threading.get_ident(),
                       self.start_ns, end, cpu, self.attrs))
        return False


def span(name: str, wait: bool = False):
    """A context manager around one step; ``wait=True`` marks a step that
    blocks the host until the device has finished."""
    profiling = _torch_profiler._is_profiler_enabled
    if not (_ON or profiling):
        return _OFF
    return _Live(name, wait, profiling)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Add a span timed elsewhere (no parent, no CPU time), if recording."""
    if _ON or _torch_profiler._is_profiler_enabled:
        _RING.add(Span(name, next(_IDS), None, threading.get_ident(),
                       start_ns, end_ns, None, attrs))


def enable(on: bool = True) -> None:
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    """Whether spans record now."""
    return _ON or _torch_profiler._is_profiler_enabled


def spans(t0: Optional[float] = None, t1: Optional[float] = None) -> list:
    """Finished spans that end in [t0, t1] (``time.perf_counter`` seconds;
    None leaves that side open), oldest first."""
    lo = None if t0 is None else int(t0 * 1e9)
    hi = None if t1 is None else int(t1 * 1e9)
    return [s for s in _RING.snapshot()
            if (lo is None or s.end_ns >= lo) and (hi is None or s.end_ns <= hi)]


def dropped() -> int:
    """Spans the ring has let go since it was last cleared."""
    return _RING.dropped()


def clear() -> None:
    """Empty the ring and zero its count of drops."""
    _RING.clear()

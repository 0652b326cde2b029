"""Spans and counters: the port's one in-program tracing.

    with span("train.forward") as s:
        ...
    s.ms  # the span's host milliseconds

A span always times itself, from two ``time.perf_counter_ns()`` reads; it
calls no CUDA event, no ``record_function`` and no sync. Only inside
``recording()`` does it also keep a ``Record`` (its parent is the span open
around it in the same thread; its ``step`` is its root's), and only there
does ``count(name, n)`` add to a counter:

    with recording() as rec:
        handles.step(...)
    rec.spans, rec.counters

On leaving ``recording()`` the stamps are moved onto the unix nanosecond
clock that torch.profiler's events carry (``trace_start_ns()`` plus an
event's offset), by one reading of both clocks taken when recording began,
so that spans and a profile share one timeline. Nothing is written out: the
records stay with the ``recording`` object until their reader takes them.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional


class Record(NamedTuple):
    id: int
    name: str
    parent: Optional[int]  # the id of the enclosing span in the same thread
    thread: int  # the thread's native id, as the profiler's events give it
    start_ns: int  # unix ns
    end_ns: int
    step: Optional[int]


class _Gathered:
    """What one ``recording()`` gathers: the raw spans (perf_counter ns), the
    counters, and each thread's stack of open spans."""

    def __init__(self):
        self.raw: list[tuple] = []
        self.counters: dict[str, int] = {}
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack


# the open recording, one a process: every span finds it without being handed it
_gathering: Optional[_Gathered] = None


class span:
    """A timed section of the program (see the module's docstring); ``step``
    names the step a root span stands for, and its children inherit it."""

    __slots__ = ("name", "step", "start", "end", "_into", "_id", "_parent")

    def __init__(self, name: str, step: Optional[int] = None):
        self.name, self.step = name, step

    def __enter__(self) -> "span":
        into = self._into = _gathering
        if into is not None:
            stack = into.stack()
            parent = stack[-1] if stack else None
            self._id = next(into.ids)
            self._parent = None if parent is None else parent._id
            if parent is not None:
                self.step = parent.step
            stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        into = self._into
        if into is not None:
            into.stack().pop()
            into.raw.append((self._id, self.name, self._parent, threading.get_native_id(),
                                self.start, self.end, self.step))
        return False

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while recording; nothing otherwise."""
    into = _gathering
    if into is not None:
        with into.lock:
            into.counters[name] = into.counters.get(name, 0) + n


class recording:
    """Records every span and counter of the process while open; on exit
    ``spans`` holds the records in order of their start, on the unix clock,
    and ``counters`` the counters. One recording at a time."""

    def __enter__(self) -> "recording":
        global _gathering
        if _gathering is not None:
            raise RuntimeError("spans are already being recorded")
        self.spans: list[Record] = []
        self.counters: dict[str, int] = {}
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        p1 = time.perf_counter_ns()
        self._offset_ns = unix - (p0 + p1) // 2
        _gathering = self._open = _Gathered()
        return self

    def __exit__(self, *exc) -> bool:
        global _gathering
        _gathering = None
        off = self._offset_ns
        self.spans = sorted((Record(i, name, parent, thread, s + off, e + off, step)
                             for i, name, parent, thread, s, e, step in self._open.raw),
                            key=lambda r: r.start_ns)
        self.counters = dict(self._open.counters)
        return False

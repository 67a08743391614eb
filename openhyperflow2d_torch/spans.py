"""Spans: named intervals of the port's host work, kept in memory.

``span(name, **attrs)`` is a context manager around one step of the
program (the span names are listed in README.md).  Recording is off by
default, and then ``span`` returns one shared null context after a single
flag check: it allocates nothing and calls nothing of torch.  ``enable()``
turns it on; each finished span is then a record (``records()``):

    name, id, parent (the id of the span it was opened in, or None),
    cycle (the solver's ``last_iter`` at the start of the outer cycle the
    span belongs to, None outside a cycle), start_ns, end_ns
    (``time.perf_counter_ns``), traced (a profiler was running), attrs

The records sit in a ring of ``CAPACITY`` spans that drops the oldest
(``dropped()`` counts them); nothing is written to disk.  While a
``torch.profiler`` runs, an enabled span also opens
``torch.profiler.record_function(name)``, so the span shows in the
profiler's timeline as a ``user_annotation`` on the device trace's
clock."""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 100_000

_on = False
_records: deque = deque(maxlen=CAPACITY)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Null:
    """The span of a disabled recorder: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _profiling() -> bool:
    return bool(getattr(_profiler, "_is_profiler_enabled", False))


class _Span:
    __slots__ = ("name", "attrs", "cycle", "id", "parent", "start_ns",
                 "traced", "_mark")

    def __init__(self, name: str, cycle, attrs: dict):
        self.name, self.cycle, self.attrs = name, cycle, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        if self.cycle is None and top is not None:
            self.cycle = top.cycle
        self.id = next(_ids)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        self.traced = _profiling()
        self._mark = None
        if self.traced:
            self._mark = torch.profiler.record_function(self.name)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mark is not None:
            self._mark.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        _local.stack.pop()
        rec = {"name": self.name, "id": self.id, "parent": self.parent,
               "cycle": self.cycle, "start_ns": self.start_ns,
               "end_ns": end_ns, "traced": self.traced,
               "attrs": self.attrs}
        global _dropped
        with _lock:
            if len(_records) == _records.maxlen:
                _dropped += 1
            _records.append(rec)
        return False


def span(name: str, cycle=None, **attrs):
    """A context manager that records ``name`` over its block when
    recording is on (``enable``); ``cycle`` marks the outer cycle, which
    the spans opened inside inherit."""
    if not _on:
        return NULL
    return _Span(name, cycle, attrs)


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def records() -> list:
    """The finished spans, oldest first."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """How many of the oldest spans the ring has dropped since ``reset``."""
    return _dropped


def reset() -> None:
    """Clear the records."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


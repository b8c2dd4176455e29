"""Spans and counters of the port's host path, off by default.

    from repro_torch import trace
    with trace.span("wmd.stage") as s:
        ...
        if s:                       # only while tracing is on
            s.set(docs=n)
            trace.add("h2d_pageable_bytes", a.nbytes)

``span(name)`` costs one flag test and returns a shared falsy no-op while
tracing is off; ``add(name, n)`` and ``on()`` the same. ``enable()`` turns
tracing on and clears what was recorded; ``records()`` reads it. A span
records ``(name, start_ns, end_ns, parent, request)`` plus its own ``id``
and attributes: ``parent`` is the id of the span open on the same thread
when it began (``None`` at a root) and ``request`` the id of that thread's
root span. Open spans live on a per-thread stack, so pool threads never
mix theirs. Times are ``time.perf_counter_ns()``, the clock of the
benchmark's call stamps.

These spans never reach ``torch.profiler``: a profiler range also lands on
the device's timeline, where it would read as device work.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

# spans kept after an enable(); later ones are counted as dropped
MAX_SPANS = 1 << 20

_on = False
_spans: list = []
_counters: dict = {}
_dropped = 0
_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None      # id of the span that caused it
    request: int            # id of its thread's root span
    id: int
    attrs: dict


class Records(NamedTuple):
    spans: tuple            # Span, in the order they began
    counters: dict
    dropped: int            # spans past MAX_SPANS, not kept


class _Off:
    """What ``span`` returns while tracing is off."""
    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "attrs")

    def __init__(self, name: str):
        self.name = name
        self.attrs = {}

    def __bool__(self):
        return True

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.request = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        global _dropped
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(Span(self.name, self.start_ns, end,
                                   self.parent, self.request, self.id,
                                   self.attrs))
            else:
                _dropped += 1
        return None


def span(name: str):
    """A context manager timing ``name``; falsy and inert while tracing is
    off."""
    if not _on:
        return _OFF
    return _Open(name)


def on() -> bool:
    """Is tracing on? (For work done only to fill a span's attributes.)"""
    return _on


def add(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def enable() -> None:
    """Turn tracing on and clear every span, counter and drop count."""
    global _on, _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays readable."""
    global _on
    _on = False


def records() -> Records:
    """A copy of what was recorded since the last ``enable()``."""
    with _lock:
        spans = sorted(_spans, key=lambda s: s.id)
        return Records(spans=tuple(s._replace(attrs=dict(s.attrs))
                                   for s in spans),
                       counters=dict(_counters), dropped=_dropped)

"""Host spans at the port's layer boundaries, off unless a caller turns
them on.

``with span(name, batch):`` marks one phase of one batch: the engine's
``engine.prepare``, ``engine.launch``, ``engine.complete`` and its child
``engine.results``, the model's ``model.backbone`` and ``model.head``, and
the head's ``head.merge``.  There are no spans per request.

Off (the default), :func:`span` returns one shared no-op context manager
after a single check of a module global: it records nothing and
allocates nothing.  After :func:`enable` each span records a
:class:`Span`: its name, its start and end on ``time.monotonic_ns()``'s
clock, the name of the span that encloses it on the same thread (the
router runs each engine on its own worker thread, so spans never nest
across threads), the thread's native id and the batch index it was given.
At most :data:`CAPACITY` spans are kept; the oldest go first and are
counted.

:func:`enable` also reads ``time.monotonic_ns()`` and ``time.time_ns()``
back to back and keeps the pair: a profiler trace stamps its events in
Unix ns, so ``t + clock[1] - clock[0]`` puts a span's time ``t`` on the
trace's clock.  :func:`take` hands over the spans, the clock pair and the
count dropped, and clears them; :func:`disable` turns recording off.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int
    batch: Optional[int]


class Taken(NamedTuple):
    spans: List[Span]
    clock: Tuple[int, int]          # (monotonic ns, Unix ns), read together
    dropped: int


_on = False
_clock = (0, 0)
_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_lock = threading.Lock()
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "batch", "start_ns", "parent", "stack")

    def __init__(self, name: str, batch: Optional[int]):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        self.stack = stack
        stack.append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        self.stack.pop()
        if _on:
            _record(Span(self.name, self.start_ns, end, self.parent,
                         threading.get_native_id(), self.batch))
        return False


def _record(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) == CAPACITY:
            _dropped += 1
        _spans.append(s)


def span(name: str, batch: Optional[int] = None):
    """A context manager that records the span while tracing is on."""
    if not _on:
        return _OFF
    return _On(name, batch)


def enable() -> None:
    """Start recording, from no spans, and read the clock pair."""
    global _on, _clock, _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
        _clock = (time.monotonic_ns(), time.time_ns())
        _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> Taken:
    """The spans recorded since :func:`enable` or the last take, oldest
    first, with the clock pair and the count dropped; clears both."""
    global _dropped
    with _lock:
        out = Taken(list(_spans), _clock, _dropped)
        _spans.clear()
        _dropped = 0
    return out

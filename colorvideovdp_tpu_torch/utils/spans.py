"""Spans of the port's steps, recorded while ``torch.profiler`` runs.

``span(name, **attrs)`` is a context manager around one step of a request.
When the profiler is off on the calling thread it returns one shared no-op
(``OFF``) and records nothing: there is nothing to switch on besides the
profiler itself. When it is on, the span goes into an in-memory list
(``recorded()``) with its ``name``, its ``start`` and ``end`` from
``time.time_ns()`` (the clock of the profiler's events, so of the device
trace), its thread, the ``index`` of its ``parent`` (the innermost span
open on that thread, -1 for none), the ``request`` id that every span of one
request shares (a span opened with no parent starts a new request), and
``attrs``, the counts taken at that boundary (bytes, frames, ...).

The spans in ``LEAVES`` never hold another span; they also open a
``record_function`` of their name, so that a profile's timeline labels its
host time by the port's step. Enclosing spans stay in memory only, so that
they never mask their children in the profile.

The profiler's state is per thread. Work handed to another thread takes
its submitter's state along: ``carried(fn)`` (or ``carry()`` and
``resume(state)``) gives the worker the submitter's on/off state, request
and parent, so the worker's spans are recorded although the profiler reads
off there.

The list holds at most ``MAX_SPANS``; beyond that the oldest are dropped
and counted (``dropped()``). ``clear()`` empties it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.profiler import record_function

MAX_SPANS = 1 << 18

LEAVES = frozenset({
    "cvvdp.relayout", "cvvdp.read", "cvvdp.prefetch_submit", "cvvdp.prefetch_wait",
    "cvvdp.upload", "cvvdp.ingest", "cvvdp.pyramid", "cvvdp.bands", "cvvdp.baseband",
    "cvvdp.readback", "cvvdp.ml.head", "cvvdp.heatmap"})

_profiler_enabled = torch.autograd._profiler_enabled
_tls = threading.local()
_lock = threading.Lock()
_spans: deque = deque(maxlen=MAX_SPANS)
_count = 0  # spans recorded since the last clear()
_requests = itertools.count()
# Threads inside ``resume`` with a state. A thread-local lookup of a missing
# attribute costs several times the profiler's test, so the off path reads
# this count first.
_carrying = 0


class Span:
    """One recorded span; ``end`` is None while it is open."""

    __slots__ = ("index", "name", "start", "end", "thread", "parent", "request", "attrs")

    def __repr__(self):
        return (f"Span({self.index}, {self.name!r}, parent={self.parent}, "
                f"request={self.request}, {self.attrs})")


class _Off:
    """The shared no-op span of a thread whose profiler is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Open:
    __slots__ = ("span", "_rf")

    def __init__(self, name, attrs):
        s = self.span = Span()
        s.name, s.attrs, s.end = name, attrs, None
        self._rf = None

    def set(self, **attrs):
        """Counts known only once the step has begun."""
        self.span.attrs.update(attrs)

    def __enter__(self):
        global _count
        s, st = self.span, _stack()
        if st:
            s.parent, s.request = st[-1].index, st[-1].request
        else:
            carried = getattr(_tls, "carried", None)
            s.parent, s.request = carried if carried is not None else (-1, None)
            if s.request is None:
                s.request = next(_requests)
        s.thread = threading.get_ident()
        with _lock:
            s.index = _count
            _count += 1
            _spans.append(s)
        st.append(s)
        s.start = time.time_ns()
        if s.name in LEAVES and _profiler_enabled():
            self._rf = record_function(s.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        s = self.span
        s.end = time.time_ns()
        st = _stack()
        if st and st[-1] is s:
            st.pop()
        elif s in st:  # closed out of order (a generator closed late)
            st.remove(s)
        return False


def _on() -> bool:
    return _profiler_enabled() or (_carrying > 0 and getattr(_tls, "carried", None) is not None)


def span(name: str, **attrs):
    """A context manager around one step: ``OFF`` with the profiler off on
    this thread (and nothing carried to it), else a recorded span whose
    ``set(**attrs)`` adds counts."""
    if _profiler_enabled() or (_carrying > 0 and getattr(_tls, "carried", None) is not None):
        return _Open(name, attrs)
    return OFF


class _Joined:
    """An open span entered again: neither opens nor closes it."""

    __slots__ = ("span",)

    def __init__(self, s):
        self.span = s

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        self.span.attrs.update(attrs)


def request(name: str):
    """``span(name)``, unless a span of that name is already open on this
    thread: then that span, so that an entry point called by another opens
    its request's root once."""
    if not _on():
        return OFF
    for s in reversed(_stack()):
        if s.name == name:
            return _Joined(s)
    return _Open(name, {})


def inside(name: str) -> bool:
    """Whether a span of that name is open on this thread."""
    return _on() and any(s.name == name for s in _stack())


def carry():
    """This thread's spans' state for work done elsewhere: None with the
    profiler off, else (parent index, request) of the innermost open span."""
    if not _on():
        return None
    st = _stack()
    if st:
        return st[-1].index, st[-1].request
    return getattr(_tls, "carried", None) or (-1, None)


class resume:
    """Spans on this thread as ``carry()`` found them on the thread that
    called it; no-op for None."""

    __slots__ = ("state", "saved")

    def __init__(self, state):
        self.state = state

    def __enter__(self):
        global _carrying
        if self.state is not None:
            self.saved = getattr(_tls, "carried", None)
            _tls.carried = self.state
            with _lock:
                _carrying += 1
        return self

    def __exit__(self, *exc):
        global _carrying
        if self.state is not None:
            _tls.carried = self.saved
            with _lock:
                _carrying -= 1
        return False


def carried(fn):
    """``fn`` run under this thread's ``carry()`` state wherever it is
    called; ``fn`` itself with the profiler off."""
    state = carry()
    if state is None:
        return fn

    def run(*args, **kwargs):
        with resume(state):
            return fn(*args, **kwargs)

    return run


def recorded() -> list:
    """The recorded spans, oldest first (open ones with ``end`` None)."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans dropped since the last ``clear()`` to keep ``MAX_SPANS``."""
    with _lock:
        return _count - len(_spans)


def clear():
    global _count
    with _lock:
        _spans.clear()
        _count = 0

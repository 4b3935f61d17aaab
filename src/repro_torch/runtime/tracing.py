"""The port's own spans and counters, recorded while a profiler records.

Tracing is on exactly while a ``torch.profiler.profile`` (or
``torch.autograd.profiler.profile``) is recording: :func:`enabled` is the
profiler's own state, one call into torch, and nothing else turns tracing
on or off.  Every boundary of the port checks it once; with no profiler
running that check is all a boundary costs.

* :func:`span` — ``with span("fft.call"):`` or ``@span("conv.fft_conv")``.
  Off, it returns a shared null context (one per name, made once) and
  records nothing.  On, it opens a profiler range ``repro_torch.<name>``
  whose arguments carry the request id and the span's sequence number (the
  trace shows them where the profiler records shapes), and appends a
  :class:`Span` — name, start and end on the host's monotonic clock (the
  profiler's clock), the index of the span that encloses it and the
  request id — to the in-memory record.
* :func:`count` — ``count(name, n)``: counters, kept only while tracing is
  on, so a profiler session's counts are that session's.
* :func:`request` — a request's scope: every span opened inside carries
  the id it takes from a process-wide counter.
* :func:`record` — the spans and counters of the latest profiler session.
  The record is emptied when a boundary finds the profiler recording after
  it was seen off, at a boundary or by :func:`record`; it holds at most
  :data:`MAX_SPANS` spans and counts those it drops.
* :func:`self_ms` and :func:`inclusive_ms` — time by span name.

Names follow the sites of :mod:`repro_torch.core.faults` (``serve.prefill``,
``kernel.<COUNTS key>``).  The ranges are ``repro_torch.*``, named after
the package that records them: never ``pb.*`` (a benchmark's own ranges)
nor ``cu*`` (the CUDA runtime's calls).  The record is the process's, as
the kernel modules' ``COUNTS`` are: spans are recorded from one thread at
a time.
"""

from __future__ import annotations

import functools
import itertools
import time
from array import array
from typing import NamedTuple, Optional

import torch

__all__ = [
    "PREFIX",
    "MAX_SPANS",
    "Span",
    "Record",
    "enabled",
    "span",
    "count",
    "request",
    "record",
    "self_ms",
    "inclusive_ms",
]

#: The prefix of every profiler range the port opens.
PREFIX = "repro_torch."
#: The most spans one record holds; later ones are counted in ``dropped``.
MAX_SPANS = 1 << 20

#: Whether a profiler is recording (torch's own flag, read in C++).
enabled = torch._C._autograd._profiler_enabled

# A profiler range that carries keyword arguments into the trace and has no
# device-side copy (``record_function``'s user ranges gain one).
_RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    #: -1 while the span is open.
    end_ns: int
    #: The index in :attr:`Record.spans` of the enclosing span; -1 for a root.
    parent: int
    request_id: Optional[int]


class Record(NamedTuple):
    spans: tuple
    counters: dict
    #: Spans not recorded because the record was full.
    dropped: int


class _State:
    """The process's record and the scope of the span and request now open."""

    def __init__(self):
        #: Whether the record belongs to the session now recording (False
        #: once a boundary or :func:`record` has seen the profiler off).
        self.live = False
        self.generation = 0
        self.request: Optional[int] = None
        self._empty()

    def _empty(self) -> None:
        # A span's fields, one column each: a span leaves behind no object
        # the garbage collector tracks, so a long record triggers no
        # collection inside the work it times.
        self.names: list = []
        self.starts, self.ends = array("q"), array("q")
        self.parents, self.requests = array("q"), array("q")  # request -1: none
        self.counters: dict = {}
        self.dropped = 0
        #: The index of the innermost open span (-1: none, or a dropped one).
        self.top = -1

    def resume(self) -> None:
        """A new profiler session: a new, empty record."""
        self.live = True
        self.generation += 1
        self._empty()


_STATE = _State()
_REQUEST_IDS = itertools.count(1)


class _Span:
    """A span while tracing is on (made by :func:`span`)."""

    __slots__ = ("name", "attrs", "_range", "_at", "_parent", "_gen")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _STATE
        at, rid = len(st.names), st.request
        self._parent, self._gen = st.top, st.generation
        if at < MAX_SPANS:
            st.names.append(self.name)
            st.starts.append(0)
            st.ends.append(-1)  # open: filled at the exit
            st.parents.append(st.top)
            st.requests.append(-1 if rid is None else rid)
        else:
            at = -1
            st.dropped += 1
        self._at = st.top = at
        args = {"seq": at} if rid is None else {"seq": at, "request": rid}
        if self.attrs:
            args.update(self.attrs)
        self._range = _RANGE(PREFIX + self.name, (), args)
        self._range.__enter__()
        if at >= 0:
            st.starts[at] = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        self._range.__exit__(None, None, None)
        st = _STATE
        if self._gen == st.generation:  # not opened in an earlier session
            st.top = self._parent
            if self._at >= 0:
                st.ends[self._at] = end
        return False

    def __call__(self, fn):
        return _decorated(self.name, self.attrs, fn)


class _Null:
    """A span while tracing is off: records nothing."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorated(self.name, self.attrs, fn)


_NULLS: dict = {}


def _decorated(name: str, attrs: dict, fn):
    """``fn`` inside a span ``name`` at each call."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not enabled():
            _STATE.live = False
            return fn(*args, **kwargs)
        with _opened(name, attrs):
            return fn(*args, **kwargs)

    return run


def _null(name: str, attrs: dict) -> _Null:
    if attrs:
        return _Null(name, attrs)
    null = _NULLS.get(name)
    if null is None:
        null = _NULLS[name] = _Null(name, {})
    return null


def span(name: str, **attrs):
    """A span ``name`` at a boundary of the port, as a context manager or a
    decorator; ``attrs`` (ints, floats or strings) go to the range's
    arguments.  Directly inside a span of the same name (``execute_plan``
    walking its program, a composed plan's halves) it records nothing: the
    outer span holds the work."""
    if not enabled():
        _STATE.live = False
        return _null(name, attrs)
    return _opened(name, attrs)


def _opened(name: str, attrs: dict):
    """:func:`span` while tracing is on."""
    st = _STATE
    if not st.live:
        st.resume()
    if st.top >= 0 and st.names[st.top] == name:
        return _null(name, attrs)
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    st = _STATE
    if not enabled():
        st.live = False
        return
    if not st.live:
        st.resume()
    st.counters[name] = st.counters.get(name, 0) + n


class _Request:
    __slots__ = ("id", "_outer")

    def __init__(self):
        self.id = next(_REQUEST_IDS)

    def __enter__(self) -> int:
        self._outer, _STATE.request = _STATE.request, self.id
        return self.id

    def __exit__(self, *exc):
        _STATE.request = self._outer
        return False


def request() -> _Request:
    """The scope of one request: ``with request() as rid:``, the id taken
    from a process-wide counter whether or not tracing is on."""
    return _Request()


def record() -> Record:
    """The spans (a span still open ends at -1) and counters of the latest
    profiler session.  Two sessions with neither a boundary of the port nor
    a call of this function between them read as one."""
    st = _STATE
    if not enabled():
        st.live = False
    spans = tuple(Span(name, start, end, parent, None if rid < 0 else rid)
                  for name, start, end, parent, rid in zip(st.names, st.starts, st.ends, st.parents, st.requests))
    return Record(spans=spans, counters=dict(st.counters), dropped=st.dropped)


def _closed(rec: Record):
    return [s for s in rec.spans if s.end_ns >= 0]


def _ancestors(spans, s: Span):
    at = s.parent
    while at >= 0:
        s = spans[at]
        yield s
        at = s.parent


def inclusive_ms(rec: Record, under: Optional[str] = None) -> dict:
    """Milliseconds by span name, each span's children included.  A span
    inside another of its own name counts with the outer one only.
    ``under``: only the spans inside a span of that name."""
    spans, out = rec.spans, {}
    for s in _closed(rec):
        names = {a.name for a in _ancestors(spans, s)}
        if s.name in names or (under is not None and under not in names):
            continue
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return out


def self_ms(rec: Record) -> dict:
    """Milliseconds by span name, each span's duration less the part of it
    its child spans cover."""
    spans = rec.spans
    covered = [0] * len(spans)
    for s in _closed(rec):
        if s.parent >= 0:
            covered[s.parent] += s.end_ns - s.start_ns
    out = {}
    for i, s in enumerate(spans):
        if s.end_ns >= 0:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns - covered[i]) / 1e6
    return out

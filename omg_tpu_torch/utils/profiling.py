"""Request tracing and metrics (port of ``omg_tpu/utils/profiling.py``).

A top-level call (``OMG.generate``, ``OMG.generate_batch``,
``sdxl.text_to_image``) is one request: ``request(name, device)``, or
the decorator ``requested``, opens its root span, and every ``span``
(or ``spanned`` function) opened under it on the same thread
joins its tree (a top-level call made inside another is a span of the
outer request). A span records its name, its id and its parent's (its
index in ``Request.spans``), its attributes, and its host start and end
from ``time.time_ns()``, the clock of the profiler's timestamps.

  * A *timed* span also records a CUDA event on the request's stream at
    each end (on a card). ``Request.resolve`` turns each pair into the
    span's device ns (``Span.device_ns``) when something first reads
    them, waiting on the request's last event; the hot path gains no
    synchronize.
  * ``count`` adds to a counter of the innermost open span; ``sync`` runs
    a blocking host-device operation and counts it there as ``sync``,
    with the host's wait in it as ``sync_wait_ns``. Inside ``recorded``
    (a CUDA graph's capture) the counts are kept aside for the replays.
  * ``Phases`` ends each phase of a request with the device idle and
    adds up its host seconds on the monotonic clock
    (``GenerationResult.timings``); ``steps`` is every denoise loop's
    range of ``step`` spans.
  * When the call ends, even by an exception, its ``Request`` joins
    ``REQUESTS`` (the last 64), in memory only.
  * While a ``torch.profiler`` records, every span is also a
    ``record_function`` range; otherwise a span costs two clock reads
    and a list append.

``trace(name)`` is the server's span of a whole call, also recorded in
``METRICS``, the process-local counters and bounded latency records the
server reports at ``/metrics``.

The JAX module's ``start_server`` (the XLA profiler server) and
``compiled_peak_bytes`` (XLA's memory analysis of a compiled program)
have no counterpart: torch compiles no whole program ahead of time, and
``torch.cuda.max_memory_allocated`` reads the peak directly.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import statistics
import threading
import time
from typing import Dict, Optional

import torch


class Metrics:
    """Thread-safe counters and latency records. Each timing keeps its
    most recent ``max_samples`` values, so a long-lived server neither
    leaks nor sorts an ever-growing list on each scrape."""

    def __init__(self, max_samples: int = 4096):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.timings: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=max_samples))

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def record(self, name: str, seconds: float):
        with self._lock:
            self.timings[name].append(seconds)

    def summary(self) -> dict:
        with self._lock:
            out = {"counters": dict(self.counters), "latency": {}}
            for name, vals in self.timings.items():
                if not vals:
                    continue
                s = sorted(vals)
                out["latency"][name] = {
                    "n": len(s),
                    "p50": statistics.median(s),
                    "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                    "mean": sum(s) / len(s),
                }
            return out


METRICS = Metrics()

# The records of the last requests, oldest first.
REQUESTS: collections.deque = collections.deque(maxlen=64)
_IDS = itertools.count(1)
_LOCAL = threading.local()


class Span:
    """One span of a request. ``t0``/``t1``: host ns (``time.time_ns``);
    ``device_ns``: the ns between its CUDA events once resolved, None for
    an untimed span or off a card; ``counters``: what
    ``count`` and ``sync`` added while it was the innermost open span."""

    __slots__ = ("name", "span_id", "parent", "attrs", "t0", "t1",
                 "counters", "events", "device_ns")

    def __init__(self, name: str, span_id: int, parent: Optional[int],
                 attrs: dict):
        self.name, self.span_id, self.parent = name, span_id, parent
        self.attrs = attrs
        self.t0 = self.t1 = None
        self.counters: Dict[str, int] = {}
        self.events = self.device_ns = None


class Request:
    """The record of one top-level call: ``rid``, and its spans in the
    order they opened, the root first."""

    def __init__(self, device=None):
        self.rid = next(_IDS)
        self.spans: list = []
        self.open: list = []                # the open spans, innermost last
        self.stream = self._last = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)

    @property
    def root(self) -> Span:
        return self.spans[0]

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self._last = ev
        return ev

    def begin(self, name: str, timed: bool, attrs: dict) -> Span:
        s = Span(name, len(self.spans),
                 self.open[-1].span_id if self.open else None, attrs)
        if timed and self.stream is not None:
            s.events = [self._event(), None]
        s.t0 = time.time_ns()
        self.spans.append(s)
        self.open.append(s)
        return s

    def end(self, s: Span) -> None:
        if s.t1 is not None:                # ended with its request
            return
        if s.events is not None:
            s.events[1] = self._event()
        s.t1 = time.time_ns()
        if self.open[-1] is s:
            self.open.pop()
        else:
            self.open.remove(s)

    def close(self) -> None:
        """End every span still open, the innermost first."""
        for s in reversed(list(self.open)):
            self.end(s)

    def resolve(self) -> "Request":
        """Put the ns between each timed span's events in its
        ``device_ns``, after waiting for the last of them, and drop the
        events."""
        if self._last is None:
            return self
        self._last.synchronize()
        for s in self.spans:
            if s.events is not None and s.events[1] is not None:
                s.device_ns = round(s.events[0].elapsed_time(s.events[1])
                                    * 1e6)
            s.events = None
        self._last = self.stream = None
        return self

    def children(self, span: Span, name: Optional[str] = None) -> list:
        return [s for s in self.spans[span.span_id + 1:]
                if s.parent == span.span_id and name in (None, s.name)]

    def total(self, span: Span, key: str) -> int:
        """``key``'s count in ``span`` and every span under it."""
        under, n = {span.span_id}, 0
        for s in self.spans[span.span_id:]:
            if s.span_id == span.span_id or s.parent in under:
                under.add(s.span_id)
                n += s.counters.get(key, 0)
        return n


def _range(name: str):
    """A ``record_function`` range entered, while a profiler records."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class span:
    """A span of this thread's open request (none outside one), and a
    profiler range while a profiler records. ``timed``: CUDA events at
    both ends; ``attrs``: the span's attributes. ``with`` gives the
    ``Span``, or None outside a request."""

    __slots__ = ("name", "timed", "attrs", "_req", "_span", "_rf")

    def __init__(self, name: str, *, timed: bool = False, **attrs):
        self.name, self.timed, self.attrs = name, timed, attrs

    def __enter__(self) -> Optional[Span]:
        self._rf = _range(self.name)
        req = self._req = getattr(_LOCAL, "request", None)
        self._span = (req.begin(self.name, self.timed, self.attrs)
                      if req is not None else None)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._span is not None:
            self._req.end(self._span)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        return False


def spanned(name: str, *, timed: bool = False):
    """A decorator: every call of the function inside a ``span``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, timed=timed):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def request(name: str, device=None):
    """The root span of a top-level call on ``device``; when the call ends
    its ``Request`` joins ``REQUESTS``. Inside another request on this
    thread it is a span of that one."""
    if getattr(_LOCAL, "request", None) is not None:
        with span(name):
            yield
        return
    req = Request(device)
    rf = _range(name)
    req.begin(name, False, {})
    _LOCAL.request = req
    try:
        yield
    finally:
        _LOCAL.request = None
        req.close()
        if rf is not None:
            rf.__exit__(None, None, None)
        REQUESTS.append(req)


def requested(name: str, device):
    """A decorator: every call of the function is a ``request(name, d)``,
    ``d = device(*args, **kwargs)`` of the call's arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with request(name, device(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` in the innermost open span (in the block's
    record inside ``recorded``)."""
    kept = getattr(_LOCAL, "recorded", None)
    if kept is not None:
        kept[name] = kept.get(name, 0) + n
        return
    req = getattr(_LOCAL, "request", None)
    if req is not None and req.open:
        c = req.open[-1].counters
        c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def recorded():
    """The block's ``count``s on this thread, {name: n}, left out of every
    span: a CUDA graph's capture runs nothing, and each replay counts
    them."""
    outer = getattr(_LOCAL, "recorded", None)
    _LOCAL.recorded = kept = {}
    try:
        yield kept
    finally:
        _LOCAL.recorded = outer


def sync(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a blocking host-device operation (a copy
    between host and card, which first waits for the card's queue to
    drain), counted as ``sync`` in the innermost open span, with the
    host's wait in it added to that span's ``sync_wait_ns``. ``fn`` is
    the torch function or bound method itself, so that CUDA's sync debug
    mode finds the call in this module."""
    t0 = time.perf_counter_ns()
    out = fn(*args, **kwargs)
    req = getattr(_LOCAL, "request", None)
    if req is not None and req.open:
        c = req.open[-1].counters
        c["sync"] = c.get("sync", 0) + 1
        c["sync_wait_ns"] = (c.get("sync_wait_ns", 0)
                             + time.perf_counter_ns() - t0)
    return out


def steps(i0: int, i1: int):
    """``range(i0, i1)``, each step inside a timed ``step`` span (attribute
    ``step``): the loop of every denoise loop."""
    for i in range(i0, i1):
        with span("step", timed=True, step=i):
            yield i


class Phases:
    """A request's phases as consecutive spans: ``next(name)`` ends the
    current phase, with the device idle (a synchronize on a card), and
    opens ``name``; ``end()`` ends the last. ``timings``: each name's host
    seconds (``time.perf_counter_ns``), summed over its phases."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.timings: dict = {}
        self._cur = None

    def next(self, name: str, *, timed: bool = False) -> None:
        self.end()
        self._cur = span(name, timed=timed)
        self._cur.__enter__()
        self._t0 = time.perf_counter_ns()

    def end(self) -> None:
        if self._cur is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        cur, self._cur = self._cur, None
        cur.__exit__(None, None, None)
        self.timings[cur.name] = (self.timings.get(cur.name, 0.0)
                                  + (t1 - self._t0) / 1e9)


@contextlib.contextmanager
def trace(name: str, metrics: Optional[Metrics] = None):
    """A span around a block and a host-clock record of it; recorded in a
    finally so that failing requests still contribute samples."""
    m = metrics or METRICS
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        m.record(name, time.perf_counter() - t0)

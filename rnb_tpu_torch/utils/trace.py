"""Spans and counters at the program's layer boundaries, on the profiler's
clock.

    from rnb_tpu_torch.utils import trace

    with trace.span("step.forward"):            # a layer boundary
        ...
    with trace.span("runner.step", request=("step", it)):  # its unit of work
        ...
    @trace.spanned("io.write_ply")              # the decorator form
    trace.count("bytes_to_host", n)             # a counter, under the open span
    trace.wait("runner.fetch.wait", device)     # the card's wait, timed apart

Off (the default) ``span`` returns the one shared ``NULL`` context after one
check of a module flag and of ``torch.autograd.profiler._is_profiler_enabled``:
no clock read, no allocation, no ``record_function``; ``count`` and ``wait``
do nothing. On is inside ``recording()`` or while a ``torch.profiler``
records. A span then keeps its name, start and end (``time.perf_counter_ns``),
its parent span and its request id in a bounded buffer (``MAX_SPANS``; what
does not fit is counted as dropped). Under a profiler it also opens
``torch.profiler.record_function("rnb::<name>")``, so that it lies in the
profiler's Chrome trace beside the kernels it launched, on the same clock.

Each thread keeps its own stack of open spans: the backward runs on
autograd's device thread. A span opened on a thread with no open span takes
as parent the innermost open span of the thread that opened the newest
request span (the step's ``step.backward`` for the ops' backward spans), and
a span without a request id takes its parent's, on any thread. A request id
names its kind and its number: ``("step", it)`` in training, ``("frame", n)``
in ``render_novel_image`` and ``("mesh", n)`` in ``validate_mesh``.

A recording starts on entering ``recording()``, or under a profiler
at the first span or count after the last recording ended; it empties the
buffer and notes ``_build.launches``. A profiler's recording ends at the first
``summary()`` after the profiler stopped; the buffer stays readable until
the next recording starts. ``summary()`` gives, per span name, the calls, the
total and the self seconds (the total less the part of each call that its
children cover) and the counters counted under it, then all counters, the
launches of the port's kernels since the recording started and the spans
dropped.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "rnb::"
MAX_SPANS = 1 << 18

# inside recording()
_on = False


class _Null:
    """The context ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _launches() -> dict:
    from rnb_tpu_torch.ops import _build
    return dict(_build.launches)


class _Span:
    __slots__ = ("rec", "name", "request", "id", "parent", "t0", "rf",
                 "counts", "stack", "owner")

    def __init__(self, rec, name: str, request):
        self.rec, self.name, self.request = rec, name, request
        self.counts = None

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        parent = stack[-1] if stack else (rec.owner[-1] if rec.owner else None)
        self.id = next(rec.ids)
        self.parent = parent.id if parent is not None else 0
        self.owner = rec.owner
        if self.request is not None:
            rec.owner = stack
        elif parent is not None:
            self.request = parent.request
        self.stack = stack
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.stack.pop()
        self.rec.owner = self.owner
        self.rec.add((self.id, self.name, self.t0, t1, self.parent,
                      self.request, self.counts))
        return False


def _covered(intervals, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] that the union of ``intervals`` covers."""
    total, end = 0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            total += e - s
            end = e
    return total


class Recorder:
    """The spans and counters of one recording."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self.lock = threading.Lock()
        self.local = threading.local()
        self.mode = None          # None, "recording" or "profiler"
        self.clear()

    def clear(self) -> None:
        self.spans = []           # (id, name, t0, t1, parent, request, counts)
        self.counters = {}
        self.dropped = 0
        self.ids = itertools.count(1)
        self.owner = None
        self.launches0 = {}

    def begin(self, mode: str) -> None:
        with self.lock:
            self.clear()
            self.launches0 = _launches()
            self.mode = mode

    def live(self) -> None:
        """Start a profiler's recording if none is live."""
        if self.mode is None:
            self.begin("profiler")

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, rec: tuple) -> None:
        if len(self.spans) < self.max_spans:
            self.spans.append(rec)
        else:
            self.dropped += 1

    def count(self, name: str, n) -> None:
        stack = self.stack()
        top = stack[-1] if stack else (self.owner[-1] if self.owner else None)
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if top is not None:
                if top.counts is None:
                    top.counts = {}
                top.counts[name] = top.counts.get(name, 0) + n

    def summary(self, request=None) -> dict:
        if self.mode == "profiler" and not _profiler._is_profiler_enabled:
            self.mode = None
        spans = list(self.spans)
        kids = {}
        for _, _, t0, t1, parent, _, _ in spans:
            if parent:
                kids.setdefault(parent, []).append((t0, t1))
        out, counters = {}, {}
        for sid, name, t0, t1, _, req, counts in spans:
            if request is not None and req != request:
                continue
            d = out.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0,
                                      "counters": {}})
            d["calls"] += 1
            d["total_s"] += (t1 - t0) * 1e-9
            d["self_s"] += (t1 - t0 - _covered(kids.get(sid, ()), t0, t1)) * 1e-9
            for k, v in (counts or {}).items():
                d["counters"][k] = d["counters"].get(k, 0) + v
                counters[k] = counters.get(k, 0) + v
        res = {"spans": out, "dropped": self.dropped}
        if request is None:
            now = _launches()
            res["counters"] = dict(self.counters)
            res["launches"] = {k: v - self.launches0.get(k, 0)
                               for k, v in now.items()
                               if v != self.launches0.get(k, 0)}
        else:
            res["counters"] = counters
        return res


_REC = Recorder()


def active() -> bool:
    """Whether spans record now."""
    return _on or _profiler._is_profiler_enabled


def _open(name: str, request):
    _REC.live()
    return _Span(_REC, name, request)


def span(name: str, request=None):
    """The context of span ``name`` (``request``: the unit of work it serves,
    inherited by its children); ``NULL`` while tracing is off."""
    if _on or _profiler._is_profiler_enabled:
        return _open(name, request)
    return NULL


def spanned(name: str):
    """Decorator: each call of the function runs inside span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _on or _profiler._is_profiler_enabled:
                with _open(name, None):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name``, and to it under the open span."""
    if _on or _profiler._is_profiler_enabled:
        _REC.live()
        _REC.count(name, n)


def wait(name: str, device) -> None:
    """While tracing is on, span ``name`` around a synchronise of ``device``
    (a card; on the CPU the span is empty): the copy after it is then timed
    apart from the wait for the work it needs. The device's timeline does
    not change, since the copy would wait for the same work. Off, nothing."""
    if _on or _profiler._is_profiler_enabled:
        with _open(name, None):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)


@contextlib.contextmanager
def recording():
    """Record the block in a recording of its own, with or without a
    profiler; ``summary()`` reads it after the block too."""
    global _on
    _REC.begin("recording")
    _on = True
    try:
        yield _REC
    finally:
        _on = False
        _REC.mode = None


def reset() -> None:
    """Empty the buffer and end the recording; the next profiler's starts
    afresh."""
    with _REC.lock:
        _REC.clear()
        _REC.mode = None


def summary(request=None) -> dict:
    """The recording's spans by name, its counters and launches (see the
    module's docstring); with ``request``, that request's spans and the
    counters counted under them only."""
    return _REC.summary(request)

"""Spans and counters of the request path, kept in memory.

A span times one step of a request at a layer boundary::

    with tracing.span("evaluator.dispatch"):
        ...

Recording is off by default, and then ``span`` returns the shared no-op
``NOOP`` after reading two flags. It is on while ``enable()`` holds, and
while a ``torch.profiler`` session runs in the process (torch's own fast flag
``torch.autograd.profiler._is_profiler_enabled``, the one its compiled
kernels read before they open a ``record_function``), so a profiled window
gets the program's spans with no change to its caller. That flag is
private to torch: where a torch lacks it, the first span warns
(``RuntimeWarning``) and only ``enable()`` turns recording on. A profiled
process that never drains keeps up to ``CAP`` spans (some 60 MB).

A recorded span is a ``Span``: its name, start and end on
``time.perf_counter_ns``, the thread it ran in, its own id, the id of the
span that was open in the same thread when it began (its parent, 0 for
none) and the id of the outermost of those (its root; its own id for a
root), so every span of one request shares the request's root id. A span
may carry one number, ``value`` (a scan launch's bytes read). At most
``CAP`` spans are kept; past that they are dropped and counted under
``spans.dropped``.

Counters are integers, kept always, whether recording is on or not: a
``busy(counter)`` block adds the wall time during which at least one
block of that counter is open in any thread (work that runs in several
threads at once counts once), ``add(counter, n)`` adds ``n``, and
``spans.dropped`` counts the spans past the cap.

``drain()`` returns the spans and counters kept so far and clears them
(``drain(clear=False)`` keeps them). Every call is safe from any thread.
Only the standard library is imported.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
import warnings
from typing import NamedTuple

CAP = 1 << 18           # a traced 10 s benchmark window records 10k-85k

_on = False
_lock = threading.Lock()
_spans: list = []
_counters: dict[str, int] = {}
_busy: dict[str, list] = {}     # counter -> [blocks open, ns of the first]
_ids = itertools.count(1)
_clock = time.perf_counter_ns
_thread = threading.get_ident
_new = object.__new__


class Span(NamedTuple):
    name: str
    start: int          # perf_counter_ns
    end: int
    thread: int         # threading.get_ident()
    id: int
    parent: int         # 0: opened with no span open in its thread
    root: int
    value: int = 0


class Record(NamedTuple):
    spans: list         # Span, in the order they ended
    counters: dict      # name -> int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _NoProfiler:
    _is_profiler_enabled = False


_profiler = None        # torch.autograd.profiler, once torch is loaded


def _torch_profiler():
    global _profiler
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None:
        return _NoProfiler
    if hasattr(prof, "_is_profiler_enabled"):
        _profiler = prof
    else:
        _profiler = _NoProfiler
        warnings.warn("torch.autograd.profiler has no _is_profiler_enabled: "
                      "a torch.profiler session no longer turns the "
                      "program's spans on, only tracing.enable() does",
                      RuntimeWarning, stacklevel=3)
    return _profiler


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_local = _Stack()


class _Open:
    __slots__ = ("name", "value", "start", "id", "parent", "root")

    def __enter__(self):
        stack = _local.open
        self.id = i = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.root = top.id, top.root
        else:
            self.parent, self.root = 0, i
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _local.open.pop()
        rec = (self.name, self.start, end, _thread(), self.id, self.parent,
               self.root, self.value)
        with _lock:
            if len(_spans) < CAP:
                _spans.append(rec)
            else:
                _counters["spans.dropped"] = (
                    _counters.get("spans.dropped", 0) + 1)
        return False


def span(name: str, value: int = 0):
    """A context manager timing ``name``; ``NOOP`` while recording is
    off."""
    if _on or (_profiler or _torch_profiler())._is_profiler_enabled:
        s = _new(_Open)         # no __init__ call: the on path's cost
        s.name, s.value = name, value
        return s
    return NOOP


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


class _Busy:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        with _lock:
            b = _busy.setdefault(self.name, [0, 0])
            if not b[0]:
                b[1] = _clock()
            b[0] += 1
        return self

    def __exit__(self, *exc):
        with _lock:
            b = _busy[self.name]
            b[0] -= 1
            if not b[0]:
                _counters[self.name] = (_counters.get(self.name, 0)
                                        + _clock() - b[1])
        return False


def add(counter: str, n: int = 1) -> None:
    """Adds ``n`` to ``counter``."""
    with _lock:
        _counters[counter] = _counters.get(counter, 0) + n


def busy(counter: str) -> _Busy:
    """A context manager adding to ``counter``, when the last open block
    of it closes, the nanoseconds since the first of them opened: the
    union of the blocks' times over every thread."""
    return _Busy(counter)


def drain(clear: bool = True) -> Record:
    """The spans and counters kept so far; both are cleared unless
    ``clear`` is false."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        if clear:
            _spans, _counters = [], {}
        else:
            spans, counters = list(spans), dict(counters)
    return Record([Span(*s) for s in spans], counters)

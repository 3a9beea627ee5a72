"""Counters, timers and the program's trace store.

The reference's only observability is printf lines (SURVEY.md section 5.1,
5.5).  Here: ``Metrics``, named counters and phase timers with aggregate
stats (``Optimizer.metrics`` keeps the always-on timers ``propose`` and
``rescore``), ``TRACE``, the ``Metrics`` that the program's spans and
counters record into, and ``LAUNCHES``, the always-on counts of the CUDA
kernels' launches and of the calls of the routes they replace.

``span(name)`` and ``count(name, n)`` record only while tracing is on:
while a torch.profiler profile records in this process (the CLI's
``--trace DIR`` runs the anneal under one).  A span then opens
``torch.profiler.record_function("gaml." + name)``, so an exported Chrome
trace shows it on the device operations' clock, and adds its call, its
total time and its self time (the total less what its child spans cover)
under its path: the names of the spans open on this thread, outermost
first, joined by "/".  While tracing is off, ``span`` returns one shared
no-op context manager and ``count`` returns at once.  Call neither inside
a per-walk, per-window or per-read loop: count into a local and record
once after it.

This module imports no torch: it finds the profiler's flag among the
loaded modules, so the host-only route never loads torch.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Dict, Optional, Tuple


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timers: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        # span path -> [calls, total ns, self ns]
        self.spans: Dict[str, list] = {}

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            agg = self.timers[name]
            agg[0] += dt
            agg[1] += 1

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()
        self.spans.clear()

    def span_stats(self, name: str,
                   under: Optional[str] = None) -> Tuple[int, float, float]:
        """(calls, total s, self s) of the spans named ``name``, summed over
        every path they were opened on; with ``under``, only those opened
        inside a span of that name."""
        calls = total = own = 0
        for path, (n, t, s) in self.spans.items():
            parts = path.split("/")
            if parts[-1] == name and (under is None or under in parts[:-1]):
                calls += n
                total += t
                own += s
        return calls, total / 1e9, own / 1e9

    def snapshot(self) -> dict:
        """Counters, timers (total s, calls) and spans (by path: name,
        parent path or None, calls, total s, self s), as plain data."""
        spans = {}
        for path, (n, t, s) in sorted(self.spans.items()):
            parent, _, name = path.rpartition("/")
            spans[path] = {"name": name, "parent": parent or None,
                           "calls": n, "total_s": t / 1e9, "self_s": s / 1e9}
        return {"counters": dict(self.counters),
                "timers": {k: {"total_s": t, "calls": n}
                           for k, (t, n) in self.timers.items()},
                "spans": spans}


TRACE = Metrics()

# Always on, by name: each kernel wrapper adds the launches it makes
# (``candgen_runs``, ``extend_exact``, ``seeds_count``, ...), and the
# CPU routes their calls (``query_plain``, ``gen_candidates``).  A name
# never counted reads 0; the CLI's ``device work`` line reports every
# name counted.
LAUNCHES = Counter()

_open = threading.local()  # .stack: this thread's open spans, innermost last
_profiler = None  # torch.autograd.profiler, once torch is loaded


def tracing() -> bool:
    """True while a torch.profiler profile records in this process."""
    global _profiler
    if _profiler is None:
        _profiler = sys.modules.get("torch.autograd.profiler")
        if _profiler is None:
            return False
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "path", "parent", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function

        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.path = self.name if self.parent is None else \
            self.parent.path + "/" + self.name
        self.child_ns = 0
        self.rf = record_function("gaml." + self.name)
        self.rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _open.stack.pop()
        self.rf.__exit__(*exc)
        agg = TRACE.spans.get(self.path)
        if agg is None:
            agg = TRACE.spans[self.path] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self.child_ns
        if self.parent is not None:
            self.parent.child_ns += dt
        return False


def span(name: str):
    """A context manager that records the span ``name`` into TRACE while
    tracing is on, and does nothing otherwise."""
    return _Span(name) if tracing() else _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to TRACE's counter ``name`` while tracing is on."""
    if tracing():
        TRACE.counters[name] += n

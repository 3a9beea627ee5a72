"""Structured metrics and phase timing.

The reference's only observability is printf lines (SURVEY.md section 5.1,
5.5).  Here: named counters, phase timers with aggregate stats, and a JSONL
emitter the optimizer can attach for per-iteration records.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.timers: Dict[str, list] = defaultdict(lambda: [0.0, 0])

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

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.counters)
        for name, (total, n) in self.timers.items():
            out[f"{name}.total_s"] = round(total, 6)
            out[f"{name}.calls"] = n
            if n:
                out[f"{name}.mean_ms"] = round(total / n * 1000, 3)
        return out

    def report(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


GLOBAL = Metrics()


class JsonlLogger:
    """Per-iteration JSONL record writer (attach to Optimizer via
    ``log_record``)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

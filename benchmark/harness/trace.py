"""Spans from the benchmark's own code and the reduction of a
torch.profiler trace of the window.

A span is a ``torch.profiler.record_function`` named ``bench.<name>``,
opened only in a traced run; untraced runs pay nothing for them.  The
profiler's Chrome trace is read back once: device operations (kernels,
copies, fills) with their times, the host launch of each (by its
correlation id), and the benchmark's spans.
"""
from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, on: bool, out_dir: str, cuda: bool = True):
        self.on = on
        self.cuda = cuda
        self.out_dir = out_dir
        self.prof = None
        self.trace = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("bench." + name)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put a span around every call of ``obj.attr`` (traced runs)."""
        if not self.on:
            return
        fn = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, attr, spanned)

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.trace = Trace(path)
        os.remove(path)


class Trace:
    """The parts of a Chrome trace the metrics read (times in us)."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.ops = []        # (name, start, end, correlation)
        launch = {}          # correlation -> host time of the launch
        self.spans = defaultdict(list)  # name -> [(start, end)]
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.ops.append((e["name"], ts, ts + dur,
                                 args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launch[args["correlation"]] = ts
            elif cat == "user_annotation" and \
                    e["name"].startswith("bench."):
                self.spans[e["name"][6:]].append((ts, ts + dur))
        self.launch = launch
        self.ops.sort(key=lambda o: o[1])
        win = self.spans.get("window") or [(min((o[1] for o in self.ops),
                                                default=0.0),
                                            max((o[2] for o in self.ops),
                                                default=0.0))]
        self.window = win[0]

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self):
        """Merged intervals in which some device operation ran, clipped to
        the window."""
        lo, hi = self.window
        out = []
        for _n, s, e, _c in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_pct(self):
        w = self.window_s()
        if w <= 0 or not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / w)

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e, _c in self.ops if match(n)) / 1e6

    def op_seconds_in(self, span: str) -> float:
        """Device seconds of the operations launched inside a span."""
        spans = sorted(self.spans.get(span, []))
        if not spans:
            return 0.0
        import bisect

        starts = [s for s, _e in spans]
        total = 0.0
        for _n, s, e, corr in self.ops:
            t = self.launch.get(corr)
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= spans[k][1]:
                total += e - s
        return total / 1e6

    def span_count(self, span: str) -> int:
        return len(self.spans.get(span, []))

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the device's
        idle time shared out by the innermost benchmark span open on the
        host while it lasted ("outside" for none)."""
        by_op = defaultdict(float)
        for n, s, e, _c in self.ops:
            by_op[short(n)] += (e - s) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        idle = defaultdict(float)
        for (s, e), name in zip_overlaps(gaps, self.innermost()):
            idle[name] += (e - s) / 1e6
        top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in top_idle]}

    def innermost(self):
        """The window cut into pieces, each with the innermost benchmark
        span open on the host then (the spans nest)."""
        marks = []
        for name, iv in self.spans.items():
            if name == "window":
                continue
            for s, e in iv:
                marks += [(s, 1, -e, name), (e, 0, 0.0, name)]
        marks.sort()
        stack, out = [], []
        t = self.window[0]
        for time, kind, _neg_end, name in marks:
            if time > t:
                out.append((t, time, stack[-1] if stack else "outside"))
                t = time
            if kind:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        out.append((t, self.window[1], stack[-1] if stack else "outside"))
        return out


def zip_overlaps(gaps, pieces):
    """Each overlap of an interval of ``gaps`` with one of ``pieces``
    ((start, end, name), both sorted and disjoint): ((start, end), name)."""
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        s = max(gaps[i][0], pieces[j][0])
        e = min(gaps[i][1], pieces[j][1])
        if e > s:
            yield (s, e), pieces[j][2]
        if gaps[i][1] <= pieces[j][1]:
            i += 1
        else:
            j += 1


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    for ch in "(<":
        name = name.split(ch, 1)[0]
    return name[:80]

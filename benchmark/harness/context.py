"""One run's state: its cell, its clocks and what the driver measured,
checked and left for the metric readers."""
from __future__ import annotations

import gc
import subprocess
import time

from . import common


class Context:
    def __init__(self, cell, args, device, root, process_start, tracer,
                 control=None):
        self.cell = cell
        self.seed = args.seed
        self.seconds = float(args.seconds)
        self.traced = bool(args.trace)
        self.device = device
        # the card by its index, for the program and the reference: with
        # the bare "cuda" the program's candgen refuses its own batches
        # (the index on "cuda", the codes on "cuda:0"); PERF.md, open
        # questions
        self.program_device = "cuda:0" if device == "cuda" else device
        # tests: the reference in this precision takes the program's place
        self.control = control
        self.root = root
        self.t_proc = process_start
        self.tracer = tracer
        self.times = {}      # set-up split, seconds
        self.e2e = {}        # name -> (value, unit)
        self.layer = {}      # raw values for the metric readers
        self.checks = {}
        self.attempted = self.failed = 0
        self.setup_s = None
        self.mem_peak = 0

    def window_seconds(self) -> float:
        """The window: --seconds, or in a traced run at most the traffic's
        ``trace_seconds``."""
        s = self.seconds
        if self.traced:
            s = min(s, float(self.cell.traffic.get("trace_seconds", s)))
        return s

    def setup_done(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        self.setup_s = time.time() - self.t_proc

    def window_closed(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
            self.mem_peak = max(torch.cuda.max_memory_allocated(i)
                                for i in range(self.cell.chips))

    def free_device(self) -> None:
        gc.collect()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def run(self) -> None:
        self.cell.driver().run(self)

    def report(self) -> None:
        metrics = {}
        breakdown = None
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
        if self.device == "cuda":
            dev = common.device_info(self.cell.chips, self.mem_peak)
        if not self.traced:
            for m in self.cell.end_to_end():
                if m["name"] == "setup_s":
                    metrics["setup_s"] = {"value": self.setup_s, "unit": "s"}
                elif m["name"] in self.e2e:
                    v, unit = self.e2e[m["name"]]
                    metrics[m["name"]] = {"value": v, "unit": unit}
        else:
            tr = self.tracer.trace
            for m in self.cell.per_layer():
                v = common.load_metric_reader(m["name"])(self)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            if tr is not None:
                dev["busy_s"] = tr.busy_s()
                dev["window_s"] = tr.window_s()
                breakdown = tr.breakdown()
        extra = {"setup_split": self.times, "power_limit": power_limit()
                 if self.device == "cuda" else None,
                 "written_bytes": written_bytes()}
        common.report(common.judge(self.checks), self.attempted,
                      self.failed, metrics, dev, self.checks, breakdown,
                      extra)


def written_bytes():
    """Bytes this process has handed to write calls so far (``wchar`` of
    /proc/self/io: files, pipes and terminals alike), or None where that
    is not there."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


def power_limit():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None

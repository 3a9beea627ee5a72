"""What every run shares: the command line, finding a cell's files by the
names in BENCHMARK.json, seeds, the device, the import check and the
result line."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may hold: the JAX package and JAX
FOREIGN = ("jax", "jaxlib", "flax", "gaml_tpu")


def process_start() -> float:
    """This process's start on the time.time() clock (from /proc; the
    module's import time where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


class Cell:
    """A workload and everything it names, each found by its name: its
    configuration file, its traffic mix (``benchmark/traffic/<traffic>.json``,
    data), the driver that the mix names (``benchmark/drivers/<driver>.py``),
    the world maker that the configuration names
    (``benchmark/worlds/<maker>.py``) and the metrics it reports
    (``benchmark/metrics/<metric>.py``)."""

    def __init__(self, name: str):
        bench = load_json("BENCHMARK.json")
        self.bench = bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload named {name!r}")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = [c for c in bench["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(conf["file"])
        self.traffic = load_json(os.path.join(
            "benchmark", "traffic", self.workload["traffic"] + ".json"))

    def driver(self):
        """The traffic's driver: its module's ``run(ctx)`` runs the cell."""
        return load_module("drivers", self.traffic["driver"])

    def worlds(self):
        """The configuration's world maker: its module's ``make(cfg,
        seed_seq, root)`` makes the world from the seed."""
        return load_module("worlds", self.config["world"]["maker"])

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if name_in(self.name, m)]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it, or
        that list no cells and move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def name_in(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module, loaded once."""
    key = f"bench_{kind}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        path = os.path.join(BENCH_DIR, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def load_metric_reader(name: str):
    """benchmark/metrics/<name>.py's ``read``."""
    return load_module("metrics", name).read


def seeds(seed: int, n: int):
    """``n`` independent child seed sequences of the run's seed."""
    return np.random.SeedSequence(int(seed)).spawn(n)


def foreign_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FOREIGN})


def device_info(chips: int, memory_peak: int):
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak)}


def report(correct, attempted, failed, metrics, device, checks,
           breakdown=None, extra=None):
    """Print the compared numbers beside their limits on standard error,
    then the result as the last line of standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out), flush=True)


def judge(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def gap_check(value, limit):
    return {"value": float(value), "limit": float(limit)}

#!/usr/bin/env python3
"""Two checkouts of the port on one NVIDIA GPU, phase against phase.

    python3 chip_ab.py OTHER [--phases 1,2,3,4,5,6,7,8,9] [--log FILE]

OTHER is another checkout of the repository (for example the parent
commit unpacked with ``git archive``).  The named phases of each tree's
own chip_smoke.py run in four processes, in the order OTHER, this, this,
OTHER, so that a drift of the card or of the shared host over the call
falls on both trees alike; each tree builds its own kernels.  Every
process prints one line ``AB {...}`` of metrics; the last line is one
JSON object holding each metric's readings, ``{"metric": {"other": [a1,
a2], "this": [b1, b2]}}``.  The phases' own output goes to ``--log`` when
given.  Kernel times are CUDA-event medians, the rest host-clock medians or
walls, as chip_smoke.py measures them; the extra ``candgen`` and
``extend`` stages of phases 2-3 are timed here the same way in both
trees.  Phase 5 reports K5 at both widths, phase 6 the PacBio
precompute's walls, DP shares and native-vs-card crossover, phase 7 the
PacBio anneal's walls and K5 launches (phases 6-7 share one world, as in
chip_smoke.py).  Any failed check of a phase fails its process and this
script.
"""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

RUNNER = r'''
import json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

phases = set(sys.argv[1].split(","))
device = torch.device("cuda", 0)
torch.cuda.set_device(device)
out = {}
if "1" in phases:
    kern = cs.phase_kernels(device)
    for name in ("swar_cost", "swar_cost_accept", "extend_fused"):
        if name in kern:
            out[name + ".ms"] = kern[name]["ms"]
for tag, world in (("2", (400_000, 100_000)), ("3", (2_800_000, 300_000))):
    if tag not in phases:
        continue
    out[f"rescore_{tag}.ms"] = cs.phase_rescore(device, *world)["ms"]
    genome, reads = cs.make_world(*world)
    dev = DeviceRescorer(cs.make_bundle(reads), device=device)

    def candgen():
        c = dev.gen.query([genome])
        cs.sync(device)
        return c

    c = candgen()
    out[f"rescore_{tag}.candgen_ms"] = cs.timer(device, candgen, 10,
                                                host_clock=True)
    out[f"rescore_{tag}.extend_ms"] = cs.timer(
        device, lambda: dev._extend(c), 10)
if "5" in phases:
    fwd = cs.phase_forward_kernel(device)
    for width in (64, 128):
        out[f"K5_w{width}.ms"] = fwd[width]["ms"]
tmp = tempfile.TemporaryDirectory(prefix="gaml_ab_")
d = tmp.name
if phases & {"6", "7"}:
    pb_dir = os.path.join(d, "pacbio")
    os.makedirs(pb_dir)
    pb_genome = cs.write_pacbio_world(pb_dir)
if "6" in phases:
    sc = cs.phase_pacbio_scoring(device, pb_dir)
    for k in ("device_s", "device_dp_s", "native_s", "native_dp_s",
              "crossover_cells"):
        out["pacbio." + k] = sc[k]
if "7" in phases:
    an = cs.phase_pacbio_anneal(device, pb_dir, pb_genome)
    for k in ("dev_wall_s", "nat_wall_s", "launches"):
        out["pacbio_anneal." + k] = an[k]
if phases & {"4", "9"}:
    t0 = time.perf_counter()
    world = cs.write_anneal_world(d) + (time.perf_counter() - t0,)
if "4" in phases:
    res = cs.phase_anneal(device, d, world)
    for k in ("dev_wall_s", "bfs_wall_s", "cpu_wall_s"):
        out["anneal." + k] = res[k]
if "8" in phases:
    ex = cs.phase_exact(device)
    out["exact_K3.ms"] = ex["K3"]["ms"]
    out["exact_K4b.ms"] = ex["K4b"]["ms"]
    out["rescore_k3_route.ms"] = ex["rescore"]["k3_route_ms"]
if "9" in phases:
    m = cs.phase_models(device, d)
    out["exact_K4a.ms"] = m["K4a"]["ms"]
    out["single.forward_ms"] = m["single"]["forward_ms"]
    out["single.host_candgen_s"] = m["single"]["host_candgen_s"]
    out["paired.model_s"] = m["paired"]["model_s"]
    out["paired.host_scorer_s"] = m["paired"]["host_scorer_s"]
tmp.cleanup()
print("AB " + json.dumps(out), flush=True)
'''


def run(tree, phases, log, timeout):
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", RUNNER, phases], cwd=tree,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    log.write(f"==== {tree}\n{proc.stdout}{proc.stderr}\n")
    log.flush()
    found = [line for line in proc.stdout.splitlines()
             if line.startswith("AB ")]
    if proc.returncode != 0 or not found:
        raise RuntimeError(f"{tree} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(found[-1][3:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--phases", default="1,2,3,4,8,9")
    ap.add_argument("--log", default=os.devnull,
                    help="file for the phases' own output")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds allowed to each process")
    args = ap.parse_args()
    if not re.fullmatch(r"[0-9]+(,[0-9]+)*", args.phases):
        ap.error(f"--phases: want a comma-separated list, got {args.phases}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    if os.path.dirname(args.log):
        os.makedirs(os.path.dirname(args.log), exist_ok=True)
    readings = {}
    with open(args.log, "w") as log:
        for label, tree in (("other", other), ("this", ROOT),
                            ("this", ROOT), ("other", other)):
            res = run(tree, args.phases, log, args.timeout)
            print(f"{label} {tree}: AB " + json.dumps(res), flush=True)
            for k, v in res.items():
                readings.setdefault(k, {"other": [], "this": []})[
                    label].append(v)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

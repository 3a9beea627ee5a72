"""Command-line driver of the port (reference main, gaml.cc:935-1023).

Usage: python -m gaml_tpu_torch.cli <config> [--device cuda|cpu]
                                    [--resume prefix]

The same run as ``python -m gaml_tpu.cli <config> --backend device``,
with the device paths on torch: short-read sets are built with the device
backend and adopted into the port (scoring.readset), and PacBio read sets
send their forward-DP batches to the port's engine (scoring.pacbio, at
their own band width; batches below GAML_PB_DEVICE_MIN_CELLS cells stay
on the native host kernel).  With ``--device cpu`` the kernels' plain
torch versions run instead of the CUDA kernels.  The last line of output
reports the device work: window batches, candidates, PacBio forward-DP
cells by route and kernel launches.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from gaml_tpu.cli import (get_longest_read, prepare_reads,
                          starting_paths_from_config)
from gaml_tpu.config import load_config, prepare_read_sets
from gaml_tpu.core.io import load_lastgraph
from gaml_tpu.optimize.anneal import Optimizer
from gaml_tpu.optimize.settings import AssemblySettings
from gaml_tpu.scoring.calculator import ProbCalculator

from .native import load_native
from .ops import extend_cuda, forward_cuda
from .scoring.pacbio import adopt_pacbio_readset
from .scoring.readset import adopt_readset

# options of gaml_tpu.cli whose device code is not ported yet
_NOT_PORTED = {
    "--paired-device": "ROADMAP A10 (parallel/paired_sharded.py)",
    "--paired-device-inc": "ROADMAP A10 (parallel/paired_sharded.py)",
    "--device-state": "ROADMAP A10 (parallel/device_state.py)",
    "--pacbio-device": "ROADMAP A10 (parallel/pacbio_sharded.py)",
    "--distributed": "ROADMAP A10 (parallel/distributed.py)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gaml-tpu-torch")
    ap.add_argument("config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the short-read rescore path: "
                         "cuda (the CUDA kernels) or cpu (their plain "
                         "torch versions)")
    ap.add_argument("--resume", default="",
                    help="resume from <prefix>.ckpt")
    for flag in _NOT_PORTED:
        if flag == "--distributed":
            ap.add_argument(flag, default="", help="not ported yet")
        else:
            ap.add_argument(flag, action="store_true",
                            help="not ported yet")
    args = ap.parse_args(argv)

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")):
            print(f"{flag} is not ported to gaml_tpu_torch yet: {item}",
                  file=sys.stderr)
            return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2

    load_native()
    configs, read_set_configs = load_config(args.config)
    if "graph" not in configs and "starting_assembly" not in configs:
        print("Missing graph in config", file=sys.stderr)
        return 1
    single, paired, pacbio = prepare_read_sets(read_set_configs,
                                               backend="device")
    settings = AssemblySettings.from_config(configs)
    if "graph" in configs:
        graph = load_lastgraph(configs["graph"])
    else:
        from gaml_tpu.core.graph import Graph

        graph = Graph()
    paths = starting_paths_from_config(configs, graph, settings)

    pc = ProbCalculator(single, paired, pacbio, graph)
    advice_paired = [pair for cfg, pair in paired if cfg.advice]
    advice_pacbio = [rs for cfg, rs in pacbio if cfg.advice]
    prepare_reads(single, paired, pacbio, graph)
    short = {id(rs): rs for rs in [rs for _c, rs in single]
             + [rs for _c, pair in paired for rs in pair]}
    for rs in short.values():
        adopt_readset(rs, device)
    for _cfg, rs in pacbio:
        adopt_pacbio_readset(rs, device)
    longest_read = get_longest_read(single, paired, pacbio)

    opt = Optimizer(graph, pc, settings, advice_paired, advice_pacbio,
                    longest_read)
    if args.resume:
        from gaml_tpu.optimize.checkpoint import load_checkpoint

        paths = load_checkpoint(opt, args.resume)
    opt.run(paths)
    aligners = [rs.aligner for rs in short.values()]
    pacbio_cells = {}
    for _cfg, rs in pacbio:
        for k, v in getattr(rs, "dp_cells", {}).items():
            pacbio_cells[k] = pacbio_cells.get(k, 0) + v
    print("device work: " + json.dumps({
        "device": str(device),
        "batches": sum(a.device_batches for a in aligners),
        "candidates": sum(a.device_candidates for a in aligners),
        "pacbio_cells": pacbio_cells,
        "launches": {**extend_cuda.LAUNCHES, **forward_cuda.LAUNCHES}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

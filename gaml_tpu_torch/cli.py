"""Command-line driver of the port (reference main, gaml.cc:935-1023).

Usage: python -m gaml_tpu_torch.cli <config> [--backend bfs|device]
                                    [--device cuda|cpu] [--resume prefix]
                                    [--paired-device | --paired-device-inc]
                                    [--device-state] [--pacbio-device]

The same run as ``python -m gaml_tpu.cli``, on the port's own host layers
and torch.  ``--backend`` picks the short-read extension: ``device``
(default) runs candidate generation and the extension kernels on
``--device``; ``bfs`` is the exact host route (the native C++ aligner).
PacBio read sets send forward-DP batches of GAML_PB_DEVICE_MIN_CELLS
cells or more to ``--device`` under either backend, and smaller ones to
the native host kernel.  With ``--device cpu`` the kernels' plain torch
versions run instead of the CUDA kernels; ``--device cuda`` on a machine
without a card exits with an error.

The JAX CLI's device scorers run on ``--device`` (parallel/, in float64):
``--paired-device`` scores paired sets with the full rescore on the
device (every walk restaged every move), ``--paired-device-inc`` with the
incremental rescore over device-resident per-read totals,
``--device-state`` keeps the host incremental scorer's running totals on
the device, and ``--pacbio-device`` runs every PacBio forward-DP batch on
K5 (cells under "mesh") and the per-read reduction on the device.
``--distributed`` (multi-process scoring) is not ported yet.

The last line of output reports the device work: window batches,
candidates, PacBio forward-DP cells by route, kernel launches and the
anneal's wall seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .config import load_config, prepare_read_sets
from .core.io import load_lastgraph, output_paths_to_file
from .native import get_lib
from .optimize.anneal import Optimizer
from .optimize.settings import AssemblySettings
from .scoring.calculator import ProbCalculator

# the option of the JAX package's CLI whose device code is not ported yet
_NOT_PORTED = {"--distributed": "ROADMAP A10b (parallel/distributed.py)"}


def get_longest_read(single, paired, pacbio) -> int:
    """Reference GetLongestRead (gaml.cc:911-933): max read length over
    single/pacbio sets; paired sets contribute their insert mean."""
    longest = 0
    for _cfg, rs in single:
        for i in range(rs.get_number_of_reads()):
            longest = max(longest, rs.get_read_len(i))
    for _cfg, rs in pacbio:
        for i in range(rs.get_number_of_reads()):
            longest = max(longest, rs.get_read_len(i))
    for cfg, _pair in paired:
        longest = max(longest, int(cfg.insert_mean))
    return longest


def prepare_reads(single, paired, pacbio, graph) -> None:
    """Reference PrepareReads (gaml.cc:883-909)."""
    for _cfg, rs in pacbio:
        rs.load_alignments()
        rs.preprocess_reads()
        rs.normalize_cache(graph)
        rs.compute_anchors(graph)
    for _cfg, (rs1, rs2) in paired:
        for rs in (rs1, rs2):
            rs.load_alignments()
            rs.preprocess_reads()
            rs.prepare_read_index()
    for _cfg, rs in single:
        rs.load_alignments()
        rs.preprocess_reads()
        rs.prepare_read_index()


def starting_paths_from_config(configs, graph, settings):
    """Starting walk set (reference gaml.cc:970-1006)."""
    if "starting_assembly" in configs:
        if "graph" in configs:
            from .assembly_import import get_paths

            paths = get_paths(graph, configs["starting_assembly"])
        else:
            from .graph_from_assembly import get_graph_from_assembly

            # connect_bootstrap_graph=1 wires edges from the interval
            # adjacency (the reference leaves the bootstrap graph
            # edge-less, so reroute/extend moves have nothing to sample)
            connect = configs.get("connect_bootstrap_graph", "0") == "1"
            paths = get_graph_from_assembly(configs["starting_assembly"],
                                            graph, connect=connect)
        from .assembly_import import add_missing_big_nodes, clip_paths

        paths = clip_paths(paths, graph)
        add_missing_big_nodes(paths, graph)
        output_paths_to_file(paths, graph, 61, 500, "starting3")
        return paths
    return [[i] for i in range(0, graph.num_nodes, 2)
            if graph.node_len(i) > settings.threshold]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gaml-tpu-torch")
    ap.add_argument("config")
    ap.add_argument("--backend", default="device", choices=["bfs", "device"],
                    help="short-read extension backend: bfs = bit-exact "
                         "reference semantics (native-accelerated), device "
                         "= the port's min-cost kernels on --device")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device work: cuda (the CUDA "
                         "kernels) or cpu (their plain torch versions)")
    ap.add_argument("--resume", default="",
                    help="resume from <prefix>.ckpt")
    ap.add_argument("--paired-device", action="store_true",
                    help="score paired read sets with the full rescore on "
                         "--device (parallel.paired_sharded) instead of "
                         "the host incremental scorer")
    ap.add_argument("--paired-device-inc", action="store_true",
                    help="incremental paired scoring on --device: diff the "
                         "walk multiset on the host, run only the changed "
                         "walks' pair products on the device and add them "
                         "into device-resident running totals")
    ap.add_argument("--device-state", action="store_true",
                    help="keep the paired incremental scorer's per-read "
                         "running totals on --device "
                         "(parallel.device_state)")
    ap.add_argument("--pacbio-device", action="store_true",
                    help="run every PacBio forward-DP batch on --device "
                         "and the per-read reduction there "
                         "(parallel.pacbio_sharded)")
    ap.add_argument("--distributed", default="", help="not ported yet")
    args = ap.parse_args(argv)

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")):
            print(f"{flag} is not ported to gaml_tpu_torch yet: {item}",
                  file=sys.stderr)
            return 2
    # torch loads only for a device other than the CPU (to check it) and
    # for the device work itself, so --backend bfs --device cpu runs on
    # the host layers alone, as gaml_tpu.cli --backend bfs does
    device = args.device
    if device != "cpu":
        import torch

        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            print("--device cuda: no CUDA device is available",
                  file=sys.stderr)
            return 2

    get_lib()
    configs, read_set_configs = load_config(args.config)
    if "graph" not in configs and "starting_assembly" not in configs:
        print("Missing graph in config", file=sys.stderr)
        return 1
    single, paired, pacbio = prepare_read_sets(
        read_set_configs, backend=args.backend, device=device)
    settings = AssemblySettings.from_config(configs)
    if "graph" in configs:
        graph = load_lastgraph(configs["graph"])
    else:
        from .core.graph import Graph

        graph = Graph()
    paths = starting_paths_from_config(configs, graph, settings)

    pc = ProbCalculator(single, paired, pacbio, graph)
    advice_paired = [pair for cfg, pair in paired if cfg.advice]
    advice_pacbio = [rs for cfg, rs in pacbio if cfg.advice]
    prepare_reads(single, paired, pacbio, graph)
    longest_read = get_longest_read(single, paired, pacbio)
    if (args.paired_device or args.paired_device_inc) and paired:
        pc.enable_sharded_paired(device, incremental=args.paired_device_inc)
    if args.pacbio_device and pacbio:
        pc.enable_sharded_pacbio(device)
    if args.device_state and paired:
        # needs read lengths: after prepare_reads
        pc.enable_device_scoring_state(device)

    opt = Optimizer(graph, pc, settings, advice_paired, advice_pacbio,
                    longest_read)
    if args.resume:
        from .optimize.checkpoint import load_checkpoint

        paths = load_checkpoint(opt, args.resume)
    t0 = time.perf_counter()
    opt.run(paths)
    anneal_s = time.perf_counter() - t0
    short = {id(rs): rs for rs in [rs for _c, rs in single]
             + [rs for _c, pair in paired for rs in pair]}
    aligners = [rs.aligner for rs in short.values()]
    pacbio_cells = {}
    for _cfg, rs in pacbio:
        for k, v in getattr(rs, "dp_cells", {}).items():
            pacbio_cells[k] = pacbio_cells.get(k, 0) + v
    launches = {}
    if args.backend == "device" or pacbio:
        from .ops import extend_cuda, forward_cuda

        launches = {**extend_cuda.LAUNCHES, **forward_cuda.LAUNCHES}
    print("device work: " + json.dumps({
        "device": device,
        "backend": args.backend,
        "batches": sum(a.device_batches for a in aligners),
        "candidates": sum(a.device_candidates for a in aligners),
        "pacbio_cells": pacbio_cells,
        "launches": launches,
        "anneal_s": anneal_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

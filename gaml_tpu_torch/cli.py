"""Command-line driver of the port (reference main, gaml.cc:935-1023).

Usage: python -m gaml_tpu_torch.cli <config> [--backend bfs|device]
                                    [--device cuda|cpu] [--resume prefix]
                                    [--paired-device | --paired-device-inc]
                                    [--device-state] [--pacbio-device]
                                    [--distributed host:port]
                                    [--trace DIR]

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

``--distributed host:port`` (or GAML_COORD) runs one process of a group
of GAML_NPROC, this one number GAML_PROC_ID, over torch.distributed
(parallel/distributed.py; GAML_DIST_BACKEND names the backend: nccl on a
card and gloo on the CPU by default, gloo for ranks that share a card).
Every process runs the same anneal from the same seed; the device
scorers split the reads between them and merge each score exactly, so
every process prints the same trace.  Without a device-scorer flag every
process runs the whole anneal.  Only process 0 writes outputs.

``--trace DIR`` runs the anneal under torch.profiler (the CPU, and CUDA
on a card), which turns on the program's spans and counters
(utils.metrics): the Chrome trace goes to ``DIR/trace.json``, with every
span as a ``gaml.<name>`` annotation on the device operations' clock,
and the spans' calls, total and self seconds and parents, the counters
(the optimizer's ``moves.*`` among them) and the optimizer's timers to
``DIR/summary.json``.  Each process of a group writes into
``DIR/rank<r>``.

The last line of output reports the device work: window batches,
candidates, PacBio forward-DP cells by route, kernel launches (with the
calls of query_plain and of the host candidate pass gen_candidates), the
anneal's wall seconds, and this process's rank and the world's size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .config import load_config, prepare_read_sets
from .core.io import load_lastgraph, output_paths_to_file
from .native import get_lib
from .optimize.anneal import Optimizer
from .optimize.settings import AssemblySettings
from .scoring.calculator import ProbCalculator


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


def prepare_reads(single, paired, pacbio, graph, persist: bool = True) -> None:
    """Reference PrepareReads (gaml.cc:883-909); ``persist``: PacBio
    anchors are read from and written to their cache file (one process
    of a group does; the others compute them)."""
    for _cfg, rs in pacbio:
        rs.load_alignments()
        rs.preprocess_reads()
        rs.normalize_cache(graph)
        rs.compute_anchors(graph, persist=persist)
    for _cfg, (rs1, rs2) in paired:
        for rs in (rs1, rs2):
            rs.load_alignments()
            rs.preprocess_reads()
            rs.prepare_read_index()
    for _cfg, rs in single:
        rs.load_alignments()
        rs.preprocess_reads()
        rs.prepare_read_index()


def starting_paths_from_config(configs, graph, settings,
                               write_outputs: bool = True):
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
        if write_outputs:
            output_paths_to_file(paths, graph, 61, 500, "starting3")
        return paths
    return [[i] for i in range(0, graph.num_nodes, 2)
            if graph.node_len(i) > settings.threshold]


def traced_run(opt, paths, write_outputs: bool, device: str,
               out_dir: str) -> None:
    """``opt.run`` under torch.profiler with the program's spans and
    counters on: the Chrome trace to ``out_dir/trace.json``, the trace
    store's snapshot with the optimizer's counters and timers to
    ``out_dir/summary.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .utils.metrics import TRACE

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    TRACE.reset()
    with profile(activities=acts) as prof:
        opt.run(paths, write_outputs=write_outputs)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    summary = TRACE.snapshot()
    own = opt.metrics.snapshot()
    summary["counters"].update(own["counters"])
    summary["timers"] = own["timers"]
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)


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
    ap.add_argument("--distributed", default="",
                    help="multi-process scoring: coordinator address "
                         "host:port (or set GAML_COORD); requires GAML_NPROC "
                         "and GAML_PROC_ID; GAML_DIST_BACKEND picks the "
                         "torch.distributed backend")
    ap.add_argument("--trace", default="", metavar="DIR",
                    help="run the anneal under torch.profiler: its Chrome "
                         "trace to DIR/trace.json, the program's spans "
                         "and counters to DIR/summary.json")
    args = ap.parse_args(argv)

    coord = args.distributed or os.environ.get("GAML_COORD", "")
    if coord:
        nproc = os.environ.get("GAML_NPROC")
        proc_id = os.environ.get("GAML_PROC_ID")
        if nproc is None or proc_id is None:
            print("--distributed/GAML_COORD requires GAML_NPROC and "
                  "GAML_PROC_ID environment variables (process count and "
                  "this process's 0-based id)", file=sys.stderr)
            return 1
    # torch loads only for a device other than the CPU (to check it), for
    # the process group and for the device work itself, so --backend bfs
    # --device cpu runs on the host layers alone, as gaml_tpu.cli
    # --backend bfs does
    device = args.device
    if device != "cpu":
        import torch

        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            print("--device cuda: no CUDA device is available",
                  file=sys.stderr)
            return 2
    if not coord:
        return run(args, device)
    from .parallel import distributed

    rank, world = distributed.initialize(
        coord, int(nproc), int(proc_id),
        backend=os.environ.get("GAML_DIST_BACKEND") or None, device=device)
    try:
        return run(args, str(distributed.rank_device(device, rank)), rank,
                   world)
    finally:
        distributed.shutdown()


def run(args, device: str, rank: int = 0, world: int = 1) -> int:
    """The run of ``main``'s arguments on ``device``, as process ``rank``
    of ``world``."""
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
    paths = starting_paths_from_config(configs, graph, settings,
                                       write_outputs=rank == 0)

    pc = ProbCalculator(single, paired, pacbio, graph)
    advice_paired = [pair for cfg, pair in paired if cfg.advice]
    advice_pacbio = [rs for cfg, rs in pacbio if cfg.advice]
    prepare_reads(single, paired, pacbio, graph, persist=rank == 0)
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
    if args.trace:
        traced_run(opt, paths, rank == 0, device, args.trace if world == 1
                   else os.path.join(args.trace, f"rank{rank}"))
    else:
        opt.run(paths, write_outputs=rank == 0)
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
        from .align import aligner
        from .ops import candgen_cuda, candgen_device, extend_cuda, \
            forward_cuda, rescore_cuda

        launches = {**extend_cuda.LAUNCHES, **forward_cuda.LAUNCHES,
                    **candgen_cuda.LAUNCHES, **rescore_cuda.LAUNCHES,
                    **candgen_device.PLAIN_CALLS, **aligner.HOST_CALLS}
    print("device work: " + json.dumps({
        "device": device,
        "backend": args.backend,
        "batches": sum(a.device_batches for a in aligners),
        "candidates": sum(a.device_candidates for a in aligners),
        "pacbio_cells": pacbio_cells,
        "launches": launches,
        "anneal_s": anneal_s,
        "rank": rank,
        "world": world}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

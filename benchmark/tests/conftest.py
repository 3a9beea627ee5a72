"""Helpers of the benchmark's CPU tests: the cells at a size a test run
holds, and a run of one of them through the harness on the CPU."""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))


def small_cell(name, genome_bp=60_000, **traffic):
    """The workload with its world cut to ``genome_bp`` (the libraries in
    proportion) and its traffic to a few requests' worth; ``traffic``
    sets further keys of the mix."""
    from harness import common

    cell = common.Cell(name)
    w = cell.config["world"]
    w["genome_bp"] = genome_bp
    w["libraries"]["rs1"]["pairs"] = genome_bp // 15
    w["libraries"]["rs2"]["pairs"] = genome_bp // 60
    tr = cell.traffic
    if tr["driver"] == "rescore":
        tr.update(pool=3, assemblies={"contigs": 4, "edits": 3,
                                      "run_nodes": [1, 3]})
    else:
        tr.update(sample_span=20, sampled_calls=6)
    tr.update(traffic)
    return cell


def run_small(name, seed=4294967311, seconds=1.0, trace=0, cell=None,
              **kw):
    """(exit code, result dict) of one CPU run of a small cell."""
    import run as bench_run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_run.main(["--workload", name, "--seed", str(seed),
                             "--seconds", str(seconds), "--trace",
                             str(trace)], device="cpu",
                            cell=cell or small_cell(name), **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="session")
def tiny_world(tmp_path_factory):
    """A small world, the port's read sets of it (CLI set-up, CPU) and
    the reference's indexes."""
    import numpy as np

    from harness import common
    from gaml_tpu_torch.cli import prepare_reads
    from gaml_tpu_torch.config import load_config, prepare_read_sets
    from gaml_tpu_torch.core.io import load_lastgraph

    cell = small_cell("aureus.rescore")
    root = str(tmp_path_factory.mktemp("world"))
    worlds = common.load_module("worlds", "paired")
    world = worlds.make(cell.config, np.random.SeedSequence(77), root)
    cfg = worlds.write_cli_config(cell.config, world, 5,
                                  os.path.join(root, "out"))
    configs, sections = load_config(cfg)
    single, paired, pacbio = prepare_read_sets(sections, backend="device",
                                               device="cpu")
    graph = load_lastgraph(configs["graph"])
    prepare_reads(single, paired, pacbio, graph)
    return world, paired, graph

"""The port's long-read rescore against the benchmark's plain reference
(benchmark/reference/pacbio.py, loaded by path) on a seeded small world
of the ``ecoli_pacbio`` configuration's shapes, on the CPU: 60 kb, 40
reads of 0.5-4 kb at 13 % errors, the CLI's start walks and a
misassembly of the chain (gaps and inverted runs).  Anchors, jobs,
guides, windows, positions, zero reads, bad bases and total length are
equal; log-probabilities and the score lie within the cell's limits
(benchmark/traffic/pacbio_rescore.json), through the engine's plain torch
route and the native route; the reference computed in float32 misses
them."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from gaml_tpu_torch.cli import prepare_reads, starting_paths_from_config
from gaml_tpu_torch.config import load_config, prepare_read_sets
from gaml_tpu_torch.core.io import load_lastgraph
from gaml_tpu_torch.optimize.settings import AssemblySettings
from gaml_tpu_torch.scoring import pacbio_score

from test_torch_kernels import port_native_lib

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.append(BENCH)

from harness import common  # noqa: E402

R = common.load_module("reference", "pacbio")
DRIVER = common.load_module("drivers", "pacbio_rescore")
with open(os.path.join(BENCH, "traffic", "pacbio_rescore.json")) as f:
    LIMITS = json.load(f)["limits"]


def small_config(**world):
    """The configuration with its world cut (``world``: keys of it)."""
    with open(os.path.join(BENCH, "configs", "ecoli_pacbio.json")) as f:
        cfg = json.load(f)
    cfg["world"].update(world)
    return cfg


class SmallWorld:
    """The world, the port's read set of it (the CLI's set-up, CPU), its
    graph and walk sets, the reference and the library's parameters."""

    def __init__(self, root, seed=20171, genome_bp=60_000, reads=40,
                 read_bp=(500, 4000)):
        worlds = common.load_module("worlds", "pacbio")
        cfg = small_config(genome_bp=genome_bp, reads=reads,
                           read_bp=list(read_bp))
        s_world, s_pool = np.random.SeedSequence(seed).spawn(2)
        self.world = worlds.make(cfg, s_world, root)
        path = worlds.write_cli_config(cfg, self.world, 0,
                                       os.path.join(root, "out"))
        configs, sections = load_config(path)
        _s, _p, pacbio = prepare_read_sets(sections, backend="device",
                                           device="cpu")
        self.graph = load_lastgraph(configs["graph"])
        start = starting_paths_from_config(
            configs, self.graph, AssemblySettings.from_config(configs),
            write_outputs=False)
        prepare_reads([], [], pacbio, self.graph)
        lib, self.rs = pacbio[0]
        self.params = dict(penalty=lib.penalty_constant, cov_move=lib.step,
                           min_prob_per_base=lib.min_prob_per_base,
                           min_prob_start=lib.min_prob_start)
        pool = worlds.walk_pool(np.random.default_rng(s_pool), self.world,
                                start, dict(walks=2, misassemblies=1,
                                            edits=4, run_nodes=[1, 3]))
        self.walk_sets = [pool[0], pool[2]]
        self.ref = R.Reference(self.world.nodes, self.world.reads,
                               float(cfg["cli"]["libraries"]["pb"]
                                     ["mismatch_prob"]))

    def score(self, walks, monkeypatch):
        """The port's answer for ``walks`` from an empty cache, with the
        forward batches it ran and its bad bases."""
        rs, batches, bad = self.rs, [], []
        rs.aligment_cache = {}
        forward = rs._forward_batch

        def recorded(seq, jobs, extents=None):
            batches.append((jobs, extents))
            return forward(seq, jobs, extents)

        sweep = pacbio_score.sweep_walk

        def counted(*a, **kw):
            out = sweep(*a, **kw)
            bad.append(out[2])
            return out

        monkeypatch.setattr(rs, "_forward_batch", recorded)
        monkeypatch.setattr(pacbio_score, "sweep_walk", counted)
        try:
            score, zeros, total = pacbio_score.calc_score_for_pacbio(
                self.graph, walks, rs,
                no_cov_penalty=self.params["penalty"],
                exp_cov_move=self.params["cov_move"],
                min_prob_per_base=self.params["min_prob_per_base"],
                min_prob_start=self.params["min_prob_start"])
        finally:
            monkeypatch.undo()
        return dict(score=score, zero_reads=zeros, total_len=total,
                    bad_bases=sum(bad), windows=rs.aligment_cache,
                    batches=batches)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The world and the reference's answers for its walk sets, in
    float64 (``want``) and float32 (``f32``).  Torch on one thread: the
    row loops' small operations run faster so."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        small = SmallWorld(str(tmp_path_factory.mktemp("pbworld")))
        small.plans = [small.ref.plan(w) for w in small.walk_sets]
        small.want, small.f32 = (
            [small.ref.finish(p, lp, **small.params) for p, lp in
             zip(small.plans, small.ref.forward(small.plans, "cpu", dtype))]
            for dtype in (torch.float64, torch.float32))
        yield small
    finally:
        torch.set_num_threads(threads)


def test_world_shapes_and_anchors_equal_the_references(small):
    lens = np.array([len(r) for r in small.world.reads])
    assert lens.min() >= 500 and lens.max() <= 4000 and len(lens) == 40
    misassembled = small.walk_sets[1]
    assert any(e < 0 for w in misassembled for e in w)
    assert any(e % 2 for w in misassembled for e in w)
    rs, ref = small.rs, small.ref
    assert rs.anchors_cache and rs.anchors_cache == ref.anchored
    assert rs.anchors_begin == ref.at_begin
    assert rs.anchors_end == ref.at_end


def gaps(got, want):
    windows, positions, lp = DRIVER.hit_gaps(got["windows"], want.windows)
    return dict(windows_gap=windows, positions_gap=positions,
                logprob_gap=lp,
                score_rel_gap=abs(got["score"] - want.score) / abs(want.score),
                zero_reads_gap=abs(got["zero_reads"] - want.zero_reads),
                bad_bases_gap=abs(got["bad_bases"] - want.bad_bases),
                total_len_gap=abs(got["total_len"] - want.total_len))


@pytest.mark.parametrize("route,min_cells,key", [
    ("engine", "0", "torch"), ("native", str(1 << 62), "native")])
def test_rescore_equals_the_reference(small, monkeypatch, route, min_cells,
                                      key):
    """Each walk set scored from an empty cache, as the cell's requests
    are: the same jobs and guides in one batch, every exact number
    equal, log-probabilities and score within the cell's limits; the
    reference in float32 misses a limit."""
    with monkeypatch.context() as m:
        m.setenv("GAML_PB_DEVICE_MIN_CELLS", min_cells)
        small.rs.dp_cells = {}
        got = [small.score(w, monkeypatch) for w in small.walk_sets]
    assert set(small.rs.dp_cells) == {key}
    for g, w, plan in zip(got, small.want, small.plans):
        (jobs, extents), = g["batches"]
        assert len(jobs) == w.jobs == len(plan.jobs) > 0
        offs = np.cumsum([0] + [len(f.target) for f in plan.fills])
        for i, ((q, centers, rid, strand), job) in enumerate(
                zip(jobs, plan.jobs)):
            assert (rid, strand) == (job.rid, job.strand)
            read = small.world.reads[rid]
            assert np.array_equal(q, read if strand == 0 else
                                  R.revcomp(read))
            assert np.array_equal(np.asarray(centers, np.int64),
                                  job.guide + offs[job.fill])
            if extents is not None:
                assert extents[i] == (offs[job.fill],
                                      len(plan.fills[job.fill].target))
        found = gaps(g, w)
        for name, v in found.items():
            assert v <= LIMITS[name], (route, name, v)
    if route == "native":
        return
    missed = [gaps(dict(score=c.score, zero_reads=c.zero_reads,
                        total_len=c.total_len, bad_bases=c.bad_bases,
                        windows=c.windows), w)
              for c, w in zip(small.f32, small.want)]
    assert any(v[name] > LIMITS[name] for v in missed
               for name in ("logprob_gap", "score_rel_gap")), missed

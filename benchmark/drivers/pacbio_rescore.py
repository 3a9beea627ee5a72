"""Traffic driver ``pacbio_rescore``: a closed loop of long-read rescores
from an empty alignment cache, one in flight.

Set-up makes the configuration's world, runs the CLI's own set-up for the
traffic's long-read library (``prepare_read_sets`` on its ``type=pacbio``
section, the start walks, ``ProbCalculator``, ``prepare_reads``, which
computes the anchors) and builds the pool of walk sets: the CLI's start
walks, the true chain cut into walks, and seeded misassemblies of it.
Warm-up scores each walk set once.  Each request empties the read set's
alignment cache (its anchors, resident read rows and packed read k-mers
stay: set-up work) and scores the next walk set of the pool through
``ProbCalculator.calc_prob``.  Every answer is kept: the score, the zero
reads, the total length, the filled cache, and, read where the program
makes them, the request's forward jobs (``PacbioReadSet._forward_batch``)
and bad bases (``pacbio_score.sweep_walk``).  After the window they are
held to the plain reference (``reference/pacbio.py``).
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np

from harness import bounds, common


class Probe:
    """Counts, per request, what the program's scorer does where it does
    it: the forward jobs and batches of the read set, and the bad bases
    of every walk's sweep."""

    def __init__(self, rs):
        from gaml_tpu_torch.scoring import pacbio_score

        self.module, self.rs = pacbio_score, rs
        self.jobs = self.batches = self.bad = 0
        forward, sweep = rs._forward_batch, pacbio_score.sweep_walk
        self.sweep = sweep

        def counted_forward(seq, jobs, extents=None):
            self.jobs += len(jobs)
            self.batches += 1
            return forward(seq, jobs, extents)

        def counted_sweep(*a, **kw):
            out = sweep(*a, **kw)
            self.bad += int(out[2])
            return out

        rs._forward_batch = counted_forward
        pacbio_score.sweep_walk = counted_sweep

    def take(self):
        out = (self.jobs, self.batches, self.bad)
        self.jobs = self.batches = self.bad = 0
        return out

    def close(self) -> None:
        self.module.sweep_walk = self.sweep
        del self.rs._forward_batch


def setup(ctx) -> dict:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    worlds = ctx.cell.worlds()
    s_world, s_pool = common.seeds(ctx.seed, 2)
    t = time.perf_counter()
    ctx.world = worlds.make(cfg, s_world, ctx.root)
    cfg_path = worlds.write_cli_config(cfg, ctx.world, 0,
                                       os.path.join(ctx.root, "out"))
    ctx.times["world_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from gaml_tpu_torch.native import get_lib
    from gaml_tpu_torch.ops import build

    get_lib()
    if ctx.device == "cuda":
        build.load()
    ctx.times["compile_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from gaml_tpu_torch.cli import prepare_reads, starting_paths_from_config
    from gaml_tpu_torch.config import load_config, prepare_read_sets
    from gaml_tpu_torch.core.io import load_lastgraph
    from gaml_tpu_torch.optimize.settings import AssemblySettings
    from gaml_tpu_torch.scoring.calculator import ProbCalculator

    configs, sections = load_config(cfg_path)
    lib = tr["library"]
    single, paired, pacbio = prepare_read_sets(
        {lib: sections[lib]}, backend="device", device=ctx.program_device)
    settings = AssemblySettings.from_config(configs)
    graph = load_lastgraph(configs["graph"])
    start = starting_paths_from_config(configs, graph, settings,
                                       write_outputs=False)
    pc = ProbCalculator(single, paired, pacbio, graph)
    prepare_reads(single, paired, pacbio, graph)
    lib_cfg, rs = pacbio[0]
    if rs.forward_width != int(cfg["forward_width"]):
        raise SystemExit(f"the read set's band is {rs.forward_width}, the "
                         f"configuration's {cfg['forward_width']}")
    ctx.times["read_sets_s"] = time.perf_counter() - t
    ctx.pool = worlds.walk_pool(np.random.default_rng(s_pool), ctx.world,
                                start, tr)
    ctx.params = dict(penalty=lib_cfg.penalty_constant, cov_move=lib_cfg.step,
                      min_prob_per_base=lib_cfg.min_prob_per_base,
                      min_prob_start=lib_cfg.min_prob_start)
    ctx.n_reads = rs.get_number_of_reads()
    ctx.tracer.wrap(pc, "calc_prob", "score")
    return {"pc": pc, "rs": rs, "probe": Probe(rs)}


def request(st, ctx, k: int):
    """Walk set ``k`` of the pool scored from an empty cache."""
    rs = st["rs"]
    rs.aligment_cache = {}
    zeros = []
    prob, total = st["pc"].calc_prob(ctx.pool[k], zeros)
    jobs, batches, bad = st["probe"].take()
    return dict(k=k, score=prob, zero_reads=zeros[0][0], total_len=total,
                windows=rs.aligment_cache, jobs=jobs, batches=batches,
                bad_bases=bad)


def run(ctx) -> None:
    st = setup(ctx)
    try:
        window(ctx, st)
    finally:
        st["probe"].close()
    rs = st["rs"]
    print(f"pacbio.rescore: forward cells by route {rs.dp_cells}, "
          f"batches a request {sorted({a['batches'] for a in ctx.answers})}",
          file=sys.stderr)
    del st, rs
    gc.collect()
    ctx.free_device()
    t = time.perf_counter()
    check(ctx)
    ctx.times["check_s"] = time.perf_counter() - t


def window(ctx, st) -> None:
    from gaml_tpu_torch.ops import forward_cuda

    t = time.perf_counter()
    for k in range(len(ctx.pool)):  # every walk set, once
        request(st, ctx, k)
    ctx.times["warm_s"] = time.perf_counter() - t
    ctx.setup_done()

    answers = []
    seconds = ctx.window_seconds()
    launched = forward_cuda.LAUNCHES["banded_forward"]
    ctx.tracer.start()
    with ctx.tracer.span("window"):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            t = time.perf_counter()
            answers.append(request(st, ctx, len(answers) % len(ctx.pool)))
            t1 = time.perf_counter()
            answers[-1]["seconds"] = t1 - t
            if t1 >= deadline:
                break
    ctx.tracer.stop()
    ctx.window_closed()
    print(f"pacbio.rescore: {len(answers)} requests, "
          f"{forward_cuda.LAUNCHES['banded_forward'] - launched} K5 "
          f"launches; walk set, jobs, seconds: "
          f"{[(a['k'], a['jobs'], round(a['seconds'], 3)) for a in answers]}",
          file=sys.stderr)
    ctx.e2e["reads_per_s"] = (ctx.n_reads * len(answers) / (t1 - t0),
                              "reads/s")
    ctx.attempted = len(answers)
    ctx.failed = sum(1 for a in answers if not math.isfinite(a["score"]))
    ctx.answers = answers
    ctx.layer["traced_calls"] = [a["k"] for a in answers]


def hit_gaps(got: dict, want: dict):
    """(windows, positions, logprob) gaps of a filled cache against the
    reference's: windows in one and not the other; hits whose (start,
    end, read) differ, or that one side lacks; the largest absolute gap
    of a matched hit's log-probability."""
    windows = len(set(got) ^ set(want))
    positions, lp = 0, 0.0
    for key in set(got) | set(want):
        a, b = list(got.get(key, ())), want.get(key, [])
        positions += abs(len(a) - len(b))
        for x, y in zip(a, b):
            if tuple(x[:3]) != tuple(y[:3]):
                positions += 1
            elif not (x[3] <= -1e29 and y[3] <= -1e29):
                lp = max(lp, abs(float(x[3]) - y[3]))
    return windows, positions, lp


def check(ctx) -> None:
    """Every answer of the window against the reference's answer for its
    walk set."""
    from reference import pacbio as R

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    lims = tr["limits"]
    lib = cfg["cli"]["libraries"][tr["library"]]
    ref = R.Reference(ctx.world.nodes, ctx.world.reads,
                      float(lib["mismatch_prob"]))
    seen = sorted({a["k"] for a in ctx.answers})
    plans = [ref.plan(ctx.pool[k]) for k in seen]
    width = int(cfg["forward_width"])
    lps = ref.forward(plans, ctx.program_device)
    want = {k: ref.finish(p, lp, **ctx.params)
            for k, p, lp in zip(seen, plans, lps)}
    ctx.work = {k: {"forward": bounds.forward_bound(
        [len(j.guide) - 1 for j in p.jobs], width,
        sum(len(f.target) for f in p.fills))} for k, p in zip(seen, plans)}
    if ctx.control is not None:
        import torch

        lps = ref.forward(plans, ctx.program_device,
                          getattr(torch, np.dtype(ctx.control).name))
        control = {k: ref.finish(p, lp, **ctx.params)
                   for k, p, lp in zip(seen, plans, lps)}
        ctx.answers = [dict(k=a["k"], score=control[a["k"]].score,
                            zero_reads=control[a["k"]].zero_reads,
                            total_len=control[a["k"]].total_len,
                            windows=control[a["k"]].windows,
                            jobs=control[a["k"]].jobs,
                            bad_bases=control[a["k"]].bad_bases)
                       for a in ctx.answers]
    gaps = dict.fromkeys(("jobs_gap", "positions_gap", "windows_gap",
                          "zero_reads_gap", "bad_bases_gap", "total_len_gap",
                          "logprob_gap", "score_rel_gap"), 0.0)
    for a in ctx.answers:
        w = want[a["k"]]
        windows, positions, lp = hit_gaps(a["windows"], w.windows)
        rel = abs(a["score"] - w.score) / abs(w.score) \
            if math.isfinite(a["score"]) else math.inf
        for name, v in (("jobs_gap", abs(a["jobs"] - w.jobs)),
                        ("positions_gap", positions),
                        ("windows_gap", windows),
                        ("zero_reads_gap", abs(a["zero_reads"]
                                               - w.zero_reads)),
                        ("bad_bases_gap", abs(a["bad_bases"] - w.bad_bases)),
                        ("total_len_gap", abs(a["total_len"] - w.total_len)),
                        ("logprob_gap", lp), ("score_rel_gap", rel)):
            gaps[name] = max(gaps[name], float(v))
    ctx.checks = {name: common.gap_check(v, lims[name])
                  for name, v in gaps.items()}

"""Traffic driver ``anneal``: the CLI's anneal, move by move.

Set-up makes the configuration's world, runs what the CLI's ``run``
runs before ``Optimizer.run`` (read sets, graph, start walks,
``ProbCalculator``, ``prepare_reads``, ``Optimizer``) and warms the
device shapes of the start scoring: each read set's device rescorer
scores the start walks' windows (the long nodes, both strands) once,
which leaves the alignment caches as they were.  With the traffic's
``warm_moves`` at 0 the window then runs ``Optimizer.run``'s prologue
(reachability, the start scoring, the start walks written out), else
set-up runs it and that many moves.  The window runs ``Optimizer.step``
until its time is up, each move timed from the start of its proposal to
the end of its accept decision; the optimizer writes its outputs every
100 iterations, as in the CLI.  Under the default routing only the start
scoring's batches are big enough for the card.

Every scoring call (``ProbCalculator.calc_prob``) is recorded: the walk
set as the paired scorer took it, how many windows each read set's
alignment cache held when the call started, and what the call answered;
of a sample of calls drawn from the seed, the paired states after the
call too.  After the window a fresh ``ProbCalculator`` scores the best
walk set from an empty state.  The reference follows every call from an
empty state and judges the sampled calls and the fresh one.
"""
from __future__ import annotations

import gc
import math
import os
import time

import numpy as np

from harness import common


class Recorder:
    """Wraps ``calc_prob``.  Of every call it keeps the paired scorer's
    walk set after the call (the call's walks, made tuples by the
    scorer), the cache sizes before it and its answer; of the calls whose
    number (the start scoring is 0) is in ``sample``, the walks as given
    and every paired state after the call."""

    def __init__(self, pc, read_sets, sample):
        self.pc, self.read_sets, self.sample = pc, read_sets, sample
        self.fn = pc.calc_prob
        self.states = pc.paired_scoring_states
        self.paths, self.pre, self.out = [], [], []
        self.given, self.ends = {}, {}
        pc.calc_prob = self

    def __call__(self, paths, zeros=None):
        k = len(self.out)
        if k in self.sample:
            self.given[k] = [tuple(p) for p in paths]
        self.pre.append([len(rs.aligment_cache) for rs in self.read_sets])
        own = [] if zeros is None else zeros
        prob, total = self.fn(paths, own)
        self.paths.append(self.states[0].old_paths)
        self.out.append((prob, total, [z for z, _n in own]))
        if k in self.sample:
            self.ends[k] = [(st.probs.copy(), st.bad_bases)
                            for st in self.states]
        return prob, total


def setup(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    worlds = ctx.cell.worlds()
    s_world, s_anneal, s_sample = common.seeds(ctx.seed, 3)
    t = time.perf_counter()
    ctx.world = worlds.make(cfg, s_world, ctx.root)
    anneal_seed = int(s_anneal.generate_state(1)[0])
    cfg_path = worlds.write_cli_config(cfg, ctx.world, anneal_seed,
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
    from gaml_tpu_torch.cli import (get_longest_read, prepare_reads,
                                    starting_paths_from_config)
    from gaml_tpu_torch.config import load_config, prepare_read_sets
    from gaml_tpu_torch.core.io import load_lastgraph
    from gaml_tpu_torch.optimize.anneal import Optimizer
    from gaml_tpu_torch.optimize.settings import AssemblySettings
    from gaml_tpu_torch.scoring.calculator import ProbCalculator

    configs, sections = load_config(cfg_path)
    single, paired, pacbio = prepare_read_sets(
        sections, backend="device", device=ctx.program_device)
    settings = AssemblySettings.from_config(configs)
    graph = load_lastgraph(configs["graph"])
    paths = starting_paths_from_config(configs, graph, settings)
    pc = ProbCalculator(single, paired, pacbio, graph)
    advice_paired = [pair for c, pair in paired if c.advice]
    advice_pacbio = [rs for c, rs in pacbio if c.advice]
    prepare_reads(single, paired, pacbio, graph)
    log = open(os.path.join(ctx.root, "anneal.log"), "w")
    opt = Optimizer(graph, pc, settings, advice_paired, advice_pacbio,
                    get_longest_read(single, paired, pacbio),
                    log=lambda line: log.write(line + "\n"))
    ctx.times["read_sets_s"] = time.perf_counter() - t
    read_sets = [rs for _c, pair in paired for rs in pair]
    rng = np.random.default_rng(s_sample)
    sample = set(rng.choice(np.arange(1, int(tr["sample_span"])),
                            int(tr["sampled_calls"]), replace=False).tolist())
    rec = Recorder(pc, read_sets, sample | {0})
    t = time.perf_counter()
    longs = [x for x in ctx.world.nodes if len(x) > settings.threshold]
    longs += [worlds.revcomp(x) for x in longs]
    for rs in read_sets:
        resc = rs.aligner.ensure_device_rescorer()
        resc.rescore(longs, None, log_match=math.log(rs.match_prob),
                     log_mismatch=math.log(rs.mismatch_prob),
                     total_len=int(sum(map(len, longs))))
        ctx.tracer.wrap(rs, "precompute_alignment_for_subpaths", "align")
        ctx.tracer.wrap(resc.gen, "query", "candgen")
    ctx.tracer.wrap(pc, "calc_prob", "score")
    ctx.times["warm_s"] = time.perf_counter() - t
    return dict(opt=opt, graph=graph, paths=paths, rec=rec,
                read_sets=read_sets, log=log,
                program=(single, paired, pacbio))


def start(ctx, st):
    """Optimizer.run's prologue: reachability, the start scoring and the
    start walks written out."""
    from gaml_tpu_torch.core.io import output_paths_to_file
    from gaml_tpu_torch.optimize import anneal

    opt, s = st["opt"], st["opt"].settings
    opt.prepare()
    paths = [list(p) for p in st["paths"]]
    opt.cur_prob, _total = opt.prob_calc.calc_prob(paths)
    output_paths_to_file(paths, st["graph"], anneal.KMER, s.threshold,
                         s.output_prefix)
    anneal._clean_lone_duplicates(paths)
    opt.best_prob = opt.cur_prob
    opt.best_paths = [list(p) for p in paths]
    return paths


def run(ctx) -> None:
    st = setup(ctx)
    opt, rec = st["opt"], st["rec"]
    warm = int(ctx.cell.traffic.get("warm_moves", 0))
    aligners = [a.aligner for a in st["read_sets"]]
    paths = None
    if warm:
        paths = start(ctx, st)
        for _ in range(warm):
            paths = opt.step(paths)
    ctx.setup_done()

    times = []
    seconds = ctx.window_seconds()
    batches0 = sum(a.device_batches for a in aligners)
    timers0 = {k: opt.metrics.timers[k][0] for k in ("propose", "rescore")}
    ctx.tracer.start()
    with ctx.tracer.span("window"):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        if paths is None:
            with ctx.tracer.span("start"):
                paths = start(ctx, st)
            ctx.layer["start_scoring_s"] = time.perf_counter() - t0
        while True:
            a = time.perf_counter()
            with ctx.tracer.span("move"):
                paths = opt.step(paths)
            b = time.perf_counter()
            times.append(b - a)
            if b >= deadline:
                break
        t1 = time.perf_counter()
    ctx.tracer.stop()
    ctx.window_closed()
    st["log"].close()

    moves = len(times)
    ctx.e2e["moves_per_s"] = (moves / (t1 - t0), "moves/s")
    ctx.e2e["move_p95_ms"] = (float(np.percentile(np.asarray(times) * 1e3,
                                                   95)), "ms")
    ctx.attempted = moves
    ctx.failed = 0
    timers = opt.metrics.timers
    ctx.layer["moves"] = moves
    for k in ("propose", "rescore"):
        ctx.layer[k + "_s"] = timers[k][0] - timers0[k]
    ctx.layer["device_batches"] = sum(a.device_batches
                                      for a in aligners) - batches0
    ctx.layer["calls"] = len(rec.out)
    fresh(st, rec)
    rec.pc = rec.fn = rec.states = rec.read_sets = None
    ctx.rec = rec
    # the program's caches: their keys in insertion order, and their
    # alignments, judged window by window
    ctx.cache_keys = [list(rs.aligment_cache) for rs in st["read_sets"]]
    ctx.program_windows = [rs.aligment_cache for rs in st["read_sets"]]
    del st, opt
    gc.collect()
    ctx.free_device()
    t = time.perf_counter()
    check(ctx)
    ctx.times["check_s"] = time.perf_counter() - t


def fresh(st, rec) -> None:
    """The best walk set scored by a new ``ProbCalculator`` (an empty
    state; the read sets and their caches as the window left them)."""
    from gaml_tpu_torch.scoring.calculator import ProbCalculator

    opt = st["opt"]
    pc = ProbCalculator(*st["program"], st["graph"])
    pre = [len(rs.aligment_cache) for rs in st["read_sets"]]
    zeros = []
    prob, total = pc.calc_prob(opt.best_paths, zeros)
    rec.best = (opt.best_prob, [tuple(p) for p in opt.best_paths])
    rec.fresh = dict(
        pre=pre, paths=pc.paired_scoring_states[0].old_paths,
        given=[tuple(p) for p in opt.best_paths],
        out=(prob, total, [z for z, _n in zeros]),
        ends=[(s.probs, s.bad_bases) for s in pc.paired_scoring_states])


def check(ctx) -> None:
    """Every call followed from an empty state; each sampled call's and
    the fresh call's totals against the program's paired states, and
    their score, zero reads and total length against the program's
    answers."""
    from reference import shortread as R

    cfg, rec = ctx.cell.config, ctx.rec
    lims = ctx.cell.traffic["limits"]
    numbers = {}

    def walks_of(paths):
        return [numbers.setdefault(p, len(numbers)) for p in paths]

    calls = [walks_of(p) for p in rec.paths]
    fresh_call = walks_of(rec.fresh["paths"])
    table = list(numbers)
    graph = R.Graph(ctx.world.nodes)
    judged = sorted(rec.ends)
    kept = {k: (rec.out[k], rec.ends[k], calls[k]) for k in judged}
    kept["fresh"] = (rec.fresh["out"], rec.fresh["ends"], fresh_call)
    control = ctx.control
    state = bad = rel = zeros = tl = uncached = by_bfs = mismatched = 0
    ref = {k: 0.0 for k in kept}
    # the program's answers, or with the control in its place the
    # reference's in lower precision
    got = {k: 0.0 if control is not None else v[0][0]
           for k, v in kept.items()}
    for j, (name, keys) in enumerate(cfg["cli"]["libraries"].items()):
        m1, m2 = ctx.world.libraries[name]
        mates = slice(2 * j, 2 * j + 2)
        lib = R.PairedLibrary(graph, m1, m2, keys, ctx.program_device,
                              ctx.program_windows[mates], table)
        cache_keys = ctx.cache_keys[mates]
        nets = lib.replay(calls, cache_keys, [p[mates] for p in rec.pre],
                          set(judged))
        nets["fresh"] = lib.replay([fresh_call], cache_keys,
                                   [rec.fresh["pre"][mates]], {0})[0]
        uncached += lib.uncached(cache_keys)
        lib.prefetch(nets.values())
        for k, net in nets.items():
            (_p, total, zs), ends, walks = kept[k]
            probs, size, want_bad = lib.totals(net)
            have, have_bad = ends[j]
            length = sum(graph.walk_len(table[w]) for w in walks)
            if control is not None:
                have = lib.totals(net, control)[0]
                have_bad = want_bad
                s, z = lib.score(have, want_bad, length, control)
                got[k] += s * lib.weight
                zs = list(zs)
                zs[j] = z
            scale = np.maximum(size, np.median(size[size > 0])
                               if (size > 0).any() else 1.0)
            state = max(state, float(np.max(np.abs(
                have.astype(np.float64) - probs) / scale)))
            bad = max(bad, abs(have_bad - want_bad))
            s, z = lib.score(have.astype(np.float64), want_bad, length)
            ref[k] += s * lib.weight
            zeros = max(zeros, abs(zs[j] - z))
            tl = max(tl, abs(total - length))
        by_bfs += sum(al.by_bfs for al in lib.al)
        mismatched += sum(al.mismatched for al in lib.al)
        del lib, nets
    for k in kept:
        if not np.isfinite(got[k]):
            rel = math.inf
            continue
        rel = max(rel, abs(got[k] - ref[k]) / abs(ref[k]))
    given = [(rec.given[k], rec.paths[k]) for k in judged]
    given.append((rec.fresh["given"], rec.fresh["paths"]))
    best_prob, best_paths = rec.best
    best = sorted(walks_of(best_paths))
    recorded = any(rec.out[k][0] == best_prob and sorted(calls[k]) == best
                   for k in range(len(calls)))
    ctx.layer["windows_by_bfs"] = by_bfs
    ctx.checks = {
        "score_rel_gap": common.gap_check(rel, lims["score_rel_gap"]),
        "state_rel_gap": common.gap_check(state, lims["state_rel_gap"]),
        "bad_bases_gap": common.gap_check(bad, lims["bad_bases_gap"]),
        "zero_reads_gap": common.gap_check(zeros, lims["zero_reads_gap"]),
        "total_len_gap": common.gap_check(tl, lims["total_len_gap"]),
        "windows_mismatched": common.gap_check(
            mismatched, lims["windows_mismatched"]),
        "windows_uncached": common.gap_check(uncached, 0),
        "walk_sets_mismatched": common.gap_check(
            sum(list(a) != list(b) for a, b in given), 0),
        "best_unrecorded": common.gap_check(0 if recorded else 1, 0),
        "judged_calls_short": common.gap_check(
            max(0, 3 - len(kept)), 0)}

"""Traffic driver ``hybrid_anneal``: the CLI's anneal, move by move, over
a paired library and a long-read (PacBio) advice library in one
likelihood.

Set-up makes the configuration's world and runs what the CLI's ``run``
runs before ``Optimizer.run`` (``prepare_read_sets`` on every library,
the graph, the start walks, ``ProbCalculator``, ``prepare_reads``, which
computes the long-read anchors, and ``Optimizer`` with the long-read set
among its advice sets).  It warms the paired read sets' device rescorers
as ``drivers/anneal.py`` does, and the long-read engine (seed lookup,
staging, the forward) by filling the windows of a few start walks, then
empties the long-read cache again.  With the traffic's ``warm_moves`` at
0 the window opens with ``Optimizer.run``'s prologue (the start
scoring), then runs ``Optimizer.step`` until its time is up, each move
timed from the start of its proposal to the end of its accept decision.

Every scoring call (``ProbCalculator.calc_prob``) is recorded: the walk
set as the paired scorer took it, each paired mate's cache size before
it, its answer and each library's part of it (the paired score; the
long-read score and bad bases); of a sample of calls drawn from the
seed, the walks as given and the paired states after the call too.
Every fill of the long-read cache (``precompute_ranges_for_paths``, from
a scoring call or a move's prefetch) is recorded with its walks, the
cache's size before it and the forward jobs it ran.  After the window a
fresh ``ProbCalculator`` scores the best walk set.  The reference
(``reference/hybrid.py``) follows every call and every fill, and judges
the sampled calls, the fresh call and the long-read cache window by
window.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np

from harness import common

anneal = common.load_module("drivers", "anneal")
pacbio_rescore = common.load_module("drivers", "pacbio_rescore")
WARM_WALKS = 8  # start walks whose fill warms the long-read engine


class Recorder:
    """Wraps ``calc_prob`` as ``drivers/anneal.py``'s ``Recorder`` does, and
    besides records each library's part of every call and every fill of
    the long-read set ``pb``.  ``close`` undoes the module patches."""

    def __init__(self, pc, read_sets, pb, sample):
        from gaml_tpu_torch.scoring import calculator, pacbio_score

        self.pc, self.read_sets, self.pb, self.sample = (pc, read_sets, pb,
                                                         sample)
        self.fn = pc.calc_prob
        self.states = pc.paired_scoring_states
        self.paths, self.pre, self.out, self.parts = [], [], [], []
        self.given, self.ends = {}, {}
        self.numbers = {}     # walk tuple -> its number
        self.fills = []       # (walk numbers, cache size before, jobs)
        self.routes = {}      # forward batches by route
        self._jobs = self._bad = 0
        self._part = {}
        self.modules = (calculator, pacbio_score)
        self.saved = (calculator.calc_score_for_paths_incremental,
                      calculator.calc_score_for_pacbio,
                      pacbio_score.sweep_walk)
        paired_fn, pacbio_fn, sweep = self.saved

        def paired_part(*a, **kw):
            out = paired_fn(*a, **kw)
            self._part["paired"] = self._part.get("paired", 0.0) + out[0]
            return out

        def pacbio_part(*a, **kw):
            out = pacbio_fn(*a, **kw)
            self._part["pacbio"] = out[0]
            return out

        def counted_sweep(*a, **kw):
            out = sweep(*a, **kw)
            self._bad += int(out[2])
            return out

        calculator.calc_score_for_paths_incremental = paired_part
        calculator.calc_score_for_pacbio = pacbio_part
        pacbio_score.sweep_walk = counted_sweep
        fill, forward = pb.precompute_ranges_for_paths, pb._forward_batch

        def recorded_fill(graph, paths):
            before, self._jobs = len(pb.aligment_cache), 0
            out = fill(graph, paths)
            self.fills.append((self.walks_of(paths), before, self._jobs))
            return out

        def counted_forward(seq, jobs, extents=None):
            cells = dict(getattr(pb, "dp_cells", None) or {})
            out = forward(seq, jobs, extents)
            self._jobs += len(jobs)
            for k, v in pb.dp_cells.items():
                if v != cells.get(k, 0):
                    self.routes[k] = self.routes.get(k, 0) + 1
            return out

        pb.precompute_ranges_for_paths = recorded_fill
        pb._forward_batch = counted_forward
        pc.calc_prob = self

    def walks_of(self, paths):
        return [self.numbers.setdefault(tuple(p), len(self.numbers))
                for p in paths]

    def take(self):
        """The last call's parts: (paired score, long-read score, long-read
        bad bases)."""
        out = (self._part.get("paired", 0.0), self._part.get("pacbio", 0.0),
               self._bad)
        self._part, self._bad = {}, 0
        return out

    def __call__(self, paths, zeros=None):
        k = len(self.out)
        if k in self.sample:
            self.given[k] = [tuple(p) for p in paths]
        self.pre.append([len(rs.aligment_cache) for rs in self.read_sets])
        own = [] if zeros is None else zeros
        self.take()
        prob, total = self.fn(paths, own)
        self.paths.append(self.states[0].old_paths)
        self.out.append((prob, total, [z for z, _n in own]))
        self.parts.append(self.take())
        if k in self.sample:
            self.ends[k] = [(st.probs.copy(), st.bad_bases)
                            for st in self.states]
        return prob, total

    def close(self) -> None:
        calculator, pacbio_score = self.modules
        (calculator.calc_score_for_paths_incremental,
         calculator.calc_score_for_pacbio,
         pacbio_score.sweep_walk) = self.saved
        for attr in ("precompute_ranges_for_paths", "_forward_batch"):
            self.pb.__dict__.pop(attr, None)


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
    paths = starting_paths_from_config(configs, graph, settings,
                                       write_outputs=False)
    pc = ProbCalculator(single, paired, pacbio, graph)
    advice_paired = [pair for c, pair in paired if c.advice]
    advice_pacbio = [rs for c, rs in pacbio if c.advice]
    _lib, pb = pacbio[0]
    if pb.forward_width != int(cfg["forward_width"]):
        raise SystemExit(f"the read set's band is {pb.forward_width}, the "
                         f"configuration's {cfg['forward_width']}")
    anchors = pb.compute_anchors

    def timed_anchors(*a, **kw):
        t0 = time.perf_counter()
        anchors(*a, **kw)
        ctx.times["anchors_s"] = time.perf_counter() - t0

    pb.compute_anchors = timed_anchors
    prepare_reads(single, paired, pacbio, graph)
    del pb.compute_anchors
    log = open(os.path.join(ctx.root, "anneal.log"), "w")
    opt = Optimizer(graph, pc, settings, advice_paired, advice_pacbio,
                    get_longest_read(single, paired, pacbio),
                    log=lambda line: log.write(line + "\n"))
    ctx.times["read_sets_s"] = time.perf_counter() - t
    read_sets = [rs for _c, pair in paired for rs in pair]

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
    # the long-read engine: one fill of a few start walks, then an empty
    # cache again
    pb.precompute_ranges_for_paths(graph, paths[:WARM_WALKS])
    pb.aligment_cache = {}
    ctx.times["warm_s"] = time.perf_counter() - t
    rng = np.random.default_rng(s_sample)
    sample = set(rng.choice(np.arange(1, int(tr["sample_span"])),
                            int(tr["sampled_calls"]), replace=False).tolist())
    rec = Recorder(pc, read_sets, pb, sample | {0})
    ctx.tracer.wrap(pc, "calc_prob", "score")
    return dict(opt=opt, graph=graph, paths=paths, rec=rec,
                read_sets=read_sets, pb=pb, log=log,
                program=(single, paired, pacbio))


def run(ctx) -> None:
    st = setup(ctx)
    try:
        window(ctx, st)
        fresh(st, st["rec"])
    finally:
        st["rec"].close()
    finish(ctx, st)
    t = time.perf_counter()
    check(ctx)
    ctx.times["check_s"] = time.perf_counter() - t


def finish(ctx, st) -> None:
    """What the check reads, kept on ``ctx``; the program let go."""
    from gaml_tpu_torch.utils.metrics import LAUNCHES

    rec = st["rec"]
    print(f"pacbio.anneal: {ctx.layer.get('moves')} moves, {len(rec.out)} "
          f"scoring calls, {len(rec.fills)} long-read fills "
          f"({ctx.layer.get('window_fills')} in the window); forward batches "
          f"by route {rec.routes}, cells by route {st['pb'].dp_cells}; "
          f"launches {dict(sorted(LAUNCHES.items()))}; set-up "
          f"{ {k: round(v, 3) for k, v in ctx.times.items()} }",
          file=sys.stderr)
    rec.pc = rec.fn = rec.states = rec.read_sets = rec.pb = None
    rec.modules = rec.saved = None
    ctx.rec = rec
    # the programs' caches: the paired mates' keys in insertion order and
    # alignments; the long-read cache's keys in order and hits
    ctx.cache_keys = [list(rs.aligment_cache) for rs in st["read_sets"]]
    ctx.program_windows = [rs.aligment_cache for rs in st["read_sets"]]
    ctx.long_keys = list(st["pb"].aligment_cache)
    ctx.long_windows = st["pb"].aligment_cache
    lib = [c for c, _rs in st["program"][2]][0]
    ctx.params = dict(penalty=lib.penalty_constant, cov_move=lib.step,
                      min_prob_per_base=lib.min_prob_per_base,
                      min_prob_start=lib.min_prob_start)
    st.clear()
    gc.collect()
    ctx.free_device()


def window(ctx, st) -> None:
    opt, rec = st["opt"], st["rec"]
    warm = int(ctx.cell.traffic.get("warm_moves", 0))
    aligners = [a.aligner for a in st["read_sets"]]
    paths = None
    if warm:
        paths = anneal.start(ctx, st)
        for _ in range(warm):
            paths = opt.step(paths)
    ctx.setup_done()

    times = []
    seconds = ctx.window_seconds()
    batches0 = sum(a.device_batches for a in aligners)
    timers0 = {k: opt.metrics.timers[k][0] for k in ("propose", "rescore")}
    fills0 = len(rec.fills)
    ctx.tracer.start()
    with ctx.tracer.span("window"):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        if paths is None:
            with ctx.tracer.span("start"):
                paths = anneal.start(ctx, st)
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
    ctx.layer["window_fills"] = (fills0, len(rec.fills))


def fresh(st, rec) -> None:
    """The best walk set scored by a new ``ProbCalculator`` (an empty
    state; the read sets and their caches as the window left them)."""
    from gaml_tpu_torch.scoring.calculator import ProbCalculator

    opt = st["opt"]
    pc = ProbCalculator(*st["program"], st["graph"])
    pre = [len(rs.aligment_cache) for rs in st["read_sets"]]
    zeros = []
    rec.take()
    prob, total = pc.calc_prob(opt.best_paths, zeros)
    rec.best = (opt.best_prob, [tuple(p) for p in opt.best_paths])
    rec.fresh = dict(
        pre=pre, paths=pc.paired_scoring_states[0].old_paths,
        given=[tuple(p) for p in opt.best_paths],
        out=(prob, total, [z for z, _n in zeros]), parts=rec.take(),
        ends=[(s.probs, s.bad_bases) for s in pc.paired_scoring_states])


def check(ctx) -> None:
    """Every call and every long-read fill followed by the reference; the
    sampled calls' and the fresh call's paired totals against the
    program's paired states, each library's score, zero reads, bad bases
    and total length, and their sum against the program's answer; the
    long-read cache fill by fill and hit by hit."""
    from reference import hybrid as H
    from reference import shortread as R

    cfg, rec, control = ctx.cell.config, ctx.rec, ctx.control
    lims = ctx.cell.traffic["limits"]
    libs = cfg["cli"]["libraries"]
    paired_names = [n for n, k in libs.items() if k["type"] != "pacbio"]
    long_name, = [n for n, k in libs.items() if k["type"] == "pacbio"]
    walks_of = rec.walks_of
    calls = [walks_of(p) for p in rec.paths]
    fresh_call = walks_of(rec.fresh["paths"])
    table = list(rec.numbers)
    judged = sorted(rec.ends)
    kept = {k: (rec.out[k], rec.ends[k], calls[k], rec.parts[k],
                rec.given[k]) for k in judged}
    kept["fresh"] = (rec.fresh["out"], rec.fresh["ends"], fresh_call,
                     rec.fresh["parts"], rec.fresh["given"])
    gaps = dict.fromkeys(lims, 0.0)

    def gap(name, v):
        gaps[name] = max(gaps[name], float(v))

    # the long-read library: every fill followed, one forward for all
    lrc = H.LongReadCache(ctx.world.nodes, ctx.world.reads,
                          float(libs[long_name]["mismatch_prob"]))
    followed = []
    for walks, before, jobs in rec.fills:
        ref_before = len(lrc.reserved)
        missing, new, n_jobs = lrc.fill([table[w] for w in walks])
        followed.append((before, ref_before, new, missing))
        gap("jobs_gap", abs(jobs - n_jobs) if control is None else 0)
    lps = lrc.forward_all(ctx.program_device)
    want = {k: lrc.answer(v[4], lps, **ctx.params) for k, v in kept.items()}
    have_long = {k: (v[3][1], v[0][2][len(paired_names)], v[3][2])
                 for k, v in kept.items()}
    windows, keys = ctx.long_windows, ctx.long_keys
    if control is not None:
        import torch

        lps = lrc.forward_all(ctx.program_device,
                              getattr(torch, np.dtype(control).name))
        low = {k: lrc.answer(v[4], lps, **ctx.params)
               for k, v in kept.items()}
        have_long = {k: (a.score, a.zero_reads, a.bad_bases)
                     for k, a in low.items()}
        windows, keys = low["fresh"].windows, list(lrc.reserved)
        followed = [(ref_before, ref_before, new, missing)
                    for _b, ref_before, new, missing in followed]
    ctx.layer["ref_windows_missing"] = [f[3] for f in followed]
    # each fill's windows, by the program's cache sizes before each fill,
    # then every window's hits
    ends = [f[0] for f in followed[1:]] + [len(keys)]
    n_windows, positions, lp = pacbio_rescore.hit_gaps(
        windows, want["fresh"].windows)
    gap("windows_gap", n_windows + sum(
        len(set(keys[before:end]) ^ set(new))
        for (before, _rb, new, _m), end in zip(followed, ends)))
    gap("positions_gap", positions)
    gap("logprob_gap", lp)

    # the paired libraries: as drivers/anneal.py follows them
    graph = R.Graph(ctx.world.nodes)
    ref = {k: want[k].score * float(libs[long_name].get("weight", 1.0))
           for k in kept}
    got_paired = {k: 0.0 if control is not None else v[3][0]
                  for k, v in kept.items()}
    ref_paired = {k: 0.0 for k in kept}
    uncached = by_bfs = mismatched = 0
    for j, name in enumerate(paired_names):
        keys_j = libs[name]
        m1, m2 = ctx.world.libraries[name]
        mates = slice(2 * j, 2 * j + 2)
        lib = R.PairedLibrary(graph, m1, m2, keys_j, ctx.program_device,
                              ctx.program_windows[mates], table)
        cache_keys = ctx.cache_keys[mates]
        nets = lib.replay(calls, cache_keys, [p[mates] for p in rec.pre],
                          set(judged))
        nets["fresh"] = lib.replay([fresh_call], cache_keys,
                                   [rec.fresh["pre"][mates]], {0})[0]
        uncached += lib.uncached(cache_keys)
        lib.prefetch(nets.values())
        for k, net in nets.items():
            (_p, total, zs), ends_k, walks, _parts, _given = kept[k]
            probs, size, want_bad = lib.totals(net)
            have, have_bad = ends_k[j]
            length = sum(graph.walk_len(table[w]) for w in walks)
            z_have = zs[j]
            if control is not None:
                have = lib.totals(net, control)[0]
                have_bad = want_bad
                s, z_have = lib.score(have, want_bad, length, control)
                got_paired[k] += s * lib.weight
            scale = np.maximum(size, np.median(size[size > 0])
                               if (size > 0).any() else 1.0)
            gap("state_rel_gap", np.max(np.abs(
                have.astype(np.float64) - probs) / scale))
            gap("bad_bases_gap", abs(have_bad - want_bad))
            s, z = lib.score(have.astype(np.float64), want_bad, length)
            ref_paired[k] += s * lib.weight
            gap("zero_reads_gap", abs(z_have - z))
            gap("total_len_gap", abs(total - length))
        by_bfs += sum(al.by_bfs for al in lib.al)
        mismatched += sum(al.mismatched for al in lib.al)
        del lib, nets
    for k, (out, _e, _w, _parts, _g) in kept.items():
        score, zeros, bad = have_long[k]
        w = want[k]
        gap("zero_reads_gap", abs(zeros - w.zero_reads))
        gap("bad_bases_gap", abs(bad - w.bad_bases))
        gap("total_len_gap", abs(out[1] - w.total_len))
        got = out[0] if control is None else got_paired[k] + score
        ref[k] += ref_paired[k]
        gap("score_rel_gap", abs(got - ref[k]) / abs(ref[k])
            if math.isfinite(got) else math.inf)
        gap("paired_score_rel_gap",
            abs(got_paired[k] - ref_paired[k]) / abs(ref_paired[k])
            if math.isfinite(got_paired[k]) else math.inf)
    gap("windows_mismatched", mismatched)
    given = [(v[4], rec.paths[k]) for k, v in kept.items() if k != "fresh"]
    given.append((rec.fresh["given"], rec.fresh["paths"]))
    best_prob, best_paths = rec.best
    best = sorted(walks_of(best_paths))
    recorded = any(rec.out[k][0] == best_prob and sorted(calls[k]) == best
                   for k in range(len(calls)))
    ctx.layer["windows_by_bfs"] = by_bfs
    ctx.checks = {name: common.gap_check(v, lims[name])
                  for name, v in gaps.items()}
    ctx.checks.update({
        "windows_uncached": common.gap_check(uncached, 0),
        "walk_sets_mismatched": common.gap_check(
            sum(list(a) != list(b) for a, b in given), 0),
        "best_unrecorded": common.gap_check(0 if recorded else 1, 0),
        "judged_calls_short": common.gap_check(
            max(0, 3 - len(kept)), 0)})

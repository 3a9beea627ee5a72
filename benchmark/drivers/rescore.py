"""Traffic driver ``rescore``: a closed loop of whole-assembly rescores,
one in flight.

Set-up makes the configuration's world, runs the CLI's own set-up
(``prepare_read_sets``, ``prepare_reads``) for the traffic's library,
builds the read sets' device rescorers and a pool of assemblies (the true
chain and seeded misassemblies of it, each a list of contigs).  The window
cycles through the pool; each request scores the traffic's
``jobs_per_call`` assemblies (1 unless it says otherwise; more go in one
call as independent jobs) against one mate read set of the library
through ``DeviceRescorer.rescore``, which uploads the assemblies' bytes
itself.  Every answer is kept and held to the plain reference after the
window.
"""
from __future__ import annotations

import gc
import math
import os
import time

import numpy as np

from harness import bounds, common


def setup(ctx) -> dict:
    """The program's objects for the window (times into ctx.times)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    worlds = ctx.cell.worlds()
    s_world, s_pool = common.seeds(ctx.seed, 2)
    t = time.perf_counter()
    ctx.world = worlds.make(cfg, s_world, ctx.root)
    cfg_path = worlds.write_cli_config(cfg, ctx.world, 0,
                                       os.path.join(ctx.root, "out"))
    rng = np.random.default_rng(s_pool)
    ctx.pool = worlds.misassemblies(rng, ctx.world, int(tr["pool"]),
                                    tr["assemblies"])
    ctx.times["world_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from gaml_tpu_torch.native import get_lib
    from gaml_tpu_torch.ops import build

    get_lib()
    if ctx.device == "cuda":
        build.load()
    ctx.times["compile_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from gaml_tpu_torch.cli import prepare_reads
    from gaml_tpu_torch.config import load_config, prepare_read_sets
    from gaml_tpu_torch.core.io import load_lastgraph

    configs, sections = load_config(cfg_path)
    lib = tr["library"]
    single, paired, pacbio = prepare_read_sets(
        {lib: sections[lib]}, backend="device", device=ctx.program_device)
    graph = load_lastgraph(configs["graph"])
    prepare_reads(single, paired, pacbio, graph)
    mates = paired[0][1]
    rescorers = [rs.aligner.ensure_device_rescorer() for rs in mates]
    ctx.times["read_sets_s"] = time.perf_counter() - t
    params = [dict(log_match=math.log(rs.match_prob),
                   log_mismatch=math.log(rs.mismatch_prob),
                   min_prob_per_base=float(tr["min_prob_per_base"]),
                   min_prob_start=float(tr["min_prob_start"]))
              for rs in mates]
    ctx.match = [(rs.match_prob, rs.mismatch_prob) for rs in mates]
    ctx.n_reads = [rs.get_number_of_reads() for rs in mates]
    for r in rescorers:
        ctx.tracer.wrap(r.gen, "query", "candgen")
        ctx.tracer.wrap(r, "_extend", "extend")
        ctx.tracer.wrap(r, "score", "score")
    return {"rescorers": rescorers, "params": params, "keep": (single,
                                                                paired)}


def request(st, ctx, job: tuple, m: int):
    """One call: the assemblies ``job`` against mate read set ``m``."""
    seqs = [c for a in job for c in ctx.pool[a]]
    totals = [int(sum(len(c) for c in ctx.pool[a])) for a in job]
    kw = dict(st["params"][m])
    if len(job) > 1:
        kw.update(seg_job=np.repeat(np.arange(len(job)), [
            len(ctx.pool[a]) for a in job]), n_jobs=len(job))
    with ctx.tracer.span("rescore"):
        score, zeros, n = st["rescorers"][m].rescore(
            seqs, None, total_len=totals if len(job) > 1 else totals[0],
            **kw)
    return (job, m, np.atleast_1d(score) if score is not None else None,
            np.atleast_1d(zeros) if zeros is not None else None, n)


def run(ctx) -> None:
    st = setup(ctx)
    per = int(ctx.cell.traffic.get("jobs_per_call", 1))
    pool = len(ctx.pool)
    jobs = [tuple((a + i) % pool for i in range(per))
            for a in range(0, pool, per)]
    calls = [(job, m) for job in jobs
             for m in range(len(st["rescorers"]))]
    t = time.perf_counter()
    for job, m in calls:  # every shape of the window, once
        request(st, ctx, job, m)
    ctx.times["warm_s"] = time.perf_counter() - t
    ctx.setup_done()

    answers = []
    seconds = ctx.window_seconds()
    ctx.tracer.start()
    with ctx.tracer.span("window"):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = 0
        while True:
            answers.append(request(st, ctx, *calls[k % len(calls)]))
            k += 1
            if time.perf_counter() >= deadline:
                break
        t1 = time.perf_counter()
    ctx.tracer.stop()
    ctx.window_closed()

    reads = sum(ctx.n_reads[m] * len(job) for job, m, *_ in answers)
    ctx.e2e["reads_per_s"] = (reads / (t1 - t0), "reads/s")
    ctx.attempted = len(answers)
    ctx.failed = sum(1 for x in answers if x[2] is None)
    ctx.answers = answers
    ctx.layer["traced_calls"] = [(job, m) for job, m, *_ in answers]
    del st
    gc.collect()
    ctx.free_device()
    t = time.perf_counter()
    check(ctx)
    ctx.times["check_s"] = time.perf_counter() - t


def check(ctx) -> None:
    """Every answer of the window against the reference's answers for its
    assemblies and read set: each job's score and zero reads, and the
    call's candidates."""
    from reference import shortread as R

    tr = ctx.cell.traffic
    lims = tr["limits"]
    lib = ctx.world.libraries[tr["library"]]
    seen = sorted({(job, m) for job, m, *_ in ctx.answers})
    ref, aligned, work = {}, {}, {}
    floors = (float(tr["min_prob_per_base"]), float(tr["min_prob_start"]))
    dtype = ctx.control or np.float64
    for m in sorted({m for _job, m in seen}):
        idx = R.ReadIndex(lib[m])
        n_fp = len(np.unique(idx.sf))
        mine = sorted({a for job, mm in seen if mm == m for a in job})
        # every assembly's contigs in one aligned batch
        first = np.cumsum([0] + [len(ctx.pool[a]) for a in mine])
        batch = R.align_batch(idx, [c for a in mine for c in ctx.pool[a]],
                              ctx.program_device)
        for k, a in enumerate(mine):
            sel = (batch["seg"] >= first[k]) & (batch["seg"] < first[k + 1])
            al = {key: v[sel] for key, v in batch.items()}
            al["seg"] = al["seg"] - first[k]
            aligned[(a, m)] = al
            ref[(a, m)] = R.rescore(idx, ctx.pool[a], *ctx.match[m],
                                    *floors, ctx.program_device,
                                    aligned=al)[:3]
            if ctx.control is not None:
                ref[(a, m, "control")] = R.rescore(
                    idx, ctx.pool[a], *ctx.match[m], *floors,
                    ctx.program_device, dtype, aligned=al)[:3]
        for job, mm in seen:
            if mm != m:
                continue
            als = [aligned[(a, m)] for a in job]
            cols = {key: np.concatenate([al[key] for al in als])
                    for key in ("g0", "r0", "orient", "rid")}
            n = len(cols["rid"])
            g = int(sum(len(c) for a in job for c in ctx.pool[a]))
            runs = sum(len(np.unique((al["orient"] << 62) | (al["seg"] << 32)
                                     | al["g0"])) for al in als)
            work[(job, m)] = {
                "candgen": bounds.candgen_bound(g, n, runs, n_fp,
                                                len(idx.srid)),
                "extend": bounds.exact_bound(
                    cols["g0"], cols["r0"], np.full(n, idx.read_len),
                    cols["orient"], cols["rid"], g, idx.read_len)}
        del idx, batch
    ctx.work = work
    if ctx.control is not None:
        ctx.answers = [
            (job, m, [ref[(a, m, "control")][0] for a in job],
             [ref[(a, m, "control")][1] for a in job],
             sum(ref[(a, m, "control")][2] for a in job))
            for job, m, *_ in ctx.answers]
    rel = cand = zeros = 0.0
    for job, m, score, z, n in ctx.answers:
        if score is None or not np.all(np.isfinite(score)):
            rel = math.inf
            continue
        for a, s, za in zip(job, score, z):
            rs, rz, _rn = ref[(a, m)]
            rel = max(rel, abs(s - rs) / abs(rs))
            zeros = max(zeros, abs(za - rz))
        cand = max(cand, abs(n - sum(ref[(a, m)][2] for a in job)))
    ctx.checks = {
        "score_rel_gap": common.gap_check(rel, lims["score_rel_gap"]),
        "zero_reads_gap": common.gap_check(zeros, lims["zero_reads_gap"]),
        "candidates_gap": common.gap_check(cand, lims["candidates_gap"])}

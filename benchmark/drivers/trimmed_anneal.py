"""Traffic driver ``trimmed_anneal``: the CLI's anneal, move by move, over
paired libraries whose reads are not all one length (quality-trimmed).

Set-up, the window, the recording of every scoring call and the fresh
call after the window are ``drivers/anneal.py``'s.  With mixed read
lengths the read sets have no native bundle, so every miss batch of
every move runs candgen and the exact extension on the card.  The judge
is ``drivers/anneal.py``'s ``check`` with ``reference/trimmed.py`` in the
place of ``reference/shortread.py``: the same replay of every call, over
ragged read indexes queried at the program's stated query length (C11).

On standard error the line ``aureus_trimmed.anneal: ...`` gives the
moves, the scoring calls, each read set's query length (the program's
``index.read_len``), the device batches (the aligners' own count) and,
in a traced run, the program's counters ``align.device_batches``,
``align.device_windows`` and ``align.short_windows`` (absent in a
program without them), and the set-up split.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np

from harness import common
from harness.program_trace import store

anneal = common.load_module("drivers", "anneal")
COUNTERS = ("align.device_batches", "align.device_windows",
            "align.short_windows")


@contextlib.contextmanager
def judged_by_trimmed():
    """``anneal.check`` imports its reference as ``reference.shortread``;
    inside this block that name gives ``reference/trimmed.py``, which
    has the same ``Graph`` and a ``PairedLibrary`` over ragged reads."""
    import reference
    from reference import shortread, trimmed

    reference.shortread = trimmed
    try:
        yield
    finally:
        reference.shortread = shortread


def run(ctx) -> None:
    st = anneal.setup(ctx)
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
    ctx.layer["query_lengths"] = [a.index.read_len for a in aligners]
    tr = store() if ctx.traced else None
    counted = {k: tr.counters[k] for k in COUNTERS
               if tr is not None and k in tr.counters}
    print(f"{ctx.cell.name}: {moves} moves, {len(rec.out)} scoring calls; "
          f"query lengths {ctx.layer['query_lengths']}; device batches "
          f"{ctx.layer['device_batches']}; counters {counted}; set-up "
          f"{ {k: round(v, 3) for k, v in ctx.times.items()} }",
          file=sys.stderr)
    del opt, aligners
    finish(ctx, st)
    t = time.perf_counter()
    judge(ctx)
    ctx.times["check_s"] = time.perf_counter() - t


def finish(ctx, st) -> None:
    """The fresh call after the window, then what the judge reads kept on
    ``ctx``; the program let go."""
    rec = st["rec"]
    anneal.fresh(st, rec)
    rec.pc = rec.fn = rec.states = rec.read_sets = None
    ctx.rec = rec
    # the program's caches: their keys in insertion order, and their
    # alignments, judged window by window
    ctx.cache_keys = [list(rs.aligment_cache) for rs in st["read_sets"]]
    ctx.program_windows = [rs.aligment_cache for rs in st["read_sets"]]
    st.clear()
    gc.collect()
    ctx.free_device()


def judge(ctx) -> None:
    """``anneal.check`` over the ragged reference."""
    with judged_by_trimmed():
        anneal.check(ctx)

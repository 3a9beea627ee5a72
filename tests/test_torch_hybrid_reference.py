"""The port's hybrid anneal (a frag library and a long-read advice library
in one likelihood) against the benchmark's plain reference
(benchmark/reference/hybrid.py, loaded by path) on a seeded small world
of the ``ecoli_hybrid`` configuration's shapes, on the CPU: 60 kb, 2,000
frag pairs, 40 long reads of 0.5-4 kb at 13 % errors.  The anneal runs
through the cell's own module, benchmark/drivers/hybrid_anneal.py:
the CLI's set-up, the start scoring and a few dozen moves, every scoring
call and every long-read fill recorded, then its check.  The
paired states, both libraries' zero reads, bad bases and total length,
each fill's windows, jobs and hits are equal, log-probabilities and the
scores within the cell's limits (benchmark/traffic/pacbio_anneal.json);
the reference computed in float32 misses them.  Under torch.profiler
the port counts ``score.pacbio`` once a long-read set a scoring call and
``pacbio.windows_missing`` as the reference's missing windows."""
import copy
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaml_tpu_torch.utils.metrics import TRACE

from test_torch_kernels import port_native_lib

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.append(BENCH)

from harness import common  # noqa: E402
from harness.context import Context  # noqa: E402
from harness.trace import Tracer  # noqa: E402

DRIVER = common.load_module("drivers", "hybrid_anneal")
CELL = "pacbio.anneal"
MOVES = 40


def small_cell(genome_bp=60_000, pairs=2_000, reads=40,
               long_read_bp=(500, 4000)):
    """The cell with its world cut; 12 of its first 30 calls sampled."""
    cell = common.Cell(CELL)
    w = cell.config["world"]
    w.update(genome_bp=genome_bp, reads=reads,
             long_read_bp=list(long_read_bp))
    w["libraries"]["rs1"]["pairs"] = pairs
    cell.traffic.update(sample_span=30, sampled_calls=12)
    return cell


def anneal(root, cell, moves, seed=4294967311):
    """``hybrid_anneal``'s set-up, the start scoring and ``moves`` moves under
    torch.profiler (the program's spans and counters on), the fresh call
    and its record: (the run's context, the trace store's span
    calls by path and counters)."""
    args = common.parse_args(["--workload", CELL, "--seed", str(seed),
                              "--seconds", "0", "--trace", "0"])
    ctx = Context(cell, args, "cpu", root, 0.0, Tracer(False, root, False))
    st = DRIVER.setup(ctx)
    pb = st["pb"]
    ctx.anchors = (pb.anchors_cache, pb.anchors_begin, pb.anchors_end)
    ctx.graph = st["graph"]
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            paths = DRIVER.anneal.start(ctx, st)
            for _ in range(moves):
                paths = st["opt"].step(paths, write_outputs=False)
        spans = {path: n for path, (n, _t, _s) in TRACE.spans.items()}
        counters = dict(TRACE.counters)
    finally:
        TRACE.reset()
    ctx.layer["moves"] = moves
    ctx.layer["window_fills"] = (0, len(st["rec"].fills))
    try:
        DRIVER.fresh(st, st["rec"])
    finally:
        st["rec"].close()
    ctx.rec_calls = len(st["rec"].out)
    DRIVER.finish(ctx, st)
    return ctx, spans, counters


def judged(ctx, control=None):
    ctx.control = control
    DRIVER.check(ctx)
    return {k: c["value"] for k, c in ctx.checks.items()}


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The anneal with every long-read batch on the native kernel
    (float64), judged, and judged again with the reference in float32 in
    the program's place.  Torch on one thread."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = os.environ.get("GAML_PB_DEVICE_MIN_CELLS")
    os.environ["GAML_PB_DEVICE_MIN_CELLS"] = str(1 << 62)
    try:
        cell = small_cell()
        ctx, spans, counters = anneal(
            str(tmp_path_factory.mktemp("hybrid")), cell, MOVES)
        sound = judged(ctx)
        missing = list(ctx.layer["ref_windows_missing"])
        control = judged(copy.copy(ctx), np.float32)
        yield dict(ctx=ctx, spans=spans, counters=counters, sound=sound,
                   control=control, missing=missing, cell=cell)
    finally:
        torch.set_num_threads(threads)
        if saved is None:
            os.environ.pop("GAML_PB_DEVICE_MIN_CELLS", None)
        else:
            os.environ["GAML_PB_DEVICE_MIN_CELLS"] = saved


def test_world_shapes_and_anchors_equal_the_references(native):
    """Both libraries in the world, the long reads' law, and the port's
    anchors (computed in the CLI's set-up) equal to the reference's."""
    from reference import hybrid as H

    ctx = native["ctx"]
    w = ctx.world
    m1, m2 = w.libraries["rs1"]
    assert m1.shape == m2.shape == (2000, 100)
    lens = np.array([len(r) for r in w.reads])
    assert len(lens) == 40 and lens.min() >= 500 and lens.max() <= 4000
    assert len(w.nodes) > w.n_chain  # the side branches
    ref = H.LongReadCache(w.nodes, w.reads, 0.0375)
    assert ref.anchored and ref.at_end
    assert ctx.anchors == (ref.anchored, ref.at_begin, ref.at_end)


def test_anneal_follows_the_reference(native):
    """Every exact number equal, every other within the cell's limits, on
    at least three judged calls; the anneal proposed long-read advice
    moves and its moves filled the long-read cache."""
    ctx, got = native["ctx"], native["sound"]
    limits = native["cell"].traffic["limits"]
    assert set(limits) <= set(got)
    for name, v in got.items():
        assert v <= limits.get(name, 0), (name, v)
    assert len(ctx.rec.ends) + 1 >= 3
    assert native["counters"].get("moves.advice_pacbio", 0) > 0
    fills = ctx.rec.fills
    assert len(fills) > ctx.rec_calls and sum(j for *_w, j in fills) > 0
    assert len(ctx.long_keys) > 0


def test_float32_control_is_not_correct(native):
    """The reference in float32 in the program's place misses the
    long-read log-probabilities, the score and the paired states."""
    got, limits = native["control"], native["cell"].traffic["limits"]
    for name in ("logprob_gap", "score_rel_gap", "state_rel_gap"):
        assert got[name] > limits[name], (name, got[name])
    for name in ("jobs_gap", "windows_gap", "positions_gap"):
        assert got[name] == 0


def test_spans_and_counters_of_the_long_read_scorer(native):
    """``score.pacbio`` once a scoring call (one long-read set), always
    inside ``score``; ``pacbio.windows_missing`` equal to the missing
    windows the reference found in the traced fills (all but the fresh
    call's)."""
    ctx, spans, counters = native["ctx"], native["spans"], native["counters"]
    paths = {p: n for p, n in spans.items()
             if p.split("/")[-1] == "score.pacbio"}
    assert paths and all(p.split("/")[-2] == "score" for p in paths)
    scores = sum(n for p, n in spans.items() if p.split("/")[-1] == "score")
    assert sum(paths.values()) == scores == ctx.rec_calls
    traced = native["missing"][:ctx.layer["window_fills"][1]]
    assert counters["pacbio.windows_missing"] == sum(traced) > 0


def test_anchors_span(native, tmp_path):
    """``pacbio.anchors`` once around a fresh anchor computation."""
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    w = native["ctx"].world
    rs = PacbioReadSet(str(tmp_path / "pb"), w.fastq_path, 0.85, 0.0375,
                       device="cpu")
    rs.preprocess_reads()
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            rs.compute_anchors(native["ctx"].graph, persist=False)
        spans = {path: n for path, (n, _t, _s) in TRACE.spans.items()}
    finally:
        TRACE.reset()
    assert spans == {"pacbio.anchors": 1}
    assert rs.anchors_cache == native["ctx"].anchors[0]


def test_engine_route_follows_the_reference(tmp_path, monkeypatch):
    """Every long-read batch on the forward engine (its plain torch
    version here, K5's on a card, float32 results) on a smaller world:
    within the cell's limits, every exact number equal."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = small_cell(genome_bp=30_000, pairs=1_000, reads=16,
                          long_read_bp=(500, 800))
        ctx, _spans, counters = anneal(str(tmp_path), cell, 20)
        got = judged(ctx)
    finally:
        torch.set_num_threads(threads)
    assert counters["pacbio.device_batches"] > 0
    assert "pacbio.native_batches" not in counters
    for name, v in got.items():
        assert v <= cell.traffic["limits"].get(name, 0), (name, v)

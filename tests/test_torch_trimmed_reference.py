"""The port on quality-trimmed paired libraries (reads of mixed lengths, so
no native bundle) against the benchmark's plain reference
(benchmark/reference/trimmed.py, loaded by path), on the CPU.

- The anneal of the ``aureus_trimmed.anneal`` cell on seeded small
  worlds of its configuration's shapes (60 kb, 4,000 frag and 1,000
  advice pairs, 20 % of every mate file's reads cut to 60-99 bp), run
  through the cell's own driver (the CLI's set-up, the start scoring and
  a few dozen moves) and judged on every scoring call: the paired
  states and the score within the cell's limits, bad bases, zero reads,
  total length and windows exactly; the reference in float32 misses.
- The query length (ROADMAP C11): the reference's, the program's index's
  and the rule written out here agree; both skip the windows shorter
  than it.
- With no read trimmed the ragged reference equals reference/shortread.py.
- The single-end rescore over ragged reads, each read at its own length.
- The counters ``align.short_windows``, ``align.device_batches`` and
  ``align.device_windows`` on batches whose counts are known, on both
  branches of the device route, and in ``cli --trace``'s summary."""
import json
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

DRIVER = common.load_module("drivers", "trimmed_anneal")
WORLDS = common.load_module("worlds", "trimmed")
PAIRED = common.load_module("worlds", "paired")
T = common.load_module("reference", "trimmed")
S = common.load_module("reference", "shortread")
CELL = "aureus_trimmed.anneal"
MOVES = 30
COUNTERS = ("align.short_windows", "align.device_batches",
            "align.device_windows")


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def small_cell(genome_bp=60_000, share=0.2, judged=300):
    """The cell with its world cut (the pairs in proportion, as the
    benchmark's own small cells) and every one of its first ``judged``
    scoring calls sampled."""
    cell = common.Cell(CELL)
    w = cell.config["world"]
    w["genome_bp"] = genome_bp
    w["libraries"]["rs1"]["pairs"] = genome_bp // 15
    w["libraries"]["rs2"]["pairs"] = genome_bp // 60
    w["trim"]["share"] = share
    cell.traffic.update(sample_span=judged + 1, sampled_calls=judged)
    return cell


def small_world(root, seed, **kw):
    cell = small_cell(**kw)
    world = WORLDS.make(cell.config, np.random.SeedSequence(seed), root)
    return cell, world


def port_read_set(tmp_path, reads, nodes=(), index_kind="maxhash"):
    """The port's read set of ``reads`` (the device backend on the CPU)
    and, where ``nodes`` are given, the graph of those nodes, unjoined."""
    from gaml_tpu_torch.core.io import load_lastgraph
    from gaml_tpu_torch.scoring.readset import ReadSet

    path = str(tmp_path / "r.fq")
    WORLDS.write_fastq(path, "r", reads)
    rs = ReadSet(str(tmp_path / "r"), path, 0.96, 0.01, backend="device",
                 index_kind=index_kind, device="cpu")
    rs.preprocess_reads()
    rs.prepare_read_index()
    if not nodes:
        return rs, None
    PAIRED.write_lastgraph(str(tmp_path / "G"), list(nodes), [])
    return rs, load_lastgraph(str(tmp_path / "G"))


@pytest.fixture(scope="module", params=[4294967311, 2718281828459])
def annealed(request, tmp_path_factory):
    """The cell's set-up, the start scoring and MOVES moves, every call
    recorded; judged, and judged again with the reference in float32 in
    the program's place.  Torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = small_cell()
        root = str(tmp_path_factory.mktemp("trimmed"))
        args = common.parse_args(["--workload", CELL, "--seed",
                                  str(request.param), "--seconds", "0",
                                  "--trace", "0"])
        ctx = Context(cell, args, "cpu", root, 0.0,
                      Tracer(False, root, False))
        st = DRIVER.anneal.setup(ctx)
        lengths = [rs.aligner.index.read_len for rs in st["read_sets"]]
        bundles = [getattr(rs.aligner, "native_bundle", None)
                   for rs in st["read_sets"]]
        paths = DRIVER.anneal.start(ctx, st)
        for _ in range(MOVES):
            paths = st["opt"].step(paths, write_outputs=False)
        DRIVER.finish(ctx, st)
        DRIVER.judge(ctx)
        sound = {k: c["value"] for k, c in ctx.checks.items()}
        ctx.control = np.float32
        DRIVER.judge(ctx)
        control = {k: c["value"] for k, c in ctx.checks.items()}
        yield dict(ctx=ctx, cell=cell, sound=sound, control=control,
                   lengths=lengths, bundles=bundles)
    finally:
        torch.set_num_threads(threads)


def test_trimmed_world_has_mixed_lengths_and_no_native_bundle(annealed):
    ctx = annealed["ctx"]
    for name in ("rs1", "rs2"):
        for mate in ctx.world.libraries[name]:
            lens = np.array([len(r) for r in mate])
            cut = lens < 100
            assert lens.max() == 100 and lens[cut].min() >= 60
            assert 0.15 < cut.mean() < 0.25
    assert annealed["bundles"] == [None] * 4
    # the program's query lengths, each the C11 rule's on its mate file
    assert annealed["lengths"] == [
        T.query_length(m) for name in ("rs1", "rs2")
        for m in ctx.world.libraries[name]]


def test_every_call_follows_the_reference(annealed):
    ctx, got = annealed["ctx"], annealed["sound"]
    limits = annealed["cell"].traffic["limits"]
    assert set(limits) <= set(got)
    for name, v in got.items():
        assert v <= limits.get(name, 0), (name, v)
    # every call judged: the start scoring, the moves' calls, the fresh
    assert len(ctx.rec.ends) == len(ctx.rec.out) > MOVES


def test_float32_control_is_not_correct(annealed):
    got, limits = annealed["control"], annealed["cell"].traffic["limits"]
    for name in ("score_rel_gap", "state_rel_gap"):
        assert got[name] > limits[name], (name, got[name])
    for name in ("bad_bases_gap", "zero_reads_gap", "total_len_gap",
                 "windows_mismatched"):
        assert got[name] == 0, name


def c11(reads):
    """ROADMAP C11 as stated: the ACGT reads grouped by length, the groups
    in the order their first read appears; the last group's length."""
    groups = {}
    for r in reads:
        if (np.asarray(r) < 4).all():
            groups.setdefault(len(r), []).append(r)
    return list(groups)[-1] if groups else 0


@pytest.mark.parametrize("order", ["as_drawn", "trimmed_first",
                                   "full_last", "n_read_last"])
def test_query_length_is_the_stated_rule(tmp_path, order):
    """The reference's query length, the program's index's and the rule
    agree, whichever length group comes first or last; a read with an N
    forms no group."""
    _cell, world = small_world(str(tmp_path), 7, genome_bp=20_000)
    reads = list(world.libraries["rs1"][0])
    lens = np.array([len(r) for r in reads])
    if order == "trimmed_first":
        reads = [reads[i] for i in np.argsort(lens, kind="stable")]
    elif order == "full_last":
        last = int(np.nonzero(lens == 100)[0][0])
        reads = reads[:last] + reads[last + 1:] + [reads[last]]
    elif order == "n_read_last":
        odd = np.array(reads[int(np.argmin(lens))][:59])
        odd[10] = 4
        reads = reads + [odd]
    rs, _graph = port_read_set(tmp_path, reads)
    want = c11(reads)
    assert T.RaggedIndex(reads).read_len == T.query_length(reads) == want
    assert rs.aligner.index.read_len == want
    assert getattr(rs.aligner, "native_bundle", None) is None


def test_windows_shorter_than_the_query_length_are_skipped(tmp_path):
    """A batch of windows around the query length: the reference skips
    those shorter than it, the program leaves them empty and counts
    them; the rest align alike."""
    _cell, world = small_world(str(tmp_path), 11, genome_bp=20_000)
    reads = list(world.libraries["rs1"][0])
    L = T.query_length(reads)
    nodes = [world.genome[1000:1000 + n]
             for n in (L - 5, L - 1, L, L + 1, 400)]
    rs, graph = port_read_set(tmp_path, reads, nodes)
    wins = [(2 * i,) for i in range(len(nodes))]
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = rs.aligner.align_subpaths_batch(graph, wins)
        counters = {k: TRACE.counters.get(k) for k in COUNTERS}
    finally:
        TRACE.reset()
    assert counters == {"align.short_windows": 2,
                        "align.device_batches": 1,
                        "align.device_windows": 3}
    al = T.WindowAligner(S.Graph(nodes), T.RaggedIndex(reads), "cpu")
    al.fill(wins)
    assert al.skipped == 2
    assert [len(g) for g in got[:2]] == [0, 0]
    assert sum(len(g) for g in got) > 0
    for w, g in zip(wins, got):
        p, e, r, o = al.done[w]
        np.testing.assert_array_equal(g.position, p)
        np.testing.assert_array_equal(g.edit_dist, e)
        np.testing.assert_array_equal(g.read_id, r)
        np.testing.assert_array_equal(g.orientation, o)


@pytest.mark.parametrize("index_kind,lens,want", [
    ("maxhash", (50, 60, 400, 700), (1, 1, 3)),
    ("maxhash", (30, 50), (2, 0, 0)),
    ("trivial", (50, 60, 400, 700), (1, 1, 3)),
    ("trivial", (30, 50), (2, 0, 0)),
])
def test_counters_of_a_known_batch(tmp_path, index_kind, lens, want):
    """Both branches of the device route (the max-hash index's candgen,
    the trivial index's host candidates): windows under the query length
    (60 here) counted as short; a batch with a window to align counted
    once with its windows, one of only short windows not at all."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 2900, 200)
    # the last read and the last length group to appear are of 60 bp:
    # the query length of either index kind
    reads = [genome[s:s + (60 if i % 3 else 100)]
             for i, s in enumerate(starts.tolist())]
    assert T.query_length(reads) == len(reads[-1]) == 60
    nodes = [genome[100 * i:100 * i + n] for i, n in enumerate(lens)]
    rs, graph = port_read_set(tmp_path, reads, nodes, index_kind)
    assert rs.aligner.index.read_len == 60
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            rs.aligner.align_subpaths_batch(
                graph, [(2 * i,) for i in range(len(nodes))])
        got = tuple(TRACE.counters.get(k, 0) for k in COUNTERS)
    finally:
        TRACE.reset()
    assert got == want


def test_untrimmed_equals_shortread(tmp_path):
    """With no read cut the ragged reference's index, alignments, rescore
    and walk terms equal reference/shortread.py's on the same world."""
    _cell, world = small_world(str(tmp_path), 13, genome_bp=30_000,
                               share=0.0)
    m1, m2 = world.libraries["rs1"]
    uniform = (np.stack(m1), np.stack(m2))
    ragged, plain = T.RaggedIndex(m1), S.ReadIndex(uniform[0])
    for name in ("fp", "seed_f", "seed_r", "sf", "srid", "read_len"):
        np.testing.assert_array_equal(getattr(ragged, name),
                                      getattr(plain, name), err_msg=name)
    seqs = [world.genome[:9000], S.revcomp(world.genome[8000:20000])]
    a, b = T.align_batch(ragged, seqs, "cpu"), S.align_batch(plain, seqs,
                                                            "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = S.rescore(plain, seqs, 0.96, 0.01, -0.7, -10.0, "cpu")[:3]
    assert T.rescore(ragged, seqs, 0.96, 0.01, -0.7, -10.0, "cpu") == want
    graph = S.Graph(world.nodes)
    keys = small_cell().config["cli"]["libraries"]["rs1"]
    walk = tuple(range(0, 2 * 12, 2))
    libs = [cls(graph, *reads, keys, "cpu", walks={0: walk})
            for cls, reads in ((T.PairedLibrary, (m1, m2)),
                               (S.PairedLibrary, uniform))]
    terms = []
    for lib in libs:
        present = [set(lib.plan(0).lookups)] * 2
        terms.append(lib.walk(0, present))
    (r1, p1, b1), (r2, p2, b2) = terms
    assert len(r1) > 100 and b1 == b2
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(p1, p2)


def test_ragged_rescore_follows_the_reference(tmp_path):
    """The program's single-end rescore over a trimmed read set (the
    ragged engines of a read set without a native bundle) against the
    reference's, each read's probability and floor at its own length:
    candidates and zero reads equal, the score to float64 rounding."""
    _cell, world = small_world(str(tmp_path), 17, genome_bp=30_000)
    reads = list(world.libraries["rs1"][1])
    rs, _graph = port_read_set(tmp_path, reads)
    resc = rs.aligner.ensure_device_rescorer()
    seqs = [world.genome[:14000], S.revcomp(world.genome[13000:])]
    total = sum(len(s) for s in seqs)
    got = resc.rescore(seqs, None, log_match=np.log(0.96),
                       log_mismatch=np.log(0.01), total_len=total,
                       min_prob_per_base=-0.7, min_prob_start=-10.0)
    score, zeros, cands = T.rescore(T.RaggedIndex(reads), seqs, 0.96, 0.01,
                                    -0.7, -10.0, "cpu")
    assert 0 < zeros < len(reads)
    assert got[1:] == (zeros, cands)
    assert abs(got[0] - score) <= 1e-12 * abs(score)


def test_trimmed_cli_trace_has_the_counters(tmp_path, monkeypatch):
    """``cli --trace DIR`` on a trimmed world: the three counters in its
    summary, the windows sent equal to what the batches counted."""
    import gaml_tpu_torch.cli as cli

    cell, world = small_world(str(tmp_path), 19, genome_bp=20_000)
    cell.config["cli"]["global"]["max_iterations"] = "6"
    cfg = WORLDS.write_cli_config(cell.config, world, 3,
                                  str(tmp_path / "out"))
    monkeypatch.chdir(tmp_path)
    TRACE.reset()
    try:
        assert cli.main([cfg, "--device", "cpu", "--trace",
                         str(tmp_path / "t")]) == 0
    finally:
        TRACE.reset()
    with open(tmp_path / "t" / "summary.json") as f:
        counters = json.load(f)["counters"]
    assert set(COUNTERS) <= set(counters)
    assert counters["align.device_windows"] >= \
        counters["align.device_batches"] > 0

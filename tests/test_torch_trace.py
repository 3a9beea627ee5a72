"""The port's spans and counters (gaml_tpu_torch.utils.metrics) on the CPU:
nothing recorded while tracing is off; under torch.profiler the span tree
of a move, the same spans in the exported Chrome trace, the native-route
counters, the rescore's syncs; and the anneal unchanged by tracing."""
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gaml_tpu_torch.cli as cli
from gaml_tpu_torch.ops.rescore_device import DeviceRescorer
from gaml_tpu_torch.scoring.readset import ReadSet
from gaml_tpu_torch.utils import metrics
from gaml_tpu_torch.utils.metrics import TRACE

from test_candgen_device import make_bundle, sample_world
from test_rescore_device import MATCH, MISMATCH, MPB, MPS
from test_torch_cli import itnum_lines, write_world
from test_torch_kernels import port_native_lib

ITERATIONS = 8
SCORE_PARTS = ("score.align", "score.diff", "score.pairs", "score.reduce")


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


@pytest.fixture
def world(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    TRACE.reset()
    return write_world(tmp_path, iterations=ITERATIONS)


def anneal(monkeypatch, config, *extra):
    """The CLI's anneal on the CPU (device backend); returns (exit code,
    the Optimizer it ran)."""
    made = []

    class Kept(cli.Optimizer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(cli, "Optimizer", Kept)
    rc = cli.main([config, "--device", "cpu", *extra])
    return rc, made[0]


def test_nothing_recorded_while_tracing_is_off(world, monkeypatch):
    monkeypatch.setenv("GAML_DEV_MIN_BASES", "0")
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: opened.append(a) or real(*a, **kw))
    rc, opt = anneal(monkeypatch, world("off"))
    assert rc == 0 and opt.itnum > ITERATIONS
    assert not metrics.tracing()
    assert TRACE.spans == {} and dict(TRACE.counters) == {}
    assert opened == []
    # the always-on timers still ran
    assert opt.metrics.timers["propose"][1] == ITERATIONS + 1
    assert metrics.span("move") is metrics.span("score")


def chrome_paths(path):
    """Span path -> count of the trace's ``gaml.*`` annotations, each
    path rebuilt from the annotations that enclose it on its thread."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = sorted(((e["tid"], float(e["ts"]), -float(e["dur"]),
                     e["name"][5:]) for e in events
                    if e.get("ph") == "X" and e.get("cat") ==
                    "user_annotation" and e["name"].startswith("gaml.")))
    out = Counter()
    stack = []
    for tid, ts, neg, name in spans:
        end = ts - neg
        while stack and (stack[-1][0] != tid or stack[-1][1] < end):
            stack.pop()
        stack.append((tid, end, name))
        out["/".join(s[2] for s in stack)] += 1
    return out


def test_traced_anneal_records_the_span_tree(world, monkeypatch, tmp_path,
                                             capsys):
    monkeypatch.setenv("GAML_DEV_MIN_BASES", "0")
    out_dir = tmp_path / "trace"
    rc, opt = anneal(monkeypatch, world("on"), "--trace", str(out_dir))
    assert rc == 0
    moves = len(itnum_lines(capsys.readouterr().out))
    assert moves == ITERATIONS + 1
    with open(out_dir / "summary.json") as f:
        summary = json.load(f)
    spans = summary["spans"]
    assert spans["move"]["calls"] == moves
    assert spans["move/propose"]["calls"] == moves
    assert spans["move/score"]["calls"] == moves
    for part in SCORE_PARTS:
        # score.align twice a call: the prefetch, then the paired scorer's
        # lookups
        want = 2 * moves if part == "score.align" else moves
        assert spans["move/score/" + part]["calls"] == want, part
    assert spans["score"]["calls"] == 1  # the start scoring
    for path, s in spans.items():
        assert s["self_s"] >= 0 and s["total_s"] >= s["self_s"], path
        kids = [k for k in spans.values() if k["parent"] == path]
        assert sum(k["total_s"] for k in kids) <= s["total_s"] + 1e-9
        if s["parent"] is not None:
            assert spans[s["parent"]]["calls"] > 0
            assert path == s["parent"] + "/" + s["name"]
    counters = summary["counters"]
    assert counters["moves.accepted"] + counters["moves.rejected"] == moves
    assert counters["score.walks"] >= counters["score.walk_memo_hits"] > 0
    assert summary["timers"]["propose"]["calls"] == moves
    # every span is a gaml.* annotation inside its parent's interval
    assert chrome_paths(out_dir / "trace.json") == \
        {path: s["calls"] for path, s in spans.items()}
    # the store holds what the summary wrote, and nothing was left open
    assert TRACE.span_stats("move")[0] == moves
    assert not getattr(metrics._open, "stack", [])


def test_native_route_counters_match_the_native_calls(world, monkeypatch):
    monkeypatch.setenv("GAML_DEV_MIN_BASES", str(10 ** 12))
    calls = []
    real = ReadSet._precompute_native_batch

    def counted(self, graph, subpaths, bundle):
        calls.append(len(subpaths))
        return real(self, graph, subpaths, bundle)

    monkeypatch.setattr(ReadSet, "_precompute_native_batch", counted)
    with profile(activities=[ProfilerActivity.CPU]):
        rc, opt = anneal(monkeypatch, world("native"))
    assert rc == 0 and calls
    assert TRACE.counters["align.native_batches"] == len(calls)
    assert TRACE.counters["align.native_windows"] == sum(calls)
    assert TRACE.span_stats("align.native")[0] == len(calls)
    assert TRACE.span_stats("align.device")[0] == 0
    assert TRACE.span_stats("align.native", under="score.align")[0] == \
        len(calls)


def test_rescore_syncs_sit_under_the_rescore():
    TRACE.reset()
    genome, reads = sample_world(seed=11, genome_len=4000)
    seqs = [genome[:1500], genome[1300:2900], genome[2600:]]
    resc = DeviceRescorer(make_bundle(reads), device="cpu")
    args = dict(log_match=MATCH, log_mismatch=MISMATCH,
                total_len=sum(len(s) for s in seqs),
                min_prob_per_base=MPB, min_prob_start=MPS)
    want = resc.rescore(seqs, **args)
    with profile(activities=[ProfilerActivity.CPU]):
        got = [resc.rescore(seqs, **args) for _ in range(3)]
    assert all(g == want for g in got)
    assert TRACE.counters["rescore.calls"] == 3
    calls, total, own = TRACE.span_stats("rescore")
    assert calls == 3 and total >= own >= 0
    for name in ("candgen.upload", "candgen.runs", "candgen.sort", "extend",
                 "rescore.dedup", "rescore.sums", "rescore.reduce"):
        assert TRACE.span_stats(name, under="rescore")[0] == 3, name
    assert TRACE.spans["rescore/rescore.reduce/sync"][0] == 3
    assert TRACE.spans["rescore/candgen.runs/sync"][0] == 3
    sync_calls, sync_s, _ = TRACE.span_stats("sync", under="rescore")
    assert sync_calls == 9 and 0 <= sync_s <= total
    assert TRACE.span_stats("sync")[0] == sync_calls


def test_tracing_leaves_the_anneal_unchanged(world, monkeypatch, tmp_path):
    monkeypatch.setenv("GAML_DEV_MIN_BASES", "0")
    runs = []
    for name, extra in (("plain", ()),
                        ("traced", ("--trace", str(tmp_path / "t")))):
        rc, opt = anneal(monkeypatch, world(name), *extra)
        assert rc == 0
        runs.append((opt.history, opt.best_prob, opt.best_paths,
                     (tmp_path / f"{name}.walks").read_bytes()))
    assert TRACE.span_stats("move")[0] == ITERATIONS + 1
    (h0, b0, p0, w0), (h1, b1, p1, w1) = runs
    assert h0 == h1 and b0 == b1 and p0 == p1 and w0 == w1
    assert np.isfinite(b0)

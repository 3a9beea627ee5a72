"""The long-read scorer's spans and counters (gaml_tpu_torch.utils.metrics)
on the CPU: under torch.profiler one rescore records each ``pacbio.*``
span (``pacbio.seeds`` inside ``pacbio.chain``) and counts its score, its
jobs and DP cells and its batch by route, equal to the batch it ran, and
its seed lookup's query k-mers, hits and batch by route, equal to what the
host index looks up and finds; without a profiler nothing is recorded."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaml_tpu_torch.align.longread import SortedKmerIndex
from gaml_tpu_torch.ops import seeds_device
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine
from gaml_tpu_torch.utils.metrics import TRACE

from test_torch_kernels import port_native_lib
from test_torch_pacbio_reference import SmallWorld

SPANS = ("pacbio.windows", "pacbio.chain", "pacbio.seeds", "pacbio.stage",
         "pacbio.forward", "pacbio.apply", "pacbio.sweep", "pacbio.reduce")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Short reads and one torch thread: the plain forward's row loop is
    the test's time."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield SmallWorld(str(tmp_path_factory.mktemp("pbspans")), seed=7,
                         genome_bp=30_000, reads=16, read_bp=(500, 800))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("min_cells,route", [("0", "device"),
                                             (str(1 << 62), "native")])
def test_traced_rescore_records_spans_and_counts(tiny, monkeypatch,
                                                 min_cells, route):
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", min_cells)
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = tiny.score(tiny.walk_sets[1], monkeypatch)
        spans = {path: n for path, (n, _t, _s) in TRACE.spans.items()}
        counters = dict(TRACE.counters)
    finally:
        TRACE.reset()
    (jobs, _extents), = got["batches"]
    for name in SPANS:
        assert any(p.split("/")[-1] == name for p in spans), (name, spans)
    assert ("pacbio.forward/sync" in spans) == (route == "device")
    seeds = [p.split("/") for p in spans if p.endswith("pacbio.seeds")]
    assert seeds and all(p[-2] == "pacbio.chain" for p in seeds), spans
    assert counters["pacbio.scores"] == 1
    assert counters["pacbio.jobs"] == len(jobs) > 0
    assert counters["pacbio.cells"] == 64 * sum(len(q) for q, *_ in jobs)
    assert counters[f"pacbio.{route}_batches"] == 1
    other = "native" if route == "device" else "device"
    assert f"pacbio.{other}_batches" not in counters
    assert np.isfinite(got["score"])


def test_nothing_recorded_untraced(tiny, monkeypatch):
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    TRACE.reset()
    tiny.score(tiny.walk_sets[0], monkeypatch)
    assert not TRACE.spans and not TRACE.counters


@pytest.mark.parametrize("seed_route", ["native", "device"])
def test_traced_seed_lookup_counts(tiny, monkeypatch, seed_route):
    """pacbio.seed_queries and pacbio.seed_hits equal the query k-mers and
    hits of the host index (one untraced run on it), on either seed route
    (the device route's host code with the rows on the CPU, the plain
    version in the kernels' place); the route's batch counter counts each
    chaining call."""
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))
    rs = tiny.rs
    looked = []
    batch = SortedKmerIndex.hits_batch_kmers

    def recorded(self, qks):
        out = batch(self, qks)
        looked.append((sum(map(len, qks)), sum(len(t) for t, _q in out)))
        return out

    with monkeypatch.context() as m:
        m.setattr(SortedKmerIndex, "hits_batch_kmers", recorded)
        m.setattr(rs, "_seed_engine", lambda: None)
        tiny.score(tiny.walk_sets[1], m)
    calls = []
    chain = rs._chain_preps

    def counted(graph, preps):
        calls.append(len(preps))
        return chain(graph, preps)

    TRACE.reset()
    try:
        with monkeypatch.context() as m:
            eng = ForwardDeviceEngine(rs.read_seq, "cpu")
            m.setattr(rs, "_seed_engine",
                      (lambda: eng) if seed_route == "device" else
                      (lambda: None))
            m.setattr(seeds_device, "seed_hits",
                      lambda rows, *args: seeds_device.seed_hits_plain(
                          rows, *args[:5]))
            m.setattr(rs, "_chain_preps", counted)
            with profile(activities=[ProfilerActivity.CPU]):
                tiny.score(tiny.walk_sets[1], m)
        counters = dict(TRACE.counters)
    finally:
        TRACE.reset()
    assert looked and calls
    assert counters["pacbio.seed_queries"] == sum(q for q, _h in looked) > 0
    assert counters["pacbio.seed_hits"] == sum(h for _q, h in looked) > 0
    assert counters[f"pacbio.seed_{seed_route}_batches"] == len(calls)
    other = "native" if seed_route == "device" else "device"
    assert f"pacbio.seed_{other}_batches" not in counters

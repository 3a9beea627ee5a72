"""The long-read scorer's spans and counters (gaml_tpu_torch.utils.metrics)
on the CPU: under torch.profiler one rescore records each ``pacbio.*``
span and counts its score, its jobs and DP cells and its batch by route,
equal to the batch it ran; without a profiler nothing is recorded."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaml_tpu_torch.utils.metrics import TRACE

from test_torch_kernels import port_native_lib
from test_torch_pacbio_reference import SmallWorld

SPANS = ("pacbio.windows", "pacbio.chain", "pacbio.stage", "pacbio.forward",
         "pacbio.apply", "pacbio.sweep", "pacbio.reduce")


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

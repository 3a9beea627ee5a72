"""Read sets of mixed read lengths (quality-trimmed libraries) on the
port: no native bundle, so a window batch is one candgen query over the
max-hash index's own CSR (DeviceCandGen.from_index; query_plain on the
CPU, no host candidate pass) and one DeviceExtender.extend call on the
read set's resident ragged codes (one launch of the exact extension).
Held window by window against gaml_tpu's
SubpathAligner(backend="device"), both read sets built from the same
FASTQ."""
import numpy as np
import pytest

from gaml_tpu.scoring.readset import ReadSet
from gaml_tpu_torch.ops import extend_device as port_extend
from gaml_tpu_torch.scoring.readset import ReadSet as PortReadSet
from gaml_tpu_torch.utils.metrics import LAUNCHES

from fixtures import make_linear_graph, sample_reads, write_fastq
from test_scoring import MATCH, MISMATCH
from test_torch_kernels import port_linear_graph, port_native_lib


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def trim_reads(reads, seed, share=0.2, lo=30, hi=49):
    """Cut ``share`` of the reads at the 3' end to a length uniform in
    [lo, hi], with their own generator."""
    rng = np.random.default_rng(seed)
    cut = rng.random(len(reads)) < share
    lens = rng.integers(lo, hi + 1, len(reads))
    return [r[:int(n)] if c else r for r, c, n in zip(reads, cut, lens)]


def test_trimmed_read_set_matches_jax_device_aligner(tmp_path, monkeypatch):
    rng = np.random.default_rng(31)
    gr, node_seqs = make_linear_graph(rng, [500, 90, 450, 120, 400])
    reads = trim_reads(sample_reads(rng, "".join(node_seqs), 150, 50,
                                    err_rate=0.03), seed=1)
    fq = tmp_path / "trim.fq"
    write_fastq(str(fq), reads)
    rs = ReadSet(str(tmp_path / "trim"), str(fq), MATCH, MISMATCH,
                 backend="device")
    rs.preprocess_reads()
    rs.prepare_read_index()
    jax_al = rs.aligner
    port_rs = PortReadSet(str(tmp_path / "ptrim"), str(fq), MATCH, MISMATCH,
                          backend="device", device="cpu")
    port_rs.preprocess_reads()
    port_rs.prepare_read_index()
    assert getattr(jax_al, "native_bundle", None) is None
    assert len({len(r) for r in reads}) > 5
    windows = [(0,), (0, 2), (2, 4, 6), (4, 6, 8), (0, 2, 4, 6, 8), (2,)]
    want = jax_al.align_subpaths_batch(gr, windows)

    al = port_rs.aligner
    assert getattr(al, "native_bundle", None) is None
    port_gr = port_linear_graph(node_seqs)
    calls = []
    real = port_extend.DeviceExtender.extend

    def spy(self, *args, **kw):
        calls.append(len(args[3]))  # the candidates' g0
        return real(self, *args, **kw)

    monkeypatch.setattr(port_extend.DeviceExtender, "extend", spy)
    plain = LAUNCHES["query_plain"]
    host = LAUNCHES["gen_candidates"]
    got = al.align_subpaths_batch(port_gr, windows)
    assert len(calls) == 1 and calls[0] > 50
    assert LAUNCHES["query_plain"] == plain + 1
    assert LAUNCHES["gen_candidates"] == host
    assert (al.device_batches, al.device_candidates) == (1, calls[0])
    assert sum(len(w) for w in want) > 50
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("pos", "ed", "rid", "orient"), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"win {i} {name}")
    # a deferred batch is one more device call with the same result
    fin = al.align_subpaths_batch(port_gr, windows[:2], defer=True)
    assert len(calls) == 2 and fin() == got[:2]
    # the per-window form (_extend_all, batch_extend_host) agrees too
    for w, g in zip(windows, got):
        assert al.align_subpath(port_gr, w) == g

"""Port's device staging + extension (gaml_tpu_torch.ops.extend_device,
CPU tensors) against the JAX DeviceExtender and host staging, and
against the native window aligner for windows near the buffer end."""
import numpy as np
import pytest
import torch

from gaml_tpu.align.aligner import spell_subpath
from gaml_tpu.core import dna
from gaml_tpu.native import align_windows_batch, query_windows_batch
from gaml_tpu.ops.extend import batch_extend_arrays as jax_extend_arrays
from gaml_tpu.ops.extend import batch_extend_multi as jax_extend_multi
from gaml_tpu.ops.extend import extend_staged, stage_candidates_uniform
from gaml_tpu.ops.extend_device import DeviceExtender as JaxExtender
from gaml_tpu_torch.align.aligner import window_columns
from gaml_tpu_torch.ops.extend_cuda import extend_fused
from gaml_tpu_torch.ops.extend_device import (DeviceExtender,
                                              batch_extend_arrays,
                                              extend_candidates)
from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

from fixtures import make_linear_graph, random_seq, sample_reads
from test_candgen_device import make_bundle, sample_world
from test_extend_kernel import random_case, seeds_of
from test_scoring import make_readset
from test_torch_kernels import fused_world, port_native_lib


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def native_batch(bundle, seqs):
    qs = query_windows_batch(bundle, seqs)
    counts = np.array([len(q[0]) for q in qs])
    rid, g0, r0, orient = (np.concatenate([q[k] for q in qs])
                           for k in range(4))
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_base = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(seq_lens[:-1], out=seq_base[1:])
    return (np.concatenate(seqs), seq_base, seq_lens,
            np.repeat(np.arange(len(qs)), counts), g0, r0,
            bundle.row_of[rid], orient, rid)


def test_run_matches_jax_extender_and_host_staging(tmp_path):
    rng = np.random.default_rng(42)
    gr, node_seqs = make_linear_graph(rng, [500, 90, 450, 120, 400])
    reads = sample_reads(rng, "".join(node_seqs), 60, 30, err_rate=0.02)
    bundle = make_readset(tmp_path, reads, "qw").aligner.native_bundle
    windows = [(0,), (0, 2), (2, 4, 6), (4, 6, 8), (0, 2, 4, 6, 8)]
    seqs = [np.ascontiguousarray(spell_subpath(gr, w)[0], dtype=np.uint8)
            for w in windows]
    *args, rid = native_batch(bundle, seqs)
    assert len(rid) > 50

    ok, errs, begin = DeviceExtender(bundle.codes_fwd, bundle.codes_rc,
                                     "cpu").run(*args, defer=True)()
    ok_j, errs_j, begin_j = JaxExtender(bundle.codes_fwd,
                                        bundle.codes_rc).run(
        *args, use_pallas=False)
    st = stage_candidates_uniform(*args, bundle.codes_fwd, bundle.codes_rc,
                                  read_ids=rid)
    ok_h, errs_h, begin_h = extend_staged(st, use_pallas=False)
    assert ok.sum() > 0 and (~ok).sum() > 0
    for ok_r, errs_r, begin_r in ((ok_j, errs_j, begin_j),
                                  (ok_h, errs_h, begin_h)):
        np.testing.assert_array_equal(ok, ok_r)
        np.testing.assert_array_equal(errs[ok], errs_r[ok])
        np.testing.assert_array_equal(begin[ok], begin_r[ok])


def test_exact_backward_route_matches_default(tmp_path, monkeypatch):
    """GAML_SWAR_BACKWARD=0 runs the backward direction through
    dp_rows_exact (the K3 route): ok equal, errs and begin equal where
    ok, to the default K2 route."""
    rng = np.random.default_rng(7)
    gr, node_seqs = make_linear_graph(rng, [400, 80, 500])
    reads = sample_reads(rng, "".join(node_seqs), 80, 30, err_rate=0.04)
    bundle = make_readset(tmp_path, reads, "k3").aligner.native_bundle
    seqs = [np.ascontiguousarray(spell_subpath(gr, w)[0], dtype=np.uint8)
            for w in [(0,), (0, 2, 4), (2, 4)]]
    *args, _rid = native_batch(bundle, seqs)
    ext = DeviceExtender(bundle.codes_fwd, bundle.codes_rc, "cpu")
    ok, errs, begin = ext.run(*args)
    import gaml_tpu_torch.ops.extend_device as ed

    calls = []
    real = ed.dp_rows_exact
    monkeypatch.setattr(ed, "dp_rows_exact",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("GAML_SWAR_BACKWARD", "0")
    ok3, errs3, begin3 = ext.run(*args)
    assert calls == [1]
    assert ok.sum() > 0 and (~ok).sum() > 0
    np.testing.assert_array_equal(ok3, ok)
    np.testing.assert_array_equal(errs3[ok], errs[ok])
    np.testing.assert_array_equal(begin3[ok], begin[ok])


def test_windows_at_buffer_end_match_native():
    """Short windows at the end of the batch buffer (the JAX staging
    clamps there, ROADMAP C1).  Reads carry substitutions only, where the
    native BFS and the DP agree."""
    genome, reads = sample_world(seed=8, genome_len=3000, n_reads=400,
                                 read_len=40)
    bundle = make_bundle(reads)
    seqs = [genome[:2000], genome[1900:2100], genome[2600:2650],
            genome[2950:3000], genome[1000:1041]]
    fetch = DeviceRescorer(bundle, device="cpu").extend(seqs, cap=1 << 20)
    res, n = fetch()
    assert n > 0
    got = window_columns(*res, [0] * len(seqs))
    want = align_windows_batch(bundle, seqs, [0] * len(seqs))
    assert sum(len(w[0]) for w in want[1:]) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("pos", "ed", "rid", "orient"), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"win {i} {name}")


def test_extend_reads_matches_jax_host_route():
    """The per-window form (batch_extend_arrays, under the aligner's
    _extend_all) on reads of mixed lengths with indels, against gaml_tpu's
    host-staged extension."""
    rng = np.random.default_rng(5)
    seq = dna.encode_seq(random_seq(rng, 400))
    g0s, r0s, reads = [], [], []
    while len(reads) < 60:
        read = random_case(rng, seq)
        seeds = seeds_of(read, seq)
        if seeds:
            g0, r0 = seeds[int(rng.integers(0, len(seeds)))]
            g0s.append(g0)
            r0s.append(r0)
            reads.append(read)
    g0s, r0s = np.array(g0s, np.int32), np.array(r0s, np.int32)
    assert len({len(r) for r in reads}) > 1
    ok, errs, begin = batch_extend_arrays(seq, g0s, r0s, reads, "cpu")
    ok_j, errs_j, begin_j = jax_extend_arrays(seq, g0s, r0s, reads)
    assert ok.sum() > 0
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(errs[ok], errs_j[ok])
    np.testing.assert_array_equal(begin[ok], begin_j[ok])


def test_aligner_redoes_cap_overflow_on_device(tmp_path):
    """A tandem-repeat window whose candidate count exceeds the batch cap
    is redone on the device with cap = count (the JAX route hands such a
    batch to the native aligner), and matches the native aligner."""
    from gaml_tpu_torch.core.graph import Graph
    from gaml_tpu_torch.scoring.readset import ReadSet

    from fixtures import write_fastq

    rng = np.random.default_rng(9)
    genome = np.tile(rng.integers(0, 4, 60).astype(np.uint8), 60)
    starts = rng.integers(0, len(genome) - 40 + 1, 600)
    fq = tmp_path / "rep.fq"
    write_fastq(str(fq), [dna.decode_seq(genome[s:s + 40]) for s in starts])
    gr = Graph()
    gr.add_node_pair(genome)
    gr.calc_prob_sums()
    gr.calc_normalize_map()
    rs = ReadSet(str(tmp_path / "rep"), str(fq), 0.96, 0.01,
                 backend="device", device="cpu")
    rs.preprocess_reads()
    rs.prepare_read_index()
    aligner = rs.aligner
    resc = aligner.ensure_device_rescorer()
    caps = []
    real = resc.extend

    def spy(seqs, cap):
        caps.append(cap)
        return real(seqs, cap)

    resc.extend = spy
    got, = aligner.align_subpaths_batch(gr, [(0,)])
    assert len(caps) == 2 and caps[1] > caps[0]
    assert aligner.device_candidates == caps[1]
    want, = align_windows_batch(aligner.native_bundle, [genome], [0])
    assert len(want[0]) > 0
    for name, a, b in zip(("pos", "ed", "rid", "orient"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_extension_matches_staged_route_and_jax(seed):
    """The fused extension's plain version (on CPU tensors) against the
    staged route it replaces (stage_views, K1 and K2's plain versions, the
    epilogue) and the JAX package's extend_kernel staged on the host, on a
    resident world with uniform reads, indels, seeds at genome position 0
    and a window that ends the buffer: ok equal, errs and begin equal
    wherever ok."""
    codes, seqs, seq_idx, meta = fused_world(seed, 3000)
    L = codes.shape[1]
    buf = np.concatenate(seqs)
    t = [torch.from_numpy(x) for x in meta]
    got = [x.numpy() for x in extend_fused(torch.from_numpy(codes),
                                           torch.from_numpy(buf), *t,
                                           L - 15)]
    base, glen, g0, r0, row = (x.to(torch.int64) for x in t)
    staged = [x.numpy() for x in extend_candidates(
        torch.from_numpy(codes), torch.full_like(g0, L),
        torch.from_numpy(buf), base, glen, g0, r0, row, L - 15)]
    jax_out = jax_extend_multi(seqs, seq_idx, meta[2], meta[3],
                               [codes[r] for r in meta[4]],
                               use_pallas=False)
    ok = got[0]
    assert 100 < ok.sum() < len(ok)
    assert ok[meta[2] == 0].any() and (~ok[meta[2] == 0]).any()
    last = seq_idx == len(seqs) - 1
    assert ok[last].any()
    for want in (staged, jax_out):
        np.testing.assert_array_equal(ok, want[0])
        np.testing.assert_array_equal(got[1][ok], want[1][ok])
        np.testing.assert_array_equal(got[2][ok], want[2][ok])

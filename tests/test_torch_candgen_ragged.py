"""Candidate generation for read sets of mixed read lengths (a
quality-trimmed library): DeviceCandGen.from_index over the max-hash
index's own CSR, with seeds for every read length and the rows of the
ragged extension's read matrix.

Tolerance: bit-equal.  On the same reads and windows, query_plain (the
CPU route of the kernel) and query_twin (the numpy twin of the kernel's
tiles) give the candidates (rid, g0, r0, orient, seg) in the emission
order of the host pass gen_candidates, run window by window: the port's
and the JAX package's.  One case parts them: a reverse hit whose
fingerprint k-mer covers an N code of the window.  There the host pass
looks for the window's k-mer, in which N packs as G, in the reverse
complemented read, where the N's mate is a C, finds none and fails its
assertion (both packages); the generator takes the read's own seed, the
rule the host pass itself applies to the majority read length's
precomputed seeds.  Such windows are held to that rule
(``reference_candidates``) and counted."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gaml_tpu.align.aligner import gen_candidates as jax_gen_candidates
from gaml_tpu.index.maxhash import ReadIndexMaxHash as JaxIndex
from gaml_tpu_torch.align.aligner import (SubpathAligner, _ReadCache,
                                          find_seed_in_read, gen_candidates)
from gaml_tpu_torch.core import dna
from gaml_tpu_torch.index.maxhash import (HASH_XOR, K_INDEX_KMER,
                                          ReadIndexMaxHash, index_csr,
                                          maxhash_of_read, pack_kmers_batch,
                                          revcomp_kmers)
from gaml_tpu_torch.ops.candgen_cuda import query_twin
from gaml_tpu_torch.ops.candgen_device import DeviceCandGen
from gaml_tpu_torch.utils.metrics import LAUNCHES

from fixtures import make_linear_graph, sample_reads
from test_torch_candgen_kernel import ragged_rows, ragged_world
from test_torch_kernels import port_linear_graph, port_native_lib

K = K_INDEX_KMER
TILES = (7, 32, 128)


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def build(reads, rids):
    """(port index, JAX index, read_seqs, generator on the CPU)."""
    index, jax_index = ReadIndexMaxHash(), JaxIndex()
    index.add_reads_batch(reads, rids)
    jax_index.add_reads_batch(reads, rids)
    read_seqs = dict(zip(rids, reads))
    gen = DeviceCandGen.from_index(index, read_seqs, ragged_rows(read_seqs),
                                   "cpu")
    return index, jax_index, read_seqs, gen


def per_window(c, n_windows):
    """Candidates as per-window lists of (rid, g0, r0, orient)."""
    out = [[] for _ in range(n_windows)]
    if c.n_total:
        cols = zip(*(t.tolist() for t in (c.seg, c.rid, c.g0, c.r0,
                                          c.orient)))
        for seg, *cand in cols:
            out[seg].append(tuple(cand))
    return out


def host_pass(fn, index, read_seqs, seq):
    """gen_candidates' candidates as (rid, g0, r0, orient), or None where
    it fails its seed assertion."""
    try:
        return [(c.read_id, c.genome_pos, c.read_pos, c.orientation)
                for c, _read in fn(index, read_seqs, seq)]
    except AssertionError:
        return None


def reference_candidates(index, read_seqs, seq):
    """The rule written out: the index's window query in gen_candidates'
    order, each seed the first k-mer of the oriented read equal to the
    read's own fingerprint k-mer (reverse: its reverse complement)."""
    cands = index.get_read_cands_with_poses(seq)
    out = []
    for rid in sorted(cands):
        read = read_seqs[rid]
        fpk = np.asarray([maxhash_of_read(read) ^ int(HASH_XOR)],
                         dtype=np.uint32)
        for e2 in cands[rid]:
            o = int(e2 < 0)
            g0 = len(seq) + e2 - 1 if o else e2 - K + 1
            target = int(revcomp_kmers(fpk)[0]) if o else int(fpk[0])
            r0 = find_seed_in_read(dna.revcomp(read) if o else read, seq, g0,
                                   target_kmer=target)
            assert r0 >= 0
            out.append((rid, g0, r0, o))
    return out


def assert_same(got, want):
    assert got.n_total == want.n_total
    assert got.overflow == want.overflow
    if got.overflow:
        return
    for name in ("rid", "g0", "r0", "orient", "seg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.int64, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def against_host(reads, rids, windows, tile=None):
    """query_plain (and query_twin at ``tile``) against the host passes,
    window by window; returns (candidates, windows the host passes
    failed on)."""
    index, jax_index, read_seqs, gen = build(reads, rids)
    staged = gen.upload(windows)
    plain = gen.query_plain(staged=staged)
    if tile is not None:
        assert_same(query_twin(gen, *staged, tile=tile), plain)
    failed = 0
    for i, (got, seq) in enumerate(zip(per_window(plain, len(windows)),
                                       windows)):
        assert got == reference_candidates(index, read_seqs, seq), i
        port = host_pass(gen_candidates, index, read_seqs, seq)
        jax = host_pass(jax_gen_candidates, jax_index, read_seqs, seq)
        assert port == jax, i
        if port is None:
            assert (seq == dna.CODE_N).any(), i
            failed += 1
        else:
            assert got == port, i
    return plain.n_total, failed


@pytest.mark.parametrize("n_rate", [0.0, 0.01])
def test_matches_host_pass_window_by_window(n_rate):
    reads, rids, windows = ragged_world(3, n_windows=12, max_window=1500,
                                        n_rate=n_rate, n_reads=600)
    n, failed = against_host(reads, rids, windows)
    assert n > 200
    assert failed == 0 or n_rate


@settings(max_examples=15, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31), n_windows=st.integers(1, 64),
       max_window=st.integers(16, 3000),
       n_rate=st.sampled_from((0.0, 0.003, 0.02)),
       tile=st.sampled_from(TILES))
def test_matches_host_pass_on_random_worlds(seed, n_windows, max_window,
                                            n_rate, tile):
    reads, rids, windows = ragged_world(seed, n_windows, max_window, n_rate)
    assert len({len(r) for r in reads}) >= 5
    against_host(reads, rids, windows, tile)


def test_reverse_hit_on_an_n_code_takes_the_reads_own_seed():
    """The one case where the host pass fails (module docstring): a read
    whose fingerprint k-mer holds a G lies on the reverse strand of a
    window with an N there.  The read has the query's length, so the
    window over it has its fingerprint."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 4, 400).astype(np.uint8)
    read = src[100:190].copy()
    kmers = pack_kmers_batch(read[None])[0]
    at = int(np.argmax(kmers ^ np.uint32(HASH_XOR)))
    g = next(at + j for j in range(K) if read[at + j] == dna.CODE_G)
    window = dna.revcomp(src[60:250])
    window[len(window) - 1 - (100 + g - 60)] = dna.CODE_N
    reads = [src[300:360].copy(), read]
    index, jax_index, read_seqs, gen = build(reads, [0, 1])
    assert index.read_len == 90
    got = per_window(gen.query_plain([window]), 1)[0]
    rev = [c for c in got if c[0] == 1 and c[3] == 1]
    assert rev
    fpk = np.asarray([kmers[at]], np.uint32)
    seed = find_seed_in_read(dna.revcomp(read), None, 0,
                             target_kmer=int(revcomp_kmers(fpk)[0]))
    assert all(c[2] == seed for c in rev)
    assert got == reference_candidates(index, read_seqs, window)
    for fn, idx in ((gen_candidates, index), (jax_gen_candidates, jax_index)):
        with pytest.raises(AssertionError, match="without exact seed"):
            fn(idx, read_seqs, window)


def test_seeds_match_find_seed_in_read_on_every_length():
    reads, rids, _w = ragged_world(5, n_reads=400)
    index, _j, read_seqs, gen = build(reads, rids)
    row_of = gen.row_of.numpy()
    seed2 = gen.seed2.numpy()
    indexed = {r for lst in index.index.values() for r in lst}
    assert len({len(read_seqs[r]) for r in indexed}) >= 5
    assert len(indexed) < len(reads)  # the reads with an N code
    for rid, read in read_seqs.items():
        row = row_of[rid]
        if rid not in indexed:
            assert (seed2[row] == -1).all()
            continue
        fpk = np.asarray([maxhash_of_read(read) ^ int(HASH_XOR)], np.uint32)
        want = (find_seed_in_read(read, None, 0, target_kmer=int(fpk[0])),
                find_seed_in_read(dna.revcomp(read), None, 0,
                                  target_kmer=int(revcomp_kmers(fpk)[0])))
        assert tuple(seed2[row]) == want, rid
        assert min(want) >= 0
    # the majority length's precomputed seeds (_ReadCache) agree
    main = max({len(r) for r in reads},
               key=lambda L: sum(len(r) == L for r in reads))
    mrids = [r for r in sorted(indexed) if len(read_seqs[r]) == main]
    cache = _ReadCache(read_seqs, pack_kmers_batch(
        np.stack([read_seqs[r] for r in mrids])))
    cache.build_precomputes()
    np.testing.assert_array_equal(cache.seed_kmer_pos,
                                  seed2[row_of[mrids]])


def test_index_csr_matches_the_sorted_dict():
    reads, rids, _w = ragged_world(6)
    index = ReadIndexMaxHash()
    index.add_reads_batch(reads, rids)
    sf, off, csr_rids = index_csr(index.index)
    keys = sorted(index.index)
    assert sf.tolist() == keys
    assert off.tolist() == np.cumsum(
        [0] + [len(index.index[k]) for k in keys]).tolist()
    assert csr_rids.tolist() == [r for k in keys for r in index.index[k]]
    assert [len(x) for x in index_csr({})] == [0, 1, 0]


def test_reads_without_a_row_or_a_seed():
    """An indexed read without a row is an error.  Reads shorter than K
    sit under fingerprint 0 with seed -1: held where no query can reach
    fingerprint 0 (read_len > K), an error where one can (read_len ==
    K)."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, 4, 500).astype(np.uint8)
    reads = [src[i:i + ln] for i, ln in ((0, 40), (50, 12), (90, 40),
                                         (200, 7), (300, 25))]
    read_seqs = dict(enumerate(reads))
    index = ReadIndexMaxHash()
    index.add_reads_batch(reads, list(read_seqs))
    assert index.read_len == 25 and sorted(index.index[0]) == [1, 3]
    row_of = ragged_rows(read_seqs)
    gen = DeviceCandGen.from_index(index, read_seqs, row_of, "cpu")
    seed2 = gen.seed2.numpy()
    assert (seed2[row_of[[1, 3]]] == -1).all()
    assert (seed2[row_of[[0, 2, 4]]] >= 0).all()
    c = gen.query_plain([src, dna.revcomp(src)])
    assert c.n_total > 0 and not set(c.rid.tolist()) & {1, 3}
    missing = row_of.copy()
    missing[2] = -1
    with pytest.raises(ValueError, match="no row"):
        DeviceCandGen.from_index(index, read_seqs, missing, "cpu")
    with pytest.raises(ValueError, match="no row"):
        DeviceCandGen.from_index(index, read_seqs, row_of[:3], "cpu")
    index.read_len = K
    with pytest.raises(ValueError, match="no seed"):
        DeviceCandGen.from_index(index, read_seqs, row_of, "cpu")


@pytest.mark.parametrize("tile", TILES)
def test_cap_overflow_and_retry(tile):
    reads, rids, windows = ragged_world(9, n_windows=3, max_window=900)
    _i, _j, _r, gen = build(reads, rids)
    staged = gen.upload(windows)
    full = gen.query_plain(staged=staged)
    assert full.n_total > 16
    for query in (gen.query_plain,
                  lambda **kw: query_twin(gen, *staged, kw["cap"],
                                          tile=tile)):
        over = query(staged=staged, cap=16)
        assert over.overflow and over.n_total == full.n_total
        assert_same(query(staged=staged, cap=over.n_total), full)


def trimmed_aligner(seed, n_reads, index_kind="maxhash"):
    """(SubpathAligner on the CPU over a trimmed library of a linear
    chain, the port's graph, windows of consecutive nodes)."""
    from gaml_tpu_torch.index.trivial import ReadIndexTrivial

    rng = np.random.default_rng(seed)
    gr, node_seqs = make_linear_graph(rng, [700, 80, 650, 120, 500])
    reads = [dna.encode_seq(r) for r in sample_reads(
        rng, "".join(node_seqs), n_reads, 100, err_rate=0.01)]
    cut = rng.random(len(reads)) < 0.3
    reads = [r[:int(rng.integers(40, 100))] if c else r
             for r, c in zip(reads, cut)]
    index = ReadIndexMaxHash() if index_kind == "maxhash" else \
        ReadIndexTrivial()
    if index_kind == "maxhash":
        index.add_reads_batch(reads, list(range(len(reads))))
    else:
        for rid, r in enumerate(reads):
            index.add_read(r, rid)
    al = SubpathAligner(index, dict(enumerate(reads)), backend="device",
                        device="cpu")
    windows = [(0,), (0, 2), (2, 4, 6), (4, 6, 8), (0, 2, 4, 6, 8)]
    return al, port_linear_graph(node_seqs), windows


def test_aligner_batch_retries_once_and_skips_the_host_pass(monkeypatch):
    """A no-bundle batch above its cap (max(4096, bases / 2)) on a
    max-hash read set: one overflowing query, one retry at the count, the
    alignments of the host route (align_subpath: gen_candidates and the
    per-window extension), and no host candidate pass."""
    al, gr, windows = trimmed_aligner(4, 6000)
    caps = []
    real = DeviceCandGen.query_plain

    def spy(self, seqs=None, cap=None, staged=None, split=None):
        out = real(self, seqs, cap, staged, split)
        caps.append((cap, out.n_total, out.overflow))
        return out

    monkeypatch.setattr(DeviceCandGen, "query_plain", spy)
    host = LAUNCHES["gen_candidates"]
    got = al.align_subpaths_batch(gr, windows)
    assert LAUNCHES["gen_candidates"] == host
    (cap0, n, over), (cap1, n1, over1) = caps
    assert over and cap0 == 4096 < n and (cap1, n1, over1) == (n, n, False)
    assert (al.device_batches, al.device_candidates) == (1, n)
    for w, g in zip(windows, got):
        assert al.align_subpath(gr, w) == g
    assert LAUNCHES["gen_candidates"] == host + len(windows)


def test_trivial_index_keeps_the_host_pass():
    al, gr, windows = trimmed_aligner(6, 300, index_kind="trivial")
    host = LAUNCHES["gen_candidates"]
    plain = LAUNCHES["query_plain"]
    got = al.align_subpaths_batch(gr, windows)
    assert al.ensure_device_rescorer() is None
    assert LAUNCHES["gen_candidates"] == host + len(windows)
    assert LAUNCHES["query_plain"] == plain
    assert sum(len(g) for g in got) > 50
    for w, g in zip(windows, got):
        assert al.align_subpath(gr, w) == g

"""The long-read seed lookup (gaml_tpu_torch/ops/seeds_device.py,
csrc/seeds.cu) against the JAX package's host index
(gaml_tpu/align/longread.py::SortedKmerIndex), segment by segment: the
plain torch version and the numpy twin of the kernels' algorithm (at tiny
tiles, so that keys, ranges and segments cross tile edges) give each
(range, read row) exactly the hits of SortedKmerIndex(range).hits_kmers on
the row's packed k-mers, in the same order.  Made cases: a k-mer over the
64 occurrences the index keeps, N codes in reads and walks, reads of 13
and 14 bases and a range shorter than 13, queries without hits, both
strands of reads over several ranges whose junctions must give nothing.
Then the read set: precompute_ranges_for_paths on both of the port's
routes (the device route's host code with the plain version in place of
the kernels, and the port's host index) gives the JAX package's
PacbioReadSet's spelled ranges, jobs and meta on the same genome and
reads, and the two routes the same cache; under a read_range, the JAX
package's jobs and meta of those reads.  The ``cuda`` tests hold the
kernels to the plain version on the card and count their launches; they
import neither jax nor the JAX package, so they run where jax is
missing:

    python -m pytest --noconftest -m cuda tests/test_torch_pacbio_seeds.py
"""
import numpy as np
import pytest
import torch

from gaml_tpu_torch.align.longread import MAX_KMER_OCC, SEED_K
from gaml_tpu_torch.core import dna
from gaml_tpu_torch.ops import seeds_device
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine
from gaml_tpu_torch.ops.seeds_device import seed_hits, seed_hits_plain, \
    seed_hits_twin

CASES = ("over_64", "n_codes", "short", "no_hits", "strands_and_ranges")


def noisy(rng, s, err=0.05):
    """``s`` with substitutions at ``err``."""
    out = s.copy()
    hit = rng.random(len(out)) < err
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def case(name):
    """(reads, ranges, segments (rid, strand, range)) of a made batch."""
    rng = np.random.default_rng(CASES.index(name) + 3)

    def bases(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    if name == "over_64":
        # code 1 (A) 150 and 30 times: its 13-mer 156 times in the range
        poly = np.ones(150, np.uint8)
        ranges = [np.concatenate([bases(300), poly, bases(300), poly[:30],
                                  bases(50)])]
        reads = [np.concatenate([bases(20), poly[:40], bases(30)]),
                 ranges[0][250:700].copy()]
    elif name == "n_codes":
        r0 = bases(600)
        r0[100:130] = dna.CODE_N
        r0[400:405] = dna.CODE_N
        ranges = [r0]
        a = r0[80:300].copy()
        a[5:9] = dna.CODE_N
        b = r0[350:550].copy()
        b[60:63] = 0  # G where the walk has N: both pack as 0
        reads = [a, b, np.full(40, dna.CODE_N, np.uint8)]
    elif name == "short":
        ranges = [bases(400), bases(10), bases(13), bases(300)]
        reads = [ranges[0][17:30].copy(), ranges[3][100:114].copy(),
                 ranges[2].copy(), bases(13)]
    elif name == "no_hits":
        ranges = [bases(500), bases(700)]
        reads = [bases(n) for n in (50, 120, 13)]
    else:  # reads over several ranges, on both strands
        ranges = [bases(n) for n in (400, 250, 600, 90, 500)]
        reads = []
        for i in range(len(ranges) - 1):  # across a junction
            reads.append(np.concatenate([ranges[i][-40:],
                                         ranges[i + 1][:40]]))
        for r in ranges:
            s = noisy(rng, r[len(r) // 4:len(r) // 4 + 80])
            reads += [s, dna.revcomp(s)]
    segs = [(rid, strand, k) for k in range(len(ranges))
            for rid in range(len(reads)) for strand in (0, 1)
            if len(reads[rid]) >= SEED_K]
    return reads, ranges, segs


def batch(reads, ranges, segs):
    """(rows on the CPU, seed_hits' arguments after the rows)."""
    rows = ForwardDeviceEngine(reads, "cpu").rows
    seg_row = [rid + strand * len(reads) for rid, strand, _k in segs]
    return rows, (np.concatenate(ranges), [len(r) for r in ranges], seg_row,
                  [k for _r, _s, k in segs],
                  [len(reads[rid]) for rid, _s, _k in segs])


def expected(reads, ranges, segs):
    """Each segment's (tpos, qpos) from the JAX package's host index."""
    from gaml_tpu.align.longread import SEED_K as K, SortedKmerIndex
    from gaml_tpu.core.dna import revcomp
    from gaml_tpu.index.maxhash import pack_kmers

    out = []
    for rid, strand, k in segs:
        q = reads[rid] if strand == 0 else revcomp(reads[rid])
        out.append(SortedKmerIndex(ranges[k]).hits_kmers(pack_kmers(q, K)))
    return out


def assert_same(seg_off, hits, want):
    assert len(seg_off) == len(want) + 1 and seg_off[-1] == len(hits)
    assert hits.dtype == np.int32 and hits.shape == (len(hits), 2)
    for s, (tpos, qpos) in enumerate(want):
        got = hits[seg_off[s]:seg_off[s + 1]]
        np.testing.assert_array_equal(got[:, 0], tpos)
        np.testing.assert_array_equal(got[:, 1], qpos)


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_the_host_index(name):
    reads, ranges, segs = case(name)
    want = expected(reads, ranges, segs)
    rows, args = batch(reads, ranges, segs)
    seg_off, hits = seed_hits_plain(rows, *args)
    assert_same(seg_off, hits, want)
    n = sum(len(t) for t, _q in want)
    if name == "over_64":
        # the cap keeps the lowest positions of the poly-A 13-mer
        first = hits[seg_off[0]:seg_off[1]]  # read 0, forward
        assert max(np.bincount(first[:, 1])) == MAX_KMER_OCC
        assert n > 0
    if name == "no_hits":
        assert n == 0
    if name == "strands_and_ranges":
        assert n > 0 and len(set(hits[:, 1])) > 10


@pytest.mark.parametrize("tiles", [(32, 16, 4), (64, 24, 8),
                                   (seeds_device.SORT_TILE,
                                    seeds_device.QUERY_TILE,
                                    seeds_device.QUERY_PER)])
@pytest.mark.parametrize("name", CASES)
def test_twin_equals_the_host_index(name, tiles):
    """The kernels' layout: the LSD passes by tiles, each query's bound
    and count, the tiles' sums, each thread's offset and the expansion."""
    reads, ranges, segs = case(name)
    want = expected(reads, ranges, segs)
    rows, args = batch(reads, ranges, segs)
    sort_tile, query_tile, per = tiles
    seg_off, hits, counts = seed_hits_twin(
        rows.numpy(), *args, sort_tile=sort_tile, query_tile=query_tile,
        query_per=per)
    assert_same(seg_off, hits, want)
    assert counts.max(initial=0) <= MAX_KMER_OCC
    assert counts.sum() == len(hits)


def test_radix_pass_is_a_stable_sort_by_its_digit():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**34, 5000).astype(np.uint64)
    val = np.arange(5000, dtype=np.int32)
    for tile in (7, 32, 4096):
        k, v = key, val
        for shift in range(0, 34, 8):
            k, v = seeds_device.radix_pass(k, v, shift, tile)
        order = np.argsort(key, kind="stable")
        np.testing.assert_array_equal(k, key[order])
        np.testing.assert_array_equal(v, val[order])


@pytest.mark.parametrize("fn", [seed_hits, seed_hits_plain])
def test_batch_is_checked(fn):
    """Both entry points check the batch alike; the kernels' refuse rows
    off a CUDA device."""
    reads, ranges, segs = case("short")
    rows, (seq, rlen, seg_row, seg_range, seg_len) = batch(reads, ranges,
                                                           segs)
    with pytest.raises(ValueError, match="outside"):
        fn(rows, seq, rlen, seg_row, seg_range, [12] + list(seg_len[1:]))
    with pytest.raises(ValueError, match="outside"):
        fn(rows, seq, rlen, [rows.shape[0]] + seg_row[1:], seg_range,
           seg_len)
    with pytest.raises(ValueError, match="bases for ranges"):
        fn(rows, seq[:-1], rlen, seg_row, seg_range, seg_len)
    with pytest.raises(ValueError, match="rows must be"):
        fn(rows.to(torch.int32), seq, rlen, seg_row, seg_range, seg_len)
    if fn is seed_hits:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(rows, seq, rlen, seg_row, seg_range, seg_len)
        return
    seg_off, hits = fn(rows, seq, rlen, [], [], [])
    assert list(seg_off) == [0] and hits.shape == (0, 2)


# ------------------------------------------------------------- the read set
def precomputed(rs, gr, walks, device_route, monkeypatch):
    """(the forward batches' jobs, the filled cache) of one precompute
    from an empty cache, the seed lookup on the device route's host code
    (the rows on the CPU, the plain version in the kernels' place) or on
    the port's host index."""
    from test_torch_pacbio import recorded

    rs.aligment_cache = {}
    with monkeypatch.context() as m:
        if device_route:
            eng = ForwardDeviceEngine(rs.read_seq, "cpu")
            m.setattr(rs, "_seed_engine", lambda: eng)
            m.setattr(seeds_device, "seed_hits",
                      lambda rows, *args: seed_hits_plain(rows, *args[:5]))
        else:
            m.setattr(rs, "_seed_engine", lambda: None)
        calls = recorded(rs)
        rs.precompute_ranges_for_paths(gr, walks)
        del rs._forward_batch
    return [jobs for _seq, jobs, _ext, _out in calls], rs.aligment_cache


def same_jobs(a, b):
    assert len(a) == len(b)
    for ja, jb in zip(a, b):
        assert len(ja) == len(jb)
        for x, y in zip(ja, jb):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
            assert x[2:] == y[2:]


def same_preps(got, want):
    """Each range's spelled sequence, jobs and meta (rid, chain) equal."""
    assert len(got) == len(want)
    for (seq, jobs, meta), (w_seq, w_jobs, w_meta) in zip(got, want):
        np.testing.assert_array_equal(seq, w_seq)
        same_jobs([jobs], [w_jobs])
        assert [(rid, tuple(ch)) for rid, ch in meta] == \
            [(rid, tuple(ch)) for rid, ch in w_meta]


def jax_preps(tmp_path, name, gr, walks):
    """The JAX package's preps (seq, jobs, meta) of one precompute of
    ``walks`` from an empty cache, on test_torch_pacbio.world's genome
    (the port's graph ``gr`` holds the same nodes) and FASTQ, its forward
    batches stubbed (the jobs are what is compared)."""
    from gaml_tpu.scoring.pacbio import PacbioReadSet

    from fixtures import make_linear_graph
    from test_pacbio import PB_MATCH

    jgr, _seqs = make_linear_graph(np.random.default_rng(21),
                                   [900, 120, 1200])
    assert jgr.num_nodes == gr.num_nodes and all(
        np.array_equal(a, b) for a, b in zip(jgr.seqs, gr.seqs))
    jrs = PacbioReadSet(str(tmp_path / f"jax_{name}"),
                        str(tmp_path / f"{name}.fq"), PB_MATCH, 0.05)
    jrs.preprocess_reads()
    jrs.compute_anchors(jgr, persist=False)
    preps = []
    prepare = jrs._slow_prepare

    def kept(graph, path, save_to_cache=True):
        prep = prepare(graph, path, save_to_cache)
        preps.append((prep["seq"], prep["jobs"], prep["meta"]))
        return prep

    jrs._slow_prepare = kept
    jrs._forward_batch = lambda seq, jobs, extents=None: [0.0] * len(jobs)
    jrs.precompute_ranges_for_paths(jgr, walks)
    return jrs, preps


def test_precompute_routes_give_the_same_jobs_and_cache(tmp_path,
                                                        monkeypatch):
    from test_torch_pacbio import WALKS, needs_native, world

    needs_native()
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))
    gr, rs = world(tmp_path, "seeds", 64)
    jrs, want = jax_preps(tmp_path, "seeds", gr, WALKS)
    assert jrs.anchors_cache == rs.anchors_cache
    assert len(want) > 1  # several ranges in the one batch
    assert sum(len(jobs) for _s, jobs, _m in want) > 0
    preps = []
    chain = rs._chain_preps

    def kept(graph, reserved):
        out = chain(graph, reserved)
        preps.append([(p["seq"], p["jobs"], p["meta"]) for p in out])
        return out

    monkeypatch.setattr(rs, "_chain_preps", kept)
    host_jobs, host_cache = precomputed(rs, gr, WALKS, False, monkeypatch)
    dev_jobs, dev_cache = precomputed(rs, gr, WALKS, True, monkeypatch)
    assert host_jobs and sum(map(len, host_jobs)) > 0
    same_jobs(host_jobs, dev_jobs)
    assert host_cache == dev_cache
    assert len(preps) == 2
    for got in preps:  # each route against the JAX package
        same_preps(got, want)

    # a process's read_range: its own reads only
    lo, hi = 3, 11
    rs.read_range = (lo, hi)
    try:
        host_part, host_pcache = precomputed(rs, gr, WALKS, False,
                                             monkeypatch)
        dev_part, dev_pcache = precomputed(rs, gr, WALKS, True, monkeypatch)
    finally:
        del rs.read_range
    same_jobs(host_part, dev_part)
    assert host_pcache == dev_pcache
    part = [(seq, [j for j in jobs if lo <= j[2] < hi],
             [m for m in meta if lo <= m[0] < hi])
            for seq, jobs, meta in want]
    for got in preps[2:]:
        same_preps(got, part)
    rids = {j[2] for jobs in dev_part for j in jobs}
    assert rids and rids <= set(range(lo, hi))
    assert rids < {j[2] for jobs in dev_jobs for j in jobs}


# ----------------------------------------------------------- on the card
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def big_case(seed=5, n_ranges=9, n_reads=60):
    """Reads of 0.5-3 kb at 5 % substitutions from ranges of 100 b-20 kb
    (one of 8 b), both strands, every read against every range."""
    rng = np.random.default_rng(seed)
    ranges = [rng.integers(0, 4, int(n)).astype(np.uint8)
              for n in rng.integers(100, 20000, n_ranges)]
    ranges[3] = ranges[3][:8]
    reads = []
    for _ in range(n_reads):
        r = ranges[int(rng.integers(0, n_ranges))]
        n = int(rng.integers(500, 3000))
        p = int(rng.integers(0, max(len(r) - n, 1)))
        s = noisy(rng, r[p:p + n]) if len(r) > SEED_K else \
            rng.integers(0, 4, n).astype(np.uint8)
        reads.append(s if rng.random() < 0.5 else dna.revcomp(s))
    segs = [(rid, strand, k) for k in range(n_ranges)
            for rid in range(n_reads) for strand in (0, 1)]
    return reads, ranges, segs


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ("big",))
def test_kernel_matches_plain(name):
    device = card()
    reads, ranges, segs = big_case() if name == "big" else case(name)
    rows, args = batch(reads, ranges, segs)
    want = seed_hits_plain(rows, *args)
    ws = seeds_device.Workspace()
    for _ in range(2):  # the second call on the workspace the first left
        got = seed_hits(rows.to(device), *args, ws)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_launches_and_no_library_sort(monkeypatch):
    device = card()
    reads, ranges, segs = big_case(seed=7)
    rows, args = batch(reads, ranges, segs)
    rows = rows.to(device)

    def no_sort(*a, **kw):
        raise AssertionError("torch.sort on the kernel route")

    monkeypatch.setattr(torch, "sort", no_sort)
    monkeypatch.setattr(torch.Tensor, "sort", no_sort)
    before = dict(seeds_device.LAUNCHES)
    seed_hits(rows, *args)
    passes = -(-(26 + (len(ranges) - 1).bit_length()) // 8)
    assert {k: v - before[k] for k, v in seeds_device.LAUNCHES.items()} == {
        "seeds_keys": 1, "seeds_hist": passes - 1, "seeds_scatter": passes,
        "seeds_count": 1, "seeds_scan": 1, "seeds_expand": 1}

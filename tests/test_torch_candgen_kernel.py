"""The candidate generation kernels (csrc/candgen.cu, ops/candgen_cuda.py).

On the CPU the kernels' algorithm runs as its numpy twin
(``query_twin``), held bit-equal to ``DeviceCandGen.query_plain`` (which
tests/test_torch_candgen.py holds to the native query and the JAX
package) at tiny tiles, so that windows, runs, segments and sort tiles
cross tile edges: n_total and every candidate (rid, g0, r0, orient, seg)
in order, on both sort routes (one block; the multi-block radix sort),
at the kernels' 8-bit digits and at other widths; its radix passes
(``radix_order``) are held to a stable argsort.  The ``cuda`` tests hold the kernels themselves to
query_plain on the same worlds, on worlds whose candidates straddle the
one-block threshold or pass 2^16, on the 64-bit key route and on
generators built from a max-hash index over reads of mixed lengths
(``ragged_world``, DeviceCandGen.from_index), and count one query's
launches on each route.  No jax import, so the card tests run where jax
is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_candgen_kernel.py
"""
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gaml_tpu_torch.core import dna
from gaml_tpu_torch.index.maxhash import K_INDEX_KMER, ReadIndexMaxHash
from gaml_tpu_torch.ops import candgen_cuda
from gaml_tpu_torch.ops.candgen_cuda import query_twin
from gaml_tpu_torch.ops.candgen_device import DeviceCandGen, stage_ms
from gaml_tpu_torch.utils.metrics import LAUNCHES

TILES = (7, 32, 128)


@pytest.fixture(autouse=True, scope="module")
def native_library():
    from gaml_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")


def make_bundle(reads):
    """The native aligner bundle of a uniform-length read matrix (the
    port's own index build; read id = row)."""
    from gaml_tpu_torch.native import NativeAlignBundle, read_index_build

    fp, ok_m, _k, _rc, seed_pos = read_index_build(reads, K_INDEX_KMER)
    okb = ok_m.astype(bool)
    rids = np.arange(len(reads), dtype=np.int64)[okb]
    order = np.argsort(fp[okb], kind="stable")
    sf, sr = fp[okb][order], rids[order]
    index = {}
    if len(sf):
        bounds = np.nonzero(np.diff(sf))[0] + 1
        starts = np.concatenate(([0], bounds)).tolist()
        ends = np.concatenate((bounds, [len(sf)])).tolist()
        index = {int(sf[s]): sr[s:e].tolist() for s, e in zip(starts, ends)}
    return NativeAlignBundle(index, reads.shape[1], reads,
                             dna._COMP_LUT[reads][:, ::-1], seed_pos,
                             np.arange(len(reads), dtype=np.int32))


def world(seed, read_len=30, n_seg=5, seg_lens=(0, 200), n_rate=0.0,
          tandem=False, foreign=False, n_reads=200):
    """(reads, window segments): segments of random or tandem-repeat
    sequence with N codes at ``n_rate``; reads sampled from them with 2 %
    substitutions, half reverse-complemented (from another genome when
    ``foreign``: no hits)."""
    rng = np.random.default_rng(seed)
    if tandem:
        motif = rng.integers(0, 4, int(rng.integers(3, 12))).astype(np.uint8)
        src = np.tile(motif, 4000 // len(motif) + 1)[:4000]
    else:
        src = rng.integers(0, 4, 4000).astype(np.uint8)
    segs = []
    for _ in range(n_seg):
        ln = int(rng.integers(seg_lens[0], seg_lens[1] + 1))
        at = int(rng.integers(0, len(src) - ln + 1))
        s = src[at:at + ln].copy()
        s[rng.random(ln) < n_rate] = 4
        segs.append(s)
    pool = rng.integers(0, 4, 4000).astype(np.uint8) if foreign else src
    starts = rng.integers(0, len(pool) - read_len + 1, n_reads)
    reads = pool[starts[:, None] + np.arange(read_len)]
    errs = rng.random(reads.shape) < 0.02
    reads[errs] = (reads[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    flip = rng.random(n_reads) < 0.5
    reads[flip] = dna._COMP_LUT[reads[flip]][:, ::-1]
    return reads, segs


def ragged_world(seed, n_windows=8, max_window=600, n_rate=0.01,
                 n_reads=240, lens=None):
    """(reads in file order, their read ids, windows): reads of six
    distinct lengths in 16-150 (or ``lens``) sampled from a 6 kb source
    with 2 % substitutions, half reverse-complemented, one in twenty with
    an N code (never indexed), read ids a permutation of the file order;
    ``n_windows`` windows of 16-``max_window`` bp cut from the source,
    N codes at ``n_rate``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 4, 6000).astype(np.uint8)
    if lens is None:
        lens = rng.choice(np.arange(16, 151), 6, replace=False)
    lens = np.asarray(lens)
    read_lens = np.concatenate([lens, rng.choice(lens, n_reads - len(lens))])
    reads = []
    for i, ln in enumerate(read_lens.tolist()):
        at = int(rng.integers(0, len(src) - ln + 1))
        r = src[at:at + ln].copy()
        errs = rng.random(ln) < 0.02
        r[errs] = (r[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
        if rng.random() < 0.5:
            r = dna.revcomp(r)
        if i % 20 == 19:
            r[int(rng.integers(0, ln))] = dna.CODE_N
        reads.append(r)
    rids = rng.permutation(n_reads).tolist()
    windows = []
    for _ in range(n_windows):
        ln = int(rng.integers(16, max_window + 1))
        at = int(rng.integers(0, len(src) - ln + 1))
        w = src[at:at + ln].copy()
        w[rng.random(ln) < n_rate] = dna.CODE_N
        windows.append(w)
    return reads, rids, windows


def ragged_rows(read_seqs):
    """SubpathAligner.ensure_ragged_extender's rid -> row map."""
    rids = sorted(read_seqs)
    row_of = np.full(max(rids) + 1, -1, dtype=np.int64)
    row_of[rids] = np.arange(len(rids))
    return row_of


WORLDS = {
    "one_segment": dict(n_seg=1, seg_lens=(3000, 3000)),
    "short_equal_long": dict(n_seg=40, seg_lens=(0, 70)),
    "n_codes": dict(n_seg=6, seg_lens=(20, 600), n_rate=0.01),
    "tandem_repeats": dict(n_seg=8, seg_lens=(10, 500), tandem=True),
    "hundreds_of_segments": dict(n_seg=400, seg_lens=(0, 90)),
    "zero_hits": dict(n_seg=5, seg_lens=(100, 400), foreign=True),
}


def assert_same(got, want):
    assert got.n_total == want.n_total
    assert got.overflow == want.overflow
    if got.overflow:
        return
    for name in ("rid", "g0", "r0", "orient", "seg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.int64, name
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                      err_msg=name)


def twin_against_plain(reads, segs, tile, cap=None, **route):
    """query_twin against query_plain at ``tile`` window starts, with
    tile // 2 + 1 threads of the window max (chunks of several starts
    that cross its blocks), sort tiles of 256 candidates in warps of 64,
    and ``route`` (one_block_max, digit_bits)."""
    gen = DeviceCandGen(make_bundle(reads), "cpu")
    staged = gen.upload(segs)
    want = gen.query_plain(cap=cap, staged=staged)
    assert_same(query_twin(gen, *staged, cap=cap, tile=tile,
                           threads=tile // 2 + 1, sort_tile=256,
                           warp_items=64, **route), want)
    return want


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_twin_matches_plain(name, tile):
    """The one-block route (the threshold large)."""
    reads, segs = world(11, **WORLDS[name])
    want = twin_against_plain(reads, segs, tile, one_block_max=1 << 30)
    assert (want.n_total == 0) == (name == "zero_hits")


@pytest.mark.parametrize("digit_bits", (8, 11))
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_twin_multi_block_route_matches_plain(name, tile, digit_bits):
    """The multi-block radix route (threshold 0) at the kernels' 8-bit
    digits and at 11 bits."""
    reads, segs = world(11, **WORLDS[name])
    twin_against_plain(reads, segs, tile, one_block_max=0,
                       digit_bits=digit_bits)


@pytest.mark.parametrize("wide", (False, True))
@pytest.mark.parametrize("digit_bits", range(1, 12))
def test_radix_twin_matches_stable_argsort(digit_bits, wide):
    """radix_order (the kernels' LSD passes: per-tile counts, the offsets
    of each (tile, digit), warps ranking rounds of 32 lanes) is the
    stable argsort, on keys with many duplicates, of 40 bits (``wide``:
    the 64-bit key route) or 19: sort tiles of 256 in warps of 64, and
    the one-block layout (one tile, 32 warps)."""
    rng = np.random.default_rng(digit_bits)
    n = 3001
    hi_bits, bits = (37, 40) if wide else (16, 19)
    key = (rng.integers(0, 8, n) << hi_bits) | rng.integers(0, 40, n)
    key[rng.random(n) < 0.1] = (1 << bits) - 1
    want = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(
        candgen_cuda.radix_order(key, bits, digit_bits, 256, 64), want)
    per_warp = -(-n // (32 * 32)) * 32
    np.testing.assert_array_equal(
        candgen_cuda.radix_order(key, bits, digit_bits, n, per_warp), want)


@pytest.mark.parametrize("tile", TILES)
def test_twin_cap_overflow_and_retry(tile):
    reads, segs = world(5, n_seg=3, seg_lens=(300, 900))
    gen = DeviceCandGen(make_bundle(reads), "cpu")
    staged = gen.upload(segs)
    over = query_twin(gen, *staged, cap=16, tile=tile)
    assert over.overflow and over.n_total > 16
    assert_same(over, gen.query_plain(cap=16, staged=staged))
    assert_same(query_twin(gen, *staged, cap=over.n_total, tile=tile),
                gen.query_plain(staged=staged))


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31), read_len=st.sampled_from((15, 16, 23,
                                                               40)),
       n_seg=st.integers(1, 300), max_len=st.integers(1, 120),
       n_rate=st.sampled_from((0.0, 0.003, 0.05)), tandem=st.booleans(),
       foreign=st.booleans(), tile=st.sampled_from(TILES),
       one_block_max=st.sampled_from((0, 1 << 30)),
       digit_bits=st.sampled_from((8, 11)))
def test_twin_matches_plain_on_random_worlds(seed, read_len, n_seg, max_len,
                                             n_rate, tandem, foreign, tile,
                                             one_block_max, digit_bits):
    reads, segs = world(seed, read_len, n_seg, (0, max_len), n_rate, tandem,
                        foreign, n_reads=120)
    twin_against_plain(reads, segs, tile, one_block_max=one_block_max,
                       digit_bits=digit_bits)


def test_cpu_query_runs_plain_and_splits():
    """On the CPU ``query`` is query_plain (counted), with the split's
    stages in order; the kernel's wrapper refuses a CPU index."""
    reads, segs = world(2, n_seg=3, seg_lens=(200, 400))
    gen = DeviceCandGen(make_bundle(reads), "cpu")
    before = LAUNCHES["query_plain"]
    split = []
    c = gen.query(segs, split=split)
    assert LAUNCHES["query_plain"] == before + 1
    assert c.n_total > 0
    assert list(stage_ms(split)) == [
        "upload", "segments", "hash", "window_max", "runs_nonzero",
        "searchsorted", "count_sync", "expand", "sort"]
    with pytest.raises(ValueError, match="unsupported device"):
        candgen_cuda.query_kernel(gen, *gen.upload(segs), None,
                                  lambda _s: None)


def test_kernel_wrapper_checks_its_inputs():
    reads, segs = world(3, n_seg=2, seg_lens=(100, 200))
    gen = DeviceCandGen(make_bundle(reads), "cpu")
    codes, seg_base, seg_len = gen.upload(segs)
    with pytest.raises(ValueError, match="codes must be uint8"):
        candgen_cuda.check_batch(gen, codes.to(torch.int32), seg_base,
                                 seg_len)
    with pytest.raises(ValueError, match="seg_len must be int64"):
        candgen_cuda.check_batch(gen, codes, seg_base, seg_len[:1])
    gen.read_len = candgen_cuda.L_MAX + 1
    with pytest.raises(ValueError, match="above the kernel"):
        candgen_cuda.check_batch(gen, codes, seg_base, seg_len)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def kernel_against_plain(reads, segs, device, cap=None):
    gen = DeviceCandGen(make_bundle(reads), device)
    staged = gen.upload(segs)
    plain = LAUNCHES["query_plain"]
    got = gen.query(cap=cap, staged=staged)
    torch.cuda.synchronize()
    assert LAUNCHES["query_plain"] == plain
    want = gen.query_plain(cap=cap, staged=staged)
    assert_same(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_kernel_matches_plain(name):
    device = card()
    reads, segs = world(11, **WORLDS[name])
    kernel_against_plain(reads, segs, device)
    for read_len in (15, 100):  # one k-mer a window; the rescore's length
        reads, segs = world(12, read_len=read_len,
                            **dict(WORLDS[name], n_reads=300))
        kernel_against_plain(reads, segs, device)


@pytest.mark.cuda
def test_kernel_on_random_worlds_and_cap():
    device = card()
    rng = np.random.default_rng(0)
    for seed in range(40):
        reads, segs = world(seed, int(rng.choice([15, 16, 40, 100, 250])),
                            int(rng.integers(1, 600)),
                            (0, int(rng.integers(1, 3000))),
                            float(rng.choice([0.0, 0.01])),
                            bool(rng.random() < 0.3), bool(rng.random() < 0.1))
        c = kernel_against_plain(reads, segs, device)
        if c.n_total > 1:
            kernel_against_plain(reads, segs, device, cap=c.n_total - 1)
            kernel_against_plain(reads, segs, device, cap=c.n_total)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rate", [0.0, 0.01])
def test_kernel_matches_plain_on_an_index_built_generator(n_rate):
    """DeviceCandGen.from_index (reads of six lengths, the ragged rows):
    the kernel bit-equal to query_plain, with a cap overflow and retry."""
    device = card()
    for seed in range(6):
        reads, rids, windows = ragged_world(seed, 64, 3000, n_rate, 600)
        index = ReadIndexMaxHash()
        index.add_reads_batch(reads, rids)
        read_seqs = dict(zip(rids, reads))
        gen = DeviceCandGen.from_index(index, read_seqs,
                                       ragged_rows(read_seqs), device)
        staged = gen.upload(windows)
        got = gen.query(staged=staged)
        torch.cuda.synchronize()
        assert got.n_total > 0
        assert_same(got, gen.query_plain(staged=staged))
        over = gen.query(staged=staged, cap=got.n_total - 1)
        assert over.overflow and over.n_total == got.n_total
        assert_same(gen.query(staged=staged, cap=got.n_total), got)


def forced(gen, staged, **route):
    """query_kernel on ``staged`` with ``route`` (one_block_max) in place
    of the default."""
    return candgen_cuda.query_kernel(gen, *staged, None, lambda _s: None,
                                     **route)


@pytest.mark.cuda
def test_kernel_on_both_sides_of_the_one_block_threshold():
    """Worlds of the first k of 40 segments (about 570 candidates each),
    k chosen from BLOCK_MAX so that two worlds fall at or below it and two
    above; each bit-equal to query_plain by default, at a threshold of
    n_total (the one-block route) and n_total - 1 (the radix route)."""
    device = card()
    reads, all_segs = world(4, read_len=100, n_seg=40, seg_lens=(3000, 3000),
                            n_reads=1000)
    gen = DeviceCandGen(make_bundle(reads), device)
    per_seg = torch.bincount(gen.query_plain(all_segs).seg.cpu(),
                             minlength=len(all_segs))
    cum = torch.cumsum(per_seg, 0).tolist()
    assert cum[-1] > candgen_cuda.BLOCK_MAX + 2 * max(per_seg.tolist())
    k = sum(c <= candgen_cuda.BLOCK_MAX for c in cum)  # cum[k - 1] <= it
    sides = set()
    for segs in (all_segs[:k - 1], all_segs[:k], all_segs[:k + 1],
                 all_segs[:k + 2]):
        got = kernel_against_plain(reads, segs, device)
        n = got.n_total
        sides.add(n <= candgen_cuda.BLOCK_MAX)
        staged = gen.upload(segs)
        for route in (dict(one_block_max=n), dict(one_block_max=n - 1)):
            assert_same(forced(gen, staged, **route), got)
    assert sides == {True, False}


@pytest.mark.cuda
def test_kernel_above_two_to_the_sixteen_candidates():
    device = card()
    reads, segs = world(4, read_len=100, n_seg=120, seg_lens=(3000, 3000),
                        n_reads=1000)
    gen = DeviceCandGen(make_bundle(reads), device)
    staged = gen.upload(segs)
    want = gen.query_plain(staged=staged)
    assert want.n_total > 1 << 16
    assert_same(forced(gen, staged), want)


@pytest.mark.cuda
def test_kernel_on_the_64_bit_key_route():
    """A row_of of 2^20 rows and 2^13 segments: 33 key bits, so 64-bit
    keys on the radix route, whatever the threshold."""
    device = card()
    reads, segs = world(4, read_len=40, n_seg=1 << 13, seg_lens=(60, 200),
                        n_reads=1000)
    gen = DeviceCandGen(make_bundle(reads), device)
    gen.row_of = torch.cat([gen.row_of, gen.row_of.new_zeros(
        (1 << 20) - gen.row_of.shape[0])])
    assert sum(candgen_cuda.key_bits(len(segs), 1 << 20)) == 33
    staged = gen.upload(segs)
    want = gen.query_plain(staged=staged)
    for cap in (None, want.n_total - 1):
        got = candgen_cuda.query_kernel(gen, *staged, cap, lambda _s: None,
                                        one_block_max=1 << 30)
        assert_same(got, gen.query_plain(cap=cap, staged=staged))


@pytest.mark.cuda
def test_kernel_launches_of_one_query():
    """The one-block route: the runs pass and one launch after the sync;
    the radix route: the expansion, a scatter a pass and a histogram
    between two; a query without candidates: the runs pass alone."""
    device = card()
    reads, segs = world(4, n_seg=20, seg_lens=(50, 3000))
    gen = DeviceCandGen(make_bundle(reads), device)
    staged = gen.upload(segs)
    bits = sum(candgen_cuda.key_bits(len(segs), gen.row_of.shape[0]))
    passes = -(-bits // candgen_cuda.DIGIT_BITS)
    for route, want in (
            (dict(one_block_max=1 << 30), dict(candgen_block=1)),
            (dict(one_block_max=0), dict(candgen_expand=1,
                                         candgen_hist=passes - 1,
                                         candgen_scatter=passes))):
        before = LAUNCHES.copy()
        c = forced(gen, staged, **route)
        torch.cuda.synchronize()
        assert 0 < c.n_total <= candgen_cuda.BLOCK_MAX
        assert LAUNCHES - before == Counter(candgen_runs=1, **want)
    reads, segs = world(4, n_seg=20, seg_lens=(50, 3000), foreign=True)
    gen = DeviceCandGen(make_bundle(reads), device)
    before = LAUNCHES.copy()
    assert gen.query(segs).n_total == 0
    assert LAUNCHES - before == Counter(candgen_runs=1)

"""The rescore's stages after the extension on the card (csrc/rescore.cu,
ops/rescore_cuda.py): the run-local first-wins dedup, the float64 sums
per (job, read) and the floored reduction.

On the CPU the kernels' algorithm runs as its numpy twin
(``score_twin``), held to the torch chain (``dedup_sums_plain`` and
``score_plain``: dedup_alignments, index_add_, reduce_read_probs) at
tiles of 7, 32 and 1024 candidates, so that runs cross tile edges: the
kept set and zero reads exact, the sums within 1e-15 relative, the
scores within 1e-13.  The ``cuda`` tests hold the kernels themselves to
the chain on the card, on the rescore's worlds, on candgen's (tandem
repeats give long runs) and on a run of 4096 candidates, and count one
call's launches.  No jax import, so the card tests run where jax is
missing:

    python -m pytest --noconftest -m cuda tests/test_torch_rescore_kernel.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaml_tpu_torch.core import dna
from gaml_tpu_torch.ops import rescore_cuda
from gaml_tpu_torch.ops.rescore_cuda import score_kernel, score_twin
from gaml_tpu_torch.ops.rescore_device import (DeviceRescorer,
                                               dedup_sums_plain, score_plain)

from test_torch_candgen_kernel import WORLDS, make_bundle, world

MATCH, MISMATCH = float(np.log(0.96)), float(np.log(0.01))
MPB, MPS = -0.7, -10.0
ARGS = dict(log_match=MATCH, log_mismatch=MISMATCH, min_prob_per_base=MPB,
            min_prob_start=MPS)


def candidates(runs, seed, n_reads, read_len=40, n_seg=None):
    """(c, ext) of candidate runs: ``runs`` a list of (segment, read,
    length, begins), begins a list to cycle through; ok false at about
    one in five, errors 0-4."""
    rng = np.random.default_rng(seed)
    seg, rid, begin = [], [], []
    for s, r, ln, bs in runs:
        seg += [s] * ln
        rid += [r] * ln
        begin += [bs[k % len(bs)] for k in range(ln)]
    n = len(seg)
    ok = rng.random(n) >= 0.2
    errs = rng.integers(0, 5, n)
    n_seg = n_seg or max(seg, default=0) + 1
    c = SimpleNamespace(
        n_total=n, seg=torch.tensor(seg, dtype=torch.int64),
        rid=torch.tensor(rid, dtype=torch.int64),
        seg_len=torch.full((n_seg,), 1000, dtype=torch.int64))
    ext = (torch.from_numpy(ok), torch.tensor(errs, dtype=torch.int32),
           torch.tensor(begin, dtype=torch.int32))
    return c, ext, n_reads, torch.full((n_reads,), read_len,
                                       dtype=torch.int32)


def case(name):
    """(c, ext, n_reads, lens, keyword arguments of the score)."""
    if name == "runs_1_2_64_4096":
        # every run all duplicates of one begin, or of a few, ok false
        # mixed in
        c, ext, n, lens = candidates(
            [(0, 0, 1, [5]), (0, 1, 2, [7]), (0, 2, 64, [3]),
             (0, 3, 64, [1, 2, 3]), (0, 4, 4096, [9]),
             (0, 5, 4096, list(range(50))), (0, 6, 2, [4, 5])], 1, 8)
        return c, ext, n, lens, dict(total_len=5000)
    if name == "one_read_in_several_segments":
        # read 3 in segments 0-3, equal begins across the runs' edges
        runs = [(s, r, ln, [10, 10, 12]) for s in range(4)
                for r, ln in ((1, 2), (3, 3), (4, 1))]
        c, ext, n, lens = candidates(runs, 2, 6)
        return c, ext, n, lens, dict(total_len=4000)
    if name == "totals_at_or_below_zero":
        # alignments whose probability underflows to 0 (a kept read with
        # a total of 0) and a total length of 0
        c, ext, n, lens = candidates(
            [(0, r, 3, [r, r + 1]) for r in range(10)], 3, 12, read_len=250)
        errs = ext[1].clone()
        errs[:9] = 250
        return c, (ext[0], errs, ext[2]), n, lens, dict(total_len=0)
    if name == "three_jobs":
        rng = np.random.default_rng(4)
        runs = [(s, int(r), int(rng.integers(1, 9)), [1, 2, 2, 5])
                for s in range(7) for r in sorted(rng.choice(40, 6, False))]
        c, ext, n, lens = candidates(runs, 4, 40, n_seg=8)
        return c, ext, n, lens, dict(total_len=[3000, 0, 9000],
                                     seg_job=np.array([0, 1, 2, 1, 0, 2]),
                                     n_jobs=3)
    if name == "no_candidates":
        c, _ext, n, lens = candidates([], 5, 7)
        return c, None, n, lens, dict(total_len=700)
    raise KeyError(name)


CASES = ("runs_1_2_64_4096", "one_read_in_several_segments",
         "totals_at_or_below_zero", "three_jobs", "no_candidates")


@pytest.mark.parametrize("tile", [7, 32, rescore_cuda.TILE])
@pytest.mark.parametrize("name", CASES)
def test_twin_matches_the_torch_chain(name, tile):
    c, ext, n_reads, lens, kw = case(name)
    jobs = dict(seg_job=kw.get("seg_job"), n_jobs=kw.get("n_jobs", 1))
    idx, probs = dedup_sums_plain(n_reads, lens, c, ext, MATCH, MISMATCH,
                                  **jobs)
    want = score_plain(n_reads, lens, c, ext, **ARGS, **kw)
    scores, zeros, keep, bins = score_twin(n_reads, lens, c, ext, **ARGS,
                                           **kw, tile=tile)
    assert sorted(np.nonzero(keep)[0].tolist()) == sorted(idx.tolist())
    np.testing.assert_allclose(bins, probs.numpy(), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(zeros, np.atleast_1d(want[1]))
    np.testing.assert_allclose(scores, np.atleast_1d(want[0]), rtol=1e-13,
                               atol=0)
    assert want[2] == c.n_total
    if name == "totals_at_or_below_zero":
        assert (bins == 0).any() and keep[:9].any() and zeros[0] > 0
    if name == "runs_1_2_64_4096" and ext is not None:
        assert keep.sum() < ext[0].sum()  # duplicates were dropped


def test_kernel_wrapper_checks_its_inputs():
    c, ext, n_reads, lens, kw = case("one_read_in_several_segments")
    resc = SimpleNamespace(device=torch.device("cpu"), n_reads=n_reads,
                           lens=lens)
    with pytest.raises(ValueError, match="unsupported device"):
        score_kernel(resc, c, ext, **ARGS, **kw)
    with pytest.raises(ValueError, match="errs must be"):
        rescore_cuda._check("errs", ext[1].to(torch.int64), torch.int32,
                            c.n_total)


# ----------------------------------------------------------- on the card
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def sample_world(seed, genome_len=3000, n_reads=300, read_len=40):
    """A genome and reads sampled from it with 2 % substitutions, half
    reverse-complemented (the rescore tests' world)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)]
    errs = rng.random(reads.shape) < 0.02
    reads[errs] = (reads[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    flip = rng.random(n_reads) < 0.5
    reads[flip] = dna._COMP_LUT[reads[flip]][:, ::-1]
    return genome, reads


def rescore_worlds():
    genome, reads = sample_world(0)
    yield "single_window", reads, [genome]
    genome, reads = sample_world(11, genome_len=4000)
    yield "multi_window", reads, [genome[:1500], genome[1300:2900],
                                  genome[2600:]]
    for name in sorted(WORLDS):
        reads, segs = world(13, **WORLDS[name])
        yield name, reads, segs


def kernel_against_plain(resc, c, ext, **kw):
    """score_kernel against score_plain on the same card tensors: kept
    count, zero reads exact, scores within 1e-13 relative."""
    jobs = dict(seg_job=kw.get("seg_job"), n_jobs=kw.get("n_jobs", 1))
    idx, _ = dedup_sums_plain(resc.n_reads, resc.lens, c, ext, MATCH,
                              MISMATCH, **jobs)
    want = score_plain(resc.n_reads, resc.lens, c, ext, **ARGS, **kw)
    for _ in range(2):  # the second call on the workspace the first left
        scores, zeros, kept = score_kernel(resc, c, ext, **ARGS, **kw)
        assert kept == len(idx)
        np.testing.assert_array_equal(zeros, np.atleast_1d(want[1]))
        np.testing.assert_allclose(scores, np.atleast_1d(want[0]),
                                   rtol=1e-13, atol=0)
    return kept


@pytest.mark.cuda
def test_kernel_matches_plain_on_rescore_worlds():
    device = card()
    for name, reads, segs in rescore_worlds():
        resc = DeviceRescorer(make_bundle(reads), device=device)
        c = resc.gen.query(segs)
        ext = resc._extend(c) if c.n_total else None
        total = sum(map(len, segs))
        kernel_against_plain(resc, c, ext, total_len=total)
        k = len(segs)
        kernel_against_plain(resc, c, ext, total_len=[total, 0, 7][:k],
                             seg_job=np.arange(k) % 3, n_jobs=min(k, 3))
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_made_runs(name):
    """The twin test's cases (a run of 4096 candidates among them) on the
    card."""
    device = card()
    c, ext, n_reads, lens, kw = case(name)
    c = SimpleNamespace(n_total=c.n_total, seg=c.seg.to(device),
                        rid=c.rid.to(device), seg_len=c.seg_len.to(device))
    if ext is not None:
        ext = tuple(t.to(device) for t in ext)
    resc = SimpleNamespace(device=device, n_reads=n_reads,
                           lens=lens.to(device))
    kernel_against_plain(resc, c, ext, **kw)


@pytest.mark.cuda
def test_score_launches_the_two_kernels_only(monkeypatch):
    device = card()
    genome, reads = sample_world(0)
    resc = DeviceRescorer(make_bundle(reads), device=device)
    c = resc.gen.query([genome])
    ext = resc._extend(c)
    torch.cuda.synchronize()

    def no_sort(*a, **kw):
        raise AssertionError("torch.sort on the kernel route")

    monkeypatch.setattr(torch, "sort", no_sort)
    monkeypatch.setattr(torch.Tensor, "sort", no_sort)
    before = dict(rescore_cuda.LAUNCHES)
    for _ in range(3):
        resc.score(c, ext, total_len=len(genome), **ARGS)
    assert {k: v - before[k] for k, v in rescore_cuda.LAUNCHES.items()} == {
        "rescore_dedup_sums": 3, "rescore_reduce": 3}

"""Ragged staging of the long-read forward batch (scoring/pacbio.py::
ragged_arrays, ForwardDeviceEngine.stage and the staging kernel of
csrc/banded_forward.cu behind ops/forward_cuda.py::forward_stage).  On
the CPU: the device inputs K5 reads (rows, steps, c0, row, gstart, glen,
rlen) equal those of the padded staging it replaced (job_arrays' padded
centers, their clipped diff) bit for bit, on resident rows and on dense
ones, on made batches (one range, several ranges with extents, one job, a
job of exactly rmax bases, guides with steps outside 0..2 and center
lists shorter or longer than the read) and on a precompute's batch;
_forward_batch answers the same on resident rows, dense rows and the
native route; a batch of several ranges answers as its ranges alone;
job_arrays places each job's centers at its extent's start; every engine
batch is staged raggedly once.  On the card the kernel equals its plain
version.  Imports no jax, so the card tests run where jax is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_pacbio_stage.py
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaml_tpu_torch.core import dna
from gaml_tpu_torch.ops.forward_cuda import forward_stage, forward_stage_ref
from gaml_tpu_torch.ops import forward_device
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine
from gaml_tpu_torch.scoring.pacbio import (PacbioReadSet, job_arrays,
                                           ragged_arrays)
from gaml_tpu_torch.utils.metrics import LAUNCHES, TRACE

from test_torch_kernels import guide_steps, port_native_lib
from test_torch_pacbio_reference import SmallWorld

CASES = ("single", "multi", "one_job", "exact_rmax")


def made_batch(case):
    """(read rows, seq, jobs, extents) of a made batch: jobs (read,
    centers, rid, strand) on ``seq``, one range or three concatenated
    (``extents`` then each job's range), centers in the range's frame by
    steps of -3..4, some lists shorter or longer than the read."""
    rng = np.random.default_rng(CASES.index(case) + 11)
    lens = rng.integers(100, 500, 12)
    lens[0] = 512 if case == "exact_rmax" else 599
    read_seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    n_ranges = 3 if case == "multi" else 1
    ranges = [rng.integers(0, 4, rng.integers(300, 900)).astype(np.uint8)
              for _ in range(n_ranges)]
    starts = np.cumsum([0] + [len(r) for r in ranges])
    rmax = ((int(lens.max()) + 127) // 128) * 128
    jobs, extents = [], []
    for k in range(1 if case == "one_job" else 24):
        rid = 0 if k == 0 else int(rng.integers(len(read_seqs)))
        strand = int(rng.integers(2))
        q = read_seqs[rid] if strand == 0 else dna.revcomp(read_seqs[rid])
        n = len(q) + 1
        if k % 5 == 3:
            n = len(q) // 2 + 1
        elif k % 5 == 4:
            n = rmax + 1
        fill = int(rng.integers(n_ranges))
        c = int(rng.integers(-20, len(ranges[fill]))) + np.concatenate(
            [[0], np.cumsum(rng.integers(-3, 5, n - 1))])
        jobs.append((q, c.astype(np.int32), rid, strand))
        extents.append((int(starts[fill]), len(ranges[fill])))
    return (read_seqs, np.concatenate(ranges), jobs,
            extents if case == "multi" else None)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A small ecoli_pacbio world on the CPU, one torch thread."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield SmallWorld(str(tmp_path_factory.mktemp("pbstage")), seed=7,
                         genome_bp=30_000, reads=16, read_bp=(500, 800))
    finally:
        torch.set_num_threads(threads)


def precompute_batch(tiny, monkeypatch):
    """(read rows, seq, jobs, extents) of the forward batch that a
    precompute of the misassembled walk set makes from an empty cache."""
    rs, got = tiny.rs, []
    forward = rs._forward_batch

    def recorded(seq, jobs, extents=None):
        got.append((seq, jobs, extents))
        return forward(seq, jobs, extents)

    rs.aligment_cache = {}
    with monkeypatch.context() as m:
        m.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
        m.setattr(rs, "_forward_batch", recorded)
        rs.precompute_ranges_for_paths(tiny.graph, tiny.walk_sets[1])
    (seq, jobs, extents), = got
    assert extents is not None and len({e[0] for e in extents}) > 1
    return rs.read_seq, seq, jobs, extents


def batch_of(case, tiny, monkeypatch):
    if case == "precompute":
        return precompute_batch(tiny, monkeypatch)
    return made_batch(case)


def padded_staging(eng, seq, jobs, extents):
    """K5's inputs as the padded staging gave them: job_arrays' padded
    centers (in ``seq``), their clipped diff as the guide steps and their
    first column as c0; the rows resident where the engine has them and
    every job a read id, else job_arrays' dense matrix (row = job)."""
    rmax, reads, rlens, centers, gstarts, glens = job_arrays(seq, jobs,
                                                             extents)
    rid = np.array([j[2] if len(j) > 2 else -1 for j in jobs], np.int64)
    strand = np.array([j[3] if len(j) > 2 else 0 for j in jobs], np.int64)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            eng.device)

    if eng.rows is not None and (rid >= 0).all():
        rows, row = eng.rows, rid + strand * eng.n_reads
    else:
        rows, row = up(reads, np.uint8), np.arange(len(jobs))
    return (rows, up(row, np.int32), up(seq, np.uint8),
            up(guide_steps(centers), np.uint8), up(centers[:, 0], np.int32),
            up(gstarts, np.int32), up(glens, np.int32), up(rlens, np.int32))


def assert_inputs_equal(got, want):
    names = ("rows", "row", "seq", "steps", "c0", "gstart", "glen", "rlen")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", CASES + ("precompute",))
def test_ragged_inputs_equal_padded_staging(case, tiny, monkeypatch):
    read_seqs, seq, jobs, extents = batch_of(case, tiny, monkeypatch)
    eng = ForwardDeviceEngine(read_seqs, "cpu")
    got = eng.stage(seq, *ragged_arrays(seq, jobs, extents))
    assert got[0] is eng.rows
    assert_inputs_equal(got, padded_staging(eng, seq, jobs, extents))
    steps = got[3]
    assert steps.shape[1] == job_arrays(seq, jobs, extents)[0]
    assert int(steps.max()) == 2 and int(steps.min()) == 0
    if case == "exact_rmax":
        assert steps.shape[1] == max(len(j[0]) for j in jobs) == 512


@pytest.mark.parametrize("rows", ("no_rid", "dense_rows"))
@pytest.mark.parametrize("case", CASES + ("precompute",))
def test_dense_inputs_equal_padded_staging(case, rows, tiny, monkeypatch):
    """Jobs without a read id on resident rows, and an engine without
    resident rows: the rows go up densely, the rest as on resident rows."""
    read_seqs, seq, jobs, extents = batch_of(case, tiny, monkeypatch)
    if rows == "no_rid":
        eng = ForwardDeviceEngine(read_seqs, "cpu")
        jobs = [j[:2] for j in jobs]
    else:
        eng = ForwardDeviceEngine(None, "cpu")
    got = eng.stage(seq, *ragged_arrays(seq, jobs, extents))
    assert got[0] is not eng.rows
    assert torch.equal(got[1], torch.arange(len(jobs), dtype=torch.int32))
    assert_inputs_equal(got, padded_staging(eng, seq, jobs, extents))


@pytest.mark.parametrize("case", ("multi", "precompute"))
def test_forward_batch_routes_agree(case, tiny, monkeypatch):
    """Resident rows (every job with a read id), dense rows (jobs without
    a read id; rows over GAML_PB_RESIDENT_MAX) bit for bit, and the native
    host kernel within
    test_torch_pacbio::test_small_batches_stay_native's bound."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    read_seqs, seq, jobs, extents = batch_of(case, tiny, monkeypatch)
    rs = PacbioReadSet("x", "x.fq", 0.85, 0.0375, device="cpu")
    rs.read_seq = read_seqs
    rs.reads_num = len(read_seqs)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    ragged = rs._forward_batch(seq, jobs, extents)
    assert rs._fwd_engine.rows is not None
    no_rid = rs._forward_batch(seq, [j[:2] for j in jobs], extents)
    monkeypatch.setenv("GAML_PB_RESIDENT_MAX", "0")
    rs._fwd_engine = None
    dense = rs._forward_batch(seq, jobs, extents)
    assert rs._fwd_engine.rows is None
    assert ragged == no_rid == dense
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))
    native = rs._forward_batch(seq, jobs, extents)
    assert set(rs.dp_cells) == {"torch", "native"}
    found = np.asarray(ragged) > -1e29
    assert found.sum() >= 8
    np.testing.assert_allclose(np.asarray(ragged)[found],
                               np.asarray(native)[found], rtol=1e-4,
                               atol=1e-3)


def test_several_ranges_answer_as_alone(tiny, monkeypatch):
    """A precompute's ranges in one batch (the walk buffers concatenated,
    each job's centers in its own range's frame) answer as each range's
    batch alone."""
    rs = tiny.rs
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    rs.aligment_cache = {}
    walk = tiny.walk_sets[1][0]
    preps = rs._prep_ranges(tiny.graph, walk,
                            [(i, i) for i in range(len(walk))])
    preps = [p for p in preps if p["jobs"]]
    assert len(preps) > 1
    got = []
    with monkeypatch.context() as m:
        m.setattr(rs, "_slow_apply", lambda prep, lps: got.append(lps))
        rs._run_preps(preps)
    alone = [rs._forward_batch(p["seq"], p["jobs"]) for p in preps]
    assert got == alone


def test_job_arrays_places_centers_at_extent_start():
    _rows, seq, jobs, extents = made_batch("multi")
    rmax, _reads, _rl, centers, gstarts, glens = job_arrays(seq, jobs,
                                                            extents)
    assert [(int(a), int(b)) for a, b in zip(gstarts, glens)] == extents
    for i, (_q, c, *_m) in enumerate(jobs):
        assert np.array_equal(centers[i, :len(c)], c + extents[i][0])
        assert (centers[i, len(c):] == c[-1] + extents[i][0]).all()
    alone = job_arrays(seq, jobs, None)[3]
    assert np.array_equal(alone[:, :1] + gstarts[:, None], centers[:, :1])
    assert rmax == centers.shape[1] - 1


@pytest.mark.parametrize("route", ("resident", "no_rid", "dense_rows",
                                   "native"))
def test_ragged_batches_counted(route, monkeypatch):
    """Every engine batch, on resident rows or dense ones, is staged
    raggedly: one call of the staging kernel's wrapper a device batch; a
    native batch makes none."""
    if route == "native" and port_native_lib() is None:
        pytest.skip("native library unavailable")
    read_seqs, seq, jobs, extents = made_batch("multi")
    rs = PacbioReadSet("x", "x.fq", 0.85, 0.0375, device="cpu")
    rs.read_seq = read_seqs
    rs.reads_num = len(read_seqs)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS",
                       str(1 << 62) if route == "native" else "0")
    if route == "dense_rows":
        monkeypatch.setenv("GAML_PB_RESIDENT_MAX", "0")
    if route == "no_rid":
        jobs = [j[:2] for j in jobs]
    staged = []

    def counted(*args):
        staged.append(args[2].shape[0])
        return forward_stage(*args)

    monkeypatch.setattr(forward_device, "forward_stage", counted)
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            rs._forward_batch(seq, jobs, extents)
            rs._forward_batch(seq, jobs[:3], extents[:3])
        counters = dict(TRACE.counters)
    finally:
        TRACE.reset()
    device = 0 if route == "native" else 2
    assert counters.get("pacbio.device_batches", 0) == device
    assert staged == ([] if route == "native" else [len(jobs), 3])


# ------------------------------ the staging kernel and its plain version
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def ragged_case(seed, n_jobs, rmax):
    """Flat centers (steps of -3..4 from -50..5000), their offsets (jobs
    of 0 to rmax + 9 centers) and gstarts."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, rmax + 10, n_jobs)
    n[:3] = (0, 1, rmax + 1)[:n_jobs]
    offsets = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    centers = np.concatenate([
        int(rng.integers(-50, 5000)) + np.concatenate(
            [[0], np.cumsum(rng.integers(-3, 5, k - 1))]) if k else
        np.zeros(0, np.int64) for k in n]).astype(np.int32)
    gstart = rng.integers(0, 1 << 20, n_jobs).astype(np.int32)
    return centers, offsets, gstart


SHAPES = [(1, 128), (300, 1024 + 132), (70_000, 8), (5, 0)]


@pytest.mark.parametrize("n_jobs,rmax", SHAPES)
def test_forward_stage_plain_matches_loop(n_jobs, rmax):
    """The plain version against the definition, job by job: jobs
    without centers, of one, of rmax + 1 and over it."""
    centers, offsets, gstart = ragged_case(n_jobs, n_jobs, rmax)
    steps, c0 = forward_stage_ref(*(torch.from_numpy(a) for a in (
        centers, offsets, gstart)), rmax)
    steps, c0 = steps.numpy(), c0.numpy()
    for j in range(0, n_jobs, max(n_jobs // 300, 1)):
        c = centers[offsets[j]:offsets[j + 1]].astype(np.int64)
        k = min(max(len(c) - 1, 0), rmax)
        want = np.zeros(rmax, np.uint8)
        want[:k] = np.clip(np.diff(c)[:k], 0, 2)
        assert np.array_equal(steps[j], want), j
        assert c0[j] == (c[0] if len(c) else 0) + gstart[j], j


@pytest.mark.cuda
@pytest.mark.parametrize("n_jobs,rmax", SHAPES)
def test_forward_stage_kernel_matches_plain_on_card(n_jobs, rmax):
    """The kernel against its plain version bit for bit, one launch a
    call: jobs without centers, of one, of rmax + 1 and over it, rmax
    over one block's columns and not a multiple of 128, more jobs than a
    grid's rows, rmax 0."""
    dev = card()
    args = [torch.from_numpy(a) for a in ragged_case(n_jobs, n_jobs, rmax)]
    n0 = LAUNCHES["forward_stage"]
    steps, c0 = forward_stage(*(a.to(dev) for a in args), rmax)
    torch.cuda.synchronize()
    assert LAUNCHES["forward_stage"] - n0 == 1
    want_steps, want_c0 = forward_stage_ref(*args, rmax)
    assert torch.equal(steps.cpu(), want_steps)
    assert torch.equal(c0.cpu(), want_c0)
    with pytest.raises(ValueError):
        forward_stage(*(a.to(dev) for a in args), rmax + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ragged_staging_on_card_equals_padded(case):
    """ForwardDeviceEngine.stage on the card equals the padded staging
    there, bit for bit."""
    dev = card()
    read_seqs, seq, jobs, extents = made_batch(case)
    eng = ForwardDeviceEngine(read_seqs, dev)
    got = eng.stage(seq, *ragged_arrays(seq, jobs, extents))
    want = padded_staging(eng, seq, jobs, extents)
    torch.cuda.synchronize()
    assert_inputs_equal(got, want)

"""Kernels of the port: K1/K2, the exact K3/K4 kernel and the exact
two-direction extension (gaml_tpu_torch.ops.extend_cuda), the wrappers'
CPU route and input checks, the K6 tool
(gaml_tpu_torch.tools.swar_kernel_proto), chip_smoke.py's ragged draw,
and on a CUDA card K1, K2, dp_rows_exact, the exact extension (uniform
and ragged reads, both loaders), the K6 tool and K5
(gaml_tpu_torch.ops.forward_cuda) against their plain versions, and the
read-sharded scorers over gloo and NCCL process groups.  Imports
no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import json
import os

import numpy as np
import pytest
import torch

from gaml_tpu_torch.ops import forward_cuda
from gaml_tpu_torch.ops.extend import PAD, SENT_GEN, SENT_READ
from gaml_tpu_torch.ops.extend_cuda import (dp_rows_exact,
                                            dp_rows_exact_ref, extend_exact,
                                            extend_exact_ref, swar_cost,
                                            swar_cost_accept,
                                            swar_cost_accept_ref,
                                            swar_cost_ref)
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine
from gaml_tpu_torch.tools import swar_kernel_proto
from gaml_tpu_torch.utils.metrics import LAUNCHES


def guide_steps(centers):
    """K5's guide steps of padded [B, rmax + 1] centers: their diff,
    clipped to 0..2 (the band catches up at most two columns a row)."""
    return np.clip(np.diff(centers.astype(np.int64), axis=1), 0,
                   2).astype(np.uint8)


def jax_native_build(build_dir):
    """The path of the JAX package's native library built by its own
    build() into ``build_dir`` under the port's build lock, named by its
    source's hash."""
    import fcntl
    import hashlib

    import gaml_tpu.native as jax_native

    with open(jax_native._SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    jax_native._SO = os.path.join(build_dir,
                                  f"libgaml_tpu_native_{digest}.so")
    with open(os.path.join(build_dir, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jax_native.build()
    return jax_native._SO


def port_native_lib():
    """The port's native library (built once, under its lock).  The JAX
    package's bindings, where a test loads them, are pointed at the JAX
    package's own library built beside it under the same lock
    (jax_native_build), so tests that hold one against the other never
    race on the JAX package's in-place build (ROADMAP C9); each package
    loads its own source's build, and where that does not build the JAX
    package's bindings are missing."""
    from gaml_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    import gaml_tpu.native as jax_native

    with jax_native._lock:
        if jax_native._lib is None:
            jax_native_build(os.path.dirname(native.library_path()))
            jax_native._tried = False
    return lib


def port_linear_graph(seqs):
    """The port's Graph of fixtures.make_linear_graph's chain of ``seqs``
    (node 2i -> node 2i + 2)."""
    from gaml_tpu_torch.core import dna
    from gaml_tpu_torch.core.graph import Graph

    gr = Graph()
    for s in seqs:
        gr.add_node_pair(dna.encode_seq(s))
    for i in range(len(seqs) - 1):
        gr.add_arc(2 * i, 2 * (i + 1))
    gr.calc_prob_sums()
    gr.calc_normalize_map()
    return gr


def random_band_inputs(seed, n, rmax):
    """Candidate-minor kernel inputs as the JAX kernel tests build them:
    half the candidates matching, sentinels, ragged rlen and short glen
    (rlen 0 included)."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 5, (rmax, n)).astype(np.uint8)
    gwin = rng.integers(0, 5, (rmax + 2 * PAD, n)).astype(np.uint8)
    gwin[PAD:PAD + rmax, :n // 2] = read[:, :n // 2]
    gwin[gwin == 4] = SENT_GEN
    read[read == 4] = SENT_READ
    rlen = rng.integers(0, rmax + 1, n).astype(np.int32)
    glen = rng.integers(0, rmax + PAD, n).astype(np.int32)
    return read, gwin, rlen, glen


def fused_world(seed, n, L=40, genome_len=3000, n_reads=200):
    """A resident read set and a window batch for the resident extension:
    reads of one length L sampled from a random genome (4 % substitutions,
    some deletions and insertions, 1 % N), both orientations as rows of
    ``codes``; four windows, the last one ending the buffer (ROADMAP C1);
    candidates mostly at random, a third at a read's true offset, 340 with
    their seed at genome position 0 (40 of them true: read 0 starts 3 or
    7 bases before window 2).  Returns (codes, seqs, seq_idx, and
    the kernel's per-candidate int32 base, glen, g0, r0, row)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    genome[rng.random(genome_len) < 0.01] = 4
    starts = rng.integers(0, genome_len - L - 2, n_reads)
    reads = []
    for p in starts.tolist():
        r = genome[p:p + L + 2].copy()
        e = rng.random(L + 2) < 0.04
        r[e] = (r[e] + 1) % 4
        u = rng.random()
        if u < 0.15:  # a deletion from the read
            j = int(rng.integers(1, L))
            r = np.delete(r, j)
        elif u < 0.3:  # an insertion into the read
            j = int(rng.integers(1, L))
            r = np.insert(r, j, int(rng.integers(0, 4)))
        reads.append(r[:L])
    reads = np.stack(reads)
    reads[0] = genome[starts[0]:starts[0] + L]
    comp = np.array([3, 2, 1, 0, 4], np.uint8)  # G=0, A=1, T=2, C=3, N=4
    codes = np.ascontiguousarray(np.concatenate([reads,
                                                 comp[reads][:, ::-1]]))
    # window 2 starts 3 bases into read 0
    w_start = [0, 700, int(starts[0]) + 3, genome_len - 600]
    w_len = [500, 750, 40, 600]
    seqs = [genome[a:a + b] for a, b in zip(w_start, w_len)]
    base = np.concatenate([[0], np.cumsum(w_len)[:-1]])
    seq_idx = rng.integers(0, len(seqs), n)
    glen = np.array(w_len)[seq_idx]
    r0 = rng.integers(0, L - 15 + 1, n)
    g0 = rng.integers(0, np.maximum(glen - 15 + 1, 1))
    row = rng.integers(0, 2 * n_reads, n)
    for i in range(0, n, 3):
        rid = int(rng.integers(0, n_reads))
        p = int(starts[rid]) - w_start[seq_idx[i]]
        if 0 <= p and p + L <= glen[i]:
            row[i], r0[i] = rid, int(rng.integers(0, L - 15 + 1))
            g0[i] = p + r0[i]
    g0[rng.permutation(n)[:300]] = 0
    # read 0's seeds at genome position 0 of window 2: ok iff r0 < 6
    at0 = rng.permutation(n)[:40]
    seq_idx[at0], glen[at0], row[at0], g0[at0] = 2, w_len[2], 0, 0
    r0[at0] = 3 + 4 * (np.arange(40) % 2)
    meta = tuple(x.astype(np.int32) for x in (base[seq_idx], glen, g0, r0,
                                               row))
    return codes, seqs, seq_idx, meta


def test_wrappers_take_plain_version_on_cpu_and_check_inputs():
    read, gwin, rlen, glen = (torch.from_numpy(x) for x in
                              random_band_inputs(2, 300, 16))
    assert torch.equal(swar_cost(read, gwin, rlen, glen),
                       swar_cost_ref(read, gwin, rlen, glen))
    for got, want in zip(swar_cost_accept(read, gwin, rlen, glen),
                         swar_cost_accept_ref(read, gwin, rlen, glen)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        swar_cost(read.to(torch.int32), gwin, rlen, glen)
    with pytest.raises(ValueError):
        swar_cost_accept(read, gwin[:-1], rlen, glen)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["swar_cost", "swar_cost_accept"])
def test_kernel_matches_plain_version_on_card(kernel):
    """K1/K2 on the card against their plain versions on the same
    inputs, at the main path's shape (n = 131072, rmax = 96)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    args = tuple(torch.from_numpy(x).cuda() for x in
                 random_band_inputs(3, 131072, 96))
    if kernel == "swar_cost":
        assert torch.equal(swar_cost(*args), swar_cost_ref(*args))
        return
    c, a = swar_cost_accept(*args)
    c_ref, a_ref = swar_cost_accept_ref(*args)
    assert torch.equal(c, c_ref)
    m = c_ref <= 6
    assert torch.equal(a[m], a_ref[m])


@pytest.mark.cuda
def test_exact_kernel_matches_plain_version_on_card():
    """dp_rows_exact (K3/K4a/K4b) on the card against its plain version
    at the main path's shape: c and a equal everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    args = tuple(torch.from_numpy(x).cuda() for x in
                 random_band_inputs(5, 131072, 96))
    c, a = dp_rows_exact(*args)
    c_ref, a_ref = dp_rows_exact_ref(*args)
    assert int((c_ref > 7).sum()) > 1000
    assert torch.equal(c, c_ref)
    assert torch.equal(a, a_ref)


def uniform_args(codes, seqs, meta, device="cpu"):
    """extend_exact's arguments for a uniform read set: every row of
    ``codes`` at its full length."""
    lens = np.full(len(codes), codes.shape[1], np.int32)
    return [torch.from_numpy(x).to(device) for x in
            (codes, lens, np.concatenate(seqs), *meta)]


@pytest.mark.cuda
def test_fused_extension_matches_plain_version_on_card():
    """The rescore's extension (the exact entry on a uniform resident read
    set, L = 100) on the card against its plain version: ok, errs and
    begin equal everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    codes, seqs, _idx, meta = fused_world(12, 20000, L=100,
                                          genome_len=6000, n_reads=600)
    args = uniform_args(codes, seqs, meta, "cuda")
    want = extend_exact_ref(*args, 100 - 15)
    assert 100 < int(want[0].sum()) < len(meta[0])
    got = extend_exact(*args, 100 - 15)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_wrapper_checks_inputs():
    """The resident exact entry's wrapper (the rescore's) takes the plain
    version for CPU tensors and refuses a wrong dtype, shape or
    layout."""
    codes, seqs, _idx, meta = fused_world(3, 50)
    args = uniform_args(codes, seqs, meta)
    for g, w in zip(extend_exact(*args, 25), extend_exact_ref(*args, 25)):
        assert torch.equal(g, w)
    for i, bad_arg in ((3, args[3].to(torch.int64)), (0, args[0][:, ::2]),
                       (1, args[1][:-1])):
        bad = list(args)
        bad[i] = bad_arg
        with pytest.raises(ValueError):
            extend_exact(*bad, 25)


def test_swar_prototype_tool_on_cpu(capsys):
    """The K6 tool's inputs are the prototype's (and phase 1's), and on
    CPU tensors it runs the plain versions to the same check."""
    read, gwin, rlen, glen = swar_kernel_proto.prototype_inputs(
        2048, 32, "cpu")
    for got, want in zip((read, gwin, rlen, glen),
                         random_band_inputs(0, 2048, 32)):
        assert np.array_equal(got.numpy(), want)
    assert swar_kernel_proto.main(["--device", "cpu", "--n", "2048",
                                   "--rmax", "32", "--reps", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mismatches"] == 0 and res["n"] == 2048


@pytest.mark.cuda
def test_swar_prototype_tool_on_card():
    """K6's counterpart: K1 against min(dp_rows_exact, 7) on the card at
    the prototype's inputs (n = 131072, rmax = 96)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    res = swar_kernel_proto.run("cuda", reps=3)
    assert res["mismatches"] == 0 and res["ms"] > 0


def resident_jobs(seed, n_reads=10, c=64, seq_len=700):
    """Random jobs over a read set: (read_seqs, seq, rid, strand, rlens,
    centers, gstarts, glens), as test_resident_staging_bit_equal_dense."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, seq_len).astype(np.uint8)
    read_seqs = [rng.integers(0, 5, rng.integers(60, 200)).astype(np.uint8)
                 for _ in range(n_reads)]
    rid = rng.integers(0, n_reads, c).astype(np.int32)
    strand = rng.integers(0, 2, c).astype(np.uint8)
    rlens = np.array([len(read_seqs[r]) for r in rid], np.int32)
    rmax = 256
    centers = np.zeros((c, rmax + 1), np.int32)
    for i in range(c):
        steps = rng.integers(0, 3, rmax)
        centers[i] = np.clip(int(rng.integers(0, 300))
                             + np.concatenate([[0], np.cumsum(steps)]),
                             0, seq_len)
    gstarts = rng.integers(0, 50, c).astype(np.int32)
    glens = np.minimum(seq_len - gstarts,
                       rng.integers(300, 650, c)).astype(np.int32)
    return read_seqs, seq, rid, strand, rlens, centers, gstarts, glens


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128])
def test_banded_forward_matches_plain_version_on_card(width):
    """K5 on the card against its plain version on the same inputs; both
    float32 with different exp/log1p and scan order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    (read_seqs, seq, rid, strand, rlens, centers, gstarts,
     glens) = resident_jobs(6, n_reads=40, c=300, seq_len=2000)
    eng = ForwardDeviceEngine(read_seqs, "cuda")
    row = torch.from_numpy((rid + strand.astype(np.int32) * len(read_seqs))
                           .astype(np.int32)).cuda()
    args = [eng.rows, row] + [
        torch.from_numpy(np.ascontiguousarray(x)).cuda()
        for x in (seq, guide_steps(centers), centers[:, 0].astype(np.int32),
                  gstarts, glens, rlens)]
    lm, lmm = float(np.log(0.85)), float(np.log(0.0375))
    got = forward_cuda.banded_forward(*args, lm, lmm, width)
    want = forward_cuda.banded_forward_ref(*args, lm, lmm, width)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-4 * want.abs() + 1e-3).all()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128])
def test_banded_forward_adversarial_on_card(width):
    """K5 on the adversarial batch (guides 20-45 columns off the true
    path, targets ending mid-read or starting beyond the band, empty jobs)
    against the plain version in float64 and against the twin of its
    arithmetic."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gaml_tpu_torch.tools.forward_bench import (adversarial_batch,
                                                    to_device,
                                                    within_tolerance)

    args = to_device(adversarial_batch(3, n_jobs=18), "cuda")
    lm, lmm = float(np.log(0.85)), float(np.log(0.0375))
    got = forward_cuda.banded_forward(*args, lm, lmm, width)
    for kw in ({"dtype": torch.float64}, {"scaled": True}):
        want = forward_cuda.banded_forward_ref(*args, lm, lmm, width, **kw)
        assert within_tolerance(got, want)[0] == 0


@pytest.mark.cuda
def test_exact_extension_matches_plain_version_on_card():
    """The exact two-direction extension on the card against its plain
    versions on a ragged batch (the fused world's reads cut to 60-100 bp,
    20000 candidates): the resident loader (extend_exact) and the staged
    loader (extend_exact_staged on a padded staged dict of the same
    candidates); ok, errs and begin equal everywhere, and the two loaders
    equal to each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gaml_tpu_torch.ops.extend import stage_candidates
    from gaml_tpu_torch.ops.extend_cuda import (extend_exact,
                                                extend_exact_ref,
                                                extend_exact_staged,
                                                extend_exact_staged_ref)

    codes, seqs, seq_idx, meta = fused_world(12, 20000, L=100,
                                             genome_len=6000, n_reads=600)
    lens = np.random.default_rng(5).integers(60, 101, len(codes))
    codes[np.arange(100) >= lens[:, None]] = SENT_READ
    base, glen, g0, r0, row = meta
    r0 = np.minimum(r0, lens[row] - 15).astype(np.int32)
    args = [torch.from_numpy(x).cuda() for x in (
        codes, lens.astype(np.int32), np.concatenate(seqs), base, glen, g0,
        r0, row)]
    want = extend_exact_ref(*args, 85)
    assert 100 < int(want[0].sum()) < len(g0)
    got = extend_exact(*args, 85)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    st = stage_candidates(seqs, g0, r0, [codes[i, :lens[i]] for i in row],
                          rmax=96, nb=len(g0) + 100, seq_idx=seq_idx,
                          device="cuda")
    got_s = extend_exact_staged(st)
    for g, w, r in zip(got_s, extend_exact_staged_ref(st), got):
        assert torch.equal(g, w) and torch.equal(g[:len(g0)], r)


def test_ragged_draw_inputs_on_cpu():
    """chip_smoke.py's ragged draw (reads of 60-100 bp, half the
    candidates at a read's true place) and its staged dict of the same
    candidates: the plain versions of the two loaders agree everywhere,
    and the draw has both outcomes and every read length."""
    import importlib.util

    from gaml_tpu_torch.ops.extend_cuda import extend_exact_staged

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    args, rmax = cs.ragged_draw(1500, "cpu", n_reads=400, genome_len=20000)
    st = cs.staged_from_resident(args, 96)
    assert st["read_f"].shape == (1500, 96) and rmax == 85
    lens = args[1]
    assert int(lens.min()) == 60 and int(lens.max()) == 100
    got = extend_exact(*args, rmax)
    for g, s in zip(got, extend_exact_staged(st)):
        assert torch.equal(g, s)
    assert 400 < int(got[0].sum()) < 1100


def random_bucket(seed, rows=4096, k=64, n_reads=1500):
    """A paired bucket in stage_paired_rows' layout: random positions,
    edit distances and orientations (about a third of the slots empty),
    innie-near mates so that some pairs qualify, each row of its own walk
    (a read id repeats), none split, 30 padding rows."""
    rng = np.random.default_rng(seed)
    pos1 = rng.integers(0, 4000, (rows, k)).astype(np.int32)
    pos2 = (pos1 + rng.normal(180, 40, (rows, k))).astype(np.int32)
    pos1[rng.random((rows, k)) < 0.3] = -1
    pos2[rng.random((rows, k)) < 0.3] = -1
    mask = np.arange(rows) < rows - 30
    pos1[~mask] = pos2[~mask] = -1
    b = {"pos1": pos1, "pos2": pos2,
         "ed1": rng.integers(0, 4, (rows, k)).astype(np.int32),
         "ed2": rng.integers(0, 4, (rows, k)).astype(np.int32),
         "or1": rng.integers(0, 2, (rows, k)).astype(np.int32),
         "or2": rng.integers(0, 2, (rows, k)).astype(np.int32),
         "rid": np.where(mask, rng.integers(0, n_reads, rows), 0
                         ).astype(np.int32),
         "walk": np.where(mask, np.arange(rows), -1).astype(np.int32),
         "len1": np.full(rows, 100, np.int32) * mask,
         "len2": np.full(rows, 100, np.int32) * mask, "mask": mask,
         "off1": np.zeros(rows, np.int32), "off2": np.zeros(rows, np.int32),
         "n2": np.full(rows, k, np.int32) * mask}
    return b, n_reads


@pytest.mark.cuda
def test_paired_bucket_products_match_cpu_on_card():
    """The paired device scorer's bucket products on the card against its
    CPU run on the same bucket: per-read totals and flags equal bit for
    bit (table lookups, products and adds in one order); bucket_apply
    adds the same totals, identically in two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gaml_tpu_torch.parallel.paired_sharded import ShardedPairedScorer

    b, n = random_bucket(4)
    exps = np.arange(107, dtype=np.float64)
    args = (0.96 ** exps, 0.01 ** exps, 0.96 ** exps, 0.01 ** exps, 180.0,
            20.0)
    out = {}
    for dev in ("cpu", "cuda"):
        sc = ShardedPairedScorer(*args, device=dev)
        dense, flags = sc.bucket_products(b, n, -0.7, -10.0)
        runs = []
        for _ in range(2):
            probs = torch.zeros(n, dtype=torch.float64, device=dev)
            sc.bucket_apply(probs, 1.0, b, -0.7, -10.0)
            runs.append(probs.cpu())
        assert torch.equal(runs[0], runs[1])
        assert torch.equal(runs[0], dense.cpu())
        out[dev] = (dense.cpu(), flags.cpu())
    (d_cpu, f_cpu), (d_gpu, f_gpu) = out["cpu"], out["cuda"]
    assert int(f_cpu.bool().sum()) > 100 and int((d_cpu > 0).sum()) > 100
    assert torch.equal(d_gpu, d_cpu)
    assert torch.equal(f_gpu, f_cpu)


@pytest.mark.cuda
def test_device_scoring_state_matches_cpu_on_card():
    """DeviceScoringState on the card against its CPU run on random signed
    chunks: the running totals equal bit for bit (the fixed-order adds),
    the reduction within 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gaml_tpu_torch.parallel.device_state import DeviceScoringState

    rng = np.random.default_rng(2)
    n = 150_000
    lens = np.full(n, 200)
    states = [DeviceScoringState(n, lens, device=d) for d in ("cpu", "cuda")]
    for step in range(8):
        k = int(rng.integers(1000, 40000))
        rids = rng.integers(0, n, k).astype(np.int32)
        ps = rng.random(k) * 10.0 ** rng.integers(-60, -20, k)
        for st in states:
            st.apply(rids, ps, 1 if step % 3 != 2 else -1)
        assert np.array_equal(states[0].to_host(), states[1].to_host())
        (s0, z0), (s1, z1) = (st.reduce(2_800_000, -0.7, -10.0)
                              for st in states)
        assert z0 == z1 and s1 == pytest.approx(s0, rel=1e-12)


@pytest.mark.cuda
def test_pacbio_dispatch_on_card():
    """A read set with forward_dispatch set (enable_sharded_pacbio) on a
    small batch: one K5 launch on its resident engine whatever the cell
    count, cells under "mesh", within K5's bound of the plain version
    (the same read set on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    (read_seqs, seq, rid, strand, rlens, centers, gstarts,
     glens) = resident_jobs(7, n_reads=40, c=300, seq_len=2000)
    # a job's centers are in its target's frame
    jobs = [(np.full(n, 6, np.uint8), c - gs, r, st)
            for n, c, r, st, gs in zip(rlens, centers, rid, strand, gstarts)]
    extents = list(zip(gstarts, glens))
    out = {}
    for dev in ("cpu", "cuda"):
        rs = PacbioReadSet("x", "x.fq", 0.85, 0.0375, device=dev)
        rs._fwd_engine = ForwardDeviceEngine(read_seqs, dev)
        rs.forward_dispatch = True
        n0 = LAUNCHES["banded_forward"]
        out[dev] = np.asarray(rs._forward_batch(seq, jobs, extents))
        assert LAUNCHES["banded_forward"] - n0 == (dev == "cuda")
        assert set(rs.dp_cells) == {"mesh"}
    got, want = out["cuda"], out["cpu"]
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-3).all()


@pytest.mark.cuda
def test_distributed_dryrun_on_card():
    """The read-sharded scorers (gaml_tpu_torch.tools.dryrun_distributed)
    with two ranks over gloo on one card against one rank over NCCL:
    every merged result equal but the single-end score (index_add_'s
    float64 atomics: rel 1e-12), each rank launching K4a (the staged
    exact extension) and K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gaml_tpu_torch.tools import dryrun_distributed as dryrun

    two = dryrun.launch(2, backend="gloo", device="cuda:0")
    one = dryrun.launch(1, backend="nccl", device="cuda")
    skip = dryrun.LOCAL_KEYS + ("world", "backend", "partials",
                                "single_end")
    merged = [{k: v for k, v in r[0].items() if k not in skip}
              for r in (one, two)]
    assert merged[0] == merged[1]
    (s1, z1), (s2, z2) = one[0]["single_end"], two[0]["single_end"]
    assert z1 == z2 and s2 == pytest.approx(s1, rel=1e-12)
    for rep in two + one:
        assert rep["launches"]["extend_exact_staged"] > 0
        assert rep["launches"]["banded_forward"] > 0

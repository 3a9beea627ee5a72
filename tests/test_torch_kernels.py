"""Kernels of the port: K1/K2 and the exact K3/K4 kernel
(gaml_tpu_torch.ops.extend_cuda), the wrappers' CPU route and input
checks, the K6 tool (gaml_tpu_torch.tools.swar_kernel_proto), and on a
CUDA card K1, K2, dp_rows_exact, the K6 tool and K5
(gaml_tpu_torch.ops.forward_cuda) against their plain versions.  Imports
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
                                            dp_rows_exact_ref, extend_fused,
                                            extend_fused_ref, swar_cost,
                                            swar_cost_accept,
                                            swar_cost_accept_ref,
                                            swar_cost_ref)
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine, guide_steps
from gaml_tpu_torch.tools import swar_kernel_proto


def port_native_lib():
    """The port's native library (built once, under its lock).  The JAX
    package's bindings, where a test loads them, are pointed at the same
    file (the same source), so tests that hold one against the other
    never race on the JAX package's in-place build."""
    from gaml_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    import gaml_tpu.native as jax_native

    with jax_native._lock:
        if jax_native._lib is None:
            so = native.library_path()
            os.utime(so)  # newer than the JAX package's copy of the source
            jax_native._SO = so
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
    """A resident read set and a window batch for the fused extension:
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


@pytest.mark.cuda
def test_fused_extension_matches_plain_version_on_card():
    """The fused extension on the card against its plain version on a
    resident world at the rescore's read length (L = 100): ok everywhere,
    errs and begin wherever ok (the kernel is exact everywhere, so all
    three are held everywhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    codes, seqs, _idx, meta = fused_world(12, 20000, L=100,
                                          genome_len=6000, n_reads=600)
    args = [torch.from_numpy(codes).cuda(),
            torch.from_numpy(np.concatenate(seqs)).cuda()]
    args += [torch.from_numpy(x).cuda() for x in meta]
    want = extend_fused_ref(*args, 100 - 15)
    assert 100 < int(want[0].sum()) < len(meta[0])
    got = extend_fused(*args, 100 - 15)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_wrapper_checks_inputs():
    codes, seqs, _idx, meta = fused_world(3, 50)
    args = [torch.from_numpy(codes), torch.from_numpy(np.concatenate(seqs))]
    args += [torch.from_numpy(x) for x in meta]
    for g, w in zip(extend_fused(*args, 25), extend_fused_ref(*args, 25)):
        assert torch.equal(g, w)
    bad = list(args)
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(ValueError):
        extend_fused(*bad, 25)
    bad = list(args)
    bad[0] = bad[0][:, ::2]
    with pytest.raises(ValueError):
        extend_fused(*bad, 25)


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

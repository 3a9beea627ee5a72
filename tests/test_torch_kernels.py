"""Kernels of the port: K1/K2 and the exact K3/K4 kernel
(gaml_tpu_torch.ops.extend_cuda), the wrappers' CPU route and input
checks, the K6 tool (gaml_tpu_torch.tools.swar_kernel_proto), and on a
CUDA card K1, K2, dp_rows_exact, the K6 tool and K5
(gaml_tpu_torch.ops.forward_cuda) against their plain versions.  Imports
no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import json

import numpy as np
import pytest
import torch

from gaml_tpu_torch.ops import forward_cuda
from gaml_tpu_torch.ops.extend import PAD, SENT_GEN, SENT_READ
from gaml_tpu_torch.ops.extend_cuda import (dp_rows_exact,
                                            dp_rows_exact_ref, swar_cost,
                                            swar_cost_accept,
                                            swar_cost_accept_ref,
                                            swar_cost_ref)
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine, guide_steps
from gaml_tpu_torch.tools import swar_kernel_proto


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

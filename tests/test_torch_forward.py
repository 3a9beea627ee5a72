"""Kernel K5 of the port: the plain torch version
(gaml_tpu_torch.ops.forward.banded_forward) against the JAX function, the
Pallas kernel in interpret mode and the float64 oracle; the wrapper's CPU
route and input checks; and the engine's resident and dense staging.  The
card test of K5 is in test_torch_kernels.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaml_tpu.core import dna
from gaml_tpu.ops.forward import banded_forward as jax_banded_forward
from gaml_tpu.ops.forward import forward_full_numpy
from gaml_tpu.ops.forward_pallas import banded_forward_pallas
from gaml_tpu_torch.ops import forward_cuda
from gaml_tpu_torch.ops.forward import banded_forward
from gaml_tpu_torch.ops.forward_cuda import banded_forward_ref
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine, guide_steps

from fixtures import random_seq
from test_forward_kernel import MATCH, MISMATCH, noisy_copy
from test_forward_pallas import make_batch
from test_torch_kernels import resident_jobs

LM, LMM = float(np.log(MATCH)), float(np.log(MISMATCH))


def targets(rng, b, glen, cut):
    """gstarts/glens: the whole buffer, or random sub-targets."""
    if not cut:
        return np.zeros(b, np.int32), np.full(b, glen, np.int32)
    gst = rng.integers(0, 60, b).astype(np.int32)
    return gst, (glen - gst - rng.integers(0, 120, b)).astype(np.int32)


def port(genome, reads, rlens, centers, gst, gl, width, rmax=None,
         dtype=torch.float32):
    rmax = reads.shape[1] if rmax is None else rmax
    return banded_forward(*(torch.from_numpy(np.ascontiguousarray(x))
                            for x in (genome, reads, rlens, centers, gst,
                                      gl)),
                          LM, LMM, rmax, width, dtype=dtype).numpy()


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("seed,cut", [(0, False), (1, True), (2, True)])
def test_plain_matches_jax_banded_forward(seed, cut, width):
    """Both float32; only the scan order differs."""
    rng = np.random.default_rng(seed)
    genome, reads, rlens, centers = make_batch(rng)
    gst, gl = targets(rng, len(rlens), len(genome), cut)
    rmax = reads.shape[1]
    want = np.asarray(jax_banded_forward(
        *(jnp.asarray(x) for x in (genome, reads, rlens, centers, gst, gl)),
        LM, LMM, rmax, width))
    got = port(genome, reads, rlens, centers, gst, gl, width)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_plain_matches_pallas_kernel_interpret():
    """The Pallas kernel truncates the gap chain at 15 gaps, so the bound
    is test_forward_pallas's."""
    rng = np.random.default_rng(1)
    genome, reads, rlens, centers = make_batch(rng)
    gst, gl = targets(rng, len(rlens), len(genome), False)
    rmax = reads.shape[1]
    want = banded_forward_pallas(genome, reads, rlens, centers, gst, gl,
                                 LM, LMM, rmax, interpret=True)
    got = port(genome, reads, rlens, centers, gst, gl, 128)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("seed,glen,start,stop,noisy", [
    (0, 40, 5, 30, False), (1, 60, 10, 50, True)])
def test_plain_float64_matches_full_oracle(seed, glen, start, stop, noisy):
    """A band as wide as the genome holds all of the unbanded mass."""
    rng = np.random.default_rng(seed)
    genome = dna.encode_seq(random_seq(rng, glen))
    read = genome[start:stop].copy()
    if noisy:
        read = noisy_copy(rng, read)
    centers = (np.arange(len(read) + 1) + start).astype(np.int32)[None]
    got = port(genome, read[None], np.array([len(read)], np.int32), centers,
               np.zeros(1, np.int32), np.array([glen], np.int32), 128,
               dtype=torch.float64)
    want = forward_full_numpy(genome, read, MATCH, MISMATCH)
    assert got.dtype == np.float64
    assert got[0] == pytest.approx(want, rel=1e-4)


def kernel_inputs(genome, reads, rlens, centers, gst, gl):
    """The wrapper's inputs for a dense batch (row = job)."""
    b = len(rlens)
    t = torch.from_numpy
    return (t(np.ascontiguousarray(reads)), torch.arange(b, dtype=torch.int32),
            t(genome), t(guide_steps(centers)),
            t(centers[:, 0].astype(np.int32)), t(gst), t(gl),
            t(rlens.astype(np.int32)))


def test_wrapper_cpu_route_is_plain_version_and_checks_inputs():
    rng = np.random.default_rng(4)
    genome, reads, rlens, centers = make_batch(rng)
    gst, gl = targets(rng, len(rlens), len(genome), True)
    args = kernel_inputs(genome, reads, rlens, centers, gst, gl)
    before = forward_cuda.LAUNCHES["banded_forward"]
    got = forward_cuda.banded_forward(*args, LM, LMM, 64)
    assert torch.equal(got, banded_forward_ref(*args, LM, LMM, 64))
    assert forward_cuda.LAUNCHES["banded_forward"] == before
    np.testing.assert_allclose(
        got.numpy(), port(genome, reads, rlens, centers, gst, gl, 64),
        rtol=0, atol=0)
    bad = list(args)
    bad[3] = args[3].to(torch.int32)
    with pytest.raises(ValueError):
        forward_cuda.banded_forward(*bad, LM, LMM, 64)
    bad = list(args)
    bad[1] = args[1][:-1]
    with pytest.raises(ValueError):
        forward_cuda.banded_forward(*bad, LM, LMM, 64)
    bad = list(args)
    bad[0] = args[0].t()
    with pytest.raises(ValueError):
        forward_cuda.banded_forward(*bad, LM, LMM, 64)


@pytest.mark.parametrize("width", [64, 128])
def test_padded_dummy_jobs_leave_live_outputs_unchanged(width):
    """Dummy jobs (rlen 0, glen 0, centers 0, reads 6) appended to a
    batch: live outputs are bit-equal and finite, dummies are NEG."""
    rng = np.random.default_rng(5)
    genome, reads, rlens, centers = make_batch(rng)
    b, rmax = reads.shape
    gst, gl = targets(rng, b, len(genome), False)
    base = forward_cuda.banded_forward(
        *kernel_inputs(genome, reads, rlens, centers, gst, gl), LM, LMM,
        width)
    pad = 4
    got = forward_cuda.banded_forward(*kernel_inputs(
        genome, np.concatenate([reads, np.full((pad, rmax), 6, np.uint8)]),
        np.concatenate([rlens, np.zeros(pad, np.int32)]),
        np.concatenate([centers, np.zeros((pad, rmax + 1), np.int32)]),
        np.concatenate([gst, np.zeros(pad, np.int32)]),
        np.concatenate([gl, np.zeros(pad, np.int32)])), LM, LMM, width)
    assert torch.isfinite(got[:b]).all()
    assert torch.equal(got[:b], base)
    assert (got[b:] <= -1e29).all()


@pytest.mark.parametrize("width", [64, 128])
def test_resident_staging_bit_equal_dense(width):
    """The engine's resident rows (forward and reverse complement, named
    by rid and strand) feed the kernel what dense per-batch rows do."""
    (read_seqs, seq, rid, strand, rlens, centers, gstarts,
     glens) = resident_jobs(3)
    eng = ForwardDeviceEngine(read_seqs, "cpu")
    dense = np.full((len(rid), centers.shape[1] - 1), 6, np.uint8)
    for i in range(len(rid)):
        q = read_seqs[rid[i]] if strand[i] == 0 else \
            dna.revcomp(read_seqs[rid[i]])
        dense[i, :len(q)] = q
    args = (seq, guide_steps(centers), centers[:, 0], gstarts, glens, rlens,
            LM, LMM, width)
    got = eng.forward(*args, rid=rid, strand=strand)
    want = ForwardDeviceEngine(None, "cpu").forward(*args, reads=dense)
    assert np.array_equal(got, want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, port(seq, dense, rlens, centers, gstarts, glens, width),
        rtol=1e-6)

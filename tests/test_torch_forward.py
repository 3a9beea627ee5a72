"""Kernel K5 of the port: the plain torch version
(gaml_tpu_torch.ops.forward.banded_forward) against the JAX function, the
Pallas kernel in interpret mode and the float64 oracle; the CPU twin of
the kernel's scaled linear-space arithmetic (banded_forward_scaled)
against the float64 forms and the JAX function, on the test worlds and on
an adversarial batch; the wrapper's CPU route and input checks; and the
engine's resident and dense staging.  The card test of K5 is in
test_torch_kernels.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaml_tpu.core import dna
from gaml_tpu.ops.forward import banded_forward as jax_banded_forward
from gaml_tpu.ops.forward import forward_full_numpy
from gaml_tpu.ops.forward_pallas import banded_forward_pallas
from gaml_tpu_torch.ops import forward_cuda
from gaml_tpu_torch.ops.forward import banded_forward, banded_forward_scaled
from gaml_tpu_torch.ops.forward_cuda import banded_forward_ref
from gaml_tpu_torch.ops.forward_device import ForwardDeviceEngine, guide_steps
from gaml_tpu_torch.tools.forward_bench import (ADVERSARIAL_KINDS,
                                                adversarial_batch,
                                                dense_layout)
from gaml_tpu_torch.utils.metrics import LAUNCHES

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


# the kernel's tolerance: |scaled - want| <= 1e-4 |want| + 1e-3
SCALED_TOL = dict(rtol=1e-4, atol=1e-3)


def scaled(genome, reads, rlens, centers, gst, gl, width):
    return banded_forward_scaled(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (genome, reads, rlens, centers, gst, gl)),
        LM, LMM, reads.shape[1], width).numpy()


def jax_forward(genome, reads, rlens, centers, gst, gl, width):
    return np.asarray(jax_banded_forward(
        *(jnp.asarray(x) for x in (genome, reads, rlens, centers, gst, gl)),
        LM, LMM, reads.shape[1], width))


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("seed,cut", [(0, False), (1, True), (2, True)])
def test_scaled_matches_float64_and_jax(seed, cut, width):
    """The twin of the kernel's arithmetic (float64 probabilities, one
    binary exponent per job) against the exact band in float64 and the
    JAX function, on the make_batch worlds."""
    rng = np.random.default_rng(seed)
    world = make_batch(rng)
    world = world + targets(rng, len(world[2]), len(world[0]), cut)
    got = scaled(*world, width)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, port(*world, width, dtype=torch.float64), **SCALED_TOL)
    np.testing.assert_allclose(got, jax_forward(*world, width), **SCALED_TOL)


@pytest.mark.parametrize("width,glen,start,stop,noisy", [
    (64, 24, 4, 20, False), (64, 28, 3, 25, True),
    (128, 40, 5, 30, False), (128, 60, 10, 50, True)])
def test_scaled_matches_full_oracle(width, glen, start, stop, noisy):
    """A band as wide as the genome: the twin against the unbanded
    float64 oracle."""
    rng = np.random.default_rng(glen)
    genome = dna.encode_seq(random_seq(rng, glen))
    read = genome[start:stop].copy()
    if noisy:
        read = noisy_copy(rng, read)
    centers = (np.arange(len(read) + 1) + start).astype(np.int32)[None]
    got = scaled(genome, read[None], np.array([len(read)], np.int32),
                 centers, np.zeros(1, np.int32), np.array([glen], np.int32),
                 width)
    want = forward_full_numpy(genome, read, MATCH, MISMATCH)
    np.testing.assert_allclose(got, [want], **SCALED_TOL)


@pytest.mark.parametrize("width", [64, 128])
def test_scaled_adversarial_batch(width):
    """Where scaled linear space could part from log space: the true path
    20-45 columns off the guide (beyond a 64-lane band's half), a guide
    stuck at the buffer's start while the true path runs on (lanes
    hundreds of nats below the band's max that later carry the
    alignment: float32 loses them, float64 keeps them), a target that
    ends mid-read or starts beyond the band, empty targets and rows,
    reads of 2-5 kb at 15 % errors.  The twin runs through the wrapper's
    plain route (kernel layout) and is held against the exact band in
    float64 and the JAX function."""
    batch = adversarial_batch(seed=3)
    args = tuple(torch.from_numpy(x) for x in batch)
    got = banded_forward_ref(*args, LM, LMM, width, scaled=True).numpy()
    want = banded_forward_ref(*args, LM, LMM, width,
                              dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, **SCALED_TOL)
    np.testing.assert_allclose(got, jax_forward(*dense_layout(batch), width),
                               **SCALED_TOL)
    empty = np.isin(np.array(ADVERSARIAL_KINDS),
                    ("target_mid", "target_beyond", "glen0", "rlen0"))
    assert (got[empty] <= -1e29).all()
    assert np.isfinite(got[~empty]).all() and (got[~empty] > -1e29).all()
    assert (batch[7][~empty] >= 2000).all()


@pytest.mark.parametrize("width", [64, 128])
def test_scaled_float32_misses_stuck_guide(width):
    """Why the kernel computes in float64: on the adversarial batch's
    stuck-guide job the lanes that later carry the alignment lie more
    than float32's 103 nats (2^-149) below the band's max, so the twin's
    arithmetic in float32 misses the float64 band by more than the
    tolerance, and in float64 stays within it."""
    k = ADVERSARIAL_KINDS.index("stuck")
    reads, _row, seq, steps, c0, gst, gl, rl = (
        torch.from_numpy(x) for x in adversarial_batch(seed=3))
    job = slice(k, k + 1)
    args = (reads[job], torch.zeros(1, dtype=torch.int32), seq, steps[job],
            c0[job], gst[job], gl[job], rl[job], LM, LMM, width)
    want = banded_forward_ref(*args, dtype=torch.float64).numpy()
    assert np.isfinite(want).all() and (want > -1e29).all()
    got = banded_forward_ref(*args, scaled=True).numpy()
    np.testing.assert_allclose(got, want, **SCALED_TOL)
    f32 = banded_forward_ref(*args, scaled=True, dtype=torch.float32)
    miss = np.abs(f32.double().numpy() - want)
    assert (miss > SCALED_TOL["rtol"] * np.abs(want)
            + SCALED_TOL["atol"]).all()


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
    before = LAUNCHES["banded_forward"]
    got = forward_cuda.banded_forward(*args, LM, LMM, 64)
    # the kernel's precision: float64, the result rounded to float32
    assert got.dtype == torch.float32
    assert torch.equal(got, banded_forward_ref(
        *args, LM, LMM, 64, dtype=torch.float64).float())
    assert LAUNCHES["banded_forward"] == before
    np.testing.assert_allclose(
        got.numpy(), port(genome, reads, rlens, centers, gst, gl, 64,
                          dtype=torch.float64).astype(np.float32),
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
        got, port(seq, dense, rlens, centers, gstarts, glens, width,
                  dtype=torch.float64), rtol=1e-6)

"""k independent assemblies in one port rescore
(gaml_tpu_torch.ops.rescore_device.DeviceRescorer.rescore(seg_job=,
n_jobs=), CPU tensors) against the JAX DeviceRescorer with the same
seg_job and against k single port rescores, and past 2^11 segments,
where the JAX package's int32 (segment << 20 | read) key overflows
(ROADMAP C2; the port only)."""
import numpy as np
import pytest

from gaml_tpu.ops.rescore_device import DeviceRescorer as JaxRescorer
from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

from test_candgen_device import make_bundle, sample_world
from test_rescore_device import MATCH, MISMATCH, MPB, MPS
from test_torch_kernels import port_native_lib

ARGS = dict(log_match=MATCH, log_mismatch=MISMATCH, min_prob_per_base=MPB,
            min_prob_start=MPS)


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def singles(port, jobs, cap):
    """(score, zero_reads) of each job's windows in its own rescore."""
    out = []
    for w in jobs:
        s, z, n = port.rescore(list(w), cap, total_len=sum(map(len, w)),
                               **ARGS)
        assert n <= cap
        out.append((s, z))
    return out


def batched(port, jobs, cap, staged=False):
    seqs = [x for w in jobs for x in w]
    seg_job = np.repeat(np.arange(len(jobs)), [len(w) for w in jobs])
    return port.rescore(None if staged else seqs, cap,
                        staged=port.stage(seqs) if staged else None,
                        seg_job=seg_job, n_jobs=len(jobs),
                        total_len=[sum(map(len, w)) for w in jobs], **ARGS)


@pytest.mark.parametrize("staged", [False, True])
def test_jobs_match_jax_and_single_rescores(staged):
    """tests/test_rescore_device.py::test_batched_jobs_match_single_
    rescores' world and jobs: within 2e-6 rel of the JAX rescore with the
    same seg_job (float32) and 1e-12 of the port's single rescores, zero
    reads equal; ``stage`` gives the same as passing the windows."""
    genome, reads = sample_world(seed=31, genome_len=2500, n_reads=250)
    bundle = make_bundle(reads)
    port = DeviceRescorer(bundle, device="cpu")
    w1, w2, w3 = genome[:1200], genome[900:2100], genome[1800:]
    jobs = [(w1,), (w2, w3)]
    sb, zb, nb = batched(port, jobs, 8192, staged)
    assert nb <= 8192 and sb.shape == zb.shape == (2,)
    sj, zj, nj = JaxRescorer(bundle).rescore(
        [w1, w2, w3], cap=8192, use_pallas=False,
        seg_job=np.array([0, 1, 1], np.int32), n_jobs=2,
        total_len=[len(w1), len(w2) + len(w3)], **ARGS)
    assert int(nj) == nb
    np.testing.assert_array_equal(zb, np.asarray(zj))
    np.testing.assert_allclose(sb, np.asarray(sj), rtol=2e-6)
    for j, (s, z) in enumerate(singles(port, jobs, 8192)):
        assert zb[j] == z
        assert sb[j] == pytest.approx(s, rel=1e-12)


def test_jobs_past_2_11_segments():
    """2100 windows (JAX's int32 key would wrap past segment 2047) in
    four jobs, the same window in several of them: each job equals its
    single rescore (1e-12 rel, zero reads equal), jobs of equal windows
    score equal, and the cap still reports an overflow."""
    genome, reads = sample_world(seed=5, genome_len=3000, n_reads=300,
                                 read_len=40)
    port = DeviceRescorer(make_bundle(reads), device="cpu")
    rng = np.random.default_rng(8)
    starts = rng.integers(0, len(genome) - 60, 2100)
    wins = [genome[s:s + int(rng.integers(40, 61))] for s in starts]
    jobs = [tuple(wins[:700]), tuple(wins[700:1400]), tuple(wins[1400:]),
            tuple(wins[:700])]
    sb, zb, nb = batched(port, jobs, 1 << 20)
    assert sum(len(w) for w in jobs) > 2048 and nb <= 1 << 20
    for j, (s, z) in enumerate(singles(port, jobs, 1 << 20)):
        assert zb[j] == z
        assert sb[j] == pytest.approx(s, rel=1e-12)
    assert sb[3] == sb[0] and zb[3] == zb[0]
    s, z, n = batched(port, jobs, 16)
    assert s is None and z is None and n == nb

"""Port's fused rescore (gaml_tpu_torch.ops.rescore_device, CPU tensors)
against the JAX DeviceRescorer on the test_rescore_device worlds."""
import numpy as np
import pytest

from gaml_tpu.ops.rescore_device import DeviceRescorer as JaxRescorer
from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

from test_candgen_device import make_bundle, sample_world
from test_rescore_device import MATCH, MISMATCH, MPB, MPS
from test_torch_kernels import port_native_lib


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def single_window():
    genome, reads = sample_world(seed=0)
    return reads, [genome]


def multi_window():
    # overlapping windows: equal (position, read) alignments in two
    # windows are not duplicates of each other
    genome, reads = sample_world(seed=11, genome_len=4000)
    return reads, [genome[:1500], genome[1300:2900], genome[2600:]]


@pytest.mark.parametrize("world", [single_window, multi_window])
def test_rescore_and_extend_match_jax(world):
    reads, seqs = world()
    bundle = make_bundle(reads)
    jax_r = JaxRescorer(bundle)
    port = DeviceRescorer(bundle, device="cpu")
    args = dict(log_match=MATCH, log_mismatch=MISMATCH,
                total_len=sum(len(s) for s in seqs),
                min_prob_per_base=MPB, min_prob_start=MPS)
    s_j, z_j, n_j = jax_r.rescore(seqs, cap=4096, use_pallas=False, **args)
    s_t, z_t, n_t = port.rescore(seqs, cap=4096, **args)
    assert n_t == int(n_j) <= 4096
    assert z_t == int(z_j)
    np.testing.assert_allclose(s_t, float(s_j), rtol=2e-6)

    (ok, errs, begin, rid, orient, seg), n = port.extend(seqs, 4096)()
    (ok_j, errs_j, begin_j, rid_j, orient_j, seg_j), n2 = \
        jax_r.extend(seqs, 4096, use_pallas=False)()
    assert n == n2 == n_t
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(errs[ok], errs_j[ok])
    np.testing.assert_array_equal(begin[ok], begin_j[ok])
    for a, b in ((rid, rid_j), (orient, orient_j), (seg, seg_j)):
        np.testing.assert_array_equal(a, b)


def test_cap_overflow_is_reported():
    genome, reads = sample_world(seed=2, genome_len=2000, n_reads=200)
    port = DeviceRescorer(make_bundle(reads), device="cpu")
    score, zeros, n = port.rescore([genome], cap=16, log_match=MATCH,
                                   log_mismatch=MISMATCH,
                                   total_len=len(genome),
                                   min_prob_per_base=MPB,
                                   min_prob_start=MPS)
    assert score is None and zeros is None and n > 16
    assert port.extend([genome], 16)() == (None, n)

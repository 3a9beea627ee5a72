"""Port's device candidate generation (gaml_tpu_torch.ops.candgen_device,
CPU tensors) against the native C++ window query and the JAX
DeviceCandGen: same candidates in the same emission order."""
import numpy as np
import pytest

from gaml_tpu.native import query_windows_batch
from gaml_tpu.ops.candgen_device import DeviceCandGen as JaxCandGen
from gaml_tpu_torch.ops.candgen_device import DeviceCandGen

from test_candgen_device import make_bundle, sample_world
from test_torch_kernels import port_native_lib


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def world_single():
    genome, reads = sample_world()
    return reads, [genome]


def world_multi_segment():
    genome, reads = sample_world(seed=3, genome_len=5000)
    return reads, [genome[:1200], genome[900:2500], genome[2400:],
                   genome[::-1].copy(), genome[:37]]  # one shorter than L


def world_n_codes():
    genome, reads = sample_world(seed=5, with_n=True)
    return reads, [genome, genome[100:900]]


def world_tandem_repeats():
    rng = np.random.default_rng(9)
    genome = np.tile(rng.integers(0, 4, 90).astype(np.uint8), 30)
    starts = rng.integers(0, len(genome) - 40 + 1, 120)
    reads = np.stack([genome[s:s + 40] for s in starts])
    return reads, [genome, genome[:271]]


def assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("rid", "g0", "r0", "orient"), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"win {i} {name}")


@pytest.mark.parametrize("world", [world_single, world_multi_segment,
                                   world_n_codes, world_tandem_repeats])
def test_matches_native_and_jax(world):
    reads, windows = world()
    bundle = make_bundle(reads)
    got = DeviceCandGen(bundle, "cpu").query_host(windows)
    want = query_windows_batch(bundle, windows)
    assert sum(len(w[0]) for w in want) > 0
    assert_same(got, want)
    assert_same(got, JaxCandGen(bundle).query_host(windows))


def test_many_segments_match_native():
    """More than 2048 windows in one batch: the JAX int32 sort key
    (seg << 20 | rid) overflows there (ROADMAP C2), the port's int64
    key does not."""
    genome, reads = sample_world(seed=4, genome_len=6000, n_reads=600)
    rng = np.random.default_rng(4)
    starts = rng.integers(0, len(genome) - 60, 2100)
    windows = [genome[s:s + int(rng.integers(40, 60))] for s in starts]
    bundle = make_bundle(reads)
    want = query_windows_batch(bundle, windows)
    assert sum(len(w[0]) for w in want[2048:]) > 0
    assert_same(DeviceCandGen(bundle, "cpu").query_host(windows), want)


def test_cap_overflow_reports_count_and_retry_terminates():
    """A cap below the candidate count returns the count and no
    candidates; the retry with cap = count returns the full set (the
    JAX query_host retry never ended on a run-table overflow, C3)."""
    genome, reads = sample_world(seed=7)
    bundle = make_bundle(reads)
    gen = DeviceCandGen(bundle, "cpu")
    c = gen.query([genome], cap=16)
    assert c.overflow and c.n_total > 16
    assert not gen.query([genome], cap=c.n_total).overflow
    assert_same(gen.query_host([genome], cap=16),
                query_windows_batch(bundle, [genome]))

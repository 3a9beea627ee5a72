"""The port's PacBio read set (gaml_tpu_torch.scoring.pacbio, CPU tensors:
the plain version of K5), built from test_pacbio's reads on the port's own
graph: forward batches against the JAX function at the read set's own
band width, walk scores against the native route, the routing and
staging choices, and an anneal-scale quality bound against the native
float64 route."""
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from gaml_tpu.ops.forward import banded_forward as jax_banded_forward
from gaml_tpu_torch.scoring.calculator import ProbCalculator
from gaml_tpu_torch.scoring.pacbio import PacbioReadSet, job_arrays

from fixtures import make_linear_graph
from test_pacbio import PB_MATCH, REPO_TOOLS, make_pb_readset
from test_torch_kernels import port_linear_graph, port_native_lib

WALKS = [[0], [4], [0, 2, 4]]


def needs_native():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


def port_pb_readset(tmp_path, seqs, rng, name, width=64, **kw):
    """test_pacbio.make_pb_readset's reads (``kw``: n_reads, rlen, err)
    in the port's read set on the CPU, anchored on the port's graph of
    ``seqs``.  Returns (graph, read set)."""
    jgr, _ = make_linear_graph(np.random.default_rng(0),
                               [len(s) for s in seqs])
    make_pb_readset(tmp_path, jgr, seqs, rng, name=name, **kw)
    gr = port_linear_graph(seqs)
    rs = PacbioReadSet(str(tmp_path / f"port_{name}"),
                       str(tmp_path / f"{name}.fq"), PB_MATCH, 0.05,
                       forward_width=width, device="cpu")
    rs.preprocess_reads()
    rs.compute_anchors(gr, persist=False)
    return gr, rs


def world(tmp_path, name, width, n_reads=16, seed=21):
    rng = np.random.default_rng(seed)
    _gr, seqs = make_linear_graph(rng, [900, 120, 1200])
    return port_pb_readset(tmp_path, seqs, np.random.default_rng(9), name,
                           width, n_reads=n_reads, rlen=400, err=0.08)


def recorded(rs):
    """Wrap rs._forward_batch to record (seq, jobs, extents, out)."""
    calls = []
    orig = rs._forward_batch

    def rec(seq, jobs, extents=None):
        out = orig(seq, jobs, extents)
        calls.append((seq, jobs, extents, out))
        return out

    rs._forward_batch = rec
    return calls


@pytest.mark.parametrize("width", [64, 128])
def test_forward_batches_match_jax_at_forward_width(tmp_path, monkeypatch,
                                                    width):
    """Every batch, concatenated targets included, runs at the read set's
    forward_width and agrees with the JAX function there (ROADMAP C5)."""
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    gr, rs = world(tmp_path, f"fb{width}", width)
    calls = recorded(rs)
    rs.precompute_ranges_for_paths(gr, WALKS)
    assert calls and any(ext is not None for _s, _j, ext, _o in calls)
    for seq, jobs, extents, out in calls:
        rmax, reads, rlens, centers, gst, gl = job_arrays(
            seq, jobs, extents)
        want = np.asarray(jax_banded_forward(
            *(jnp.asarray(x) for x in (seq, reads, rlens, centers, gst, gl)),
            float(np.log(rs.match_prob)), float(np.log(rs.mismatch_prob)),
            rmax, width))
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-3)
    assert rs.dp_cells.get("torch", 0) > 0
    assert set(rs.dp_cells) == {"torch"}


def test_dense_staging_equals_resident(tmp_path, monkeypatch):
    """Over GAML_PB_RESIDENT_MAX, and for jobs without a read id, rows are
    staged densely into the same kernel: the same outputs, bit for bit."""
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    gr, rs = world(tmp_path, "res", 64)
    prep = rs._slow_prepare(gr, WALKS[0], save_to_cache=False)
    jobs = prep["jobs"]
    assert jobs and all(len(j) == 4 for j in jobs)
    resident = rs._forward_batch(prep["seq"], jobs)
    assert rs._fwd_engine.rows is not None
    no_rid = rs._forward_batch(prep["seq"], [j[:2] for j in jobs])
    monkeypatch.setenv("GAML_PB_RESIDENT_MAX", "0")
    rs._fwd_engine = None
    dense = rs._forward_batch(prep["seq"], jobs)
    assert rs._fwd_engine.rows is None
    assert resident == no_rid == dense
    assert np.isfinite(resident).all()


def test_prewarm_is_noop_and_mesh_dispatch_raises(tmp_path):
    """The port's read set has no prewarm ladder (nothing compiles ahead
    of the anneal) and runs its batches on its own device;
    enable_sharded_pacbio sets its forward_dispatch, so that every batch
    goes to its engine (cells under "mesh"), and nothing raises."""
    gr, rs = world(tmp_path, "pw", 64, n_reads=4)
    assert not hasattr(rs, "prewarm_device")
    assert not hasattr(rs, "prewarm_device_async")
    assert rs.device.type == "cpu"
    assert PacbioReadSet("x", "x.fq", 0.8, 0.05).device.type == "cuda"
    assert not getattr(rs, "dp_cells", None)
    pc = ProbCalculator([], [], [(None, rs)], gr)
    pc.enable_sharded_pacbio(device="cpu")
    assert rs.forward_dispatch is True
    assert pc._sharded_pacbio.device.type == "cpu"
    prep = rs._slow_prepare(gr, WALKS[0], save_to_cache=False)
    out = rs._forward_batch(prep["seq"], prep["jobs"][:1])
    assert np.isfinite(out).all()
    assert set(rs.dp_cells) == {"mesh"}


@pytest.mark.parametrize("width", [64, 128])
def test_read_probabilities_match_native(tmp_path, monkeypatch, width):
    """Walk scores of the port's read set (plain K5, float32) against the
    native float64 route at the same width: positions equal, logprobs
    within test_pacbio's device-route bound."""
    needs_native()
    gr, rs_nat = world(tmp_path, f"n{width}", width, n_reads=30)
    _, rs_dev = world(tmp_path, f"d{width}", width, n_reads=30)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))
    want = [rs_nat.get_read_probabilities(gr, w) for w in WALKS]
    assert set(rs_nat.dp_cells) == {"native"}
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    got = [rs_dev.get_read_probabilities(gr, w) for w in WALKS]
    assert set(rs_dev.dp_cells) == {"torch"}
    n = 0
    for (pos_n, tl_n), (pos_d, tl_d) in zip(want, got):
        assert tl_n == tl_d
        for p_n, p_d in zip(pos_n, pos_d):
            assert [s for s, _ in p_n] == [s for s, _ in p_d]
            for (_s, lp_n), (_t, lp_d) in zip(p_n, p_d):
                assert lp_d == pytest.approx(lp_n, rel=1e-4, abs=1e-3)
                n += 1
    assert n >= 10


def test_small_batches_stay_native(tmp_path, monkeypatch):
    """Batches under GAML_PB_DEVICE_MIN_CELLS cells run on the native host
    kernel, the rest on the engine, each counted under its route."""
    needs_native()
    gr, rs = world(tmp_path, "thr", 64)
    prep = rs._slow_prepare(gr, WALKS[0], save_to_cache=False)
    cells = sum(len(j[0]) for j in prep["jobs"]) * 64
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(cells + 1))
    nat = rs._forward_batch(prep["seq"], prep["jobs"])
    assert rs.dp_cells == {"native": cells}
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(cells))
    dev = rs._forward_batch(prep["seq"], prep["jobs"])
    assert rs.dp_cells == {"native": cells, "torch": cells}
    np.testing.assert_allclose(dev, nat, rtol=1e-4, atol=1e-3)
    # the default threshold keeps a one-job batch of 200 bases native
    monkeypatch.delenv("GAML_PB_DEVICE_MIN_CELLS")
    q, centers, *meta = prep["jobs"][0]
    rs._forward_batch(prep["seq"], [(q[:200], centers[:201], *meta)])
    assert rs.dp_cells["native"] == cells + 200 * 64


def test_f32_route_anneal_quality_bound(tmp_path, monkeypatch):
    """test_pacbio's bound on the port: the same seeded anneal on the
    native float64 route and on the port's float32 route (the CUDA
    kernel's accumulation class) ends in quality-equivalent assemblies
    with near-equal best scores."""
    needs_native()
    from gaml_tpu_torch.core.io import output_paths_to_file
    from gaml_tpu_torch.optimize.anneal import Optimizer
    from gaml_tpu_torch.optimize.settings import AssemblySettings
    from gaml_tpu_torch.scoring.config import SingleReadConfig

    rng = np.random.default_rng(8)
    _gr, seqs = make_linear_graph(
        rng, [2200, 150, 2500, 120, 2300, 200, 2400])
    genome = "".join(seqs)

    def run(tag, port):
        gr, rs = port_pb_readset(tmp_path, seqs, np.random.default_rng(4),
                                 f"q{tag}", n_reads=30, rlen=1000, err=0.08)
        cfg = SingleReadConfig(penalty_constant=0.0001, step=100)
        pc = ProbCalculator([], [], [(cfg, rs)], gr)
        settings = AssemblySettings(
            threshold=500, max_iterations=120, seed=47,
            output_prefix=str(tmp_path / f"o{tag}"))
        opt = Optimizer(gr, pc, settings, advice_pacbio=[rs],
                        longest_read=1000, log=lambda *a: None)
        opt.prepare()
        paths = [[i] for i in range(0, gr.num_nodes, 2)
                 if gr.node_len(i) > 500]
        best = opt.run(paths, write_outputs=False)
        assert set(rs.dp_cells) == ({"torch"} if port else {"native"})
        output_paths_to_file(best, gr, 47, 500, str(tmp_path / f"fin{tag}"))
        sys.path.insert(0, str(REPO_TOOLS))
        from asm_quality import assembly_quality

        q = assembly_quality(genome, str(tmp_path / f"fin{tag}.fasta"))
        return float(opt.best_prob), q

    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))
    s64, q64 = run("64", False)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    s32, q32 = run("32", True)
    assert abs(s32 - s64) < 0.05, (s32, s64)
    assert abs(q32["kmer_recall"] - q64["kmer_recall"]) <= 0.005, (q32, q64)
    assert q32["kmer_junk"] <= q64["kmer_junk"] + 0.001
    assert q64["ng50"] == 0 or \
        0.95 <= q32["ng50"] / q64["ng50"] <= 1.06, (q32, q64)

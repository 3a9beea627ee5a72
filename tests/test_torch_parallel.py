"""The port's device scorers (gaml_tpu_torch.parallel, on the CPU) against
the JAX package's mesh scorers under x64, on a (1, 1) mesh and on the
8-device CPU mesh, and against the port's float64 host scorers: the
device state, the paired full and incremental rescores and their staging,
the PacBio forward dispatch and reduction, the single-end forward over
the staged cell layout, ProbCalculator's enable_* methods, anneals and
the CLI's four flags.  Tolerances: 1e-9 relative for float64 scores
(1e-12 for the device state), rel 2e-6 against the JAX single-end step
(float32 there), rel 1e-4 / abs 1e-3 where the PacBio forward runs the
plain K5 (float32 out) against the native float64 route."""
import json

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import gaml_tpu.scoring.paired as jscoring

from gaml_tpu.parallel import device_state as jdevice_state
from gaml_tpu.parallel import pacbio_sharded as jpacbio
from gaml_tpu.parallel import paired_sharded as jpaired
from gaml_tpu.parallel import sharded as jsharded
from gaml_tpu.scoring.reduce import get_total_prob
from gaml_tpu_torch.parallel import pacbio_sharded, paired_sharded, sharded
from gaml_tpu_torch.parallel.device_state import (DeviceScoringState,
                                                  fold_segments,
                                                  segment_ranks)
from gaml_tpu_torch.scoring.calculator import ProbCalculator
from gaml_tpu_torch.scoring.config import PairedReadConfig, SingleReadConfig
from gaml_tpu_torch.scoring.paired import (ScoringState,
                                           calc_score_for_paths_incremental)
from gaml_tpu_torch.scoring.readset import ReadSet

from fixtures import make_linear_graph, random_seq, write_fastq
from test_paired_sharded import WALKSETS, _world
from test_scoring import MATCH, MISMATCH, make_pairs
from test_torch_kernels import port_linear_graph, port_native_lib

KW = dict(no_cov_penalty=1e-4, exp_cov_move=150, use_all_to_cov=True)


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def meshes():
    """The JAX package's meshes: one device, and the 8-device CPU mesh."""
    return [Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1),
                 ("reads", "cand")) for n in (1, 8)]


def port_mates(tmp_path, jrs1, jrs2, tag):
    """The port's read sets of the JAX mates' FASTQ files (host route)."""
    out = []
    for k, jrs in ((1, jrs1), (2, jrs2)):
        rs = ReadSet(str(tmp_path / f"port{k}_{tag}"), jrs.filename, MATCH,
                     MISMATCH, device="cpu")
        rs.preprocess_reads()
        rs.prepare_read_index()
        out.append(rs)
    return out


def paired_world(tmp_path, seed=0, n_pairs=60):
    """test_paired_sharded._world for JAX, and the port's graph and mates
    of the same sequences and FASTQ files: (jax (gr, rs1, rs2), port (gr,
    rs1, rs2), insert mean, std)."""
    jgr, jrs1, jrs2, im, istd = _world(tmp_path, seed, n_pairs)
    _g, seqs = make_linear_graph(np.random.default_rng(seed),
                                 [600, 90, 500, 120, 550])
    prs1, prs2 = port_mates(tmp_path, jrs1, jrs2, seed)
    return (jgr, jrs1, jrs2), (port_linear_graph(seqs), prs1, prs2), im, istd


# ------------------------------------------------------------ device state
def test_segment_fold_adds_in_np_add_at_order():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 9, 200)
    vals = rng.random(200) * 10.0 ** rng.integers(-8, 8, 200)
    start = rng.random(9)
    uniq, seg, rank = segment_ranks(torch.from_numpy(ids))
    assert uniq.tolist() == np.unique(ids).tolist()
    for u in range(len(uniq)):
        assert rank[seg == u].tolist() == list(range(int((ids == u).sum())))
    got = fold_segments(torch.from_numpy(start)[uniq], torch.from_numpy(vals),
                        seg, rank)
    want = start.copy()
    np.add.at(want, ids, vals)
    assert got.numpy().tolist() == want[uniq.numpy()].tolist()
    empty = segment_ranks(torch.zeros(0, dtype=torch.int64))
    assert [len(x) for x in empty] == [0, 0, 0]
    st = torch.from_numpy(start)
    assert fold_segments(st, torch.zeros(0, dtype=torch.float64), *empty[1:]
                         ) is st


@pytest.mark.parametrize("n_reads", [37, 1000])
def test_device_state_matches_host_and_jax(n_reads, x64):
    """Random signed chunks: the port's totals equal the host's np.add.at
    bit for bit, the reduction holds get_total_prob and the JAX state at
    rel 1e-12.  One total is driven to exactly 0 and one below 0: both
    floor and count as zero reads, as on the host (a plain torch.log gives
    NaN there)."""
    rng = np.random.default_rng(9)
    lens = rng.integers(80, 120, n_reads).astype(np.int64)
    st = DeviceScoringState(n_reads, lens, device="cpu")
    jst = [jdevice_state.DeviceScoringState(m, n_reads, lens)
           for m in meshes()]
    host = np.zeros(n_reads)
    chunks = [(np.array([3, 5, 5], np.int32), np.array([1e-6, 0.3, 0.4]), 1),
              (np.array([3, 5, 5], np.int32), np.array([1e-6, 0.4, 0.3]),
               -1)]
    for step in range(6):
        k = int(rng.integers(1, 400))
        rids = rng.integers(6, n_reads, k).astype(np.int32)
        chunks.append((rids, rng.random(k) * 1e-6, 1 if step % 3 != 2
                       else -1))
    total_len = 50_000
    for i, (rids, ps, sign) in enumerate(chunks):
        st.apply(rids, ps, sign)
        for j in jst:
            j.apply(rids, ps, sign)
        np.add.at(host, rids, sign * ps)
        s, z = st.reduce(total_len + i, -0.7, -10.0)
        hs, hz = get_total_prob(host, total_len + i, -0.7, -10.0, lens)
        assert (z, st.to_host().tolist()) == (hz, host.tolist())
        assert s == pytest.approx(hs, rel=1e-12, abs=1e-12)
        for j in jst:
            js, jz = j.reduce(total_len + i, -0.7, -10.0)
            assert jz == z and s == pytest.approx(js, rel=1e-12)
    assert host[3] == 0.0 and host[5] < 0.0 and z >= 2
    assert torch.isnan(torch.log(torch.from_numpy(host))).any()
    st2 = DeviceScoringState(n_reads, lens, device="cpu")
    st2.from_host(host)
    assert st2.reduce(total_len, -0.7, -10.0) == st.reduce(total_len, -0.7,
                                                           -10.0)


# ------------------------------------------------------------- paired
def test_stage_paired_rows_equals_jax_row_for_row(tmp_path, x64):
    (jgr, j1, j2), (gr, r1, r2), _im, _istd = paired_world(tmp_path, 7, 40)
    paths = [[0, 2, 4, 6, 8], [0, 2, 4], [0, 2, -35, 6, 8]]
    want = jpaired.stage_paired_rows(jgr, paths, j1, j2, row_align=1)
    got = paired_sharded.stage_paired_rows(gr, paths, r1, r2, row_align=1)
    assert got[1:] == want[1:]
    assert len(got[0]) == len(want[0]) > 0
    for b, jb in zip(got[0], want[0]):
        # the port's split-row columns: no row of this world is split
        assert set(b) - set(jb) == {"off1", "off2", "n2"}
        assert not b["off1"].any() and not b["off2"].any()
        np.testing.assert_array_equal(b["n2"], (b["pos2"] >= 0).sum(1))
        for k in jb:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        np.testing.assert_array_equal(paired_sharded.pack_bucket(b),
                                      jpaired.pack_bucket(jb))


def test_full_paired_rescore_matches_jax_and_host(tmp_path, x64):
    """The five WALKSETS: rel and abs 1e-9 against the JAX mesh scorer
    (both meshes) and the port's float64 host incremental scorer from a
    fresh state; zero reads and total_len equal."""
    (jgr, j1, j2), (gr, r1, r2), im, istd = paired_world(tmp_path)
    scorer = paired_sharded.paired_scorer(r1, r2, im, istd, True, "cpu")
    for paths in WALKSETS:
        host = calc_score_for_paths_incremental(gr, paths, r1, r2, im, istd,
                                                ScoringState(), **KW)
        got = paired_sharded.calc_score_for_paths_paired_sharded(
            gr, paths, r1, r2, im, istd, scorer=scorer, **KW)
        for want in [host] + [jpaired.calc_score_for_paths_paired_sharded(
                jgr, paths, j1, j2, im, istd, m, **KW) for m in meshes()]:
            assert got[1:] == want[1:], paths
            assert got[0] == pytest.approx(want[0], rel=1e-9, abs=1e-9)
    no_ev = paired_sharded.calc_score_for_paths_paired_sharded(
        gr, WALKSETS[0], r1, r2, im, istd, device="cpu")
    host = calc_score_for_paths_incremental(gr, WALKSETS[0], r1, r2, im,
                                            istd, ScoringState())
    assert no_ev[1:] == host[1:]
    assert no_ev[0] == pytest.approx(host[0], rel=1e-9)


SEQUENCE = [
    [[0, 2, 4, 6, 8]],
    [[0, 2, 4], [6, 8]],                 # break
    [[0, 2, 4], [6, 8], [0, 2, 4]],      # duplicate walk added
    [[0, 2, 4], [6, 8]],                 # duplicate erased again
    [[0, 2, -35, 6, 8]],                 # gap walk replaces both
    [[0, 2, 4, 6, 8]],                   # back to the start walk
]


def test_incremental_matches_host_and_jax_sequence(tmp_path, x64):
    """test_incremental_sharded_matches_host_sequence on the port: per
    step, scores at 1e-9 against the host incremental scorer and the JAX
    mesh scorer, zero reads, total_len and bad_bases equal; after the
    sequence the device totals equal the host's bit for bit."""
    (jgr, j1, j2), (gr, r1, r2), im, istd = paired_world(tmp_path, 11)
    st_host, st_dev = ScoringState(), ScoringState()
    st_jax = [jscoring.ScoringState() for _ in meshes()]
    for paths in SEQUENCE:
        host = calc_score_for_paths_incremental(gr, paths, r1, r2, im, istd,
                                                st_host, **KW)
        got = paired_sharded.calc_score_for_paths_incremental_sharded(
            gr, paths, r1, r2, im, istd, st_dev, device="cpu", **KW)
        wants = [host] + [
            jpaired.calc_score_for_paths_incremental_sharded(
                jgr, paths, j1, j2, im, istd, s, m, **KW)
            for s, m in zip(st_jax, meshes())]
        for want in wants:
            assert got[1:] == want[1:], paths
            assert got[0] == pytest.approx(want[0], rel=1e-9, abs=1e-9)
        assert st_dev.bad_bases == st_host.bad_bases == st_jax[0].bad_bases
    # the host's arithmetic in the host's order: equal bit for bit
    assert np.array_equal(st_dev.device.to_host(), st_host.probs)


def repeat_world(tmp_path, seed=41, copies=160):
    """A chain through a tandem repeat (a 37 bp unit ``copies`` times)
    between random flanks, with pairs inside the repeat, whose mates align
    once a unit (more than _SPLIT_K positions each), and pairs anywhere:
    the port's (graph, rs1, rs2, insert mean, std)."""
    rng = np.random.default_rng(seed)
    unit = random_seq(rng, 37)
    seqs = [random_seq(rng, 400), unit * copies, random_seq(rng, 400)]
    L, im, istd = 30, 200, 20
    m1, m2 = make_pairs(rng, seqs[1], 6, L, im, istd)
    f1, f2 = make_pairs(rng, "".join(seqs), 20, L, im, istd)
    mates = []
    for k, reads in ((1, m1 + f1), (2, m2 + f2)):
        fq = tmp_path / f"rep{k}.fq"
        write_fastq(str(fq), reads)
        rs = ReadSet(str(tmp_path / f"rep{k}"), str(fq), MATCH, MISMATCH,
                     device="cpu")
        rs.preprocess_reads()
        rs.prepare_read_index()
        mates.append(rs)
    return port_linear_graph(seqs), mates[0], mates[1], im, istd


def test_split_rows_add_in_host_order(tmp_path):
    """Rows with more than _SPLIT_K positions in both mates are staged as
    a grid of sub-rows; the scorer still adds their pairs x-major over the
    whole row, as the host does: totals equal the host incremental
    scorer's bit for bit, from a fresh state and over a move sequence, and
    the scores and zero reads with them (the full rescore against the
    host from a fresh state: erased walks leave rounding residues in the
    running totals, which keep 12 reads of the last walk set above the
    floor)."""
    gr, r1, r2, im, istd = repeat_world(tmp_path)
    paths = [[0, 2, 4], [2], [0, 2, 4]]
    buckets = paired_sharded.stage_paired_rows(gr, paths, r1, r2,
                                               row_align=1)[0]
    assert any(((b["off1"] > 0) & (b["off2"] > 0)).any() for b in buckets)
    assert max(int(b["n2"].max()) for b in buckets) > \
        paired_sharded._SPLIT_K
    n = r1.get_number_of_reads()
    st = ScoringState()
    calc_score_for_paths_incremental(gr, paths, r1, r2, im, istd, st, **KW)
    sc = paired_sharded.paired_scorer(r1, r2, im, istd, True, "cpu")
    totals, _f = sc.read_totals(buckets, n, -0.7, -10.0)
    assert np.array_equal(totals.numpy(), st.probs)
    st_host, st_dev = ScoringState(), ScoringState()
    for walks in (paths, [[0, 2, 4]], [[2], [0, 2, 4], [2]], [[0], [4]]):
        host = calc_score_for_paths_incremental(gr, walks, r1, r2, im, istd,
                                                st_host, **KW)
        got = paired_sharded.calc_score_for_paths_incremental_sharded(
            gr, walks, r1, r2, im, istd, st_dev, device="cpu", **KW)
        full = paired_sharded.calc_score_for_paths_paired_sharded(
            gr, walks, r1, r2, im, istd, scorer=sc, **KW)
        fresh = calc_score_for_paths_incremental(gr, walks, r1, r2, im,
                                                 istd, ScoringState(), **KW)
        assert np.array_equal(st_dev.device.to_host(), st_host.probs)
        for res, want in ((got, host), (full, fresh)):
            assert res[1:] == want[1:], walks
            assert res[0] == pytest.approx(want[0], rel=1e-9, abs=1e-9)


def test_incremental_stages_only_changes(tmp_path, monkeypatch):
    _j, (gr, r1, r2), im, istd = paired_world(tmp_path, 17)
    st = ScoringState()
    base = [[0, 2], [4], [6, 8]]
    paired_sharded.calc_score_for_paths_incremental_sharded(
        gr, base, r1, r2, im, istd, st, device="cpu")
    staged = []
    real = paired_sharded.stage_paired_rows

    def spy(graph, paths, *a, **k):
        staged.append([list(p) for p in paths])
        return real(graph, paths, *a, **k)

    monkeypatch.setattr(paired_sharded, "stage_paired_rows", spy)
    moved = [[0, 2], [4, 6, 8]]              # erase [4] + [6,8], add [4,6,8]
    paired_sharded.calc_score_for_paths_incremental_sharded(
        gr, moved, r1, r2, im, istd, st, device="cpu")
    assert sorted(sum(staged, [])) == sorted([[4], [6, 8], [4, 6, 8]])
    staged.clear()
    paired_sharded.calc_score_for_paths_incremental_sharded(
        gr, moved, r1, r2, im, istd, st, device="cpu")   # no-op move
    assert staged == []


def test_bucket_products_and_apply_agree(tmp_path):
    """bucket_products' dense totals are what bucket_apply adds, with the
    same flags; the walk has qualifying pairs; read_totals over a walk set
    equals the host incremental scorer's totals from a fresh state bit for
    bit."""
    _j, (gr, r1, r2), im, istd = paired_world(tmp_path, 3)
    buckets, _ev, _tl = paired_sharded.stage_paired_rows(
        gr, [[0, 2, 4, 6, 8]], r1, r2, row_align=1)
    sc = paired_sharded.paired_scorer(r1, r2, im, istd, True, "cpu")
    n = r1.get_number_of_reads()
    paths = [[0, 2, 4, 6, 8], [0, 2, 4], [4, 6, 8], [0, 2, 4]]
    st = ScoringState()
    calc_score_for_paths_incremental(gr, paths, r1, r2, im, istd, st)
    staged = paired_sharded.stage_paired_rows(gr, paths, r1, r2,
                                              row_align=1)[0]
    totals, _f = sc.read_totals(staged, n, -0.7, -10.0)
    assert np.array_equal(totals.numpy(), st.probs)
    probs = torch.zeros(n, dtype=torch.float64)
    for b in buckets:
        dense, flags = sc.bucket_products(b, n, -0.7, -10.0)
        before = probs.clone()
        flags2 = sc.bucket_apply(probs, -1.0, b, -0.7, -10.0)
        assert torch.equal(probs, before - dense)
        assert torch.equal(flags, flags2) and flags.dtype == torch.uint8
        assert flags.shape == b["pos1"].shape
    assert any(int(f.any()) for f in paired_sharded.fetch_flags(
        [sc.bucket_products(b, n, -0.7, -10.0)[1] for b in buckets]))


# ------------------------------------------------------------- calculator
def test_prob_calculator_enable_paired_and_state(tmp_path):
    """Each paired enable_* on the CPU against the host calculator over a
    walk-set sequence: scores at 1e-9, total_len and zeros equal."""
    _j, (gr, r1, r2), im, istd = paired_world(tmp_path, 23)
    cfg = PairedReadConfig(insert_mean=im, insert_std=istd,
                           penalty_constant=1e-4, step=150)
    host = ProbCalculator([], [(cfg, (r1, r2))], [], gr)
    calcs = []
    for how in ("full", "inc", "state"):
        pc = ProbCalculator([], [(cfg, (r1, r2))], [], gr)
        if how == "state":
            pc.enable_device_scoring_state(device="cpu")
        else:
            pc.enable_sharded_paired(device="cpu", incremental=how == "inc")
        calcs.append(pc)
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]],
                  [[0, 2, -20, 8]], [[0, 2, 4, 6, 8]]):
        zh = []
        sh, tlh = host.calc_prob(paths, zh)
        for pc in calcs:
            zd = []
            sd, tld = pc.calc_prob(paths, zd)
            assert (tld, zd) == (tlh, zh)
            assert sd == pytest.approx(sh, rel=1e-9, abs=1e-9)
    full, inc, state = calcs
    assert len(full._sharded_scorers) == 1 and full._sharded_scorers[0]
    scorer = inc._sharded_scorers[0]
    inc.calc_prob([[0], [4]])
    assert inc._sharded_scorers[0] is scorer      # one scorer per read set
    assert state.paired_scoring_states[0].device.device.type == "cpu"


def port_build_world(tmp_path, seed, n_pairs):
    """test_optimizer.build_world on the port: the paired calculator of
    its graph and mates (host route)."""
    from gaml_tpu_torch.scoring.readset import ReadSet as PortReadSet

    from fixtures import write_fastq

    rng = np.random.default_rng(seed)
    _g, seqs = make_linear_graph(rng, [700, 80, 600, 80, 800])
    L, im, istd = 30, 250, 25
    m1, m2 = make_pairs(rng, "".join(seqs), n_pairs, L, im, istd)
    mates = []
    for k, reads in ((1, m1), (2, m2)):
        fq = tmp_path / f"w{seed}_{k}.fq"
        write_fastq(str(fq), reads)
        rs = PortReadSet(f"o{k}", str(fq), MATCH, MISMATCH, device="cpu")
        rs.preprocess_reads()
        rs.prepare_read_index()
        mates.append(rs)
    cfg = PairedReadConfig(penalty_constant=0.0, step=im - 50.0,
                           insert_mean=im, insert_std=istd)
    return ProbCalculator([], [(cfg, tuple(mates))], [],
                          port_linear_graph(seqs))


@pytest.mark.parametrize("how", ["paired-device-inc", "device-state"])
def test_anneal_matches_host(tmp_path, how):
    """25 iterations of the anneal with the flag's scorer on the CPU
    against the host calculator: the same best walks, best_prob within
    1e-9, the same history of accepts."""
    from gaml_tpu_torch.optimize.anneal import Optimizer
    from gaml_tpu_torch.optimize.settings import AssemblySettings

    def run(enable):
        pc = port_build_world(tmp_path, 29, 30)
        if enable == "paired-device-inc":
            pc.enable_sharded_paired(device="cpu", incremental=True)
        elif enable == "device-state":
            pc.enable_device_scoring_state(device="cpu")
        settings = AssemblySettings(threshold=500, max_iterations=25, seed=7,
                                    output_prefix=str(tmp_path / enable))
        opt = Optimizer(pc.graph, pc, settings, longest_read=250,
                        log=lambda *a: None)
        best = opt.run([[0], [4], [8]], write_outputs=False)
        return best, opt

    best_h, opt_h = run("host")
    best_d, opt_d = run(how)
    assert [list(w) for w in best_d] == [list(w) for w in best_h]
    assert opt_d.best_prob == pytest.approx(opt_h.best_prob, rel=1e-9,
                                            abs=1e-9)
    assert [r["accept"] for r in opt_d.history] == \
        [r["accept"] for r in opt_h.history]
    assert len(opt_d.history) >= 25


# ------------------------------------------------------------- pacbio
def test_pacbio_log_sum_exp_matches_jax(x64):
    """ShardedPacbioScorer.score against the JAX scorer on the same rows:
    a read with no rows, one with only -inf rows, one whose only row is
    K5's no-path value (-1e30), reads with several rows."""
    rng = np.random.default_rng(5)
    n = 12
    rid = np.concatenate([rng.integers(3, n, 60), [1, 1, 2]]).astype(
        np.int32)
    lp = np.concatenate([rng.normal(-300, 80, 60), [-np.inf, -np.inf,
                                                   -1e30]])
    lens = rng.integers(300, 900, n).astype(np.float64)
    got = pacbio_sharded.ShardedPacbioScorer("cpu").score(
        rid, lp, n, lens, 9000, -0.7, -10.0)
    for m in meshes():
        want = jpacbio.ShardedPacbioScorer(m).score(rid, lp, n, lens, 9000,
                                                   -0.7, -10.0)
        assert got[1] == want[1] >= 3
        assert got[0] == pytest.approx(want[0], rel=1e-12)
    hp = np.full(n, -np.inf)
    from gaml_tpu_torch.scoring.pacbio_score import add_positions_to_read_probs

    add_positions_to_read_probs(
        [[((0, 0), x) for r, x in zip(rid, lp) if r == i] for i in range(n)],
        hp)
    floors = -10.0 - 0.7 * lens
    host = np.mean(np.maximum(hp, floors)) - np.log(2 * 9000)
    assert got[1] == int((hp < floors).sum())
    assert got[0] == pytest.approx(host, rel=1e-12)


def pacbio_world(tmp_path, name, seed=33):
    """test_pacbio_sharded's world on the port's read set (CPU)."""
    from test_torch_pacbio import port_pb_readset

    rng = np.random.default_rng(seed)
    _g, seqs = make_linear_graph(rng, [900, 120, 1100, 90, 800])
    return port_pb_readset(tmp_path, seqs, rng, name, n_reads=12, rlen=450,
                           err=0.08)


def test_pacbio_sharded_matches_host(tmp_path, monkeypatch):
    """calc_score_for_pacbio_sharded against calc_score_for_pacbio: at
    1e-9 over the same cached alignments (native forward), and with
    forward_dispatch installed (every batch on the plain K5, cells under
    "mesh") at the device route's bound against the native route."""
    from gaml_tpu_torch.scoring.pacbio_score import calc_score_for_pacbio

    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))
    gr, rs = pacbio_world(tmp_path, "nat")
    _, rs_mesh = pacbio_world(tmp_path, "mesh")
    sc = pacbio_sharded.ShardedPacbioScorer("cpu")
    rs_mesh.forward_dispatch = True
    kw = dict(no_cov_penalty=1e-4, exp_cov_move=100)
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]], [[0, 2, -30, 8]]):
        host = calc_score_for_pacbio(gr, paths, rs, **kw)
        got = pacbio_sharded.calc_score_for_pacbio_sharded(
            gr, paths, rs, device="cpu", **kw)
        assert got[1:] == host[1:]
        assert got[0] == pytest.approx(host[0], rel=1e-9, abs=1e-9)
        mesh = pacbio_sharded.calc_score_for_pacbio_sharded(
            gr, paths, rs_mesh, scorer=sc, **kw)
        assert mesh[1:] == host[1:]
        assert mesh[0] == pytest.approx(host[0], rel=1e-4, abs=1e-3)
    assert set(rs.dp_cells) == {"native"}
    assert set(rs_mesh.dp_cells) == {"mesh"} and rs_mesh.dp_cells["mesh"] > 0


def test_prob_calculator_enable_pacbio(tmp_path, monkeypatch):
    """enable_sharded_pacbio: with the forward on the device every batch
    runs on the read set's engine (resident rows) under "mesh"; without,
    the read set keeps its routes and only the reduction moves."""
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    cfg = SingleReadConfig(penalty_constant=1e-4, step=100)
    gr, rs_h = pacbio_world(tmp_path, "ph", 55)
    _, rs_d = pacbio_world(tmp_path, "pd", 55)
    _, rs_r = pacbio_world(tmp_path, "pr", 55)
    pc_h = ProbCalculator([], [], [(cfg, rs_h)], gr)
    pc_d = ProbCalculator([], [], [(cfg, rs_d)], gr)
    pc_r = ProbCalculator([], [], [(cfg, rs_r)], gr)
    pc_d.enable_sharded_pacbio(device="cpu")
    pc_r.enable_sharded_pacbio(device="cpu", forward_on_mesh=False)
    assert rs_d.forward_dispatch is True
    assert not hasattr(rs_r, "forward_dispatch")
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]]):
        zh = []
        sh, tlh = pc_h.calc_prob(paths, zh)
        for pc in (pc_d, pc_r):
            zd = []
            sd, tld = pc.calc_prob(paths, zd)
            assert (tld, zd) == (tlh, zh)
            assert sd == pytest.approx(sh, rel=1e-9, abs=1e-9)
    assert set(rs_d.dp_cells) == {"mesh"} and set(rs_r.dp_cells) == {"torch"}
    assert rs_d.dp_cells["mesh"] == rs_h.dp_cells["torch"]
    assert rs_d._fwd_engine.rows is not None


# ------------------------------------------------------------ single-end
def test_sharded_single_end_score_matches_jax_and_host():
    """test_parallel.py's world on a (1, 1) world: rel 2e-6 against the
    JAX step (float32) on the same staging, zero reads equal, and against
    the host truth."""
    from gaml_tpu.align.aligner import gen_candidates
    from gaml_tpu.align.bfs import process_hit
    from gaml_tpu.core import dna
    from gaml_tpu.index.maxhash import ReadIndexMaxHash

    from fixtures import random_seq, sample_reads

    rng = np.random.default_rng(21)
    genome = random_seq(rng, 800)
    seq = dna.encode_seq(genome)
    n_reads, L = 64, 32
    codes = [dna.encode_seq(r) for r in
             sample_reads(rng, genome, n_reads, L, err_rate=0.0)]
    idx = ReadIndexMaxHash()
    for i, c in enumerate(codes):
        idx.add_read(c, i)
    cands = gen_candidates(idx, dict(enumerate(codes)), seq)
    host = np.zeros(n_reads)
    seen = set()
    for cand, read in cands:
        res = process_hit(cand.genome_pos, cand.read_pos, read, seq)
        if res is not None and (cand.read_id, res[1]) not in seen:
            seen.add((cand.read_id, res[1]))
            host[cand.read_id] += MISMATCH ** res[0] * MATCH ** (L - res[0])
    thr = np.exp(-10 + -0.7 * L)
    probs = host / (2 * len(genome))
    host_score = float(np.mean(np.log(np.maximum(probs, thr))))
    shard = [[(c.read_id, c.genome_pos, c.read_pos, r) for c, r in cands]]
    lens = [np.full(n_reads, L)]
    args = (float(np.log(MATCH)), float(np.log(MISMATCH)), len(genome),
            -0.7, -10.0, 64)
    staged, lens_mask, n_local = sharded.stage_sharded(
        seq, shard, 64, lens, device="cpu")
    assert staged["read_f"].shape[:2] == (1, 1)
    score, zeros = sharded.sharded_single_end_score(
        staged, lens_mask, *args, n_local, n_reads)
    mesh = jsharded.make_mesh(jax.devices()[:1], 1, 1)
    jst, jlm, jn = jsharded.stage_sharded(seq, shard, mesh, 64, lens)
    jscore, jzeros = jsharded.sharded_single_end_score(
        mesh, jst, jlm, *args, jn, n_reads)
    assert int(zeros) == int(jzeros) == int((probs < thr).sum())
    assert float(score) == pytest.approx(float(jscore), rel=2e-6)
    assert float(score) == pytest.approx(host_score, rel=1e-9)
    with pytest.raises(ValueError, match="A10b"):
        sharded.sharded_single_end_score(
            {k: v.expand(2, *v.shape[1:]) for k, v in staged.items()},
            lens_mask, *args, n_local, n_reads)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("flag", ["--paired-device", "--paired-device-inc",
                                  "--device-state", "--pacbio-device"])
def test_cli_flag_trace_equals_port_default(tmp_path, monkeypatch, capsys,
                                            flag):
    """Each flag with --device cpu: exit 0 and the itnum trace and .walks
    of the port's own run without it (PacBio: every batch on the plain K5
    in both runs, the flag's cells under "mesh")."""
    from gaml_tpu_torch.cli import main
    from test_torch_cli import itnum_lines, write_pacbio_world, write_world

    monkeypatch.setenv("GAML_DEV_MIN_BASES", "0")
    monkeypatch.chdir(tmp_path)
    if flag == "--pacbio-device":
        monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
        cfg = write_pacbio_world(tmp_path)
        configs = [cfg, cfg.replace("pb.cfg", "pb2.cfg")]
        text = open(cfg).read()
        open(configs[1], "w").write(text.replace("pbout", "pbflag").replace(
            "pbcache", "pbcache2"))
        outs = [tmp_path / "pbout.walks", tmp_path / "pbflag.walks"]
    else:
        config = write_world(tmp_path, iterations=12)
        configs = [config("plain"), config("flag")]
        outs = [tmp_path / "plain.walks", tmp_path / "flag.walks"]
    # the function each flag must reach, counted
    owner, name = {"--paired-device": (paired_sharded, "stage_paired_rows"),
                   "--paired-device-inc": (paired_sharded,
                                           "stage_paired_rows"),
                   "--device-state": (DeviceScoringState, "apply"),
                   "--pacbio-device": (pacbio_sharded.ShardedPacbioScorer,
                                       "score")}[flag]
    calls = []
    real = getattr(owner, name)
    monkeypatch.setattr(owner, name, lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    runs = []
    for cfg, extra in zip(configs, ([], [flag])):
        assert main([cfg, "--device", "cpu", *extra]) == 0
        runs.append(capsys.readouterr().out)
        assert bool(calls) == bool(extra)
    traces = [itnum_lines(r) for r in runs]
    assert len(traces[0]) >= 8 and traces[1] == traces[0]
    assert outs[1].read_bytes() == outs[0].read_bytes()
    summary = json.loads(runs[1].splitlines()[-1].split("device work: ")[1])
    if flag == "--pacbio-device":
        assert set(summary["pacbio_cells"]) == {"mesh"}

"""The plain reference (benchmark/reference) against the port at a small
size on the CPU, and its extension against ProcessHit's BFS."""
import numpy as np
import pytest

from reference import shortread as R


def assemblies(world, n=3, seed=3):
    from harness import common

    return common.load_module("worlds", "paired").misassemblies(np.random.default_rng(seed), world, n,
                           {"contigs": 4, "edits": 3, "run_nodes": [1, 4]})


def test_candidates_equal_the_ports(tiny_world):
    from gaml_tpu_torch.align.aligner import gen_candidates

    world, paired, _graph = tiny_world
    rs = paired[0][1][0]
    idx = R.ReadIndex(world.libraries["rs1"][0])
    for start, stop in ((0, 4000), (1000, 1700), (20_000, 50_000)):
        seq = world.genome[start:stop]
        got = np.stack(idx.candidates([seq])[1:], 1)
        want = np.array([(c.read_id, c.genome_pos, c.read_pos,
                          c.orientation) for c, _read in gen_candidates(
                              rs.index, rs.read_seqs, seq,
                              rs.aligner._read_cache)]).reshape(-1, 4)
        assert np.array_equal(got, want)
    # a batch of sequences gives each its own candidates
    seqs = [world.genome[a:b] for a, b in ((0, 4000), (10, 90),
                                            (5000, 9000))]
    seg, *cols = idx.candidates(seqs)
    for i, s in enumerate(seqs):
        one = idx.candidates([s])[1:]
        assert all(np.array_equal(c[seg == i], o) for c, o in zip(cols, one))


def hits(world, n_max=3000):
    idx = R.ReadIndex(world.libraries["rs1"][1])
    seq = world.genome[:30_000]
    _seg, rid, g0, r0, ori = idx.candidates([seq])
    return idx, seq, list(zip(rid, g0, r0, ori))[:n_max]


def test_process_hit_equals_the_ports_bfs(tiny_world):
    from gaml_tpu_torch.align import bfs

    idx, seq, cands = hits(tiny_world[0])
    for rid, g0, r0, o in cands:
        read = idx.oriented[o][rid]
        want = bfs.process_hit(int(g0), int(r0), read, seq)
        got = R.process_hit(int(g0), int(r0), read, seq)
        assert got == (None if want is None else (want[0], want[1])), \
            (rid, g0, r0, o)


def test_dp_is_the_bfs_without_its_queue_artefact(tiny_world):
    """The device route's DP (the reference's ``extend``) never costs more
    than the BFS, and where both cost the same they agree on the begin."""
    idx, seq, cands = hits(tiny_world[0])
    rid, g0, r0, o = (np.array(x) for x in zip(*cands))
    ok, errs, begin = R.extend(idx, seq, np.zeros(len(rid), np.int64),
                               np.full(len(rid), len(seq)), rid, g0, r0, o,
                               "cpu")
    same = 0
    for i in range(len(rid)):
        want = R.process_hit(int(g0[i]), int(r0[i]), idx.oriented[o[i]][
            rid[i]], seq)
        if want is None:
            continue
        assert ok[i] and errs[i] <= want[0]
        if errs[i] == want[0]:
            assert begin[i] == want[1]
            same += 1
    assert same > 0.99 * ok.sum()


def rescore_args(rs):
    return dict(log_match=float(np.log(rs.match_prob)),
                log_mismatch=float(np.log(rs.mismatch_prob)),
                min_prob_per_base=-0.7, min_prob_start=-10.0)


@pytest.mark.parametrize("mate", [0, 1])
def test_rescore_equals_the_ports_and_float32_departs(tiny_world, mate):
    world, paired, _graph = tiny_world
    rs = paired[0][1][mate]
    resc = rs.aligner.ensure_device_rescorer()
    idx = R.ReadIndex(world.libraries["rs1"][mate])
    for contigs in assemblies(world):
        total = sum(len(c) for c in contigs)
        score, zeros, n = resc.rescore(contigs, None, total_len=total,
                                       **rescore_args(rs))
        ref = R.rescore(idx, contigs, rs.match_prob, rs.mismatch_prob,
                        -0.7, -10.0, "cpu")
        assert abs(score - ref[0]) <= 1e-12 * abs(ref[0])
        assert (zeros, n) == ref[1:3]
        f32 = R.rescore(idx, contigs, rs.match_prob, rs.mismatch_prob,
                        -0.7, -10.0, "cpu", np.float32, aligned=ref[3])
        assert abs(f32[0] - ref[0]) > 1e-9 * abs(ref[0])


def test_coverage_sweep_equals_the_ports():
    from gaml_tpu_torch.scoring.paired import _coverage_sweep

    rng = np.random.default_rng(5)
    for _ in range(200):
        n = int(rng.integers(1, 60))
        pos = rng.integers(0, 5000, n)
        typ = rng.choice([1, 3], n)
        want = _coverage_sweep(list(zip(pos.tolist(), typ.tolist())), 180.0,
                               20.0, 150.0)
        assert R.coverage_sweep(pos, typ, 180.0, 20.0, 150.0) == want

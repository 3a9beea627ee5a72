"""The port's device likelihood models (gaml_tpu_torch.models, ops.score,
ops.pair, CPU tensors) against the JAX package's: scores, zero reads,
per-read probabilities and dedup on the same inputs."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gaml_tpu.models as jmodels
import gaml_tpu.ops.pair as jpair
import gaml_tpu.ops.score as jscore
from gaml_tpu.align.aligner import gen_candidates
from gaml_tpu.core import dna
from gaml_tpu.index.maxhash import ReadIndexMaxHash
from gaml_tpu.ops.extend import batch_extend_host as jax_batch_extend_host
from gaml_tpu.ops.extend import stage_candidates as jax_stage_candidates
from gaml_tpu.scoring.paired import calc_score_for_paths_paired
from gaml_tpu_torch import models as tmodels
from gaml_tpu_torch.ops import pair as tpair
from gaml_tpu_torch.ops import score as tscore

from fixtures import make_linear_graph, random_seq
from test_scoring import MATCH, MISMATCH, make_pairs, make_readset

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STAGED = ("read_f", "rlen_f", "gwin_f", "glen_f", "read_b", "rlen_b",
          "gwin_b", "glen_b", "g0", "r0", "valid", "read_id", "read_len",
          "at_start")


def models_world():
    """tests/test_models.py::test_single_end_model's world: 20 exact
    30 bp reads tiling a 500 bp genome."""
    rng = np.random.default_rng(0)
    genome = random_seq(rng, 500)
    reads = [dna.encode_seq(genome[i * 15:i * 15 + 30]) for i in range(20)]
    return dna.encode_seq(genome), reads


def noisy_world():
    """A 3 kb genome and 400 reads of 40-70 bp with substitutions and
    indels (a few reads per hundred far off), both strands."""
    rng = np.random.default_rng(12)
    seq = dna.encode_seq(random_seq(rng, 3000))
    reads = []
    for _ in range(400):
        ln = int(rng.integers(40, 71))
        p = int(rng.integers(0, len(seq) - ln))
        r = seq[p:p + ln].copy()
        for _ in range(int(rng.integers(0, 9 if rng.random() < 0.1 else 4))):
            i = int(rng.integers(0, len(r)))
            u = rng.random()
            if u < 0.7:
                r[i] = (r[i] + int(rng.integers(1, 4))) % 4
            elif u < 0.85:
                r = np.delete(r, i)
            else:
                r = np.insert(r, i, int(rng.integers(0, 4)))
        reads.append(dna.revcomp(r) if rng.random() < 0.5 else r)
    return seq, reads


@pytest.mark.parametrize("world", [models_world, noisy_world])
def test_single_end_model_matches_jax(world):
    """SingleEndModel.score_candidates against the JAX model on the same
    host candidates: score rel 2e-6, zero_reads equal.  The port sums in
    float64 (ROADMAP C12), so its read_probs are held within rel 1e-12 to
    the float64 sums of the JAX extension's own first-wins alignments,
    and against the JAX model's float32 read_probs within rel 1e-6 on
    the exact reads of models_world; on noisy_world (up to 6 errors a
    read) the JAX values carry the rounding of their float32 exponent,
    so there the bound is one float32 epsilon of the largest |log p|."""
    seq, reads = world()
    idx = ReadIndexMaxHash()
    for i, c in enumerate(reads):
        idx.add_read(c, i)
    cands = gen_candidates(idx, dict(enumerate(reads)), seq)
    assert len(cands) >= len(reads) // 2
    lens = [len(r) for r in reads]
    want = jmodels.SingleEndModel(MATCH, MISMATCH).score_candidates(
        seq, cands, len(reads), lens, len(seq))
    got = tmodels.SingleEndModel(MATCH, MISMATCH,
                                 device="cpu").score_candidates(
        seq, cands, len(reads), lens, len(seq))
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6)
    f64, seen, log_p = np.zeros(len(reads)), set(), [0.0]
    for (c, r), (ok, e, begin) in zip(cands,
                                      jax_batch_extend_host(seq, cands)):
        if ok and (c.read_id, begin) not in seen:
            seen.add((c.read_id, begin))
            f64[c.read_id] += MISMATCH ** e * MATCH ** (len(r) - e)
            log_p.append(e * np.log(MISMATCH) + (len(r) - e) * np.log(MATCH))
    assert got[2].dtype == np.float64
    np.testing.assert_allclose(got[2], f64, rtol=1e-12, atol=0)
    if world is models_world:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
    if world is noisy_world:
        assert 0 < got[1] < len(reads)
        exponent = np.finfo(np.float32).eps * np.abs(log_p).max()
        np.testing.assert_allclose(got[2], want[2], rtol=exponent, atol=0)


def test_single_end_forward_matches_jax():
    """single_end_forward on the JAX staged dict of __graft_entry__'s
    synthetic world (the compile-checked entry), against the JAX
    function."""
    import __graft_entry__ as ge

    seq, cands, n_reads, read_len, genome_len = ge._synthetic_world()
    st = jax_stage_candidates(
        seq, np.array([c.genome_pos for c, _ in cands], np.int32),
        np.array([c.read_pos for c, _ in cands], np.int32),
        [r for _, r in cands],
        read_ids=np.array([c.read_id for c, _ in cands], np.int32))
    lens = np.full(n_reads, read_len, np.int32)
    scalars = (np.log(0.96), np.log(0.01), genome_len, -0.7, -10.0)
    want = jscore.single_end_forward(
        *(jnp.asarray(st[k]) for k in STAGED), jnp.asarray(lens),
        *(jnp.float32(x) for x in scalars[:2]), jnp.int32(genome_len),
        jnp.float32(-0.7), jnp.float32(-10.0), rmax=st["rmax"],
        n_reads=n_reads)
    got = tscore.single_end_forward(
        *(torch.from_numpy(st[k]) for k in STAGED), torch.from_numpy(lens),
        float(np.float32(scalars[0])), float(np.float32(scalars[1])),
        genome_len, -0.7, -10.0, rmax=st["rmax"], n_reads=n_reads)
    assert int(got[1]) == int(want[1]) == 0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=2e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        tscore.single_end_forward(
            *(torch.from_numpy(st[k]) for k in STAGED),
            torch.from_numpy(lens), 0.0, 0.0, genome_len, -0.7, -10.0,
            rmax=st["rmax"] + 1, n_reads=n_reads)


def test_dedup_matches_jax():
    """dedup_alignments / dedup_sort_payload keep the same rows as the
    JAX functions on keys with duplicates and invalid rows."""
    rng = np.random.default_rng(4)
    n = 3000
    rid = rng.integers(0, 60, n).astype(np.int32)
    begin = rng.integers(-1, 40, n).astype(np.int32)
    good = rng.random(n) < 0.8
    errs = rng.integers(0, 7, n).astype(np.int32)
    order_j, keep_j = (np.asarray(x) for x in jscore.dedup_alignments(
        jnp.asarray(rid), jnp.asarray(begin), jnp.asarray(good)))
    order, keep = (x.numpy() for x in tscore.dedup_alignments(
        torch.from_numpy(rid), torch.from_numpy(begin),
        torch.from_numpy(good)))
    assert keep.sum() < good.sum()  # duplicates were dropped
    np.testing.assert_array_equal(order[keep], order_j[keep_j])
    np.testing.assert_array_equal(keep, keep_j)

    rid_j, keep_j, (errs_j,) = jscore.dedup_sort_payload(
        jnp.asarray(rid), jnp.asarray(begin), jnp.asarray(good),
        (jnp.asarray(errs),))
    rid_s, keep, (errs_s,) = tscore.dedup_sort_payload(
        torch.from_numpy(rid), torch.from_numpy(begin),
        torch.from_numpy(good), (torch.from_numpy(errs),))
    np.testing.assert_array_equal(rid_s.numpy(), np.asarray(rid_j))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(errs_s.numpy(), np.asarray(errs_j))


def test_paired_end_model_matches_jax():
    """tests/test_models.py::test_paired_end_model's pair, and the model
    carried across with from_params."""
    jm = jmodels.PairedEndModel(insert_mean=200, insert_std=20,
                                match_prob=MATCH, mismatch_prob=MISMATCH)
    args = ([[(10, (0, 0))]], [[(180, (0, 1))]], 1, [30], [30], 600)
    want = jm.score_positions(*args)
    for model in (tmodels.PairedEndModel(200, 20, match_prob=MATCH,
                                         mismatch_prob=MISMATCH,
                                         device="cpu"),
                  tmodels.from_params(*jax_params(jm), device="cpu")):
        got = model.score_positions(*args)
        assert got[1] == want[1] == 0
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


def test_paired_score_device_matches_jax_and_host(tmp_path):
    """tests/test_pair_device.py's world: the positions the host paired
    scorer assembled, through the port's pair product and reduction;
    rel 1e-6 against JAX, rel 1e-5 against the float64 host scorer, zero
    reads equal."""
    rng = np.random.default_rng(0)
    gr, seqs = make_linear_graph(rng, [500, 90, 450])
    L, im, istd = 28, 220, 20
    m1, m2 = make_pairs(rng, "".join(seqs), 40, L, im, istd)
    rs1 = make_readset(tmp_path, m1, "dp1")
    rs2 = make_readset(tmp_path, m2, "dp2")
    host_score, host_zero, tl = calc_score_for_paths_paired(
        gr, [[0, 2, 4]], rs1, rs2, im, istd)
    staged = []
    for rs in (rs1, rs2):
        pos, ed, orient, dropped = tpair.stage_positions_dense(
            rs.positions, 40)
        for a, b in zip((pos, ed, orient, dropped),
                        jpair.stage_positions_dense(rs.positions, 40)):
            np.testing.assert_array_equal(a, b)
        staged.append((pos, ed, orient, np.full(40, L, np.int32)))
    args = [x for mate in staged for x in mate]
    scalars = (float(np.log(MATCH)), float(np.log(MISMATCH)), float(im),
               float(istd), tl, -0.7, -10.0)
    want = jpair.paired_score_device(*(jnp.asarray(a) for a in args),
                                     *scalars)
    got = tpair.paired_score_device(*(torch.from_numpy(a) for a in args),
                                    *scalars)
    assert int(got[1]) == int(want[1]) == host_zero
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got[0]), host_score, rtol=1e-5)

    model = tmodels.PairedEndModel(im, istd, match_prob=MATCH,
                                   mismatch_prob=MISMATCH, device="cpu")
    score, zeros, _ = model.score_positions(rs1.positions, rs2.positions,
                                            40, [L] * 40, [L] * 40, tl)
    assert zeros == host_zero
    np.testing.assert_allclose(score, host_score, rtol=1e-5)


def test_stage_positions_dense_drops_like_jax():
    positions = [[(5, (1, 0)), (9, (0, 1)), (30, (2, 1))], [],
                 [(2, (0, 0))]]
    for k_cap in (1, 2, 4):
        for a, b in zip(tpair.stage_positions_dense(positions, 4, k_cap),
                        jpair.stage_positions_dense(positions, 4, k_cap)):
            np.testing.assert_array_equal(a, b)


def jax_params(model):
    """(kind, params) of a JAX package model, read from its attributes,
    for the port's from_params."""
    keys = ["match_prob", "mismatch_prob", "min_prob_per_base",
            "min_prob_start"]
    kind = "base"
    if isinstance(model, jmodels.PairedEndModel):
        kind, keys = "paired", keys + ["insert_mean", "insert_std"]
    elif isinstance(model, jmodels.SingleEndModel):
        kind = "single"
    return kind, {k: getattr(model, k) for k in keys}


def test_from_jax_carries_the_configuration():
    """from_params on the parameters of each JAX model: the same class,
    configuration and scores."""
    kw = dict(match_prob=0.9, mismatch_prob=0.02, min_prob_per_base=-0.5,
              min_prob_start=-8.0)
    for jm, cls in ((jmodels.SingleEndModel(**kw), tmodels.SingleEndModel),
                    (jmodels.PairedEndModel(300, 30, **kw),
                     tmodels.PairedEndModel),
                    (jmodels.LikelihoodModel(**kw),
                     tmodels.LikelihoodModel)):
        tm = tmodels.from_params(*jax_params(jm), device="cpu")
        assert type(tm) is cls and isinstance(tm, torch.nn.Module)
        assert tm.device == torch.device("cpu")
        assert tmodels.from_params(*jax_params(jm)).device.type == "cuda"
        for k in list(kw) + ["log_match", "log_mismatch"]:
            assert getattr(tm, k) == getattr(jm, k), k
        if cls is tmodels.PairedEndModel:
            assert (tm.insert_mean, tm.insert_std) == (300, 30)
    seq, reads = noisy_world()
    idx = ReadIndexMaxHash()
    for i, c in enumerate(reads):
        idx.add_read(c, i)
    cands = gen_candidates(idx, dict(enumerate(reads)), seq)
    args = (seq, cands, len(reads), [len(r) for r in reads], len(seq))
    got = tmodels.from_params(*jax_params(jmodels.SingleEndModel(**kw)),
                              device="cpu").score_candidates(*args)
    want = tmodels.SingleEndModel(**kw, device="cpu").score_candidates(*args)
    with pytest.raises(ValueError):
        tmodels.from_params("pacbio", kw, device="cpu")
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


def test_floor_of_long_pairs_does_not_underflow(tmp_path):
    """Pairs of 100 bp mates, a few of which align nowhere: the floor
    exp(-10 - 0.7 * 200) underflows in float32, so the JAX reduction
    counts no floored pair and scores -inf (ROADMAP C10).  The port
    floors in log space and agrees with the float64 host scorer."""
    rng = np.random.default_rng(8)
    gr, seqs = make_linear_graph(rng, [900, 90, 800])
    L, im, istd = 100, 300, 30
    m1, m2 = make_pairs(rng, "".join(seqs), 30, L, im, istd)
    for i in range(3):  # mates from elsewhere
        m1[i], m2[i] = random_seq(rng, L), random_seq(rng, L)
    rs1 = make_readset(tmp_path, m1, "lp1")
    rs2 = make_readset(tmp_path, m2, "lp2")
    host_score, host_zero, tl = calc_score_for_paths_paired(
        gr, [[0, 2, 4]], rs1, rs2, im, istd)
    assert host_zero >= 3 and np.isfinite(host_score)
    args = (rs1.positions, rs2.positions, 30, [L] * 30, [L] * 30, tl)
    kw = dict(match_prob=MATCH, mismatch_prob=MISMATCH)
    score, zeros, _ = tmodels.PairedEndModel(
        im, istd, **kw, device="cpu").score_positions(*args)
    assert zeros == host_zero
    np.testing.assert_allclose(score, host_score, rtol=1e-5)
    j_score, j_zeros, _ = jmodels.PairedEndModel(im, istd,
                                                 **kw).score_positions(*args)
    assert j_zeros == 0 and j_score == -np.inf

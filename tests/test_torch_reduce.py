"""Per-read sums and the GetTotalProb reduction of the port's device
scorers (ops.score, ops.pair, ops.rescore_device, the models; CPU
tensors) against the float64 host reduction of the JAX package
(gaml_tpu.scoring.reduce.get_total_prob) on reads whose probabilities
lie below float32's range but above the log-space floor (ROADMAP C12):
score within 1e-9 relative, zero reads equal."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaml_tpu.core.logprob import gaussian_pdf
from gaml_tpu.scoring.reduce import get_total_prob
from gaml_tpu_torch import models as tmodels
from gaml_tpu_torch.ops import pair as tpair
from gaml_tpu_torch.ops import score as tscore
from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

from test_scoring import MATCH, MISMATCH

TOTAL_LEN = 2_800_000
MPB, MPS = -0.7, -10.0
MATE = 150
IM, ISTD = 180, 20
# (errors per mate, insert offset in sd) of the five pairs: with few
# errors and an insert 11-17 sd off, a pair's p / (2 total_len) lies
# below 2^-149 while its log stays above the floor of -220
PAIRS = ((1, 1), (3, 8), (3, 12), (6, 10), (6, 14))


def five_pair_world():
    """Dense position arrays [5, 1] of the five pairs (mate 1 forward at
    1000 + 5000 i, mate 2 reverse at the insert's end) and the float64
    host's (score, zero_reads) over them."""
    n = len(PAIRS)
    pos1 = np.array([[1000 + 5000 * i] for i in range(n)], np.int32)
    ins = np.array([IM + off * ISTD for _e, off in PAIRS])
    pos2 = pos1 + (ins - MATE)[:, None].astype(np.int32)
    ed = np.array([[e] for e, _off in PAIRS], np.int32)
    probs = np.array([(MISMATCH ** e * MATCH ** (MATE - e)) ** 2
                      * float(gaussian_pdf(d, IM, ISTD))
                      for (e, _off), d in zip(PAIRS, ins)])
    lens = np.full(n, 2 * MATE)
    host = get_total_prob(probs, TOTAL_LEN, MPB, MPS, lens)
    logs = np.log(probs / (2 * TOTAL_LEN))
    assert host[1] == 0 and (logs < math.log(2.0 ** -149)).sum() >= 3
    arrays = (pos1, ed, np.zeros_like(pos1), np.full(n, MATE, np.int32),
              pos2, ed, np.ones_like(pos1), np.full(n, MATE, np.int32))
    return arrays, host


@pytest.mark.parametrize("route", ["paired_score_device",
                                   "PairedEndModel.score_positions"])
def test_five_pairs_below_float32_match_f64_host(route):
    arrays, (h_score, h_zeros) = five_pair_world()
    if route == "paired_score_device":
        score, zeros, probs = tpair.paired_score_device(
            *(torch.from_numpy(a) for a in arrays), math.log(MATCH),
            math.log(MISMATCH), float(IM), float(ISTD), TOTAL_LEN, MPB,
            MPS)
        score, zeros = float(score), int(zeros)
        assert probs.dtype == torch.float64 and bool((probs > 0).all())
    else:
        pos1, ed1, or1, len1, pos2, ed2, or2, len2 = arrays
        positions = [[[(int(p[i, 0]), (int(e[i, 0]), int(o[i, 0])))]
                      for i in range(len(PAIRS))]
                     for p, e, o in ((pos1, ed1, or1), (pos2, ed2, or2))]
        model = tmodels.PairedEndModel(IM, ISTD, match_prob=MATCH,
                                       mismatch_prob=MISMATCH,
                                       min_prob_per_base=MPB,
                                       min_prob_start=MPS, device="cpu")
        score, zeros, _ = model.score_positions(
            *positions, len(PAIRS), len1, len2, TOTAL_LEN)
    assert zeros == h_zeros == 0
    assert abs(score - h_score) <= 1e-9 * abs(h_score)


def long_single_reads(seed=3, n_reads=12, L=250):
    """Alignments of 250 bp reads with 0-6 errors, a few candidates a
    read (duplicates of a (read, begin) among them, some not ok, three
    reads with none), in the rescore's emission order (grouped by read),
    and the float64 host's (score, zero_reads) over the first-wins
    alignments."""
    rng = np.random.default_rng(seed)
    rid, begin, errs, ok = [], [], [], []
    for r in range(n_reads - 3):
        for _ in range(int(rng.integers(1, 5))):
            rid.append(r)
            begin.append(int(rng.integers(0, 4)) * 100 + r)
            errs.append(int(rng.integers(0, 7)))
            ok.append(bool(rng.random() < 0.85))
    probs, seen = np.zeros(n_reads), set()
    for r, b, e, k in zip(rid, begin, errs, ok):
        if k and (r, b) not in seen:
            seen.add((r, b))
            probs[r] += MISMATCH ** e * MATCH ** (L - e)
    host = get_total_prob(probs, TOTAL_LEN, MPB, MPS, np.full(n_reads, L))
    assert host[1] >= 3 and len(seen) < sum(ok)
    t = [torch.tensor(x) for x in (rid, begin, errs, ok)]
    return t, n_reads, L, host


@pytest.mark.parametrize("route", ["candidates_to_score",
                                   "DeviceRescorer.score"])
def test_long_single_reads_match_f64_host(route):
    (rid, begin, errs, ok), n_reads, L, (h_score, h_zeros) = \
        long_single_reads()
    n = len(rid)
    lens = torch.full((n_reads,), L, dtype=torch.int32)
    args = (math.log(MATCH), math.log(MISMATCH), TOTAL_LEN, MPB, MPS)
    if route == "candidates_to_score":
        score, zeros, probs = tscore.candidates_to_score(
            ok, errs.to(torch.int32), begin.to(torch.int32),
            torch.ones(n, dtype=torch.bool), rid.to(torch.int32),
            torch.full((n,), L, dtype=torch.int32), lens, *args, n_reads)
        score, zeros = float(score), int(zeros)
        assert probs.dtype == torch.float64
    else:
        resc = object.__new__(DeviceRescorer)
        resc.n_reads, resc.lens = n_reads, lens
        resc.device = torch.device("cpu")
        c = SimpleNamespace(seg=torch.zeros(n, dtype=torch.int64), rid=rid,
                            n_total=n)
        score, zeros, n_tot = resc.score(c, (ok, errs.to(torch.int32),
                                             begin.to(torch.int32)), *args)
        assert n_tot == n
    assert zeros == h_zeros
    assert abs(score - h_score) <= 1e-9 * abs(h_score)

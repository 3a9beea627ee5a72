"""The port's exact band DP (gaml_tpu_torch.ops.extend_cuda.dp_rows_exact,
the counterpart of K3/K4a/K4b), its staging and the extension routes
built on it, against the JAX package: Pallas kernels in interpret mode,
the jnp extension kernel, and the batch helpers of gaml_tpu.ops.extend."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gaml_tpu.ops.extend as jext
from gaml_tpu.core import dna
from gaml_tpu.ops.extend_pallas import (BLOCK_CANDS, block_bounds,
                                        block_layout, dp_rows_pallas,
                                        dp_rows_pallas_reg_dyn,
                                        extend_kernel_pallas)
from gaml_tpu_torch.ops import extend as text
from gaml_tpu_torch.ops.extend_cuda import (dp_rows_exact,
                                            dp_rows_exact_ref,
                                            extend_kernel_exact)
from gaml_tpu_torch.ops.extend_device import (batch_extend_arrays,
                                              batch_extend_host,
                                              batch_extend_multi,
                                              extend_staged)

from fixtures import random_seq
from test_extend_kernel import random_case, seeds_of
from test_torch_kernels import random_band_inputs


def exact_ref(read, gwin, rlen, glen):
    c, a = dp_rows_exact_ref(*(torch.from_numpy(x) for x in
                               (read, gwin, rlen, glen)))
    return c.numpy(), a.numpy()


@pytest.mark.parametrize("route", ["K4a", "K4b"])
def test_exact_ref_matches_k4(route):
    """dp_rows_exact_ref against dp_rows_pallas at
    test_extend_pallas.py::test_reg_kernel_matches_sublane_kernel's seed
    and shape (with sentinels): the sublane kernel (K4a, width 128) and
    its default register route at n % 1024 == 0 (K4b).  c and a equal
    everywhere."""
    read, gwin, rlen, glen = random_band_inputs(3, 2048, 32)
    args = (jnp.asarray(read.astype(np.int32)),
            jnp.asarray(gwin.astype(np.int32)), jnp.asarray(rlen[None]),
            jnp.asarray(glen[None]))
    width = 128 if route == "K4a" else 0
    c_j, a_j = dp_rows_pallas(*args, 32, interpret=True, width=width)
    c, a = exact_ref(read, gwin, rlen, glen)
    assert (c > 7).sum() > 100  # the exact costs are not saturated
    np.testing.assert_array_equal(c, np.asarray(c_j))
    np.testing.assert_array_equal(a, np.asarray(a_j))


def test_exact_ref_matches_k3():
    """Against dp_rows_pallas_reg_dyn (K3) with its block layout and
    per-block row bounds (tests/test_device_candgen.py::
    test_sorted_dynamic_kernels_bit_exact): c and a equal everywhere."""
    n, rmax = BLOCK_CANDS, 32
    read, gwin, rlen, glen = random_band_inputs(0, n, rmax)
    order = np.argsort(rlen, kind="stable")
    perm = order[block_layout(n)]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    c_j, a_j = dp_rows_pallas_reg_dyn(
        jnp.asarray(read[:, perm].astype(np.int32)),
        jnp.asarray(gwin[:, perm].astype(np.int32)),
        jnp.asarray(rlen[perm]), jnp.asarray(glen[perm]), rmax,
        jnp.asarray(block_bounds(rlen[order])), interpret=True)
    c, a = exact_ref(read, gwin, rlen, glen)
    np.testing.assert_array_equal(c, np.asarray(c_j)[inv])
    np.testing.assert_array_equal(a, np.asarray(a_j)[inv])


def test_dp_rows_exact_takes_plain_version_on_cpu_and_checks_inputs():
    read, gwin, rlen, glen = (torch.from_numpy(x) for x in
                              random_band_inputs(4, 500, 40))
    for got, want in zip(dp_rows_exact(read, gwin, rlen, glen),
                         dp_rows_exact_ref(read, gwin, rlen, glen)):
        assert got.dtype == torch.int32
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        dp_rows_exact(read, gwin.to(torch.int32), rlen, glen)
    with pytest.raises(ValueError):
        dp_rows_exact(read, gwin, rlen[:-1], glen)
    with pytest.raises(ValueError):
        dp_rows_exact(read[:, ::2], gwin[:, ::2], rlen[::2], glen[::2])


def pallas_world(seed, n_reads=40):
    """test_extend_pallas.py::test_pallas_matches_jnp's candidates: reads
    with indels and substitutions seeded in one 350 bp window."""
    rng = np.random.default_rng(seed)
    seq = dna.encode_seq(random_seq(rng, 350))
    g0s, r0s, reads = [], [], []
    for _ in range(n_reads):
        read = random_case(rng, seq)
        seeds = seeds_of(read, seq)
        if not seeds:
            continue
        g0, r0 = seeds[int(rng.integers(0, len(seeds)))]
        g0s.append(g0)
        r0s.append(r0)
        reads.append(read)
    return seq, np.array(g0s, np.int32), np.array(r0s, np.int32), reads


@pytest.mark.parametrize("seed", range(4))
def test_extend_kernel_exact_matches_pallas(seed):
    """Both directions of the JAX staged dict in one stacked launch,
    against extend_kernel_pallas (interpret): ok and errs equal
    everywhere, d equal where ok; the plain extend_kernel equals the jnp
    extend_kernel the same way."""
    seq, g0s, r0s, reads = pallas_world(seed)
    st = jext.stage_candidates(seq, g0s, r0s, reads)
    ok_p, errs_p, d_p = extend_kernel_pallas(st, interpret=True)
    ok, errs, d = (t.numpy() for t in extend_kernel_exact(st))
    np.testing.assert_array_equal(ok, ok_p)
    np.testing.assert_array_equal(errs, errs_p)
    np.testing.assert_array_equal(d[ok], d_p[ok])

    views = [st[k] for k in ("read_f", "rlen_f", "gwin_f", "glen_f",
                             "read_b", "rlen_b", "gwin_b", "glen_b")]
    ok_j, errs_j, d_j = (np.asarray(x) for x in jext.extend_kernel(
        *(jnp.asarray(v) for v in views), st["rmax"]))
    ok_t, errs_t, d_t = (x.numpy() for x in text.extend_kernel(
        *(torch.from_numpy(v) for v in views), st["rmax"]))
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(errs_t, errs_j)
    np.testing.assert_array_equal(d_t[ok_t], d_j[ok_t])


def mixed_windows(seed=6, n_windows=4):
    """Several windows and, per window, candidates of mixed read lengths
    with indels, a quarter of them with too many substitutions to align
    (the no-bundle aligner's batch form)."""
    rng = np.random.default_rng(seed)
    seqs, seq_idx, g0s, r0s, reads, rids = [], [], [], [], [], []
    for w in range(n_windows):
        seq = dna.encode_seq(random_seq(rng, int(rng.integers(200, 420))))
        seqs.append(seq)
        while len(reads) < 30 * (w + 1):
            read = random_case(rng, seq)
            seeds = seeds_of(read, seq)
            if seeds:
                g0, r0 = seeds[int(rng.integers(0, len(seeds)))]
                if len(reads) % 4 == 3:  # too many errors outside the seed
                    read = read.copy()
                    far = np.setdiff1d(np.arange(len(read)),
                                       np.arange(r0, r0 + 15))
                    hit = rng.choice(far, min(8, len(far)), replace=False)
                    read[hit] = (read[hit] + 1) % 4
                seq_idx.append(w)
                g0s.append(g0)
                r0s.append(r0)
                reads.append(read)
                rids.append(len(rids) % 17)
    return (seqs, np.array(seq_idx, np.int32), np.array(g0s, np.int32),
            np.array(r0s, np.int32), reads, np.array(rids, np.int32))


@pytest.mark.parametrize("multi", [False, True])
def test_stage_candidates_matches_jax(multi):
    """The port's staged dict equals the JAX package's, array for array,
    at the JAX shapes (rmax and nb rounded up for the TPU)."""
    seqs, seq_idx, g0s, r0s, reads, rids = mixed_windows()
    if multi:
        kw = dict(seq_idx=seq_idx)
        seq = seqs
    else:
        keep = seq_idx == 0
        seq, kw = seqs[0], {}
        g0s, r0s, rids = g0s[keep], r0s[keep], rids[keep]
        reads = [r for r, k in zip(reads, keep) if k]
    want = jext.stage_candidates(seq, g0s, r0s, reads, read_ids=rids, **kw)
    got = text.stage_candidates(seq, g0s, r0s, reads, rmax=want["rmax"],
                                nb=len(want["valid"]), read_ids=rids,
                                device="cpu", **kw)
    assert len({len(r) for r in reads}) > 1
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            g = got[k].numpy()
            assert g.dtype == v.dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            assert got[k] == v, k
    # the default shapes (no TPU rounding) stage the same rows
    small = text.stage_candidates(seq, g0s, r0s, reads, device="cpu", **kw)
    ok, errs, begin = extend_staged(small)
    ok_w, errs_w, begin_w = extend_staged(got)
    np.testing.assert_array_equal(ok, ok_w)
    np.testing.assert_array_equal(errs[ok], errs_w[ok])
    np.testing.assert_array_equal(begin[ok], begin_w[ok])


def test_batch_extend_routes_match_jax():
    """batch_extend_multi / batch_extend_arrays / batch_extend_host on a
    multi-window, mixed-length batch with indels, against the JAX
    functions (jnp route): ok equal, errs and begin equal where ok."""
    seqs, seq_idx, g0s, r0s, reads, _rids = mixed_windows(seed=9)
    ok, errs, begin = batch_extend_multi(seqs, seq_idx, g0s, r0s, reads,
                                         "cpu")
    ok_j, errs_j, begin_j = jext.batch_extend_multi(
        seqs, seq_idx, g0s, r0s, reads, use_pallas=False)
    assert ok.sum() > 0 and (~ok).sum() > 0
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(errs[ok], errs_j[ok])
    np.testing.assert_array_equal(begin[ok], begin_j[ok])

    w0 = seq_idx == 0
    reads0 = [r for r, k in zip(reads, w0) if k]
    ok, errs, begin = batch_extend_arrays(seqs[0], g0s[w0], r0s[w0], reads0,
                                          "cpu")
    ok_j, errs_j, begin_j = jext.batch_extend_arrays(seqs[0], g0s[w0],
                                                     r0s[w0], reads0)
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(errs[ok], errs_j[ok])
    np.testing.assert_array_equal(begin[ok], begin_j[ok])

    from gaml_tpu.align.aligner import Candidate

    cands = [(Candidate(i, int(g), int(r), 0), rd) for i, (g, r, rd) in
             enumerate(zip(g0s[w0], r0s[w0], reads0))]
    got = batch_extend_host(seqs[0], cands, "cpu")
    want = jext.batch_extend_host(seqs[0], cands)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g for g in got if g[0]] == [w for w in want if w[0]]
    for out in (batch_extend_multi([], [], [], [], [], "cpu"),
                batch_extend_arrays(seqs[0], [], [], [], "cpu")):
        assert [len(x) for x in out] == [0, 0, 0]

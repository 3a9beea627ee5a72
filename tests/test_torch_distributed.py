"""The port's multi-process scoring over torch.distributed on the CPU
(gloo): parallel/distributed.py against gaml_tpu's, the read-sharded
scorers through gaml_tpu_torch.tools.dryrun_distributed at worlds 1, 2
and 3 (bit-equal merged results, held to the JAX package's single-process
values as tests/test_multiprocess.py holds its two processes), and the
CLI's --distributed wiring and traces."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_multiprocess as jmp
from gaml_tpu.parallel import distributed as jdist
from gaml_tpu_torch.parallel import distributed
from gaml_tpu_torch.tools import dryrun_distributed as dryrun

from test_torch_cli import itnum_lines, write_pacbio_world, write_world
from test_torch_kernels import port_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for one process group, then every rank is killed


@pytest.fixture(scope="module")
def reports():
    """The dry run's reports at worlds 1, 2 and 3 (an uneven partition:
    16 single-end reads and 8 forward jobs over 3 ranks), on the CPU."""
    return {w: dryrun.launch(w, backend="gloo", device="cpu",
                             timeout=TIMEOUT) for w in (1, 2, 3)}


def merged(report):
    """A report's merged results that hold at every world (the partial
    sums of combine_partials are added in rank order: another association
    at another world)."""
    return {k: v for k, v in report.items()
            if k not in dryrun.LOCAL_KEYS + ("world", "partials")}


@pytest.mark.parametrize("n_reads", [0, 1, 5, 16, 40, 41])
def test_reads_for_process_equals_jax(n_reads):
    for world in range(1, 6):
        parts = []
        for pid in range(world):
            got = distributed.reads_for_process(n_reads, pid, world)
            assert got == jdist.reads_for_process(n_reads, pid, world)
            parts += got
        assert parts == list(range(n_reads))


def test_read_range_without_a_group_is_every_read():
    assert distributed.world() == (0, 1)
    assert distributed.read_range(7) == (0, 7)
    t = torch.arange(7.0)
    assert distributed.gather_read_values(t, 7) is t


@pytest.mark.parametrize("world", [1, 2])
def test_combine_partials_equals_the_combined_sum(reports, world):
    """tests/test_distributed.py's world: the partial sums of each rank's
    reads, combined, give every read's sum (float64, rel 1e-12), zero
    count and count; without a group the local values come back."""
    log_probs = np.random.default_rng(42).normal(-20.0, 3.0, 40)
    for rep in reports[world]:
        s, z, c = rep["partials"]
        assert (z, c) == (int((log_probs < -24).sum()), 40)
        assert s == pytest.approx(float(log_probs.sum()), rel=1e-12)
    assert distributed.combine_partials(-3.5, 2, 7) == (-3.5, 2, 7)


@pytest.mark.parametrize("world", [2, 3])
def test_dryrun_bit_equal_to_world_one(reports, world):
    """Every rank's merged single-end, paired full (with its merged event
    positions), paired incremental, device-state and PacBio results and
    forward values equal a world of one's bit for bit (the launcher has
    checked that the ranks agree); each rank scored its own reads."""
    one = merged(reports[1][0])
    reps = reports[world]
    assert [r["rank"] for r in reps] == list(range(world))
    for rep in reps:
        assert rep["world"] == world and rep["foreign_modules"] == []
        assert merged(rep) == one
    for key, n in (("single_end", dryrun.N_READS),
                   ("paired", dryrun.PAIRED_N_READS),
                   ("pacbio", dryrun.PB_N_READS)):
        for r, rep in enumerate(reps):
            lo, hi = rep["reads"][key]
            assert list(range(lo, hi)) == distributed.reads_for_process(
                n, r, world)
    for r, rep in enumerate(reps):
        lo, hi = rep["fwd_jobs"]
        assert list(range(lo, hi)) == distributed.reads_for_process(
            dryrun.PB_FWD_JOBS, r, world)


def host_paired(steps):
    """The float64 host incremental scorer's (score, zero_reads) after
    ``steps`` = [(sign, bucket)]: each bucket's walks in order through
    the host's native pair loop (gaml_tpu.native.paired_inc_pairs2, the
    pairs of a read in the host's order), added with np.add.at."""
    from gaml_tpu.core.logprob import insert_prob_table
    from gaml_tpu.native import paired_inc_pairs2
    from gaml_tpu.scoring.reduce import get_total_prob

    n, L = dryrun.PAIRED_N_READS, dryrun.PAIRED_L
    m, mm = (np.power(p, np.arange(L + 1, dtype=np.float64))
             for p in (dryrun.MATCH, dryrun.MISMATCH))
    lens = np.full(n, L, np.int32)
    table = insert_prob_table(dryrun.PAIRED_IM, dryrun.PAIRED_ISTD)
    probs = np.zeros(n)
    for sign, b in steps:
        for w in np.unique(b["walk"]).tolist():
            rows = np.flatnonzero(b["walk"] == w)
            rows = rows[np.argsort(b["rid"][rows], kind="stable")]

            def grouped(mate):
                pos = b["pos" + mate][rows]
                cnt = (pos >= 0).sum(1).astype(np.int32)
                keep = pos >= 0
                st = np.zeros(len(rows), np.int64)
                st[1:] = np.cumsum(cnt[:-1])
                return (b["rid"][rows].astype(np.int32), st, cnt,
                        pos[keep].astype(np.int32),
                        b["ed" + mate][rows][keep].astype(np.int32),
                        b["or" + mate][rows][keep].astype(np.int32))

            p, rid, _ev, _typ = paired_inc_pairs2(
                grouped("1"), grouped("2"), lens, lens, m, mm, m, mm, table,
                float(dryrun.PAIRED_IM), float(dryrun.PAIRED_ISTD),
                dryrun.MPS, dryrun.MPB, True)
            np.add.at(probs, rid, sign * p)
    return get_total_prob(probs, dryrun.PAIRED_TOTAL_LEN, dryrun.MPB,
                          dryrun.MPS, np.full(n, 2.0 * L))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_dryrun_within_jax_single_process(reports, world):
    """tests/test_multiprocess.py's single-process JAX values (float32):
    rel 1e-6, zero reads equal.  The paired incremental (+A +B -B) holds
    the float64 host scorer (host_paired: rel 1e-12, zero reads equal)
    instead of JAX's 2e-5: the port adds pair by pair in the host's order,
    so a read of B only keeps the host's rounding residue of its +B -B,
    which the floor keeps (7 zero reads), where JAX's per-walk float32
    sums cancel to 0 and floor it (8).  The paired full rescore holds both.
    The forward values hold the JAX forward at the K5 tolerance (rtol
    1e-4, atol 1e-3) and each rank's jobs its plain version (checked in
    the rank).  JAX has no DeviceScoringState in that test: the device
    state holds the float64 host instead (np.add.at, get_total_prob), bit
    for bit and rel 1e-12."""
    import jax.numpy as jnp

    from gaml_tpu.ops.forward import banded_forward
    from gaml_tpu.scoring.reduce import get_total_prob

    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    rep = reports[world][0]
    for key, (score, zeros), rel in (
            ("single_end", jmp._single_process_expected(), 1e-6),
            ("paired", jmp._single_process_paired_expected(), 1e-6),
            ("paired", host_paired([(1.0, dryrun.paired_rows())]), 1e-12),
            ("paired_inc", host_paired([
                (1.0, dryrun.paired_rows(0, dryrun.PAIRED_BLK)),
                (1.0, dryrun.paired_rows(dryrun.PAIRED_BLK,
                                         dryrun.PAIRED_BLK)),
                (-1.0, dryrun.paired_rows(dryrun.PAIRED_BLK,
                                          dryrun.PAIRED_BLK))]), 1e-12),
            ("pacbio", jmp._single_process_pacbio_expected(), 1e-6)):
        assert rep[key][1] == zeros, key
        assert rep[key][0] == pytest.approx(score, rel=rel), key
    genome, reads, rlens, centers, gstarts, glens = \
        dryrun.pb_forward_world()
    want = np.asarray(banded_forward(
        *(jnp.asarray(a) for a in (genome, reads, rlens, centers, gstarts,
                                   glens)), jnp.float32(dryrun.PB_FWD_LM),
        jnp.float32(dryrun.PB_FWD_LMM), dryrun.PB_FWD_RMAX,
        dryrun.PB_FWD_WIDTH))
    np.testing.assert_allclose(rep["fwd_vals"], want, rtol=dryrun.FWD_RTOL,
                               atol=dryrun.FWD_ATOL)
    host = np.zeros(dryrun.PAIRED_N_READS)
    for rids, deltas, sign in dryrun.state_chunks():
        np.add.at(host, rids, sign * deltas)
    assert rep["device_state_totals"] == host.tolist()
    s, z = get_total_prob(host, 50_000, dryrun.MPB, dryrun.MPS,
                          np.full(dryrun.PAIRED_N_READS,
                                  2.0 * dryrun.PAIRED_L))
    assert rep["device_state"][1] == z
    assert rep["device_state"][0] == pytest.approx(s, rel=1e-12)


def test_nccl_refuses_ranks_sharing_a_card():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card per rank"):
        distributed.initialize("127.0.0.1:1", n + 1, 0, backend="nccl",
                               device="cuda")
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------------- CLI
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, cfg, extra, world, env_extra=None):
    """``world`` processes of the port's CLI on the CPU under
    --distributed; returns their stdouts in rank order (every rank is
    killed when one fails or outlives TIMEOUT)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, GAML_NPROC=str(world), GAML_PROC_ID=str(rank),
                   PYTHONPATH=REPO, **(env_extra or {}))
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gaml_tpu_torch.cli", cfg, "--device",
             "cpu", "--distributed", f"127.0.0.1:{port}", *extra],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def summary(text):
    return json.loads(text.strip().splitlines()[-1].split(
        "device work: ", 1)[1])


@pytest.mark.parametrize("flag", ["--paired-device-inc", "--device-state",
                                  "--paired-device", "--pacbio-device"])
def test_cli_two_ranks_trace_equals_world_one(tmp_path, flag, monkeypatch,
                                              capsys):
    """Two ranks of `gaml_tpu_torch.cli --distributed` give the same itnum
    trace as each other and as one process with the flag, and only rank 0
    writes outputs, the same .walks.  The paired libraries carry a
    coverage penalty, so the merged event positions feed the sweeps."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    from gaml_tpu_torch.cli import main

    env = {"GAML_PB_DEVICE_MIN_CELLS": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if flag == "--pacbio-device":
        one = write_pacbio_world(tmp_path)
        text = open(one).read()
        two = one.replace("pb.cfg", "pb2.cfg")
        open(two, "w").write(text.replace("pbout", "two").replace(
            "pbcache", "twocache"))
        walks = [tmp_path / "pbout.walks", tmp_path / "two.walks"]
    else:
        config = write_world(tmp_path, iterations=12)
        one, two = config("one"), config("two")
        for cfg in (one, two):
            with open(cfg, "a") as f:
                f.write("penalty_constant=0.0001\npenalty_step=100\n")
        walks = [tmp_path / "one.walks", tmp_path / "two.walks"]
    monkeypatch.chdir(tmp_path)
    assert main([one, "--device", "cpu", flag]) == 0
    want = itnum_lines(capsys.readouterr().out)
    assert len(want) >= 8
    outs = run_ranks(tmp_path, two, [flag], 2, env)
    for rank, out in enumerate(outs):
        assert itnum_lines(out) == want, rank
        s = summary(out)
        assert (s["rank"], s["world"]) == (rank, 2)
    assert walks[1].read_bytes() == walks[0].read_bytes()


def test_cli_only_rank_zero_writes(tmp_path):
    """Two ranks without a scorer flag each run the whole anneal (the same
    trace); only rank 0 writes outputs: rank 1, given its own output
    prefix, leaves it empty."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    config = write_world(tmp_path, iterations=3)
    cfgs = [config("r0"), config("r1")]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gaml_tpu_torch.cli", cfgs[rank], "--device",
         "cpu", "--backend", "bfs", "--distributed", f"127.0.0.1:{port}"],
        cwd=tmp_path, env=dict(os.environ, GAML_NPROC="2",
                               GAML_PROC_ID=str(rank), PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert len(itnum_lines(outs[0])) >= 2
    assert itnum_lines(outs[0]) == itnum_lines(outs[1])
    assert (tmp_path / "r0.fasta").exists() and \
        (tmp_path / "r0.walks").exists()
    assert [p.name for p in tmp_path.glob("r1*")] == ["r1.cfg"]


def test_cli_distributed_wiring(tmp_path):
    """GAML_COORD with GAML_NPROC=1 and GAML_PROC_ID=0 initializes a
    group of one before the run (tests/test_multiprocess.py::
    test_cli_distributed_wiring on the port)."""
    if port_native_lib() is None:
        pytest.skip("native library unavailable")
    cfg = write_world(tmp_path, iterations=3)("out")
    env = dict(os.environ, GAML_COORD=f"127.0.0.1:{_free_port()}",
               GAML_NPROC="1", GAML_PROC_ID="0", PYTHONPATH=REPO)
    env.pop("PYTEST_CURRENT_TEST", None)
    proc = subprocess.run(
        [sys.executable, "-m", "gaml_tpu_torch.cli", cfg, "--device", "cpu",
         "--paired-device-inc"],
        env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "out.fasta").exists()
    assert (summary(proc.stdout)["rank"], summary(proc.stdout)["world"]) \
        == (0, 1)


@pytest.mark.parametrize("missing", ["GAML_NPROC", "GAML_PROC_ID"])
def test_cli_distributed_without_process_count_exits_1(tmp_path,
                                                        monkeypatch, capsys,
                                                        missing):
    from gaml_tpu_torch.cli import main

    cfg = write_world(tmp_path, iterations=1)("x")
    monkeypatch.setenv("GAML_NPROC", "2")
    monkeypatch.setenv("GAML_PROC_ID", "0")
    monkeypatch.delenv(missing)
    assert main([cfg, "--device", "cpu", "--distributed",
                 "127.0.0.1:1"]) == 1
    assert "requires GAML_NPROC and GAML_PROC_ID" in capsys.readouterr().err

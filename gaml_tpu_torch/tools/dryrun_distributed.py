"""Multi-process dry run of the port's read-sharded scorers.

    python -m gaml_tpu_torch.tools.dryrun_distributed --world 2 \
        [--backend gloo|nccl] [--device cuda|cuda:N|cpu] [--timeout S]

The launcher starts ``--world`` processes of this module with
``subprocess`` (never by fork: a CUDA context does not survive one), each
joining one process group over torch.distributed
(parallel/distributed.py).  Every process builds the same world from
fixed seeds with numpy and scores its own share of the reads:

- single-end: it indexes only its own reads, generates their candidates
  and stages its reads shard over two cells (parallel/sharded.py; one
  extend_exact_staged launch a cell on a card);
- paired full: the pair rows of its reads (parallel/paired_sharded.py),
  the per-read totals gathered and reduced, the event positions OR-merged;
- paired incremental: +A +B -B into its running totals (apply_buckets);
- DeviceScoringState: signed (read, delta) chunks of every read, of which
  it keeps its own;
- the PacBio reduction: the (read, logprob) rows of its reads;
- the PacBio forward DP: the jobs of its reads (K5 on a card), each held
  to the plain version over all jobs.

Each process writes a JSON report (its results, its kernel launches and
the modules of jax or gaml_tpu it holds, which must be none).  The
launcher checks that every process exited 0, holds no such module and
reports the same merged results, and prints them; ``launch`` returns the
reports.  The worlds are those of tests/mp_common.py and
tests/test_distributed.py, so the JAX package's single-process values
can be held against them.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

# per-process keys (everything else is a merged result that every
# process must agree on)
LOCAL_KEYS = ("rank", "reads", "fwd_jobs", "fwd_max_err", "launches",
              "foreign_modules", "device")
MPB, MPS = -0.7, -10.0

# single-end (tests/mp_common.py)
GENOME_LEN, N_READS, READ_LEN, RMAX = 400, 16, 24, 32
MATCH, MISMATCH = 0.96, 0.01
N_CELLS = 2
# paired rows
PAIRED_ROWS, PAIRED_K, PAIRED_L = 32, 4, 30
PAIRED_IM, PAIRED_ISTD, PAIRED_N_READS, PAIRED_TOTAL_LEN = 200, 20, 24, 1000
PAIRED_BLK = PAIRED_ROWS // 2
# PacBio rows and forward jobs
PB_ROWS, PB_N_READS, PB_READ_LEN, PB_TOTAL_LEN = 32, 12, 500.0, 2000.0
PB_FWD_JOBS, PB_FWD_RMAX, PB_FWD_WIDTH, PB_FWD_GLEN = 8, 64, 64, 300
PB_FWD_LM, PB_FWD_LMM = float(np.log(0.9)), float(np.log(0.03))
# K5's tolerance against its plain version (chip_smoke.py phase 5)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-3


# ------------------------------------------------------------------ world
def single_end_world(seed=1):
    """(genome codes, read strings): tests/mp_common.py::build_world."""
    from ..core import dna

    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, GENOME_LEN))
    reads = []
    for _ in range(N_READS):
        p = int(rng.integers(0, GENOME_LEN - READ_LEN + 1))
        reads.append(genome[p:p + READ_LEN])
    return dna.encode_seq(genome), reads


def paired_rows(offset=0, n=PAIRED_ROWS):
    """Pair rows [offset, offset + n) of tests/mp_common.py::
    paired_row_block, with the port's bucket keys: walk = row // n_reads
    (rows of one read in different walks), off1 = off2 = 0 and n2 the
    row's mate-2 count (no row is split)."""
    rng = np.random.default_rng(99)
    b = {k: np.full((PAIRED_ROWS, PAIRED_K), -1 if k.startswith("pos")
                    else 0, np.int32)
         for k in ("pos1", "ed1", "or1", "pos2", "ed2", "or2")}
    for i in range(PAIRED_ROWS):
        p = int(rng.integers(0, 500))
        k = int(rng.integers(1, PAIRED_K + 1))
        b["pos1"][i, :k] = p + np.arange(k)
        b["ed1"][i, :k] = rng.integers(0, 3, k)
        b["pos2"][i, :k] = p + PAIRED_IM - PAIRED_L + np.arange(k)
        b["ed2"][i, :k] = rng.integers(0, 3, k)
        b["or2"][i, :k] = 1
    rows = np.arange(PAIRED_ROWS)
    b.update(rid=(rows % PAIRED_N_READS).astype(np.int32),
             walk=(rows // PAIRED_N_READS).astype(np.int32),
             len1=np.full(PAIRED_ROWS, PAIRED_L, np.int32),
             len2=np.full(PAIRED_ROWS, PAIRED_L, np.int32),
             mask=np.ones(PAIRED_ROWS, bool),
             off1=np.zeros(PAIRED_ROWS, np.int32),
             off2=np.zeros(PAIRED_ROWS, np.int32),
             n2=(b["pos2"] >= 0).sum(1).astype(np.int32))
    return {k: v[offset:offset + n] for k, v in b.items()}


def local_rows(bucket, lo, hi):
    """The rows of reads [lo, hi), in order, their rid rebased to lo, as
    a list of buckets: none when there are no such rows (staging makes
    no empty bucket)."""
    keep = (bucket["rid"] >= lo) & (bucket["rid"] < hi)
    out = {k: v[keep] for k, v in bucket.items()}
    out["rid"] = out["rid"] - lo
    return [out] if keep.any() else []


def pacbio_rows():
    """(rid, logprob) alignment rows: tests/mp_common.py::pacbio_rows."""
    rng = np.random.default_rng(123)
    rid = rng.integers(0, PB_N_READS, PB_ROWS).astype(np.int64)
    lp = (-rng.random(PB_ROWS) * 200.0 - 50.0).astype(np.float32)
    return rid, lp.astype(np.float64)


def pb_forward_world():
    """The forward-DP job batch of tests/mp_common.py::pb_forward_world
    (genome, reads, rlens, centers, gstarts, glens); job i is read i's."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, PB_FWD_GLEN).astype(np.uint8)
    reads = np.full((PB_FWD_JOBS, PB_FWD_RMAX), 6, np.uint8)
    rlens = np.zeros(PB_FWD_JOBS, np.int32)
    centers = np.zeros((PB_FWD_JOBS, PB_FWD_RMAX + 1), np.int32)
    gstarts = np.zeros(PB_FWD_JOBS, np.int32)
    glens = np.full(PB_FWD_JOBS, PB_FWD_GLEN, np.int32)
    for i in range(PB_FWD_JOBS):
        n = int(rng.integers(40, PB_FWD_RMAX + 1))
        p = int(rng.integers(0, PB_FWD_GLEN - PB_FWD_RMAX - 1))
        r = genome[p:p + n].copy()
        errs = rng.random(n) < 0.1
        r[errs] = (r[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
        reads[i, :n] = r
        rlens[i] = n
        centers[i] = np.minimum(p + np.arange(PB_FWD_RMAX + 1),
                                PB_FWD_GLEN - 1)
    return genome, reads, rlens, centers, gstarts, glens


def state_chunks(seed=9):
    """Signed (read ids, deltas, sign) chunks over PAIRED_N_READS reads,
    one read driven to exactly 0 (it floors)."""
    rng = np.random.default_rng(seed)
    chunks = [(np.array([3, 5, 5]), np.array([1e-6, 0.3, 0.4]), 1),
              (np.array([3]), np.array([1e-6]), -1)]
    for step in range(5):
        k = int(rng.integers(1, 60))
        chunks.append((rng.integers(0, PAIRED_N_READS, k), rng.random(k)
                       * 1e-6, 1 if step % 3 != 2 else -1))
    return chunks


def partial_sums_world(seed=42, n=40):
    """tests/test_distributed.py's per-read log probabilities."""
    return np.random.default_rng(seed).normal(-20.0, 3.0, n)


# ------------------------------------------------------------------- rank
def score_world(device) -> Dict:
    """This process's share of every scorer, merged over the group."""
    import torch

    from ..align.aligner import gen_candidates
    from ..core import dna
    from ..index.maxhash import ReadIndexMaxHash
    from ..ops.forward import banded_forward
    from ..ops.forward_device import ForwardDeviceEngine
    from ..parallel import distributed, paired_sharded, sharded
    from ..parallel.device_state import DeviceScoringState
    from ..parallel.pacbio_sharded import ShardedPacbioScorer
    from ..utils.metrics import LAUNCHES

    res: Dict = {}
    rank, size = distributed.world()

    # single-end: index and stage this process's reads only
    seq, reads = single_end_world()
    lo, hi = distributed.read_range(N_READS)
    idx = ReadIndexMaxHash()
    codes = {}
    for local, rid in enumerate(range(lo, hi)):
        codes[local] = dna.encode_seq(reads[rid])
        idx.add_read(codes[local], local)
    cands = [(c.read_id, c.genome_pos, c.read_pos, r)
             for c, r in gen_candidates(idx, codes, seq)]
    staged, lens_mask, n_local = sharded.stage_sharded(
        seq, [cands], RMAX, [np.full(hi - lo, READ_LEN)],
        world=(size, N_CELLS), device=device)
    score, zeros = sharded.sharded_single_end_score(
        staged, lens_mask, float(np.log(MATCH)), float(np.log(MISMATCH)),
        GENOME_LEN, MPB, MPS, RMAX, n_local, N_READS)
    res["single_end"] = [float(score), int(zeros)]
    res["reads"] = {"single_end": [lo, hi]}

    # paired full: this process's reads' pair rows, events OR-merged
    pows = [np.power(p, np.arange(PAIRED_L + 1, dtype=np.float64))
            for p in (MATCH, MISMATCH, MATCH, MISMATCH)]
    scorer = paired_sharded.ShardedPairedScorer(
        *pows, PAIRED_IM, PAIRED_ISTD, collect_events=True, device=device)
    lo, hi = distributed.read_range(PAIRED_N_READS)
    res["reads"]["paired"] = [lo, hi]
    buckets = local_rows(paired_rows(), lo, hi)
    local, flags = scorer.read_totals(buckets, hi - lo, MPB, MPS)
    lens = torch.full((PAIRED_N_READS,), 2.0 * PAIRED_L,
                      dtype=torch.float64, device=device)
    res["paired"] = list(scorer.reduce(
        distributed.gather_read_values(local, PAIRED_N_READS), lens,
        PAIRED_TOTAL_LEN, MPB, MPS))
    events = paired_sharded.merge_walk_events(
        paired_sharded._event_positions_by_walk(
            buckets, paired_sharded.fetch_flags(flags), True),
        [PAIRED_TOTAL_LEN] * 2)
    res["paired_events"] = {str(w): p for w, p in sorted(events.items())}

    # paired incremental: +A +B -B into this process's running totals
    state = DeviceScoringState(PAIRED_N_READS, lens.cpu().numpy(), device)
    blocks = {"A": local_rows(paired_rows(0, PAIRED_BLK), lo, hi),
              "B": local_rows(paired_rows(PAIRED_BLK, PAIRED_BLK), lo, hi)}
    for sign, which in ((1.0, "A"), (1.0, "B"), (-1.0, "B")):
        scorer.apply_buckets(state.probs, sign, blocks[which], MPB, MPS)
    res["paired_inc"] = list(state.reduce(PAIRED_TOTAL_LEN, MPB, MPS))

    # DeviceScoringState: every read's chunks, this process's kept
    state = DeviceScoringState(PAIRED_N_READS, lens.cpu().numpy(), device)
    for rids, deltas, sign in state_chunks():
        state.apply(rids, deltas, sign)
    res["device_state"] = list(state.reduce(50_000, MPB, MPS))
    res["device_state_totals"] = state.to_host().tolist()

    # PacBio reduction: the rows of this process's reads
    lo, hi = distributed.read_range(PB_N_READS)
    res["reads"]["pacbio"] = [lo, hi]
    rid, lp = pacbio_rows()
    mine = (rid >= lo) & (rid < hi)
    res["pacbio"] = list(ShardedPacbioScorer(device).score(
        rid[mine] - lo, lp[mine], PB_N_READS,
        np.full(PB_N_READS, PB_READ_LEN), PB_TOTAL_LEN, MPB, MPS))

    # PacBio forward DP: this process's reads' jobs, on its device
    genome, f_reads, rlens, centers, gstarts, glens = pb_forward_world()
    lo, hi = distributed.read_range(PB_FWD_JOBS)
    res["fwd_jobs"] = [lo, hi]
    sl = slice(lo, hi)
    engine = ForwardDeviceEngine(None, device)
    n = hi - lo
    mine = engine.run(engine.stage(
        genome, PB_FWD_RMAX, (centers[sl] - gstarts[sl, None]).reshape(-1),
        np.arange(n + 1) * (PB_FWD_RMAX + 1), gstarts[sl], glens[sl],
        rlens[sl], np.full(n, -1), np.zeros(n, np.uint8), f_reads[sl]),
        PB_FWD_LM, PB_FWD_LMM, PB_FWD_WIDTH) if n else np.zeros(0)
    plain = banded_forward(*(torch.from_numpy(a) for a in (
        genome, f_reads, rlens, centers, gstarts, glens)), PB_FWD_LM,
        PB_FWD_LMM, PB_FWD_RMAX, PB_FWD_WIDTH).numpy().astype(np.float64)
    err = np.abs(mine - plain[sl])
    if np.any(err > FWD_ATOL + FWD_RTOL * np.abs(plain[sl])):
        raise AssertionError(f"rank {rank}: forward jobs {mine} against "
                             f"the plain version {plain[sl]}")
    res["fwd_max_err"] = float(err.max(initial=0.0))
    res["fwd_vals"] = distributed.gather_read_values(
        torch.from_numpy(np.asarray(mine, dtype=np.float64)).to(device),
        PB_FWD_JOBS).cpu().tolist()

    # partial sums (tests/test_distributed.py's world)
    lp = partial_sums_world()
    lo, hi = distributed.read_range(len(lp))
    res["partials"] = list(distributed.combine_partials(
        float(lp[lo:hi].sum()), int((lp[lo:hi] < -24).sum()), hi - lo))

    res["launches"] = dict(LAUNCHES)
    return res


def rank_main(args) -> int:
    """One process of the group: score the world, write the report."""
    import torch

    from ..parallel import distributed

    rank, size = distributed.initialize(
        args.coord, args.world, args.rank, backend=args.backend,
        device=args.device)
    try:
        device = distributed.rank_device(args.device, rank)
        res = score_world(device)
        res.update(rank=rank, world=size,
                   backend=torch.distributed.get_backend(),
                   device=torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    finally:
        distributed.shutdown()
    res["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "gaml_tpu"))
    with open(args.out, "w") as f:
        json.dump(res, f)
    return 0


# --------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, backend: Optional[str] = None, device="cuda",
           timeout: float = 300.0, env=None) -> List[Dict]:
    """Run the dry run in ``world`` processes on ``device`` (each rank's
    card under ``cuda``) over ``backend`` (default: nccl on a card, gloo
    on the CPU); returns their reports in rank order.  Raises if a process fails or outlives ``timeout`` (all
    of them are killed then), holds a module of jax or gaml_tpu, or
    reports merged results that differ from rank 0's."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = _free_port()
    run_env = dict(os.environ if env is None else env)
    run_env["PYTHONPATH"] = repo + os.pathsep + run_env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="gaml_dryrun_") as d:
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gaml_tpu_torch.tools.dryrun_distributed",
             "--rank", str(r), "--world", str(world), "--coord",
             f"127.0.0.1:{port}", "--device", str(device), "--out", outs[r]]
            + (["--backend", backend] if backend else []),
            cwd=repo, env=run_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"rank {r} of {world} exited {p.returncode}:\n"
                  f"{log[-3000:]}"
                  for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        reports = []
        for out in outs:
            with open(out) as f:
                reports.append(json.load(f))
    for rep in reports:
        if rep["foreign_modules"]:
            raise RuntimeError(f"rank {rep['rank']} holds modules of jax or "
                               f"gaml_tpu: {rep['foreign_modules']}")
    merged = [{k: v for k, v in rep.items() if k not in LOCAL_KEYS}
              for rep in reports]
    for r, m in enumerate(merged[1:], 1):
        if m != merged[0]:
            raise RuntimeError(f"rank {r} merged {m}, rank 0 {merged[0]}")
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun_distributed")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="default: nccl on a card, gloo on the CPU")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this process of the group (the launcher "
                         "passes it with --coord and --out)")
    ap.add_argument("--coord", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    reports = launch(args.world, args.backend, args.device, args.timeout)
    print(json.dumps(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())

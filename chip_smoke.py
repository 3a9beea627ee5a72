#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from gaml_tpu_torch/csrc, then drives the port's
short-read rescore path and its long-read scoring path phase by phase,
each phase printing its results and seconds.  Every comparison is against
the port's own host routes (the native C++ aligner, ``--backend bfs``,
the native PacBio kernel) or the kernels' plain torch versions; nothing of
the JAX package is imported.

0. the card (nvidia-smi name and power limit), torch and CUDA versions,
   the kernel build (ptxas registers and spills, the DPX instructions in
   the SASS of the band kernels, among them the exact two-direction
   extension's two loaders, K5's MUFU instructions);
1. the exact two-direction extension (resident loader) against its plain
   version on the rescore's resident world of 131072 candidates (reads of
   100 bp), timed beside the staged route it replaces (stage_views + K1 +
   K2) on the same candidates; the staged K1/K2 entries against their
   plain versions at the band shape (131072 candidates, rmax 96);
2. candidate generation and the full rescore at bench.py's world (400 kb
   genome, 100k reads of 100 bp) against the native C++ query and the
   port's own CPU engine (which runs the plain versions), with warm
   timings, the stage split (candgen, extension, dedup + reduction) and
   the extension against its plain version on the rescore's own
   candidates, and the stage after it (csrc/rescore.cu's two kernels
   against the torch chain: kept alignments and zero reads equal, score
   within 1e-13, both routes' device and host times, the longest
   (segment, read) run); the candgen kernels (csrc/candgen.cu) bit-equal to the
   native query and to their plain version (query_plain), also on the
   radix route, both timed and split into stages with CUDA events, the
   runs pass launched once by the rescore and query_plain never, the hand-written sort stage timed beside
   torch.sort on the same keys (whose sorted keys must equal the
   kernels'); and k = 4 assemblies (the genome each,
   bench.py's batched mode) in one rescore (seg_job, one candgen, one
   extension launch) against four single rescores, each job within
   1e-12, both timed, its candidates the kernel's = query_plain's;
3. the same at S. aureus scale (2.8 Mb, 300k reads of 100 bp), and 200
   anneal-sized window batches cut from that genome (1-512 segments of
   60-3000 bp, N codes in every third) through the kernels (by the
   default route and by the radix route), query_plain and the native
   query, all bit-equal;
4. an anneal (200 iterations) through ``python -m gaml_tpu_torch.cli
   --device cuda`` on the 2.8 Mb paired world of
   examples/aureus_like_run.py, held against a ``--device cpu`` run of
   the same config and reported against the port's ``--backend bfs``;
5. kernel K5 (the PacBio banded forward DP) against its plain torch
   version in float32 and float64 and against the twin of its arithmetic
   on the card at widths 64 and 128, at an S. aureus-sized batch (2.8 Mb
   walk buffer, 2048 jobs, reads up to 5 kb) and on an adversarial batch
   (guides 20-45 columns off or stuck at the buffer's start, targets that
   end or start away from the band);
6. long-read scoring at the repo's pinned scale (the examples/pacbio_run.py
   world: 1 Mb, 500 reads of 3 kb, 10 % errors, seed 5): the port's read
   set on the card against the same read set's native host route, and the
   native-vs-card crossover in DP cells;
6b. the long-read seed lookup (csrc/seeds.cu) at the ``pacbio.rescore``
   cell's shapes (the benchmark's ``ecoli_pacbio`` world, each walk set's
   batch): hits equal to its plain version's and the host index's, wall,
   device and plain ms, the host index's ms, the bound and the launches,
   and one small range alone; the precomputes launch the kernels once a
   walk set, and stage each forward batch raggedly (the staging kernel of
   csrc/banded_forward.cu, one launch a K5 launch and a
   ``pacbio.device_batches``); then each walk set's forward batch through
   the ragged staging against the padded one it replaced (equal inputs,
   host ms of each to the uploaded inputs), the staging kernel's card,
   device and plain ms, its bound and launches
   (``python3 chip_smoke.py --seeds`` runs phases 0, 6b and 7 only);
7. a PacBio anneal through the port's CLI (``--device cuda``, in this
   process, under the profiler) against the port's CLI on the native host
   route, held to the assembly-level bound of
   tests/test_pacbio.py::test_f32_route_anneal_quality_bound, its seed
   lookups on the seed kernels;
8. the exact band DP: the single-direction API (dp_rows_exact, the
   contract of K3/K4a/K4b) against its plain version at phase 1's band
   inputs, one launch and stacked; the exact two-direction extension
   (the port of K3/K4a/K4b) against its plain version on a ragged draw
   of 131072 candidates (reads of 60-100 bp), resident and staged at
   rmax 96; and the K6 tool (gaml_tpu_torch.tools.swar_kernel_proto);
9. the device likelihood models at S. aureus scale: SingleEndModel on
   phase 3's world (host candidates) against the model on the CPU and
   DeviceRescorer.rescore, its forward step split into staging, launch,
   dedup and reduction, the exact extension on its candidates (both
   loaders) beside the stacked single-direction launch the port made
   before; PairedEndModel on the phase-4 world's frag
   library against the host paired scorer over the start walks; and the
   paired reduction on five pairs whose probabilities lie below float32's
   range, against the float64 host (ROADMAP C12);
10. a mixed-length anneal: phase 4's world with 20 % of each frag mate
   file's reads quality-trimmed (no native bundle, so its windows run
   the candgen kernel over the max-hash index's own CSR and the exact
   extension on a resident ragged read set, as the advice library's run
   them on its uniform one), ``--device cuda`` against ``--device cpu``,
   reported against ``--backend bfs``, the host pass gen_candidates
   never called; the start scoring and first moves again in this
   process, every frag batch's candidates held to query_plain and to
   gen_candidates window by window, the start scoring split into its
   stages beside gen_candidates' time on its windows, the card's busy
   share over warm moves; and the split of one 64-window batch beside
   gen_candidates on the same windows;
11. the JAX CLI's four device scorers through the port's CLI on the
   card: ``--paired-device-inc`` and ``--device-state`` over phase 4's
   anneal (130 iterations in their second runs), ``--paired-device``
   over 13 iterations, the first two flags each run twice (the second
   in this process under the profiler, each move timed; --paired-device
   only so, its second run phase 12's) and held to the default host
   incremental scorer's trace and .walks;
   ``--pacbio-device`` on phase 6-7's world, every forward cell on K5,
   held to phase 7's assembly bound; ``sharded_single_end_score`` on
   phase 9's candidates against SingleEndModel's score.  Each flag's ms
   per move and per warm move (beside the host scorer's), the bucket
   products' ms per scoring call, the host staging's share and the
   card's busy share;
12. multi-process scoring (parallel/distributed.py): the dry run
   (gaml_tpu_torch.tools.dryrun_distributed) with two ranks over gloo on
   this card against one rank over NCCL; the four flags through the CLI
   with ``--distributed`` at world 2 (two ranks over gloo on this card,
   this script in rank mode, ``--rank``), each rank's trace equal to
   phase 11's world-1 run of the same config and rank 0's .walks equal,
   the PacBio run held to phase 7's bound; sharded_single_end_score at
   world (2, 1) on phase 9's candidates.  Per flag and rank: ms a move
   beside world 1's, the host staging share, the busy share, launches.

The anneals of phases 4 and 10-12 must launch the candgen kernels and
never query_plain on the card (phase 4 the one-block route too); those
of phases 4 and 10 never the host candidate pass either.  ``python3
chip_smoke.py --candgen-split [plain] [kernel] [radix]`` runs only the
candgen stage split of each route (radix: the kernels with the
one-block threshold 0) on phase 2's and phase 3's worlds and phase 4's
first 100 moves' batches, with the kernel route the sort against
torch.sort.

Kernel times are the median over warm calls of CUDA events around one
call (the launch included).  Each kernel's bound is the larger of its
16-bit lane operations (for K5: its FP32 instructions, or the longest
job's serial FMA chain) over the card's peak and the bytes it must move
over 3.35 TB/s, from this run's inputs.  Any failed check raises and
exits non-zero.  The last two lines are a JSON object describing each
kernel and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository beside it, the script exits non-zero before any
phase.
"""
import concurrent.futures
import contextlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MATCH, MISMATCH = 0.96, 0.01
MPB, MPS = -0.7, -10.0
READ_LEN = 100
BAND_DP = "gaml_tpu_torch/csrc/band_dp.cu"
KERNELS = (  # (TPU kernel, entry name, source, the pallas_call it replaces)
    ("K1", "extend_exact:K1", BAND_DP, "gaml_tpu/ops/extend_pallas.py:467"),
    ("K2", "extend_exact:K2", BAND_DP, "gaml_tpu/ops/extend_pallas.py:600"),
    ("K3", "extend_exact:K3", BAND_DP, "gaml_tpu/ops/extend_pallas.py:710"),
    ("K4a", "extend_exact_staged:K4a", BAND_DP,
     "gaml_tpu/ops/extend_pallas.py:287"),
    ("K4b", "extend_exact_staged:K4b", BAND_DP,
     "gaml_tpu/ops/extend_pallas.py:231"),
    ("K5", "banded_forward", "gaml_tpu_torch/csrc/banded_forward.cu",
     "gaml_tpu/ops/forward_pallas.py:134"),
    ("K6", "swar_cost:K6", BAND_DP, "tools/swar_kernel_proto.py:127"),
)
# candidate generation: no pallas_call; it replaces the JAX package's XLA
# graph (gaml_tpu/ops/candgen_device.py:91-278)
CANDGEN = ("candgen", "gaml_tpu_torch/csrc/candgen.cu",
           "gaml_tpu/ops/candgen_device.py:91")
CANDGEN_KERNELS = ("candgen_runs_kernel", "candgen_block_kernel",
                   "candgen_expand_kernel", "candgen_hist_kernel",
                   "candgen_scatter_kernel")
RESCORE_KERNELS = ("rescore_dedup_sums_kernel", "rescore_reduce_kernel")
SEEDS_KERNELS = ("seeds_keys_kernel", "seeds_hist_kernel",
                 "seeds_scatter_kernel", "seeds_count_kernel",
                 "seeds_scan_kernel", "seeds_expand_kernel")
# the forward batch's ragged staging (csrc/banded_forward.cu)
STAGE_KERNEL = "forward_stage_kernel"
PB_MATCH, PB_MISMATCH = 0.85, 0.0375  # config mismatch_prob=0.0375
# peaks of one NVIDIA H100 SXM for the bounds: HBM bytes/s; the SM clock;
# 16-bit lane operations/s of the packed integer band (132 SMs x 64 int32
# lanes x 2 lanes of 16 bits x 1.98 GHz); FP32 instructions/s of K5 (132
# SMs x 128 lanes x 1.98 GHz); special-function (exp, log) results/s, the
# bound of the earlier log-space form of K5 (132 SMs x 16 x 1.98 GHz)
HBM_BPS = 3.35e12
SM_HZ = 1.98e9
LANE_OPS = 132 * 64 * 2 * SM_HZ
FP32_OPS = 132 * 128 * SM_HZ
INT32_OPS = 132 * 64 * SM_HZ  # int32 lane operations/s (candgen's bound)
MUFU_OPS = 132 * 16 * SM_HZ
# 16-bit lane operations per band cell (one candidate-row-diagonal): the
# cost (match test, the diagonal select, substitution and read-skip each
# an add and a min, three genome-skip add/min sweeps) and the accept
# offset's tie-break (three comparisons, three take masks, two selects,
# four sweeps)
COST_OPS, ACCEPT_OPS = 12, 12


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def timer(device, fn, reps, host_clock=False):
    """Median milliseconds of fn() over ``reps`` warm calls: CUDA events
    on the card, the host clock on the CPU or when asked (for calls that
    end in a synchronisation)."""
    import torch

    fn()
    times = []
    if device.type == "cuda" and not host_clock:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(reps):
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ------------------------------------------------------------------ phase 0
# the band kernels of band_dp.cu by a part of their mangled names (the
# template arguments), as the entry points that launch them
BAND_KERNELS = {"band_dp_kernelILb0ELb1E": "swar_cost",
                "band_dp_kernelILb1ELb1E": "swar_cost_accept",
                "band_dp_kernelILb1ELb0E": "dp_rows_exact",
                "extend_kernelINS_12ResidentLoad": "extend_exact",
                "extend_kernelINS_10StagedLoad": "extend_exact_staged"}


def sass_counts(so):
    """{mangled kernel name: {"sass": instructions, "dpx": DPX
    instructions, "mufu": special-function instructions}} from cuobjdump
    -sass of the built library.  DPX counts VIADDMNMX, VIMNMX3, VIBMNMX
    and every packed 16x2 form: the instructions that exist in hardware on
    sm_90 and that an emulated __viaddmin_s16x2 would not produce."""
    from gaml_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Za-z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            d = out.setdefault(name, {"sass": 0, "dpx": 0, "mufu": 0})
            d["sass"] += 1
            d["dpx"] += op.startswith(("VIADDMNMX", "VIMNMX3", "VIBMNMX")) \
                or "16x2" in op
            d["mufu"] += op.startswith("MUFU")
    return out


def phase_card():
    """The card, the versions, the build; per band kernel its registers
    and spills (-Xptxas -v) and its DPX instructions in the SASS, and per
    width of K5 its registers, spills and MUFU (special-function)
    instructions.  Fails if a band kernel has no DPX instruction or if
    any of these kernels spills."""
    import torch

    from gaml_tpu_torch.native import get_lib
    from gaml_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    check(get_lib() is not None, "the native C++ library did not build")
    build.load()
    print(f"kernel build {build.build_info['seconds']:.2f} s -> "
          f"{os.path.relpath(build.build_info['path'], ROOT)}", flush=True)
    sass = sass_counts(build.build_info["path"])
    usage = {}
    for frag, entry in BAND_KERNELS.items():
        names = [k for k in sass if frag in k]
        check(len(names) == 1, f"{entry}: kernels {names} in the SASS")
        reg = ptxas_usage(build.build_info["log"], frag)
        usage[entry] = dict(reg[0] if reg else {}, **sass[names[0]])
        check(usage[entry]["dpx"] > 0 and
              usage[entry].get("spill_stores", 0) == 0,
              f"{entry}: no DPX instruction in its SASS, or spills: "
              f"{usage[entry]}")
        print(f"  {entry}: " + json.dumps(usage[entry]), flush=True)
    for width in (64, 128):
        frag = f"banded_forward_kernelILi{width}E"
        names = [k for k in sass if frag in k]
        check(len(names) == 1, f"K5 W={width}: kernels {names} in the SASS")
        reg = ptxas_usage(build.build_info["log"], frag)
        entry = f"banded_forward_w{width}"
        usage[entry] = dict(reg[0] if reg else {}, **sass[names[0]])
        check(usage[entry].get("spill_stores", 0) == 0,
              f"{entry} spills: {usage[entry]}")
        print(f"  {entry}: " + json.dumps(usage[entry]), flush=True)
    for frag in CANDGEN_KERNELS + RESCORE_KERNELS + SEEDS_KERNELS + (
            STAGE_KERNEL,):
        # each over its instances
        names = [k for k in sass if frag in k]
        reg = ptxas_usage(build.build_info["log"], frag)
        check(names and reg, f"{frag}: kernels {names} in the SASS, "
              f"{len(reg)} in the compiler's output")
        usage[frag] = {
            "instances": len(names),
            "registers": max(r.get("registers", 0) for r in reg),
            "spill_stores": sum(r.get("spill_stores", 0) for r in reg),
            "spill_loads": sum(r.get("spill_loads", 0) for r in reg),
            "sass": sum(sass[k]["sass"] for k in names)}
        check(usage[frag]["spill_stores"] == 0 and
              usage[frag]["spill_loads"] == 0,
              f"{frag} spills: {usage[frag]}")
        print(f"  {frag}: " + json.dumps(usage[frag]), flush=True)
    return usage


# ------------------------------------------------------------------ phase 1
def band_inputs(seed, n, rmax, device):
    """K1/K2 inputs as the kernel tests make them: half the candidates
    matching, sentinels, ragged rlen and short glen."""
    import torch

    from gaml_tpu_torch.ops.extend import PAD, SENT_GEN, SENT_READ

    rng = np.random.default_rng(seed)
    read = rng.integers(0, 5, (rmax, n)).astype(np.uint8)
    gwin = rng.integers(0, 5, (rmax + 2 * PAD, n)).astype(np.uint8)
    gwin[PAD:PAD + rmax, :n // 2] = read[:, :n // 2]
    gwin[gwin == 4] = SENT_GEN
    read[read == 4] = SENT_READ
    rlen = rng.integers(0, rmax + 1, n).astype(np.int32)
    glen = rng.integers(0, rmax + PAD, n).astype(np.int32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (read, gwin, rlen, glen))


def band_bound(rows_cost, rows_accept, nbytes):
    """(bound ms, what bounds it) of a band DP that runs ``rows_cost``
    candidate-rows for the cost alone and ``rows_accept`` for the cost
    and the accept offset, and must move ``nbytes``."""
    ops = 7 * (COST_OPS * rows_cost + (COST_OPS + ACCEPT_OPS) * rows_accept)
    t_ops, t_bytes = ops / LANE_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "lane_ops": ops, "bytes": nbytes}


def staged_bound(args, accept):
    """The bound of a staged entry (K1, K2, the exact DP) on band inputs
    read_t [rmax, n], gwin_t, rlen, glen: each candidate's rows below its
    read length, with the read byte and the new genome byte of each row
    (7 more genome bytes to start a band) and its outputs."""
    import torch

    read, _gwin, rlen, _glen = args
    n = rlen.shape[0]
    rows = rlen.to(torch.int64).clamp(0, read.shape[0])
    nrow, live = int(rows.sum()), int((rows > 0).sum())
    nbytes = 2 * nrow + 7 * live + 8 * n + (8 if accept else 4) * n
    return band_bound(0 if accept else nrow, nrow if accept else 0, nbytes)


def exact_bound(rows_b, rows_f, nbytes):
    """The exact extension's bound, counted two ways: with the operations
    its algorithm needs (the backward rows' cost and accept offset, the
    forward rows' cost alone), which ``bound_ms`` and the share use; and
    with the count of the stacked launch the port made before (every row
    of both directions with the offset), ``bound_ms_stacked_count``."""
    nb, nf = int(rows_b.sum()), int(rows_f.sum())
    res = band_bound(nf, nb, nbytes)
    stacked = band_bound(0, nb + nf, nbytes)
    res.update(rows=nb + nf, bound_ms_stacked_count=stacked["bound_ms"],
               lane_ops_stacked_count=stacked["lane_ops"])
    return res


def resident_exact_bound(args, rmax):
    """The bound of extend_exact on (codes, lens, buf, base, glen, g0, r0,
    row): the rows of both directions, the read rows the candidates name
    (at their lengths, with their lengths), the window buffer, five int32
    and three outputs (9 bytes) per candidate."""
    import torch

    from gaml_tpu_torch.ops.extend import K

    _codes, lens, buf, _base, _glen, g0, r0, row = args
    rows_b = torch.where(g0 > 0, r0, 0).clamp(0, rmax)
    rows_f = (lens[row.to(torch.int64)] - r0 - K).clamp(0, rmax)
    named = lens[torch.unique(row).to(torch.int64)]
    nbytes = int(named.sum()) + 4 * named.numel() + buf.numel() \
        + 29 * g0.shape[0]
    return exact_bound(rows_b, rows_f, nbytes)


def staged_exact_bound(st):
    """The bound of extend_exact_staged on a staged dict: the rows of
    both directions, one read byte and one genome byte a row (7 more
    genome bytes to start a band), six int32, the start flag and three
    outputs per candidate."""
    rmax = st["read_f"].shape[1]
    rows_b, rows_f = (st[k].clamp(0, rmax) for k in ("rlen_b", "rlen_f"))
    live = int((rows_b > 0).sum()) + int((rows_f > 0).sum())
    nbytes = 2 * int(rows_b.sum() + rows_f.sum()) + 7 * live \
        + 34 * rows_b.shape[0]
    return exact_bound(rows_b, rows_f, nbytes)


def exact_against_plain_two(device, args, rmax, reps):
    """The exact two-direction extension against its plain version:
    ``args`` a staged dict (extend_exact_staged) or the resident
    arguments with their row bound rmax (extend_exact).  ok equal
    everywhere, errs and begin equal wherever ok (integers: the tolerance
    is exact); its times, bound (both counts) and share."""
    from gaml_tpu_torch.ops import extend_cuda as kc

    if isinstance(args, dict):
        run = lambda: kc.extend_exact_staged(args)  # noqa: E731
        plain = lambda: kc.extend_exact_staged_ref(args)  # noqa: E731
        bound = staged_exact_bound(args)
    else:
        run = lambda: kc.extend_exact(*args, rmax)  # noqa: E731
        plain = lambda: kc.extend_exact_ref(*args, rmax)  # noqa: E731
        bound = resident_exact_bound(args, rmax)
    want = plain()
    got = run()
    sync(device)
    ok = want[0]
    check(bool((got[0] == ok).all()), "exact extension: ok differs from "
          "its plain version")
    err = max(int((g[ok] - w[ok]).abs().max()) if ok.any() else 0
              for g, w in zip(got[1:], want[1:]))
    check(err == 0, f"exact extension: errs/begin differ from the plain "
          f"version by {err} where ok")
    res = {"n": int(ok.numel()), "ok": int(ok.sum()), "max_abs_err": err,
           "equal_everywhere": all(bool((g == w).all())
                                   for g, w in zip(got, want)),
           "ms": timer(device, run, reps), "plain_ms": timer(device, plain, 3),
           **bound}
    res["share"] = res["bound_ms"] / res["ms"]
    return res


def resident_world(device, n=None, genome_len=400_000, n_reads=100_000):
    """Phase 2's world made resident as the rescore holds it: both
    orientations' read codes (DeviceExtender), the genome as the window
    buffer, and the device candgen's candidates over it.  With ``n``,
    random candidates (any row, any seed offset, anywhere in the genome)
    fill the batch up to n.  Returns the extend_exact arguments (int32
    per-candidate tensors), rmax and the candgen's count."""
    import torch

    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen
    from gaml_tpu_torch.ops.extend import K
    from gaml_tpu_torch.ops.extend_device import DeviceExtender

    genome, reads = make_world(genome_len, n_reads)
    bundle = make_bundle(reads)
    gen = DeviceCandGen(bundle, device)
    ext = DeviceExtender(bundle.codes_fwd, bundle.codes_rc, device)
    c = gen.query([genome])
    g0, r0 = c.g0, c.r0
    row = gen.row_of[c.rid] + c.orient * ext.n_rows
    if n is not None:
        rng = np.random.default_rng(3)
        m = max(n - c.n_total, 0)
        fill = [torch.as_tensor(x, device=device) for x in (
            rng.integers(0, genome_len - K + 1, m),
            rng.integers(0, ext.L - K + 1, m),
            rng.integers(0, 2 * ext.n_rows, m))]
        g0, r0, row = (torch.cat([x, y])[:n] for x, y in
                       zip((g0, r0, row), fill))
    m = g0.shape[0]
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    args = (ext.codes, ext.lens, c.codes, i32(torch.zeros(m, device=device)),
            i32(torch.full((m,), genome_len, device=device)), i32(g0),
            i32(r0), i32(row))
    return args, ext.rmax, c.n_total


def phase_kernels(device, n=131072, rmax=96, reps=20):
    """The exact extension (resident loader) against its plain version on
    the rescore's resident world of n candidates, timed beside the staged
    route it replaces on the same candidates (stage_views, K1, K2, the
    epilogue, and each of those alone).  Then each staged entry against
    its plain version on band inputs.  The outputs are integers, so the
    tolerance is exact equality: K1's cost everywhere, K2's cost
    everywhere and its offset wherever the exact cost is <= 6 (the
    contract of the TPU kernels)."""
    import torch

    from gaml_tpu_torch.ops import extend_cuda as kc
    from gaml_tpu_torch.ops.extend import stage_views
    from gaml_tpu_torch.ops.extend_device import extend_candidates

    fargs, frmax, n_cands = resident_world(device, n)
    res = exact_against_plain_two(device, fargs, frmax, reps)
    res["candgen_candidates"] = n_cands
    codes, _lens, buf, *meta = fargs
    i64 = [x.to(torch.int64) for x in meta]
    read_len = torch.full_like(i64[0], codes.shape[1])
    staged = extend_candidates(codes, read_len, buf, *i64, frmax)
    got = kc.extend_exact(*fargs, frmax)
    ok = got[0]
    check(bool((staged[0] == ok).all()) and all(
        bool((s[ok] == g[ok]).all()) for s, g in zip(staged[1:], got[1:])),
        "the staged route and the exact extension differ where ok")
    fwd, bwd = stage_views(codes, read_len, buf, *i64, frmax)
    res["staged_route_ms"] = timer(device, lambda: extend_candidates(
        codes, read_len, buf, *i64, frmax), reps)
    res["stage_views_ms"] = timer(device, lambda: stage_views(
        codes, read_len, buf, *i64, frmax), reps)
    res["staged_k1_ms"] = timer(device, lambda: kc.swar_cost(*fwd), reps)
    res["staged_k2_ms"] = timer(device, lambda: kc.swar_cost_accept(*bwd),
                                reps)
    print(f"  resident extension n={n} L={codes.shape[1]}: "
          + json.dumps(res), flush=True)

    args = band_inputs(0, n, rmax, device)
    c1, c1_ref = kc.swar_cost(*args), kc.swar_cost_ref(*args)
    err1 = int((c1 - c1_ref).abs().max())
    (c2, a2), (c2_ref, a2_ref) = (kc.swar_cost_accept(*args),
                                  kc.swar_cost_accept_ref(*args))
    m = c2_ref <= 6
    err2 = max(int((c2 - c2_ref).abs().max()),
               int((a2[m] - a2_ref[m]).abs().max()))
    check(int(m.sum()) > n // 8, "too few unsaturated K2 candidates")
    check(err1 == 0, f"K1 differs from its plain version by {err1}")
    check(err2 == 0, f"K2 differs from its plain version by {err2}")
    out = {"extend_exact": res}
    for name, err in (("swar_cost", err1), ("swar_cost_accept", err2)):
        out[name] = {
            "max_abs_err": err,
            "ms": timer(device, lambda: getattr(kc, name)(*args), reps),
            "plain_ms": timer(device, lambda: getattr(kc, name + "_ref")(
                *args), 3),
            **staged_bound(args, name == "swar_cost_accept")}
        print(f"  {name} n={n} rmax={rmax}: " + json.dumps(out[name]),
              flush=True)
    return out


# -------------------------------------------------------------- phases 2-3
def make_world(genome_len, n_reads, read_len=READ_LEN, err_rate=0.01,
               seed=7):
    """bench.py's world: a random genome and reads sampled from it with
    substitution errors, half of them reverse-complemented."""
    from gaml_tpu_torch.core import dna

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)]
    errs = rng.random(reads.shape) < err_rate
    reads[errs] = (reads[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    flip = rng.random(n_reads) < 0.5
    reads[flip] = dna._COMP_LUT[reads[flip]][:, ::-1]
    return genome, reads


def make_bundle(reads):
    """The native aligner bundle (index, read codes, seed positions) of a
    uniform-length read matrix; read id = row."""
    from gaml_tpu_torch.core.dna import _COMP_LUT
    from gaml_tpu_torch.index.maxhash import K_INDEX_KMER
    from gaml_tpu_torch.native import NativeAlignBundle, read_index_build

    fp, ok_m, _k, _rc, seed_pos = read_index_build(reads, K_INDEX_KMER)
    okb = ok_m.astype(bool)
    rids = np.arange(len(reads), dtype=np.int64)[okb]
    order = np.argsort(fp[okb], kind="stable")
    sf, sr = fp[okb][order], rids[order]
    bounds = np.nonzero(np.diff(sf))[0] + 1
    starts = np.concatenate(([0], bounds)).tolist()
    ends = np.concatenate((bounds, [len(sf)])).tolist()
    index = {int(sf[s]): sr[s:e].tolist() for s, e in zip(starts, ends)}
    return NativeAlignBundle(index, reads.shape[1], reads,
                             _COMP_LUT[reads][:, ::-1], seed_pos,
                             np.arange(len(reads), dtype=np.int32))


def host_total_prob(bundle, genome, n_reads):
    """GetTotalProb in float64 over the native BFS window alignments."""
    from gaml_tpu_torch.native import align_window

    _pos, ed, rid, _or = align_window(bundle, genome, 0)
    probs = np.zeros(n_reads)
    np.add.at(probs, rid, MISMATCH ** ed * MATCH ** (READ_LEN - ed))
    probs /= 2.0 * len(genome)
    thr = np.exp(MPS + MPB * READ_LEN)
    zeros = int((probs < thr).sum())
    return float(np.log(np.maximum(probs, thr)).mean()), zeros


def phase_rescore(device, genome_len, n_reads, reps=10, launches=None,
                  jobs=0, fuzz=0):
    """Candgen and rescore on ``device`` against the native query and the
    port's CPU engine; score tolerance 2e-6 relative (float32 sums taken
    in another order).  Then the stage split and the exact extension
    against its plain version on the rescore's own candidates, and the
    stage after it (dedup, sums, reduction: the two kernels against the
    torch chain, score_stage) on them.  With
    ``jobs`` = k, k assemblies (the genome each, bench.py's batched mode)
    in one rescore (seg_job, one extension launch) against k single
    rescores: each job's score within 1e-12 rel, zero reads equal, both
    timed.  Candgen: the kernel (DeviceCandGen.query) bit-equal to the
    native query and to query_plain, both timed and split into stages,
    the kernel once on the rescore's main path and query_plain never;
    with ``fuzz`` = n, n anneal-sized batches cut from the genome
    (candgen_fuzz)."""
    import torch

    from gaml_tpu_torch.native import query_windows_batch
    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

    t0 = time.perf_counter()
    genome, reads = make_world(genome_len, n_reads)
    bundle = make_bundle(reads)
    t_world = time.perf_counter() - t0
    want = query_windows_batch(bundle, [genome])[0]
    gen = DeviceCandGen(bundle, device)
    got = gen.query_host([genome])[0]
    for name, a, b in zip(("rid", "g0", "r0", "orient"), got, want):
        check(np.array_equal(a, b), f"candgen {name} differs from native")
    cand = candgen_against_plain(device, gen, [genome], reps)
    cap = len(want[0])
    args = dict(log_match=float(np.log(MATCH)),
                log_mismatch=float(np.log(MISMATCH)), total_len=genome_len,
                min_prob_per_base=MPB, min_prob_start=MPS)
    ref = DeviceRescorer(bundle, device="cpu").rescore([genome], cap, **args)
    dev = DeviceRescorer(bundle, device=device)
    reset_launches()
    score, zeros, n_tot = dev.rescore([genome], cap, **args)
    main = all_launches()
    check(device.type != "cuda" or (main["candgen_runs"] == 1 and
                                    main["query_plain"] == 0),
          f"the rescore's candgen did not run the kernel once: {main}")
    cand["launches"] = main["candgen_runs"]
    if launches is not None:
        launches.update(main)
        check(device.type != "cuda" or (
            main["extend_exact"] == 1 and main["swar_cost"] ==
            main["swar_cost_accept"] == main["dp_rows_exact"] == 0),
            f"the rescore did not make one exact launch: {main}")
    ms = timer(device, lambda: dev.rescore([genome], cap, **args), reps,
               host_clock=True)

    # the stage split: candgen (ending in its count's synchronisation),
    # the extension (CUDA events) and dedup + reduction (ending in the
    # score's); then the extension on these candidates
    def candgen():
        out = dev.gen.query([genome], cap)
        sync(device)
        return out

    c = candgen()
    ext = dev._extend(c)
    split = {"candgen_ms": timer(device, candgen, reps, host_clock=True),
             "extend_ms": timer(device, lambda: dev._extend(c), reps),
             "dedup_reduce_ms": timer(device, lambda: dev.score(
                 c, ext, **args), reps, host_clock=True),
             "score_stage": score_stage(device, dev, c, ext, args, reps)}
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    fargs = (dev.ext.codes, dev.ext.lens, c.codes, i32(c.seg_base[c.seg]),
             i32(c.seg_len[c.seg]), i32(c.g0), i32(c.r0),
             i32(dev.gen.row_of[c.rid] + c.orient * dev.ext.n_rows))
    on_cands = exact_against_plain_two(device, fargs, dev.ext.rmax, reps)
    check(n_tot == ref[2] == cap, f"n_total {n_tot} vs cpu {ref[2]} "
          f"vs native {cap}")
    check(zeros == ref[1], f"zero_reads {zeros} vs cpu {ref[1]}")
    rel = abs(score - ref[0]) / abs(ref[0])
    check(np.isfinite(score) and rel <= 2e-6,
          f"score {score} vs cpu {ref[0]} (rel {rel:.3g})")
    if jobs:
        res_jobs = rescore_jobs(device, dev, genome, cap, args, jobs,
                                (score, zeros), reps)
        cand["launches"] += res_jobs["candgen_launches"]
    if fuzz:
        cand["fuzz"] = candgen_fuzz(gen, bundle, genome, fuzz)
    h_score, h_zeros = host_total_prob(bundle, genome, n_reads)
    res = {"genome": genome_len, "reads": n_reads, "candidates": n_tot,
           "score": score, "zero_reads": zeros, "rel_vs_cpu": rel,
           "ms": ms, "reads_per_s": n_reads / (ms / 1e3),
           "bfs_score": h_score, "bfs_zero_reads": h_zeros,
           "rel_vs_bfs": abs(score - h_score) / abs(h_score),
           "world_s": t_world, **split}
    if device.type == "cuda":
        res["peak_mem_mb"] = torch.cuda.max_memory_allocated() / 2**20
    print("  " + json.dumps(res), flush=True)
    print("  extension on these candidates: " + json.dumps(on_cands),
          flush=True)
    print("  candgen, kernel and plain: " + json.dumps(cand), flush=True)
    res["candgen"] = cand
    if jobs:
        print(f"  {jobs} jobs in one rescore: " + json.dumps(res_jobs),
              flush=True)
        res["jobs"] = res_jobs
    return res


def longest_run(c):
    """The most candidates of ``c`` in one run of equal (segment, read)."""
    import numpy as np

    if not c.n_total:
        return 0
    seg, rid = c.seg.cpu().numpy(), c.rid.cpu().numpy()
    heads = np.nonzero(np.r_[True, (seg[1:] != seg[:-1]) |
                             (rid[1:] != rid[:-1])])[0]
    return int(np.diff(np.r_[heads, len(seg)]).max())


def device_ms(fn, reps):
    """Device time a call of fn(): the durations of the kernels, copies
    and memsets in torch.profiler's trace of ``reps`` warm calls, as the
    benchmark's trace reader sums them; None where the trace holds no
    device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="gaml_smoke_prof_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    us = sum(float(e.get("dur", 0.0)) for e in events
             if e.get("ph") == "X" and
             e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return us / 1e3 / reps if us else None


def score_stage(device, dev, c, ext, args, reps):
    """DeviceRescorer.score's stage on the rescore's own candidates, the
    kernels (ops.rescore_cuda.score_kernel: two launches, one read-back)
    against the torch chain (score_plain): kept alignments and zero reads
    equal, score within 1e-13 rel; each route's device time (the kernels
    and copies a call launches) and host clock a call, and the longest
    (segment, read) run."""
    from gaml_tpu_torch.ops import rescore_cuda
    from gaml_tpu_torch.ops.rescore_device import (dedup_sums_plain,
                                                   score_plain)

    idx, _ = dedup_sums_plain(dev.n_reads, dev.lens, c, ext,
                              args["log_match"], args["log_mismatch"])
    want = score_plain(dev.n_reads, dev.lens, c, ext, **args)
    res = {"longest_run": longest_run(c), "candidates": c.n_total,
           "kept": len(idx)}
    if device.type != "cuda":
        return res
    (scores, zeros, kept), launched = launches_of(
        lambda: rescore_cuda.score_kernel(dev, c, ext, **args))
    rel = abs(float(scores[0]) - want[0]) / abs(want[0])
    check(kept == len(idx) and int(zeros[0]) == want[1] and rel <= 1e-13,
          f"score stage: kernels ({scores[0]}, {zeros[0]}, {kept} kept) vs "
          f"the chain ({want[0]}, {want[1]}, {len(idx)} kept)")
    check(launched == {"rescore_dedup_sums": 1, "rescore_reduce": 1},
          f"score stage launches {launched}")

    def kernel():
        return rescore_cuda.score_kernel(dev, c, ext, **args)

    def plain():
        return score_plain(dev.n_reads, dev.lens, c, ext, **args)

    res.update(rel_vs_plain=rel, launches=launched,
               device_ms=device_ms(kernel, reps),
               plain_device_ms=device_ms(plain, reps),
               host_ms=timer(device, kernel, reps, host_clock=True),
               plain_host_ms=timer(device, plain, reps, host_clock=True))
    return res


def rescore_jobs(device, dev, genome, cap, args, k, single, reps):
    """k copies of the genome as k jobs of one rescore (seg_job, n_jobs:
    one candgen, one extension launch) against the single rescore's
    (score, zeros) ``single``; timed beside k single rescores."""
    seqs = [genome] * k
    kw = dict(args, total_len=[args["total_len"]] * k)

    def batched():
        return dev.rescore(seqs, cap * k, seg_job=np.arange(k), n_jobs=k,
                           **kw)

    staged = dev.stage(seqs)
    same_candidates(dev.gen.query(staged=staged),
                    dev.gen.query_plain(staged=staged), f"{k} jobs")
    counts = reset_launches()
    sb, zb, nb = batched()
    launches = counts["extend_exact"]
    main = all_launches()
    check(device.type != "cuda" or (main["candgen_runs"] == 1 and
                                    main["query_plain"] == 0),
          f"{k} jobs: the candgen kernel did not run once: {main}")
    check(nb == cap * k, f"{k} jobs: n_total {nb} vs {k} x {cap}")
    rel = float(np.max(np.abs(sb - single[0]) / abs(single[0])))
    check(rel <= 1e-12 and (zb == single[1]).all(),
          f"{k} jobs ({sb}, {zb}) vs one rescore {single}")
    check(device.type != "cuda" or launches == 1,
          f"{k} jobs made {launches} extension launches")
    return {"jobs": k, "candidates": nb, "max_rel_vs_single": rel,
            "launches": launches, "candgen_launches": main["candgen_runs"],
            "ms": timer(device, batched, reps, host_clock=True),
            "singles_ms": timer(device, lambda: [
                dev.rescore([genome], cap, **args) for _ in range(k)],
                reps, host_clock=True)}


# --------------------------------------------- candgen: the two routes
def all_launches():
    """A copy of the one launch-count store (every kernel's launches and
    the calls of query_plain and gen_candidates; a name never counted
    reads 0)."""
    from gaml_tpu_torch.utils.metrics import LAUNCHES

    return LAUNCHES.copy()


def same_candidates(got, want, what):
    """Two candgen results bit-equal: n_total and every tensor in order."""
    import torch

    check(got.n_total == want.n_total,
          f"{what}: n_total {got.n_total} vs {want.n_total}")
    for name in ("rid", "g0", "r0", "orient", "seg"):
        a, b = getattr(got, name), getattr(want, name)
        check(a is not None and b is not None and a.dtype == b.dtype and
              torch.equal(a, b), f"{what}: {name} differs")


def native_layout(c, n_seg):
    """Candidates as the native query's per-window (rid, g0, r0, orient)
    int32 arrays (they come sorted by segment)."""
    cols = [t.cpu().numpy() for t in (c.rid, c.g0, c.r0, c.orient)]
    cuts = np.searchsorted(c.seg.cpu().numpy(), np.arange(n_seg + 1))
    return [tuple(x[cuts[i]:cuts[i + 1]].astype(np.int32) for x in cols)
            for i in range(n_seg)]


def candgen_bound(gen, g, c):
    """The candgen kernels' bound on a batch of g codes with candidates
    ``c``: the larger of bytes over HBM_BPS and int32 operations over
    INT32_OPS, counted as the function needs them, not as the kernels'
    tiles do.  Bytes: each code read once; per run with hits its
    fingerprint and its two CSR offsets (two 32-byte sectors), the whole
    ``sf`` and ``off`` at most; per candidate its read id, row and seed
    position read (each array at most once) and five int64 written.
    Operations, per window start of each strand: a rolling hash (shift,
    or, mask, xor), the key (2), a van Herk/Gil-Werman window max (three
    64-bit maxes, 6) and the validity and run flags (8); 12 a candidate.
    Runs are counted from the candidates (their distinct orientation,
    segment and g0), so runs without hits are left out."""
    import torch

    n = c.n_total
    runs = int(torch.unique((c.orient << 62) | (c.seg << 32) | c.g0)
               .numel()) if n else 0
    gathers = sum(min(n * 8, t.nbytes)
                  for t in (gen.rids, gen.row_of, gen.seed2))
    nbytes = g + min(runs * 64, gen.sf.nbytes + gen.off.nbytes) + gathers \
        + n * 5 * 8
    ops = 2 * g * (4 + 2 + 6 + 8) + n * 12
    t_ops, t_bytes = ops / INT32_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "int32_ops": ops, "bytes": nbytes, "runs": runs}


def candgen_against_plain(device, gen, seqs, reps):
    """The candgen kernels (DeviceCandGen.query) against query_plain on
    one uploaded batch: bit-equal (max_abs_err 0), both timed from the
    uploaded codes (CUDA events around a call that ends in its host
    synchronisation), the bound, each route's stage split, one query's
    launches by kernel, and the sort stage against torch.sort."""
    staged = gen.upload(seqs)
    want = gen.query_plain(staged=staged)
    got, launches = launches_of(lambda: gen.query(staged=staged))
    same_candidates(got, want, "candgen")
    same_candidates(forced_query(gen, staged, one_block_max=0), want,
                    "candgen, radix route")
    res = {"candidates": got.n_total, "max_abs_err": 0,
           "ms": timer(device, lambda: gen.query(staged=staged), reps),
           "plain_ms": timer(device, lambda: gen.query_plain(staged=staged),
                             reps), "launches_of_a_query": launches}
    res.update(candgen_bound(gen, staged[0].shape[0], got))
    res["share"] = res["bound_ms"] / res["ms"]
    res["split"] = {route: candgen_split(device, [(gen, seqs, None)],
                                         route, reps)
                    for route in ("kernel", "plain")}
    res["sort"] = sort_against_torch(device, gen, staged, got, reps)
    return res


def launches_of(fn):
    """(fn(), the launches and counted calls it made, by name: a name it
    did not count reads 0)."""
    before = all_launches()
    out = fn()
    return out, all_launches() - before


def forced_query(gen, staged, split=None, **route):
    """candgen_cuda.query_kernel on an uploaded batch with ``route``
    (one_block_max) in place of the default."""
    from gaml_tpu_torch.ops import candgen_cuda
    from gaml_tpu_torch.ops.candgen_device import stage_marker

    return candgen_cuda.query_kernel(
        gen, *staged, None, stage_marker(split, gen.device), **route)


def sort_against_torch(device, gen, staged, got, reps):
    """The hand-written sort against torch.sort(stable=True) on the same
    keys: on the radix route, the stage after the sync (CUDA events from
    the sync to the last pass's end, the host's launches included, median
    of ``reps``), the sort's device time (its histogram and scatter
    kernels, profiler, mean of ``reps``; the last pass writes the
    outputs), the expansion's, and device ops a query; beside torch.sort
    of the same compact keys as int64 (``got``'s segment << rid_bits |
    read id, in a seeded random order: a radix sort's cost does not
    depend on the order; CUDA events, and its kernels' device time),
    whose sorted keys must equal ``got``'s; where the candidates fit one
    block, that route's stage after the sync, its kernel's device time
    and device ops."""
    import torch

    from gaml_tpu_torch.ops import candgen_cuda
    from gaml_tpu_torch.ops.candgen_device import stage_ms

    def stage(name, **route):
        split = []
        forced_query(gen, staged, split, **route)
        return stage_ms(split)[name]

    res = {"candidates": got.n_total}
    if not got.n_total:
        return res
    stage("sort", one_block_max=0)
    res["after_sync_ms"] = float(np.median(
        [stage("sort", one_block_max=0) for _ in range(reps)]))
    ops, ms = device_profile(device, lambda: forced_query(
        gen, staged, one_block_max=0), reps)
    res["sort_device_ms"] = ms.get("candgen_hist_kernel", 0.0) \
        + ms.get("candgen_scatter_kernel", 0.0)
    res["expand_device_ms"] = ms.get("candgen_expand_kernel", 0.0)
    res["runs_device_ms"] = ms.get("candgen_runs_kernel", 0.0)
    res["radix_device_ops"] = ops
    seg_bits, rid_bits = candgen_cuda.key_bits(staged[2].shape[0],
                                                gen.row_of.shape[0])
    sorted_key = (got.seg << rid_bits) | got.rid
    rng = torch.Generator(device=device).manual_seed(got.n_total)
    key = sorted_key[torch.randperm(got.n_total, device=device,
                                    generator=rng)]
    check(torch.equal(torch.sort(key, stable=True).values, sorted_key),
          "the kernels' sorted keys differ from torch.sort's")
    res["torch_sort_ms"] = timer(device, lambda: torch.sort(key, stable=True),
                                 reps)
    res["torch_sort_device_ops"], ms = device_profile(
        device, lambda: torch.sort(key, stable=True), reps)
    res["torch_sort_device_ms"] = sum(ms.values())
    if got.n_total <= candgen_cuda.BLOCK_MAX and seg_bits + rid_bits <= 32:
        stage("block")
        res["block_ms"] = float(np.median([stage("block")
                                           for _ in range(reps)]))
        res["block_device_ops"], ms = device_profile(
            device, lambda: forced_query(gen, staged), reps)
        res["block_device_ms"] = ms.get("candgen_block_kernel", 0.0)
        res["block_runs_device_ms"] = ms.get("candgen_runs_kernel", 0.0)
    return res


def candgen_fuzz(gen, bundle, genome, n, seed=17):
    """``n`` anneal-sized window batches cut from ``genome``: 1-512
    segments of 60-3000 bp each, N codes in every third batch; on each
    the kernels bit-equal to query_plain and to the native query, by the
    default route and by the radix route; the default route's queries
    counted by route, and on the first batch of each route the sort
    against torch.sort (device ops of both routes)."""
    from gaml_tpu_torch.native import query_windows_batch

    rng = np.random.default_rng(seed)
    t0, cands = time.perf_counter(), 0
    routes = {"block": 0, "radix": 0, "none": 0}
    sorts = {}
    for b in range(n):
        k = int(rng.integers(1, 513))
        lens = rng.integers(60, 3001, k)
        starts = rng.integers(0, len(genome) - lens + 1)
        segs = [genome[a:a + ln].copy() for a, ln in zip(starts, lens)]
        if b % 3 == 0:
            for x in segs:
                x[rng.random(len(x)) < 0.002] = 4
        staged = gen.upload(segs)
        got, launches = launches_of(lambda: gen.query(staged=staged))
        want = gen.query_plain(staged=staged)
        same_candidates(got, want, f"fuzz batch {b}")
        same_candidates(forced_query(gen, staged, one_block_max=0), want,
                        f"fuzz batch {b}, radix route")
        route = "block" if launches["candgen_block"] else \
            "radix" if launches["candgen_expand"] else "none"
        routes[route] += 1
        if route != "none" and routes[route] == 1:
            sorts[route] = sort_against_torch(gen.device, gen, staged, got, 5)
        for i, (x, y) in enumerate(zip(native_layout(got, k),
                                       query_windows_batch(bundle, segs))):
            for name, u, v in zip(("rid", "g0", "r0", "orient"), x, y):
                check(np.array_equal(u, v), f"fuzz batch {b} window {i}: "
                      f"{name} differs from native")
        cands += got.n_total
    return {"batches": n, "candidates": cands, "routes": routes,
            "sort": sorts, "s": time.perf_counter() - t0}


def device_profile(device, fn, reps=1, kernels=r"candgen_\w+?_kernel"):
    """(kernels and copies the card ran for one fn() call, {kernel: device
    ms a call}) over ``reps`` calls under torch.profiler; the kernels
    matching ``kernels`` by name, "memset", "memcpy", the rest as "other";
    (None, {}) where the profiler saw no device activity."""
    import torch

    if device.type != "cuda":
        return None, {}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        sync(device)
    n, ms = 0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        m = re.search(kernels, e.name)
        name = m.group(0) if m else "memset" if "Memset" in e.name else \
            "memcpy" if "Memcpy" in e.name else "other"
        ms[name] = ms.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return (n / reps or None), ms


def candgen_split(device, batches, route, reps):
    """The stage split of one candgen route over window batches
    ``batches`` [(DeviceCandGen, seqs, cap)]: {stage: ms per query}, each
    stage's CUDA-event span (ops.candgen_device.stage_ms) summed over the
    batches and divided by their count (a stage a route skips counts 0),
    the median over ``reps`` passes after a warm one; "total_ms" their
    sum, "device_ops" the kernels and copies a query and "device_ms" each
    kernel's device time a query (profiler, one more pass over the
    batches).  ``route``: "kernel" (DeviceCandGen.query), "radix" (its
    kernels with the one-block threshold 0) or "plain" (query_plain)."""
    from gaml_tpu_torch.ops.candgen_device import stage_marker, stage_ms

    def query(gen, seqs, cap, split=None):
        if route == "plain":
            return gen.query_plain(seqs, cap, split=split)
        if route == "kernel":
            return gen.query(seqs, cap, split=split)
        mark = stage_marker(split, gen.device)
        staged = gen.upload(seqs)
        mark("upload")
        from gaml_tpu_torch.ops.candgen_cuda import query_kernel

        return query_kernel(gen, *staged, cap, mark, one_block_max=0)

    def one_pass():
        split = []
        for gen, seqs, cap in batches:
            query(gen, seqs, cap, split)
        return stage_ms(split)

    one_pass()
    passes = [one_pass() for _ in range(reps)]
    stages = {k: None for p in passes for k in p}
    res = {k: float(np.median([p.get(k, 0.0) for p in passes]))
           / len(batches) for k in stages}
    res["total_ms"] = sum(res.values())
    ops, ms = device_profile(device, lambda: [
        query(gen, seqs, cap) for gen, seqs, cap in batches])
    res["device_ops"] = ops and ops / len(batches)
    res["device_ms"] = {k: v / len(batches) for k, v in ms.items()}
    return res


def route_sweep(device, gen, genome, reps=20, seed=5):
    """The one-block route against the radix route on batches of k windows
    of 3000 bp cut from ``genome`` (k from 4 to 60: about 1k to 16k
    candidates at the aureus world's density): for each, its candidates,
    each route's ms from the uploaded codes (CUDA events around a call
    that ends in its host synchronisation and launches the rest, the
    median of ``reps``) and the device ms of its candgen kernels
    (profiler), both routes bit-equal to query_plain.  The one-block
    threshold is the largest count where it is the faster route."""
    from gaml_tpu_torch.ops import candgen_cuda

    rng = np.random.default_rng(seed)
    out = []
    for k in (4, 12, 24, 36, 48, 60):
        starts = rng.integers(0, len(genome) - 3000, k)
        staged = gen.upload([genome[a:a + 3000].copy() for a in starts])
        want = gen.query_plain(staged=staged)
        row = {"windows": k, "candidates": want.n_total}
        routes = {"radix": dict(one_block_max=0)}
        if want.n_total <= candgen_cuda.BLOCK_MAX:
            routes["block"] = dict(one_block_max=candgen_cuda.BLOCK_MAX)
        for name, route in routes.items():
            same_candidates(forced_query(gen, staged, **route), want,
                            f"{k} windows, {name} route")
            row[name + "_ms"] = timer(device, lambda: forced_query(
                gen, staged, **route), reps)
            _ops, ms = device_profile(device, lambda: forced_query(
                gen, staged, **route), reps)
            row[name + "_device_ms"] = sum(
                v for key, v in ms.items() if key.startswith("candgen"))
        out.append(row)
    return out


def anneal_batches(device, d, iterations=100):
    """The window batches of phase 4's anneal (its world in ``d``) over
    its first ``iterations`` moves, recorded where they reach
    DeviceCandGen.query (answered by query_plain while recording):
    [(DeviceCandGen, seqs, cap)]."""
    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen

    real, rec = DeviceCandGen.query, []

    def query(self, seqs=None, cap=None, staged=None, split=None):
        rec.append((self, seqs, cap))
        return self.query_plain(seqs, cap, staged, split)

    DeviceCandGen.query = query
    try:
        cli_in_process(device, d, write_config(d, "split", iterations), [],
                       env={"GAML_DEV_MIN_BASES": "0"})
    finally:
        DeviceCandGen.query = real
    return rec


def candgen_split_main(routes):
    """``--candgen-split [routes]``: each route's stage split on the bench
    world, the aureus world and phase 4's anneal batches, and with the
    kernel route the sort against torch.sort (sort_against_torch; on the
    anneal's first 20 batches, their mean) and the two sort routes on
    batches of 1k-16k candidates (route_sweep); one JSON line."""
    import torch

    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi}
    for tag, world in (("bench", (400_000, 100_000)),
                       ("aureus", (2_800_000, 300_000))):
        genome, reads = make_world(*world)
        gen = DeviceCandGen(make_bundle(reads), device)
        out[tag + ".candidates"] = gen.query_plain([genome]).n_total
        for route in routes:
            out[f"{tag}.{route}"] = candgen_split(
                device, [(gen, [genome], None)], route, 10)
        if "kernel" in routes:
            staged = gen.upload([genome])
            out[tag + ".sort"] = sort_against_torch(
                device, gen, staged, gen.query(staged=staged), 10)
            if tag == "aureus":
                out["route_sweep"] = route_sweep(device, gen, genome)
        print(json.dumps({k: v for k, v in out.items()
                          if k.startswith(tag)}), flush=True)
    with tempfile.TemporaryDirectory(prefix="gaml_split_") as d:
        write_anneal_world(d)
        batches = anneal_batches(device, d)
        out["anneal.batches"] = len(batches)
        out["anneal.segments_per_batch"] = float(np.mean(
            [len(s) for _g, s, _c in batches]))
        out["anneal.bases_per_batch"] = float(np.mean(
            [sum(map(len, s)) for _g, s, _c in batches]))
        out["anneal.candidates_per_batch"] = float(np.mean(
            [g.query_plain(s, c).n_total for g, s, c in batches]))
        for route in routes:
            out["anneal." + route] = candgen_split(device, batches, route, 3)
        if "kernel" in routes:
            sorts = [sort_against_torch(device, g, st, g.query(staged=st), 3)
                     for g, s, _c in batches[:20]
                     for st in [g.upload(s)]]
            sorts = [x for x in sorts if x["candidates"]]
            out["anneal.sort"] = {k: float(np.mean([x[k] for x in sorts]))
                                  for k in sorts[0]
                                  if all(x.get(k) is not None
                                         for x in sorts)}
    print(json.dumps(out), flush=True)
    return 0


# ------------------------------------------------------------------ phase 4
def write_anneal_world(d, genome_mb=2.8, n_frag=150_000, n_adv=30_000):
    """examples/aureus_like_run.py's world (seed 13) as LastGraph + FASTQ:
    long nodes 1200-6000 bp alternating with 60-300 bp ones in a chain,
    90 bp side branches, a frag library 180+-20 and an advice library
    3700+-350 of 100 bp innie pairs with 0.5 % substitutions."""
    from gaml_tpu_torch.core import dna

    rng = np.random.default_rng(13)
    genome_len = int(genome_mb * 1_000_000)
    segments = []
    remaining = genome_len
    while remaining > 0:
        ln = int(rng.integers(1200, 6000)) if len(segments) % 2 == 0 \
            else int(rng.integers(60, 300))
        ln = min(ln, remaining)
        segments.append(rng.integers(0, 4, ln).astype(np.uint8))
        remaining -= ln
    nodes = list(segments)
    arcs = [(i + 1, i + 2) for i in range(len(segments) - 1)]
    for _ in range(len(segments) // 4):
        src = int(rng.integers(0, len(segments) - 1))
        nodes.append(rng.integers(0, 4, 90).astype(np.uint8))
        arcs.append((src + 1, len(nodes)))
    genome = np.concatenate(segments)
    lines = [f"{len(nodes)}\t0\t0\t1"]
    for i, s in enumerate(nodes):
        lines += [f"NODE\t{i + 1}", dna.decode_seq(s),
                  dna.decode_seq(dna.revcomp(s))]
    lines += [f"ARC\t{a}\t{b}" for a, b in arcs]
    with open(os.path.join(d, "LastGraph"), "w") as f:
        f.write("\n".join(lines) + "\n")

    def pairs(n, im, istd, err=0.005):
        ins = np.clip(rng.normal(im, istd, n).astype(int), 2 * READ_LEN,
                      len(genome) - 1)
        p = rng.integers(0, len(genome) - ins)
        col = np.arange(READ_LEN)
        m1 = genome[p[:, None] + col]
        m2 = dna._COMP_LUT[genome[(p + ins - READ_LEN)[:, None] + col]][
            :, ::-1]
        for m in (m1, m2):
            errs = rng.random(m.shape) < err
            m[errs] = (m[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
        return m1, m2

    lut = dna._DECODE_LUT
    qual = b"I" * READ_LEN
    for name, mat in zip(("f1", "f2", "a1", "a2"),
                         pairs(n_frag, 180, 20) + pairs(n_adv, 3700, 350)):
        seqs = lut[mat]
        with open(os.path.join(d, f"{name}.fq"), "wb") as f:
            for i in range(len(seqs)):
                f.write(b"@%s%d\n%s\n+\n%s\n" % (name.encode(), i,
                                                 seqs[i].tobytes(), qual))
    return len(genome), len(nodes)


def write_config(d, name, iterations, frag="f"):
    """The anneal config; ``frag`` names the frag library's FASTQ pair
    (<frag>1.fq, <frag>2.fq)."""
    cfg = os.path.join(d, f"{name}.cfg")
    libs = (("frag", frag, 180, 20, 0.00007, 30, False),
            ("adv", "a", 3700, 350, 0.00013, 3000, True))
    text = [f"graph={d}/LastGraph", f"max_iterations={iterations}",
            f"output_prefix={d}/{name}", "seed=47", ""]
    for lib, fq, im, istd, pc, step, advice in libs:
        text += [f"[{lib}]", "type=paired", f"filename1={d}/{fq}1.fq",
                 f"filename2={d}/{fq}2.fq", f"insert_mean={im}",
                 f"insert_std={istd}", f"penalty_constant={pc}",
                 f"penalty_step={step}", f"cache_prefix={d}/{name}_{lib}"]
        text += ["advice=1", ""] if advice else [""]
    with open(cfg, "w") as f:
        f.write("\n".join(text))
    return cfg


def run_cli(module, cfg, extra, timeout):
    """One anneal in its own process; returns (stdout, wall seconds)."""
    env = dict(os.environ, GAML_DEV_MIN_BASES="0")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, cfg, *extra],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{module} {' '.join(extra)} exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


def summary_of(text):
    """The CLI's device-work summary (its last line) as a dict, its
    launches a Counter (a name the line leaves out was never counted and
    reads 0)."""
    summary = json.loads(text.strip().splitlines()[-1]
                         .split("device work: ", 1)[1])
    summary["launches"] = Counter(summary["launches"])
    return summary


def trace(text):
    """itnum lines with the timestamp field stripped."""
    out = []
    for line in text.splitlines():
        if line.startswith("itnum"):
            f = line.split()
            del f[5]
            out.append(" ".join(f))
    return out


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        return min(len(a), len(b)), "<end>", "<end>"
    return None


def anneal_against_cpu_and_bfs(device, d, iterations, check_iterations,
                               timeout, launched, frag="f", tag=""):
    """The port's CLI on ``device`` against --device cpu (must agree over
    the cpu run's iterations) and against the port's --backend bfs, the
    native host route (reported, with its anneal_s), on the world in
    ``d``; outputs and caches are named <tag>dev, <tag>bfs, <tag>cpu.
    Every kernel named in ``launched`` must have been launched by the
    ``device`` run, and neither it nor the cpu run may call the host
    candidate pass (gen_candidates)."""
    dev, bfs, cpu = (tag + x for x in ("dev", "bfs", "cpu"))
    dev_out, dev_wall = run_cli(
        "gaml_tpu_torch.cli", write_config(d, dev, iterations, frag),
        ["--device", str(device)], timeout)
    bfs_out, bfs_wall = run_cli(
        "gaml_tpu_torch.cli", write_config(d, bfs, iterations, frag),
        ["--backend", "bfs", "--device", "cpu"], timeout)
    cpu_out, cpu_wall = run_cli(
        "gaml_tpu_torch.cli", write_config(d, cpu, check_iterations, frag),
        ["--device", "cpu"], timeout)
    dev_tr, bfs_tr, cpu_tr = trace(dev_out), trace(bfs_out), trace(cpu_out)
    summary = summary_of(dev_out)
    for out in (dev_out, cpu_out):
        check(summary_of(out)["launches"]["gen_candidates"] == 0,
              f"the anneal ran the host candidate pass: {summary_of(out)}")
    check(len(dev_tr) >= iterations and len(cpu_tr) >= check_iterations,
          f"short traces: {len(dev_tr)} / {len(cpu_tr)} itnum lines")
    check(dev_tr[:len(cpu_tr)] == cpu_tr,
          f"{device} and cpu traces differ: "
          f"{first_difference(dev_tr, cpu_tr)}")
    check(summary["batches"] > 0 and summary["candidates"] > 0,
          f"no window batch reached the device: {summary}")
    check(device.type != "cuda" or all(
        summary["launches"][k] > 0 for k in launched),
        f"a kernel was not launched by the anneal: {summary}")
    check(device.type != "cuda" or summary["launches"]["query_plain"] == 0,
          f"the anneal ran query_plain on the card: {summary}")
    best = float(dev_tr[-1].split()[9])
    check(np.isfinite(best), f"best prob {best}")
    files = {}
    for ext in ("walks", "fasta"):
        with open(os.path.join(d, f"{dev}.{ext}"), "rb") as f:
            a = f.read()
        with open(os.path.join(d, f"{bfs}.{ext}"), "rb") as f:
            b = f.read()
        check(len(a) > 0, f"empty {dev}.{ext}")
        files[ext] = "identical" if a == b else "differ"
    diff = first_difference(dev_tr, bfs_tr)
    res = {"iterations": iterations,
           "dev_wall_s": dev_wall, "bfs_wall_s": bfs_wall,
           "cpu_wall_s": cpu_wall, "cpu_iterations": check_iterations,
           "dev_anneal_s": summary["anneal_s"],
           "bfs_anneal_s": summary_of(bfs_out)["anneal_s"],
           "ms_per_move": summary["anneal_s"] / iterations * 1e3,
           "best_prob": best, "batches": summary["batches"],
           "candidates": summary["candidates"],
           "launches": summary["launches"],
           "vs_bfs_trace": "identical" if diff is None else
           f"first difference at line {diff[0]}",
           "vs_bfs_files": files}
    return res, diff, dev_tr


def phase_anneal(device, d, world, iterations=200, check_iterations=40,
                 timeout=450):
    """The anneal on the aureus world written to ``d`` (``world``: its
    genome length, node count and seconds to write)."""
    res, diff, dev_tr = anneal_against_cpu_and_bfs(
        device, d, iterations, check_iterations, timeout,
        ("extend_exact", "candgen_runs", "candgen_block"))
    res = dict(zip(("genome", "nodes", "world_s"), world), **res)
    print("  " + json.dumps(res), flush=True)
    if diff is not None:
        print(f"  {device}: {diff[1]}\n  bfs:  {diff[2]}", flush=True)
    res["trace"] = dev_tr  # phase 11's reference (not printed)
    return res


# ------------------------------------------------------------------ phase 5
def ptxas_usage(log, name):
    """{"registers", "spill_stores", "spill_loads"} of each kernel whose
    mangled name contains ``name``, from the compiler's -Xptxas -v."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and name in entry:
            use = out.setdefault(entry, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                use["spill_stores"], use["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                use["registers"] = int(m.group(1))
    return list(out.values())


def forward_bound(args, width):
    """The bound of K5 on its inputs, the largest of: 3 FP32 instructions
    per band cell (the emission product, the up term's FMA, the chain
    FMA) over FP32_OPS; the read and step bytes of each job's rows, the
    walk buffer once, seven int32 in and one float32 out per job over
    HBM_BPS; and the serial floor, the longest job's rows at one dependent
    FMA (4 cycles) each.  ``mufu_bound_ms`` is the bound stated for the
    earlier log-space form of the kernel: 4 special-function results (two
    log-add-exps) per band cell over MUFU_OPS."""
    reads, _row, seq, _steps, _c0, _gs, _gl, rlen = args
    rows = int(rlen.sum())
    terms = {"fp32": 3 * rows * width / FP32_OPS * 1e3,
             "bytes": (2 * rows + seq.numel() + 32 * rlen.shape[0])
             / HBM_BPS * 1e3,
             "serial": int(rlen.max()) * 4 / SM_HZ * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms,
            "fp32_ops": 3 * rows * width,
            "mufu_bound_ms": 4 * rows * width / MUFU_OPS * 1e3}


def phase_forward_kernel(device, reps=10, **shape):
    """K5 against its plain version at both band widths, on an S.
    aureus-sized batch (forward_bench.aureus_batch: 2.8 Mb walk buffer,
    2048 jobs, reads of 640-5120) and on the adversarial batch
    (forward_bench.adversarial_batch, 72 jobs of 2-5 kb), each against the
    log-space plain version in float32 and in float64 and against the
    float64 twin of the kernel's arithmetic (banded_forward_scaled), with
    the tolerance |kernel - plain| <= 1e-4 |plain| + 1e-3 per job."""
    import torch

    from gaml_tpu_torch.ops import forward_cuda as fc
    from gaml_tpu_torch.tools.forward_bench import (adversarial_batch,
                                                    aureus_batch, to_device,
                                                    within_tolerance)

    batches = {"aureus": to_device(aureus_batch(0, **shape), device),
               "adversarial": to_device(adversarial_batch(3, n_jobs=72),
                                        device)}
    lm, lmm = float(np.log(PB_MATCH)), float(np.log(PB_MISMATCH))
    refs = {"f32": {}, "f64": {"dtype": torch.float64},
            "twin": {"scaled": True}}
    out = {}
    for width in (64, 128):
        res = {}
        for name, args in batches.items():
            got = fc.banded_forward(*args, lm, lmm, width)
            sync(device)
            check(bool(torch.isfinite(got).all()),
                  f"K5 W={width} {name}: non-finite")
            for ref, kw in refs.items():
                t0 = time.perf_counter()
                want = fc.banded_forward_ref(*args, lm, lmm, width, **kw)
                sync(device)
                if name == "aureus" and ref == "f32":
                    res["plain_ms"] = (time.perf_counter() - t0) * 1e3
                    res["max_rel_err"] = float(
                        ((got - want).abs() / want.abs()).max())
                bad, err = within_tolerance(got, want)
                check(bad == 0,
                      f"K5 W={width} {name}: {bad} jobs outside the "
                      f"tolerance of the {ref} plain version (max abs err "
                      f"{err:.3g})")
                key = "max_abs_err" if ref == "f32" else \
                    f"max_abs_err_{ref}"
                res[key if name == "aureus" else f"{name}_{key}"] = err
        args = batches["aureus"]
        res["ms"] = timer(device, lambda: fc.banded_forward(
            *args, lm, lmm, width), reps)
        res["cells_per_s"] = int(args[7].sum()) * width / (res["ms"] / 1e3)
        res.update(forward_bound(args, width))
        res["share"] = res["bound_ms"] / res["ms"]
        out[width] = res
        print(f"  W={width} jobs={len(args[7])} rmax={args[3].shape[1]} "
              f"cells={int(args[7].sum()) * width}: " + json.dumps(res),
              flush=True)
    return out


# -------------------------------------------------------------- phases 6-7
def write_pacbio_world(d, genome_kb=1000, n_reads=500, read_len=3000):
    """examples/pacbio_run.py's world (seed 5) as LastGraph + FASTQ: a
    chain of long nodes (2-8 kb) alternating with short ones (80-400 bp),
    and long reads with 10 % errors (4 % substitutions, 3 % insertions,
    3 % deletions), half of them reverse-complemented.  Returns the truth
    genome's codes."""
    from gaml_tpu_torch.core import dna

    rng = np.random.default_rng(5)
    segments = []
    remaining = genome_kb * 1000
    while remaining > 0:
        ln = int(rng.integers(2000, 8000)) if len(segments) % 2 == 0 \
            else int(rng.integers(80, 400))
        ln = min(ln, remaining)
        segments.append(rng.integers(0, 4, ln).astype(np.uint8))
        remaining -= ln
    genome = np.concatenate(segments)
    lines = [f"{len(segments)}\t0\t0\t1"]
    for i, sq in enumerate(segments):
        lines += [f"NODE\t{i + 1}", dna.decode_seq(sq),
                  dna.decode_seq(dna.revcomp(sq))]
    lines += [f"ARC\t{i + 1}\t{i + 2}" for i in range(len(segments) - 1)]
    with open(os.path.join(d, "LastGraph"), "w") as f:
        f.write("\n".join(lines) + "\n")

    def noisy(read, err=0.1):
        out = []
        for c in read:
            u = rng.random()
            if u < err * 0.4:
                out.append(int(rng.integers(0, 4)))
            elif u < err * 0.7:
                out.append(int(c))
                out.append(int(rng.integers(0, 4)))
            elif u < err:
                continue
            else:
                out.append(int(c))
        return np.array(out, dtype=np.uint8)

    with open(os.path.join(d, "pb.fq"), "w") as f:
        for i in range(n_reads):
            p = int(rng.integers(0, len(genome) - read_len))
            r = noisy(genome[p:p + read_len])
            if rng.random() < 0.5:
                r = dna.revcomp(r)
            sq = dna.decode_seq(r)
            f.write(f"@pb{i}\n{sq}\n+\n{'I' * len(sq)}\n")
    return genome


def pacbio_readsets(d, graph, device):
    """Two PacbioReadSets of the world in ``d`` (same reads and anchors,
    separate alignment caches): one for the native route, one whose
    device batches run on ``device``."""
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    sets = []
    for name in ("nat", "dev"):
        rs = PacbioReadSet(os.path.join(d, f"pb_{name}"),
                           os.path.join(d, "pb.fq"), PB_MATCH, PB_MISMATCH,
                           device=device)
        rs.preprocess_reads()
        sets.append(rs)
    nat, dev = sets
    nat.compute_anchors(graph, persist=False)
    for attr in ("anchors_cache", "anchors_begin", "anchors_end",
                 "anchors_reverse"):
        setattr(dev, attr, getattr(nat, attr))
    return nat, dev


def with_min_cells(value, fn, *args):
    old = os.environ.get("GAML_PB_DEVICE_MIN_CELLS")
    os.environ["GAML_PB_DEVICE_MIN_CELLS"] = str(value)
    try:
        return fn(*args)
    finally:
        if old is None:
            del os.environ["GAML_PB_DEVICE_MIN_CELLS"]
        else:
            os.environ["GAML_PB_DEVICE_MIN_CELLS"] = old


NATIVE = 1 << 62  # GAML_PB_DEVICE_MIN_CELLS that keeps every batch native


def route(device):
    """The dp_cells key of the port's forward batches on ``device``."""
    return "cuda" if device.type == "cuda" else "torch"


def phase_pacbio_scoring(device, d, reps=3):
    """The start walks' bulk precompute and walk scores on the port's
    read set (every batch on ``device``) against the native route:
    positions equal, logprobs within rel 1e-4, abs 1e-3 (the bound of
    tests/test_pacbio.py's device-route tests).  Then a ladder of batch
    sizes over that precompute's jobs, timing each route, to find the
    crossover in DP cells (the smallest rung from which the card wins
    every rung)."""
    from gaml_tpu_torch.core.io import load_lastgraph

    t0 = time.perf_counter()
    graph = load_lastgraph(os.path.join(d, "LastGraph"))
    nat, dev = pacbio_readsets(d, graph, device)
    t_setup = time.perf_counter() - t0
    walks = [[i] for i in range(0, graph.num_nodes, 2)
             if graph.node_len(i) > 500]
    batches, dp_s = [], {}

    def recorded(rs, tag):
        orig = rs._forward_batch

        def rec(seq, jobs, extents=None):
            t0 = time.perf_counter()
            out = orig(seq, jobs, extents)
            dp_s[tag] = dp_s.get(tag, 0.0) + time.perf_counter() - t0
            if tag == "device":
                batches.append((seq, jobs, extents))
            return out

        rs._forward_batch = rec

    recorded(nat, "native")
    recorded(dev, "device")
    t0 = time.perf_counter()
    with_min_cells(NATIVE, nat.precompute_ranges_for_paths, graph, walks)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    with_min_cells(0, dev.precompute_ranges_for_paths, graph, walks)
    sync(device)
    t_dev = time.perf_counter() - t0
    del nat._forward_batch, dev._forward_batch
    check(set(nat.dp_cells) == {"native"}, f"native route: {nat.dp_cells}")
    check(set(dev.dp_cells) == {route(device)}, f"port: {dev.dp_cells}")
    n_al, worst = 0, 0.0
    for w in walks:
        pn, tn = with_min_cells(NATIVE, nat.get_read_probabilities, graph, w)
        pd, td = with_min_cells(0, dev.get_read_probabilities, graph, w)
        check(tn == td, f"walk {w}: total length {td} vs native {tn}")
        for rid, (a, b) in enumerate(zip(pn, pd)):
            check([p for p, _ in a] == [p for p, _ in b],
                  f"walk {w} read {rid}: positions differ")
            for (_p, x), (_q, y) in zip(a, b):
                check(np.isfinite(y) and abs(y - x) <= 1e-3 + 1e-4 * abs(x),
                      f"walk {w} read {rid}: logprob {y} vs native {x}")
                worst = max(worst, abs(y - x))
                n_al += 1
    check(n_al > 0, "no read aligned")
    seq, jobs, extents = max(batches, key=lambda b: len(b[1]))
    width = dev.forward_width
    ladder = []

    def rung(sub, ext):
        t_n = timer(device, lambda: with_min_cells(
            NATIVE, nat._forward_batch, seq, sub, ext), reps, host_clock=True)
        t_d = timer(device, lambda: with_min_cells(
            0, dev._forward_batch, seq, sub, ext), reps, host_clock=True)
        ladder.append({"jobs": len(sub),
                       "cells": sum(len(j[0]) for j in sub) * width,
                       "native_ms": t_n, "device_ms": t_d})

    # batches smaller than one job: prefixes of the first job's read
    q, centers, *meta = jobs[0]
    for n in (128, 256, 512, 1024, 2048):
        if n < len(q):
            rung([(q[:n], centers[:n + 1], *meta)],
                 extents[:1] if extents else None)
    # then 1, 2, 4, ... jobs, until the card has won three rungs in a row
    k = 1
    while True:
        rung(jobs[:k], extents[:k] if extents else None)
        if k == len(jobs) or all(r["device_ms"] < r["native_ms"]
                                 for r in ladder[-3:]):
            break
        k = min(2 * k, len(jobs))
    crossover = next((r["cells"] for i, r in enumerate(ladder)
                      if all(x["device_ms"] < x["native_ms"]
                             for x in ladder[i:])), None)
    res = {"walks": len(walks), "reads": nat.reads_num,
           "precompute_jobs": sum(len(b[1]) for b in batches),
           "dp_cells": dev.dp_cells[route(device)],
           "native_s": t_nat, "device_s": t_dev, "setup_s": t_setup,
           "native_dp_s": dp_s["native"], "device_dp_s": dp_s["device"],
           "alignments": n_al, "max_abs_err": worst,
           "crossover_cells": crossover}
    print("  " + json.dumps(res), flush=True)
    for r in ladder:
        print("  ladder " + json.dumps(r), flush=True)
    return res


# ----------------------------------------------------------------- phase 6b
def ecoli_pacbio_world(d, device, seed):
    """The benchmark's ``ecoli_pacbio`` world at the ``pacbio.rescore``
    cell's size from ``seed`` (benchmark/worlds/pacbio.py, the CLI's
    set-up of its long-read library on ``device``): (graph, read set,
    the cell's pool of walk sets)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    from harness import common

    from gaml_tpu_torch.cli import prepare_reads, starting_paths_from_config
    from gaml_tpu_torch.config import load_config, prepare_read_sets
    from gaml_tpu_torch.core.io import load_lastgraph
    from gaml_tpu_torch.optimize.settings import AssemblySettings

    worlds = common.load_module("worlds", "pacbio")
    bench = os.path.join(ROOT, "benchmark")
    with open(os.path.join(bench, "configs", "ecoli_pacbio.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "traffic", "pacbio_rescore.json")) as f:
        tr = json.load(f)
    s_world, s_pool = common.seeds(seed, 2)
    world = worlds.make(cfg, s_world, d)
    path = worlds.write_cli_config(cfg, world, 0, os.path.join(d, "out"))
    configs, sections = load_config(path)
    _s, _p, pacbio = prepare_read_sets({tr["library"]: sections[
        tr["library"]]}, backend="device", device=str(device))
    graph = load_lastgraph(configs["graph"])
    start = starting_paths_from_config(
        configs, graph, AssemblySettings.from_config(configs),
        write_outputs=False)
    prepare_reads([], [], pacbio, graph)
    pool = worlds.walk_pool(np.random.default_rng(s_pool), world, start, tr)
    return graph, pacbio[0][1], pool


def seed_batches(rs, graph, pool):
    """The seed lookup's batch (seqs, rids) and the forward batch (seq,
    jobs, extents) of each walk set's precompute from an empty cache, as a
    ``pacbio.rescore`` request makes them, and the program's counters of
    the precomputes (traced under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from gaml_tpu_torch.utils.metrics import TRACE

    got, fwd = [], []
    lookup, forward = rs._seed_hits, rs._forward_batch

    def recorded(seqs, rids):
        got.append((seqs, rids))
        return lookup(seqs, rids)

    def recorded_forward(seq, jobs, extents=None):
        fwd.append((seq, jobs, extents))
        return forward(seq, jobs, extents)

    rs._seed_hits, rs._forward_batch = recorded, recorded_forward
    TRACE.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for walks in pool:
                rs.aligment_cache = {}
                rs.precompute_ranges_for_paths(graph, walks)
        counters = dict(TRACE.counters)
    finally:
        del rs._seed_hits, rs._forward_batch
        TRACE.reset()
    return got, fwd, counters


def seeds_bound(seq_len, seg_row, seg_len, n_hits):
    """The seed pass's bound: what the function itself must move, over
    HBM_BPS.  Each distinct resident row read once (its read's bases; a
    row looked up in several ranges counts once), the walk bases read
    once, the hits (8 bytes) and the segment offsets (8 bytes, n_seg + 1)
    written.  The sorted index (8 bytes a walk k-mer) is the kernels' own
    intermediate and fits in L2, so it is left out."""
    rows = dict(zip(np.asarray(seg_row).tolist(),
                    np.asarray(seg_len).tolist()))
    nbytes = int(sum(rows.values())) + seq_len + 8 * n_hits + \
        8 * (len(seg_len) + 1)
    return {"bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes,
            "distinct_rows": len(rows), "bound_by": "bytes"}


def seed_launches(batches):
    """The launches of each seed kernel that the precomputes recorded in
    ``batches`` (seed_batches' (seqs, rids)) must make: one batch each
    with a query k-mer and a walk k-mer, and in it one keys, count, scan
    and expand launch, ``passes`` scatters and ``passes - 1`` histograms,
    ``passes`` the 8-bit digits of a 26-bit k-mer under its range."""
    from gaml_tpu_torch.align.longread import SEED_K

    want = dict.fromkeys(("seeds_keys", "seeds_hist", "seeds_scatter",
                          "seeds_count", "seeds_scan", "seeds_expand"), 0)
    for seqs, rids in batches:
        if not any(rids) or not any(len(x) >= SEED_K for x in seqs):
            continue
        passes = -(-(2 * SEED_K + (len(seqs) - 1).bit_length()) // 8)
        for k in ("seeds_keys", "seeds_count", "seeds_scan",
                  "seeds_expand"):
            want[k] += 1
        want["seeds_scatter"] += passes
        want["seeds_hist"] += passes - 1
    return want


def stage_bound(n_centers, n_jobs, rmax):
    """The staging kernel's bound: the centers (4 bytes), offsets (8,
    n_jobs + 1) and gstarts (4) read once, the steps (n_jobs x rmax
    bytes) and c0 (4) written once, over HBM_BPS."""
    nbytes = 4 * n_centers + 8 * (n_jobs + 1) + 8 * n_jobs + n_jobs * rmax
    return {"bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes,
            "bound_by": "bytes"}


def stage_cases(device, rs, batches, reps):
    """Each forward batch (seq, jobs, extents) of seed_batches staged
    raggedly (ragged_arrays, ForwardDeviceEngine.stage) against the padded
    staging it replaced (job_arrays' padded centers, their int64 diff on
    the host, the uploads): the inputs K5 reads equal; host ms of each to
    its uploaded inputs (synchronised); the staging kernel alone on the
    uploaded centers: card ms (CUDA events around one launch, and a
    launch's share of 50 back to back), device ms a launch (torch.profiler
    over 50 back to back, and over one launch; null where the profiler
    sees no launch), its plain version's ms on the card, the bound, its
    share of the bound (of the device ms, else of the back-to-back ms, as
    ``share_of`` says) and the launches a call."""
    import torch

    from gaml_tpu_torch.ops import forward_cuda
    from gaml_tpu_torch.scoring.pacbio import job_arrays, ragged_arrays

    eng = rs._ensure_fwd_engine()

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = []
    for k, (seq, jobs, extents) in enumerate(batches):
        def ragged():
            staged = eng.stage(seq, *ragged_arrays(seq, jobs, extents))
            sync(device)
            return staged

        def padded():
            (_rmax, _reads, rlens, centers, gstarts,
             glens) = job_arrays(seq, jobs, extents)
            steps = np.clip(np.diff(centers.astype(np.int64), axis=1), 0,
                            2).astype(np.uint8)
            row = np.array([j[2] + j[3] * eng.n_reads for j in jobs])
            meta = up(np.stack([np.asarray(x, dtype=np.int32) for x in (
                row, centers[:, 0], gstarts, glens, rlens)]))
            staged = (eng.rows, meta[0], up(seq), up(steps), meta[1],
                      meta[2], meta[3], meta[4])
            sync(device)
            return staged

        got, want = ragged(), padded()
        names = ("rows", "row", "seq", "steps", "c0", "gstart", "glen",
                 "rlen")
        for name, a, b in zip(names, got, want):
            check(a.shape == b.shape and torch.equal(a, b),
                  f"walk set {k}: the ragged staging's {name} differs from "
                  f"the padded staging's")
        rmax, centers, offsets, gstarts = ragged_arrays(seq, jobs,
                                                        extents)[:4]
        args = [up(a) for a in (centers, offsets, gstarts)]

        def kernel():
            return forward_cuda.forward_stage(*args, rmax)

        def plain():
            return forward_cuda.forward_stage_ref(*args, rmax)

        def fifty():
            return [kernel() for _ in range(50)]

        (steps, c0), launched = launches_of(kernel)
        p_steps, p_c0 = plain()
        check(torch.equal(steps, p_steps) and torch.equal(c0, p_c0),
              f"walk set {k}: the staging kernel differs from its plain "
              f"version")
        seen = {}
        for name, fn, n in (("device_ms", fifty, 50),
                            ("lone_device_ms", kernel, 1)):
            _n, dev = device_profile(device, fn, reps,
                                     kernels=STAGE_KERNEL)
            seen[name] = (dev[STAGE_KERNEL] / n
                          if STAGE_KERNEL in dev else None)
        back_to_back = timer(device, fifty, reps) / 50
        bound = stage_bound(len(centers), len(jobs), rmax)
        share_of = "device_ms" if seen["device_ms"] else "back_to_back_ms"
        res = {"case": f"walk set {k}", "jobs": len(jobs),
               "centers": len(centers), "rmax": rmax,
               "ranges": len({e[0] for e in extents}) if extents else 1,
               "ragged_host_ms": timer(device, ragged, reps,
                                       host_clock=True),
               "padded_host_ms": timer(device, padded, 1, host_clock=True),
               "card_ms": timer(device, kernel, reps),
               "back_to_back_ms": back_to_back, **seen,
               "plain_ms": timer(device, plain, reps),
               "launches": launched["forward_stage"], **bound,
               "share_of": share_of,
               "share_of_bound_pct": 100 * bound["bound_ms"] / (
                   seen["device_ms"] or back_to_back)}
        print("  stage " + json.dumps(res), flush=True)
        out.append(res)
    return out


def phase_seeds(device, seed=1181783497, reps=5):
    """The long-read seed lookup at the ``pacbio.rescore`` cell's shapes:
    each walk set's batch (every range of its precompute, every anchored
    read on both strands) through the kernels (csrc/seeds.cu), their plain
    torch version on the card and the host index the card route replaces
    (its packed read k-mers warm, as between requests); the three hit
    lists equal; wall ms a batch (median of ``reps``, each ending in the
    read-back), the kernels' device ms (torch.profiler), the bound, the
    launches a batch.  The precomputes themselves (the read set's entry
    point) must launch the kernels once a walk set (seed_launches), and
    stage each walk set's one forward batch raggedly.  Then the smallest
    range of the start walks alone, the size an anneal move's miss has,
    the same three ways.  Last, each forward batch's staging
    (stage_cases)."""
    from gaml_tpu_torch.ops import seeds_device

    with tempfile.TemporaryDirectory(prefix="gaml_smoke_seeds_") as d:
        t0 = time.perf_counter()
        graph, rs, pool = ecoli_pacbio_world(d, device, seed)
        t_world = time.perf_counter() - t0
        (batches, fwd_batches, counters), ran_all = launches_of(
            lambda: seed_batches(rs, graph, pool))
    want = seed_launches(batches)
    ran = {k: ran_all[k] for k in want}
    check(len(batches) == len(pool) and want["seeds_keys"] == len(pool),
          f"{len(batches)} seed batches of {want['seeds_keys']} with "
          f"queries from {len(pool)} walk sets")
    check(ran == want, f"the precomputes launched the seed kernels "
          f"{ran}, not {want}")
    staging = {"forward_batches": len(fwd_batches),
               "banded_forward": ran_all["banded_forward"],
               "forward_stage": ran_all["forward_stage"],
               "pacbio.device_batches": counters.get(
                   "pacbio.device_batches", 0)}
    check(len(fwd_batches) == len(pool) and
          staging["banded_forward"] == staging["forward_stage"] ==
          staging["pacbio.device_batches"] == len(pool),
          f"the precomputes' forward batches were not each staged "
          f"raggedly once: {staging}")
    print("  staging " + json.dumps(staging), flush=True)
    eng = rs._seed_engine()
    check(eng is not None, "the read set on the card has no resident rows")
    ws = seeds_device.Workspace()
    smallest = min((len(s), i) for i, (s, r) in enumerate(
        zip(*batches[0])) if r)[1]
    cases = [(f"walk set {k}", seqs, rids)
             for k, (seqs, rids) in enumerate(batches)]
    cases.append(("one small range", [batches[0][0][smallest]],
                  [batches[0][1][smallest]]))
    out = []
    for name, seqs, rids in cases:
        segs = [(rid + strand * eng.n_reads, i, len(rs.read_seq[rid]))
                for i, rr in enumerate(rids) for rid in rr
                for strand in (0, 1)]
        seg_row, seg_range, seg_len = (np.array(c, dtype=np.int64)
                                       for c in zip(*segs))
        args = (np.concatenate(seqs), [len(x) for x in seqs], seg_row,
                seg_range, seg_len)

        def kernel():
            return seeds_device.seed_hits(eng.rows, *args, ws)

        def plain():
            return seeds_device.seed_hits_plain(eng.rows, *args)

        def host():
            return rs._seed_hits_host(seqs, rids)

        got, launched = launches_of(kernel)
        launches = sum(launched.values())
        want = plain()
        check(np.array_equal(got[0], want[0]) and
              np.array_equal(got[1], want[1]),
              f"{name}: the seed kernels differ from their plain version")
        hits_host, n_host = host()
        flat = [h for per in hits_host for pair in per for h in pair]
        check(n_host == len(got[1]) and len(flat) == len(seg_len) and all(
            np.array_equal(t, got[1][a:b, 0]) and
            np.array_equal(q, got[1][a:b, 1])
            for (t, q), a, b in zip(flat, got[0][:-1], got[0][1:])),
            f"{name}: the seed kernels differ from the host index")
        kern_ms = timer(device, kernel, reps, host_clock=True)
        plain_ms = timer(device, plain, reps, host_clock=True)
        host_ms = timer(device, host, max(reps // 2, 1), host_clock=True)
        _n, dev = device_profile(device, kernel, reps,
                                 kernels=r"seeds_\w+?_kernel")
        kern_dev = sum(v for k, v in dev.items() if k.startswith("seeds_"))
        kstart, _rb, qstart = seeds_device.layout(args[1], seg_len)
        bound = seeds_bound(len(args[0]), seg_row, seg_len, len(got[1]))
        res = {"case": name, "ranges": len(seqs), "segments": len(seg_len),
               "walk_kmers": int(kstart[-1]), "query_kmers": int(qstart[-1]),
               "hits": len(got[1]), "card_ms": kern_ms,
               "device_ms": dev or None, "kernels_device_ms": kern_dev,
               "plain_ms": plain_ms, "host_ms": host_ms,
               "launches": launches, **bound,
               "share_of_bound_pct": (100 * bound["bound_ms"] / kern_dev
                                      if kern_dev else None)}
        print("  seeds " + json.dumps(res), flush=True)
        out.append(res)
    sync(device)
    stage = stage_cases(device, rs, fwd_batches, reps)
    return {"world_s": t_world, "precompute_launches": ran, "cases": out,
            "precompute_staging": staging, "stage": stage}


def seeds_main():
    """``chip_smoke.py --seeds``: the card, the build, phase 6b and the
    PacBio anneal of phase 7 (the CLI's seed lookups on the kernels)."""
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    usage = run_phase("0 card", phase_card)
    res = run_phase("6b seed lookup", phase_seeds, device)
    with tempfile.TemporaryDirectory(prefix="gaml_smoke_pb_") as d_pb:
        genome = write_pacbio_world(d_pb)
        pb = run_phase("7 pacbio anneal", phase_pacbio_anneal, device, d_pb,
                       genome)
    print(json.dumps({"seeds": res, "anneal_seed_launches":
                      pb["seed_launches"], "kernels": {
                          k: usage[k] for k in SEEDS_KERNELS + (
                              STAGE_KERNEL,)}}), flush=True)
    return 0


def write_pacbio_config(d, name, iterations):
    cfg = os.path.join(d, f"{name}.cfg")
    with open(cfg, "w") as f:
        f.write("\n".join([
            f"graph={d}/LastGraph", f"max_iterations={iterations}",
            f"output_prefix={d}/{name}", "seed=47", "", "[pb]",
            "type=pacbio", f"filename={d}/pb.fq",
            f"mismatch_prob={PB_MISMATCH}", "penalty_constant=0.0001",
            "penalty_step=100", "advice=1", f"cache_prefix={d}/{name}_pb",
            ""]))
    return cfg


def device_busy_ms(prof):
    """Summed device time of a profile (CUDA activity only), or None when
    the profiler saw none."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) or 0
    return total / 1e3 if total > 0 else None


def cli_in_process(device, d, cfg, extra, env=None, window=None):
    """gaml_tpu_torch.cli.main on ``cfg`` in this process (cwd ``d``,
    ``env`` set for the call, stdout captured), under the profiler, with
    every launch count set to 0 first.  ``window`` = (first, moves)
    profiles only those moves of the anneal (the profiler's own
    processing grows with the events it keeps), else the whole call.
    Returns (stdout, its summary line, the call's wall seconds, the
    device's busy milliseconds in the profiled span or None, that span's
    wall seconds, each move's wall seconds)."""
    import contextlib
    import io

    import torch

    from gaml_tpu_torch import cli
    from gaml_tpu_torch.optimize.anneal import Optimizer

    reset_launches()
    buf = io.StringIO()
    acts = [torch.profiler.ProfilerActivity.CUDA
            if device.type == "cuda" else torch.profiler.ProfilerActivity.CPU]
    kw = {} if window is None else {"schedule": torch.profiler.schedule(
        wait=window[0], warmup=1, active=window[1], repeat=1)}
    real_step, move_s, live = Optimizer.step, [], []

    def step(self, *args, **kwargs):
        # every move ends in the score's synchronising fetch
        t0 = time.perf_counter()
        out = real_step(self, *args, **kwargs)
        move_s.append(time.perf_counter() - t0)
        if window is not None:
            live[0].step()
        return out

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    cwd = os.getcwd()
    os.chdir(d)
    Optimizer.step = step
    try:
        with torch.profiler.profile(activities=acts, **kw) as prof, \
                contextlib.redirect_stdout(buf):
            live.append(prof)
            t0 = time.perf_counter()
            rc = cli.main([cfg, "--device", str(device), *extra])
            sync(device)
            wall = time.perf_counter() - t0
    finally:
        Optimizer.step = real_step
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    out = buf.getvalue()
    check(rc == 0, f"gaml_tpu_torch.cli {' '.join(extra)} exited {rc}")
    span = wall if window is None else \
        sum(move_s[window[0] + 1:window[0] + 1 + window[1]])
    return out, summary_of(out), wall, device_busy_ms(prof), span, move_s


def quality(truth, path):
    """tools/asm_quality.py's assembly quality of the FASTA at ``path``."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from asm_quality import assembly_quality

    return assembly_quality(truth, path)


def assembly_bound(d, truth, name, best, nat):
    """The PacBio anneal ``name`` in ``d``, whose best score is ``best``,
    against the native route's ``nat`` ({"best_prob", "quality"}): best
    score within 0.05, k-mer recall within 0.005, junk no higher than
    native + 0.001, NG50 ratio in [0.95, 1.06] (tests/test_pacbio.py::
    test_f32_route_anneal_quality_bound, PARITY.md).  Returns the run's
    quality."""
    q = quality(truth, os.path.join(d, f"{name}.fasta"))
    q_nat = nat["quality"]
    check(abs(best - nat["best_prob"]) < 0.05,
          f"{name}: best prob {best} vs native {nat['best_prob']}")
    check(abs(q["kmer_recall"] - q_nat["kmer_recall"]) <= 0.005,
          f"{name}: k-mer recall {q} vs native {q_nat}")
    check(q["kmer_junk"] <= q_nat["kmer_junk"] + 0.001,
          f"{name}: k-mer junk {q} vs native {q_nat}")
    check(q_nat["ng50"] == 0 or 0.95 <= q["ng50"] / q_nat["ng50"] <= 1.06,
          f"{name}: NG50 {q} vs native {q_nat}")
    return q


def native_pacbio_run(d, iterations, timeout):
    """The port's CLI on the native host route (every forward batch on
    the native kernel) over the PacBio world in ``d``, outputs named nat.
    Returns (trace, wall seconds)."""
    env = dict(os.environ, GAML_PB_DEVICE_MIN_CELLS=str(NATIVE))
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gaml_tpu_torch.cli",
         write_pacbio_config(d, "nat", iterations), "--device", "cpu"],
        cwd=d, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the native route exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return trace(proc.stdout), wall


def phase_pacbio_anneal(device, d, genome, iterations=400, timeout=600):
    """The port's CLI on ``device`` (in this process, under the profiler)
    against the port's CLI on the native host route, both from the same
    world and config seed, held to assembly_bound."""
    from gaml_tpu_torch.core import dna

    truth = dna.decode_seq(genome)
    nat_tr, nat_wall = native_pacbio_run(d, iterations, timeout)

    out, summary, dev_wall, busy, _span, _moves = cli_in_process(
        device, d, write_pacbio_config(d, "dev", iterations), [])
    seeds_ran = {k: v for k, v in summary["launches"].items()
                 if k.startswith("seeds_")}
    launches = summary["launches"]["banded_forward"]
    dev_tr = trace(out)
    check(len(dev_tr) >= iterations and len(nat_tr) >= iterations,
          f"short traces: {len(dev_tr)} / {len(nat_tr)} itnum lines")
    check(device.type != "cuda" or launches > 0,
          f"K5 was not launched by the anneal: {summary}")
    check(device.type != "cuda" or seeds_ran["seeds_count"] > 0,
          f"the seed kernels were not launched by the anneal: "
          f"{seeds_ran}")
    check(summary["pacbio_cells"].get(route(device), 0) > 0,
          f"no forward-DP cell on {device}: {summary}")
    best_dev, best_nat = float(dev_tr[-1].split()[9]), \
        float(nat_tr[-1].split()[9])
    nat = {"best_prob": best_nat,
           "quality": quality(truth, os.path.join(d, "nat.fasta"))}
    q_dev = assembly_bound(d, truth, "dev", best_dev, nat)
    diff = first_difference(dev_tr, nat_tr)
    res = {"iterations": iterations, "dev_wall_s": dev_wall,
           "nat_wall_s": nat_wall, "dev_moves_per_s": iterations / dev_wall,
           "nat_moves_per_s": iterations / nat_wall,
           "best_prob": best_dev, "nat_best_prob": best_nat,
           "quality": q_dev, "nat_quality": nat["quality"],
           "pacbio_cells": summary["pacbio_cells"], "launches": launches,
           "seed_launches": seeds_ran, "device_busy_ms": busy,
           "device_busy_share": None if busy is None
           else busy / 1e3 / dev_wall,
           "vs_native_trace": "identical" if diff is None else
           f"first difference at line {diff[0]}"}
    print("  " + json.dumps(res), flush=True)
    return res


# ------------------------------------------------------------------ phase 8
def reset_launches():
    """Every count of the one launch-count store set to 0 (every kernel's
    launches, the calls of query_plain and gen_candidates); returns the
    store."""
    from gaml_tpu_torch.utils.metrics import LAUNCHES

    LAUNCHES.clear()
    return LAUNCHES


def exact_against_plain(device, args, reps):
    """dp_rows_exact on ``args`` against its plain version: c and a equal
    everywhere (integers: the tolerance is exact), with both times."""
    from gaml_tpu_torch.ops import extend_cuda as kc

    (c, a), (c_ref, a_ref) = kc.dp_rows_exact(*args), \
        kc.dp_rows_exact_ref(*args)
    err = max(int((c - c_ref).abs().max()), int((a - a_ref).abs().max()))
    n = args[0].shape[1]
    check(err == 0, f"dp_rows_exact differs from its plain version by "
          f"{err} at n={n}")
    return {"n": n, "rmax": args[0].shape[0], "max_abs_err": err,
            "above_saturation": int((c_ref > 7).sum()),
            "ms": timer(device, lambda: kc.dp_rows_exact(*args), reps),
            "plain_ms": timer(device, lambda: kc.dp_rows_exact_ref(*args),
                              3),
            **staged_bound(args, True)}


def ragged_draw(n: int, device, seed: int = 0, genome_len: int = 400_000,
                n_reads: int = 100_000, lo: int = 60, hi: int = 100):
    """A resident ragged read set and n candidates over one window (the
    genome): reads of lo..hi bp sampled from a random genome with 1 %
    substitutions, both orientations as rows; half the candidates on a
    forward row at its true place, half anywhere; shuffled.  Returns the
    extend_exact arguments (codes, lens, buf, base, glen, g0, r0, row; int32
    per-candidate tensors) and the row bound hi - K."""
    import torch

    from gaml_tpu_torch.ops.extend import K, SENT_READ
    from gaml_tpu_torch.ops.extend_device import reverse_complements

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    lens = rng.integers(lo, hi + 1, n_reads)
    starts = rng.integers(0, genome_len - hi + 1, n_reads)
    mat = genome[starts[:, None] + np.arange(hi)]
    err = rng.random(mat.shape) < 0.01
    mat[err] = (mat[err] + rng.integers(1, 4, int(err.sum()))) % 4
    mat[np.arange(hi) >= lens[:, None]] = SENT_READ
    codes = np.concatenate([mat, reverse_complements(mat, lens)])
    lens2 = np.concatenate([lens, lens])
    half = n // 2
    row = np.concatenate([rng.integers(0, n_reads, half),
                          rng.integers(0, 2 * n_reads, n - half)])
    r0 = rng.integers(0, lens2[row] - K + 1)
    g0 = np.concatenate([starts[row[:half]] + r0[:half],
                         rng.integers(0, genome_len - K + 1, n - half)])
    perm = rng.permutation(n)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    i32 = np.int32
    args = (t(codes), t(lens2.astype(i32)), t(genome), t(np.zeros(n, i32)),
            t(np.full(n, genome_len, i32)), t(g0[perm].astype(i32)),
            t(r0[perm].astype(i32)), t(row[perm].astype(i32)))
    return args, hi - K


def staged_from_resident(args, rmax: int):
    """The staged dict (candidate-major views at rmax rows) of the
    resident arguments' candidates, as ops.extend.stage_candidates builds
    it."""
    import torch

    from gaml_tpu_torch.ops.extend import stage_views

    codes, lens, buf, base, glen, g0, r0, row = args
    i64 = [x.to(torch.int64) for x in (base, glen, g0, r0, row)]
    views = stage_views(codes, lens.to(torch.int64)[i64[4]], buf, *i64,
                        rmax)
    st = {}
    for sfx, (read, gwin, rlen, gl) in zip("fb", views):
        st.update({"read_" + sfx: read.t().contiguous(),
                   "gwin_" + sfx: gwin.t().contiguous(),
                   "rlen_" + sfx: rlen, "glen_" + sfx: gl})
    st.update(g0=g0, r0=r0, at_start=g0 == 0)
    return st


def phase_exact(device, n=131072, rmax=96, reps=20):
    """The single-direction exact API (dp_rows_exact, the contract of
    K3/K4a/K4b) at phase 1's inputs (one launch) and stacked with a second
    draw (2n); the exact two-direction extension, the port of K3/K4a/K4b,
    on a ragged draw of n candidates (ragged_draw: reads of 60-100 bp)
    through its resident loader and, staged at rmax, its staged loader,
    each against its plain version; and the K6 tool, also held against
    the plain version."""
    import torch

    from gaml_tpu_torch.ops import extend_cuda as kc
    from gaml_tpu_torch.tools import swar_kernel_proto

    args = band_inputs(0, n, rmax, device)
    stacked = tuple(torch.cat([x, y], dim=-1).contiguous() for x, y in
                    zip(args, band_inputs(1, n, rmax, device)))
    out = {"dp_rows_exact": exact_against_plain(device, args, reps),
           "dp_rows_exact_stacked": exact_against_plain(device, stacked,
                                                        reps)}
    check(out["dp_rows_exact"]["above_saturation"] > n // 8,
          f"too few costs above K1/K2's saturation: {out['dp_rows_exact']}")
    res_args, res_rmax = ragged_draw(n, device)
    st = staged_from_resident(res_args, rmax)
    out["exact_resident"] = exact_against_plain_two(device, res_args,
                                                    res_rmax, reps)
    out["exact_staged"] = exact_against_plain_two(device, st, None, reps)
    out["exact_resident"]["read_lens"] = [int(res_args[1].min()),
                                          int(res_args[1].max())]

    launches = reset_launches()
    k6 = swar_kernel_proto.run(device, n, rmax, reps)
    k6_launches = launches["swar_cost"]
    check(k6["mismatches"] == 0, f"K6 tool: {k6}")
    want = torch.clamp(kc.dp_rows_exact_ref(*args)[0], max=kc.SAT)
    out["K6"] = {"max_abs_err": int((kc.swar_cost(*args) - want)
                                    .abs().max()),
                 "ms": k6["ms"], "plain_ms": timer(
                     device, lambda: kc.swar_cost_ref(*args), 3),
                 "launches": k6_launches, "exact_ms": k6["exact_ms"],
                 **staged_bound(args, False)}
    check(out["K6"]["max_abs_err"] == 0, f"K6 vs plain: {out['K6']}")
    for k, v in out.items():
        print(f"  {k}: " + json.dumps(v), flush=True)
    return out


# ------------------------------------------------------------------ phase 9
def host_candidates(bundle, reads, genome):
    """gen_candidates over one window, from the bundle's max-hash index
    and a read cache with the seed positions precomputed (as
    ReadSet.prepare_read_index builds them)."""
    from gaml_tpu_torch.align.aligner import _ReadCache, gen_candidates
    from gaml_tpu_torch.index.maxhash import K_INDEX_KMER, ReadIndexMaxHash
    from gaml_tpu_torch.native import read_index_build

    _fp, _ok, kmers, rc, seed_pos = read_index_build(reads, K_INDEX_KMER)
    index = ReadIndexMaxHash()
    off = bundle.fp_off.tolist()
    index.index = {fp: bundle.fp_rids[off[i]:off[i + 1]].tolist()
                   for i, fp in enumerate(bundle.fp_sorted.tolist())}
    index.read_len = reads.shape[1]
    read_seqs = dict(enumerate(reads))
    cache = _ReadCache(read_seqs, kmers, {i: i for i in range(len(reads))})
    cache._rc_matrix, cache.seed_kmer_pos = rc, seed_pos
    return gen_candidates(index, read_seqs, genome, cache)


def close(a, b, rel):
    return np.isfinite(a) and abs(a - b) <= rel * abs(b)


def five_pair_world(device, total_len=2_800_000, mate=150, im=180, istd=20):
    """Five pairs of 2 x 150 bp mates (insert 180 +- 20) on a 2.8 Mb
    assembly, with (errors per mate, insert offset in sd) of (1, 1), (3,
    8), (3, 12), (6, 10), (6, 14): p / (2 total_len) of the last three
    lies below float32's range (2^-149), their logs above the floor of
    -220 (ROADMAP C12).  Returns the paired_score_device arguments on
    ``device`` and the float64 host's (score, zero_reads)
    (scoring.reduce.get_total_prob)."""
    import torch

    from gaml_tpu_torch.core.logprob import gaussian_pdf
    from gaml_tpu_torch.scoring.reduce import get_total_prob

    pairs = ((1, 1), (3, 8), (3, 12), (6, 10), (6, 14))
    n = len(pairs)
    pos1 = np.array([[1000 + 5000 * i] for i in range(n)], np.int32)
    ins = np.array([im + off * istd for _e, off in pairs])
    pos2 = pos1 + (ins - mate)[:, None].astype(np.int32)
    ed = np.array([[e] for e, _off in pairs], np.int32)
    probs = np.array([(MISMATCH ** e * MATCH ** (mate - e)) ** 2
                      * float(gaussian_pdf(x, im, istd))
                      for (e, _off), x in zip(pairs, ins)])
    host = get_total_prob(probs, total_len, MPB, MPS, np.full(n, 2 * mate))
    arrays = (pos1, ed, np.zeros_like(pos1), np.full(n, mate, np.int32),
              pos2, ed, np.ones_like(pos1), np.full(n, mate, np.int32))
    args = [torch.as_tensor(x, device=device) for x in arrays]
    args += [float(np.log(MATCH)), float(np.log(MISMATCH)), float(im),
             float(istd), total_len, MPB, MPS]
    return args, host


def phase_models(device, d, world=(2_800_000, 300_000), reps=5):
    """SingleEndModel on ``device`` over host candidates of phase 3's
    world, against the model on the CPU and DeviceRescorer.rescore on the
    same window (score rel 2e-6, zero_reads equal), with its forward step
    on the staged dict (the same score within 1e-9) split with CUDA
    events into staging, launch, dedup and reduction; the exact extension
    on these candidates against its plain version, staged (the forward
    step's) and resident (score_candidates'), beside the stacked
    single-direction launch the forward step made before;
    PairedEndModel on the frag library of the world in ``d`` over the
    start walks, against the float64 host paired scorer (rel 1e-5,
    zero_reads equal); and the paired reduction on five_pair_world
    against the float64 host (rel 1e-9, zero_reads equal)."""
    import torch

    from gaml_tpu_torch.cli import starting_paths_from_config
    from gaml_tpu_torch.core.io import load_lastgraph
    from gaml_tpu_torch.optimize.settings import AssemblySettings
    from gaml_tpu_torch.scoring.paired import calc_score_for_paths_paired
    from gaml_tpu_torch.scoring.readset import ReadSet
    from gaml_tpu_torch.models import PairedEndModel, SingleEndModel
    from gaml_tpu_torch.ops import extend_cuda as kc
    from gaml_tpu_torch.ops import score as tscore
    from gaml_tpu_torch.ops.extend import K, read_matrix, stage_candidates
    from gaml_tpu_torch.ops.pair import paired_score_device
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

    genome_len, n_reads = world
    genome, reads = make_world(genome_len, n_reads)
    bundle = make_bundle(reads)
    t0 = time.perf_counter()
    cands = host_candidates(bundle, reads, genome)
    t_cands = time.perf_counter() - t0
    lens = [READ_LEN] * n_reads
    lens_t = torch.full((n_reads,), READ_LEN, dtype=torch.int32,
                        device=device)
    model = SingleEndModel(MATCH, MISMATCH, MPB, MPS, device=device)
    g0s = [c.genome_pos for c, _ in cands]
    r0s = [c.read_pos for c, _ in cands]
    rds = [r for _, r in cands]
    rids = [c.read_id for c, _ in cands]

    def stage():
        return stage_candidates(genome, g0s, r0s, rds, read_ids=rids,
                                device=device)

    st = stage()
    launches = reset_launches()
    score, zeros, _ = model.score_candidates(genome, cands, n_reads, lens,
                                             genome_len)
    fwd = model(st, lens_t, genome_len, n_reads)
    model_launches = launches["extend_exact"] + \
        launches["extend_exact_staged"]
    check(device.type != "cuda" or (
        launches["extend_exact"] == launches["extend_exact_staged"] == 1
        and launches["dp_rows_exact"] == 0),
        f"the model did not run the exact extension: {launches}")
    check(int(fwd[1]) == zeros and close(float(fwd[0]), score, 1e-9),
          f"forward step ({float(fwd[0])}, {int(fwd[1])}) vs "
          f"score_candidates ({score}, {zeros})")
    cpu = SingleEndModel(MATCH, MISMATCH, MPB, MPS,
                         device="cpu").score_candidates(
        genome, cands, n_reads, lens, genome_len)
    resc = DeviceRescorer(bundle, device=device).rescore(
        [genome], len(genome), log_match=float(np.log(MATCH)),
        log_mismatch=float(np.log(MISMATCH)), total_len=genome_len,
        min_prob_per_base=MPB, min_prob_start=MPS)
    for name, (s_ref, z_ref) in (("cpu model", cpu[:2]),
                                 ("rescore", resc[:2])):
        check(zeros == z_ref and close(score, s_ref, 2e-6),
              f"model on {device} ({score}, {zeros}) vs {name} "
              f"({s_ref}, {z_ref})")
    fwd_ms = timer(device, lambda: float(model(st, lens_t, genome_len,
                                               n_reads)[0]),
                   reps, host_clock=True)
    # the forward step's stages, each timed alone with CUDA events
    sd = {k: st[k] for k in kc.STAGED}
    ok, errs, begin = kc.extend_exact_staged(sd)
    good = ok & st["valid"]

    def dedup():
        return tscore.dedup_sort_payload(st["read_id"], begin, good,
                                         (errs, st["read_len"]))

    rid_s, keep, (errs_s, rlen_s) = dedup()

    def reduction():
        p = tscore.alignment_probs(errs_s, rlen_s, float(np.log(MATCH)),
                                   float(np.log(MISMATCH)))
        rp = torch.zeros(n_reads, dtype=torch.float64, device=device)
        rp.index_add_(0, rid_s[keep].to(torch.int64), p[keep])
        return tscore.reduce_read_probs(rp, lens_t, genome_len, MPB, MPS)

    split = {"staging_ms": timer(device, stage, reps),
             "launch_ms": timer(device, lambda: kc.extend_exact_staged(sd),
                                reps),
             "dedup_ms": timer(device, dedup, reps),
             "reduction_ms": timer(device, reduction, reps)}
    # the exact extension at this shape: staged (the forward step's) and
    # resident (score_candidates'), beside the stacked single-direction
    # launch of both directions that the forward step made before
    k4a = exact_against_plain_two(device, sd, None, reps)
    views = [torch.cat([st[f"{k}_f"].t(), st[f"{k}_b"].t()], dim=-1)
             .contiguous() for k in ("read", "gwin")]
    views += [torch.cat([st[f"{k}_f"], st[f"{k}_b"]]) for k in
              ("rlen", "glen")]
    k4a["stacked"] = exact_against_plain(device, views, reps)
    mat, rl = read_matrix(rds)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32),  # noqa: E731
                                    device=device)
    n_c = len(cands)
    res_args = (torch.as_tensor(mat, device=device), i32(rl),
                torch.as_tensor(genome, device=device), i32(np.zeros(n_c)),
                i32(np.full(n_c, genome_len)), i32(g0s), i32(r0s),
                i32(np.arange(n_c)))
    res_rmax = max(mat.shape[1] - K, 1)
    k4a["resident"] = exact_against_plain_two(device, res_args, res_rmax,
                                              reps)
    k4a["launches"] = model_launches
    single = {"genome": genome_len, "reads": n_reads,
              "candidates": len(cands), "host_candgen_s": t_cands,
              "score": score, "zero_reads": zeros,
              "rel_vs_cpu": abs(score - cpu[0]) / abs(cpu[0]),
              "rel_vs_rescore": abs(score - resc[0]) / abs(resc[0]),
              "forward_ms": fwd_ms, **split, "launches": model_launches}
    print("  single " + json.dumps(single), flush=True)
    print("  exact extension at this shape " + json.dumps(k4a), flush=True)

    args, (h_score, h_zeros) = five_pair_world(device)
    c12_score, c12_zeros, c12_probs = paired_score_device(*args)
    c12 = {"score": float(c12_score), "zero_reads": int(c12_zeros),
           "host_score": h_score, "host_zero_reads": h_zeros,
           "rel_vs_host": abs(float(c12_score) - h_score) / abs(h_score),
           "probs_dtype": str(c12_probs.dtype)}
    check(c12["zero_reads"] == h_zeros and close(c12["score"], h_score,
                                                  1e-9),
          f"C12: paired reduction {c12} against the float64 host")
    print("  c12 " + json.dumps(c12), flush=True)

    graph = load_lastgraph(os.path.join(d, "LastGraph"))
    walks = starting_paths_from_config({}, graph,
                                       AssemblySettings.from_config({}))
    mates = []
    for k in (1, 2):
        rs = ReadSet(os.path.join(d, f"pm{k}"), os.path.join(d, f"f{k}.fq"),
                     MATCH, MISMATCH)
        rs.preprocess_reads()
        rs.prepare_read_index()
        mates.append(rs)
    t0 = time.perf_counter()
    h_score, h_zeros, tl = calc_score_for_paths_paired(graph, walks, *mates,
                                                       180, 20)
    host_s = time.perf_counter() - t0
    pm = PairedEndModel(180, 20, match_prob=MATCH, mismatch_prob=MISMATCH,
                        min_prob_per_base=MPB, min_prob_start=MPS,
                        device=device)
    n_pairs = mates[0].reads_num
    t0 = time.perf_counter()
    p_score, p_zeros, _ = pm.score_positions(
        mates[0].positions, mates[1].positions, n_pairs,
        mates[0].read_lens, mates[1].read_lens, tl)
    paired_s = time.perf_counter() - t0
    check(p_zeros == h_zeros and close(p_score, h_score, 1e-5),
          f"paired model ({p_score}, {p_zeros}) vs host ({h_score}, "
          f"{h_zeros})")
    paired = {"walks": len(walks), "pairs": n_pairs, "total_len": tl,
              "score": p_score, "zero_reads": p_zeros,
              "rel_vs_host": abs(p_score - h_score) / abs(h_score),
              "host_scorer_s": host_s, "model_s": paired_s,
              "k_cap": max(len(p) for rs in mates for p in rs.positions)}
    print("  paired " + json.dumps(paired), flush=True)
    return {"single": single, "paired": paired, "K4a": k4a, "c12": c12,
            "world": {"genome": genome, "cands": cands, "rmax": st["rmax"],
                      "n_reads": n_reads, "score": score,
                      "zero_reads": zeros}}


# ----------------------------------------------------------------- phase 10
def trim_fastq(src, dst, rng, share=0.2, lo=60, hi=99):
    """Copy a FASTQ, cutting ``share`` of its reads at the 3' end to a
    length uniform in [lo, hi] (quality trimming)."""
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")
    n = len(lines) // 4
    cut = rng.random(n) < share
    lens = rng.integers(lo, hi + 1, n)
    for i in np.nonzero(cut)[0].tolist():
        lines[4 * i + 1] = lines[4 * i + 1][:lens[i]]
        lines[4 * i + 3] = lines[4 * i + 3][:lens[i]]
    with open(dst, "wb") as f:
        f.write(b"\n".join(lines))
    return int(cut.sum())


ROUTE_STAGES = ("build", "query", "extend", "fetch", "columns")


@contextlib.contextmanager
def route_stage_timers(spent, live=lambda: True):
    """Wraps the stages of the device route's window batches
    (SubpathAligner._align_subpaths_batch_device) for the host clock,
    adding seconds to ``spent`` while ``live()``: "build"
    (SubpathAligner.ensure_device_rescorer: the read set's engine, built
    by its first batch), "query" (DeviceCandGen.query: the upload and the
    query to its one host synchronisation), "extend" (DeviceExtender.
    extend: the exact extension's launch), "fetch" (the closure of
    DeviceRescorer.extend: the results back, which waits for the card)
    and "columns" (window_columns, the host dedup)."""
    from gaml_tpu_torch.align import aligner as al_mod
    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen
    from gaml_tpu_torch.ops.extend_device import DeviceExtender
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

    sites = {"build": (al_mod.SubpathAligner, "ensure_device_rescorer"),
             "query": (DeviceCandGen, "query"),
             "extend": (DeviceExtender, "extend"),
             "fetch": (DeviceRescorer, "extend"),
             "columns": (al_mod, "window_columns")}
    saved = {k: getattr(mod, name) for k, (mod, name) in sites.items()}

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if live():
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def fetch_timed(fn):  # DeviceRescorer.extend: time its closure only
        return lambda *args, **kw: timed("fetch", fn(*args, **kw))

    for key, (mod, name) in sites.items():
        setattr(mod, name, fetch_timed(saved[key]) if key == "fetch"
                else timed(key, saved[key]))
    try:
        yield spent
    finally:
        for key, (mod, name) in sites.items():
            setattr(mod, name, saved[key])


def host_pass_against(got, al, seqs, what):
    """The kernel's candidates ``got`` of the windows ``seqs`` bit-equal
    to the host pass gen_candidates run window by window on the
    aligner's own index, reads and read cache; returns its seconds."""
    from gaml_tpu_torch.align.aligner import gen_candidates

    t0 = time.perf_counter()
    host = [gen_candidates(al.index, al.read_seqs, s, al._read_cache)
            for s in seqs]
    spent = time.perf_counter() - t0
    for i, (x, h) in enumerate(zip(native_layout(got, len(seqs)), host)):
        y = [np.array([getattr(c, f) for c, _r in h], np.int32) for f in
             ("read_id", "genome_pos", "read_pos", "orientation")]
        for name, u, v in zip(("rid", "g0", "r0", "orient"), x, y):
            check(np.array_equal(u, v), f"{what} window {i}: {name} "
                  f"differs from gen_candidates")
    return spent


def mixed_anneal_batches(device, d, iterations=12, window=(1, 10)):
    """The trimmed anneal in this process on ``device`` (cli_in_process,
    ``iterations`` moves, the profiler over moves 3-12 only): every window
    batch of the frag read sets (no native bundle, so their engine is
    DeviceCandGen.from_index's) recorded where it reaches
    DeviceCandGen.query, with its move (0: the start scoring, the
    anneal's first ProbCalculator.calc_prob, which aligns every start
    walk's windows); every query counted by library (frag, advice); the
    start scoring split by route_stage_timers, "rest" its calc_prob
    wall less the stages.  Then on each recorded batch the kernel's
    candidates bit-equal to query_plain and to gen_candidates window by
    window (host_pass_against; its seconds on the start scoring's
    batches are the yardstick of the host pass the route replaced).
    Returns (the result, the aligner of the first frag read set queried:
    the first mate file's)."""
    from gaml_tpu_torch.align.aligner import SubpathAligner
    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen
    from gaml_tpu_torch.optimize.anneal import Optimizer
    from gaml_tpu_torch.scoring.calculator import ProbCalculator

    move, owner, rec, seen = [0], {}, [], set()
    queries = {"frag": 0, "advice": 0}
    calc_s = []
    real = (SubpathAligner.ensure_device_rescorer, DeviceCandGen.query,
            Optimizer.step, ProbCalculator.calc_prob)

    def ensure(self):
        resc = real[0](self)
        if resc is not None and getattr(self, "native_bundle", None) is None:
            owner[id(resc.gen)] = self
        return resc

    def query(self, seqs=None, cap=None, staged=None, split=None):
        frag = id(self) in owner
        queries["frag" if frag else "advice"] += 1
        if frag and id(seqs) not in seen:  # a retry queries seqs again
            seen.add(id(seqs))
            rec.append((self, owner[id(self)], seqs, move[0]))
        return real[1](self, seqs, cap, staged, split)

    def step(self, *args, **kw):
        move[0] += 1
        return real[2](self, *args, **kw)

    def calc_prob(self, *args, **kw):
        t0 = time.perf_counter()
        out = real[3](self, *args, **kw)
        if move[0] == 0:
            calc_s.append(time.perf_counter() - t0)
        return out

    (SubpathAligner.ensure_device_rescorer, DeviceCandGen.query,
     Optimizer.step, ProbCalculator.calc_prob) = (ensure, query, step,
                                                  calc_prob)
    spent = {}
    try:
        with route_stage_timers(spent, lambda: move[0] == 0):
            _out, summary, wall, busy_ms, span, move_s = cli_in_process(
                device, d, write_config(d, "mixed_rec", iterations, "t"), [],
                env={"GAML_DEV_MIN_BASES": "0"}, window=window)
    finally:
        (SubpathAligner.ensure_device_rescorer, DeviceCandGen.query,
         Optimizer.step, ProbCalculator.calc_prob) = real
    launches = summary["launches"]
    check(queries["frag"] > 0 and queries["advice"] > 0,
          f"a library ran no candgen query: {queries}")
    check(launches["gen_candidates"] == 0 and (
        device.type != "cuda" or launches["query_plain"] == 0),
        f"the in-process anneal left the kernel route: {launches}")
    check(any(m == 0 for *_x, m in rec), "no start-scoring batch recorded")
    start = sum(calc_s)
    res = {"moves": iterations, "wall_s": wall, "start_ms": start * 1e3,
           "start_split_ms": {k: spent.get(k, 0.0) * 1e3
                              for k in ROUTE_STAGES},
           "start_rest_ms": (start - sum(spent.values())) * 1e3,
           "ms_per_warm_move": float(np.median(move_s[1:])) * 1e3,
           "busy_share": None if busy_ms is None else busy_ms / (span * 1e3),
           "profiled_moves": f"{window[0] + 2}-{window[0] + 1 + window[1]}",
           "queries": queries, "launches": launches}
    host_s, cands, bases = 0.0, {}, {}
    for b, (gen, al, seqs, m) in enumerate(rec):
        staged = gen.upload(seqs)
        got = gen.query(staged=staged)
        same_candidates(got, gen.query_plain(staged=staged),
                        f"frag batch {b} (move {m})")
        t = host_pass_against(got, al, seqs, f"frag batch {b} (move {m})")
        tag = "start" if m == 0 else "moves"
        host_s += t if m == 0 else 0.0
        cands[tag] = cands.get(tag, 0) + got.n_total
        bases[tag] = bases.get(tag, 0) + int(staged[0].shape[0])
    res.update(recorded_batches=len(rec),
               start_batches=sum(m == 0 for *_x, m in rec),
               candidates=cands, bases=bases,
               start_host_pass_ms=host_s * 1e3)
    return res, rec[0][1]


def mixed_batch_split(device, d, al, n_windows=64, reps=5):
    """The host split of one no-bundle window batch on the trimmed frag
    library's first mate file (``al``, its aligner from
    mixed_anneal_batches): n_windows windows of three consecutive chain
    nodes aligned in one align_subpaths_batch call, its stages timed by
    route_stage_timers (medians over warm batches), "other_ms" the rest
    (spelling the windows, the cap); beside it, on the same windows, the
    host pass gen_candidates window by window (the route it replaced),
    its candidates bit-equal to the kernel's."""
    from gaml_tpu_torch.align.aligner import spell_subpath
    from gaml_tpu_torch.core.io import load_lastgraph

    graph = load_lastgraph(os.path.join(d, "LastGraph"))
    check(getattr(al, "native_bundle", None) is None,
          "the trimmed read set has a native bundle")
    windows = [(2 * i, 2 * i + 2, 2 * i + 4) for i in range(n_windows)]
    seqs = [spell_subpath(graph, w)[0] for w in windows]
    check(min(map(len, seqs)) >= al.index.read_len,
          "a split window is shorter than the query's read length")
    got = al.ensure_device_rescorer().gen.query(seqs)
    rows = []
    for _ in range(reps + 1):
        spent = {}
        with route_stage_timers(spent):
            n0 = al.device_candidates
            t0 = time.perf_counter()
            al.align_subpaths_batch(graph, windows)
            total = time.perf_counter() - t0
        rows.append({"total_ms": total * 1e3,
                     **{f"{k}_ms": spent.get(k, 0.0) * 1e3
                        for k in ROUTE_STAGES[1:]},
                     "other_ms": (total - sum(spent.values())) * 1e3,
                     "candidates": al.device_candidates - n0,
                     "host_pass_ms": host_pass_against(
                         got, al, seqs, "split batch") * 1e3})
    rows = rows[1:]  # the first batch is a warm-up
    res = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    check(res["candidates"] == got.n_total,
          f"split batch: {res['candidates']} vs {got.n_total} candidates")
    res.update(windows=n_windows, reads=len(al.read_seqs))
    return res


def phase_mixed_anneal(device, d, iterations=30, check_iterations=10,
                       timeout=450):
    """The phase-4 world with its frag library quality-trimmed: 20 % of
    each mate file's reads cut to 60-99 bp (own generator, seed 29).  The
    frag read sets get no native bundle, so their windows take the
    candgen kernel over the max-hash index's own CSR
    (DeviceCandGen.from_index) and the exact extension on a resident
    ragged read set (extend_exact, never dp_rows_exact), as the advice
    library does on its uniform read set.  --device cuda against
    --device cpu (equal traces over the cpu run), reported against
    --backend bfs; every batch runs a candgen query, the host pass
    gen_candidates never; then the start scoring's batches recorded,
    checked and split in this process (mixed_anneal_batches) and one
    64-window batch split (mixed_batch_split)."""
    rng = np.random.default_rng(29)
    trimmed = [trim_fastq(os.path.join(d, f"f{k}.fq"),
                          os.path.join(d, f"t{k}.fq"), rng) for k in (1, 2)]
    res, diff, _tr = anneal_against_cpu_and_bfs(
        device, d, iterations, check_iterations, timeout,
        ("extend_exact", "candgen_runs"), frag="t",
        tag="mixed_")
    launches = res["launches"]
    check(launches["dp_rows_exact"] == 0,
          f"the mixed anneal launched dp_rows_exact: {launches}")
    check(device.type != "cuda" or
          launches["candgen_runs"] >= res["batches"],
          f"a batch ran no candgen query: {res['batches']} batches, "
          f"{launches}")
    res["trimmed_reads"] = trimmed
    print("  " + json.dumps(res), flush=True)
    if diff is not None:
        print(f"  {device}: {diff[1]}\n  bfs:  {diff[2]}", flush=True)
    res["in_process"], t1 = mixed_anneal_batches(device, d)
    print("  in-process " + json.dumps(res["in_process"]), flush=True)
    res["batch_split"] = mixed_batch_split(device, d, t1)
    print("  no-bundle batch " + json.dumps(res["batch_split"]), flush=True)
    return res


# ----------------------------------------------------------------- phase 11
def traces_agree(got, want):
    """How the itnum trace ``got`` agrees with ``want``: "identical";
    "within 1e-9" when every line has the same fields but for the three
    probabilities, each within 1e-9 relative plus one unit of the printed
    sixth decimal (a last-bit difference may round either way), so the
    same moves were accepted; else None."""
    if got == want:
        return "identical"
    if len(got) != len(want):
        return None
    for a, b in zip(got, want):
        fa, fb = a.split(), b.split()
        if len(fa) != len(fb):
            return None
        for i, (x, y) in enumerate(zip(fa, fb)):
            if x != y and (i not in (7, 8, 9) or abs(float(x) - float(y))
                           > 1e-6 + 1e-9 * abs(float(y))):
                return None
    return "within 1e-9"


def scoring_probes(spent, moves, keep):
    """Wrap, for one in-process run, the host scoring steps (timed into
    ``spent``: the scoring call, the paired staging, the host pair loop,
    the PacBio seeding, chaining and job staging)
    and the paired device scorer's bucket products (each call's scorer
    and buckets recorded into ``moves``, one list per scoring call, the
    last ``keep`` calls kept).  Returns a function that undoes it."""
    from gaml_tpu_torch.parallel import paired_sharded
    from gaml_tpu_torch.scoring import calculator, paired
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    scorer = paired_sharded.ShardedPairedScorer
    sites = {"calc_prob": (calculator.ProbCalculator, "calc_prob"),
             "staging": (paired_sharded, "stage_paired_rows"),
             "host_pairs": (paired, "calc_score_for_path_inc"),
             "pb_staging": (PacbioReadSet, "_slow_prepare"),
             "products": (scorer, "read_totals"),
             "products_inc": (scorer, "apply_buckets")}
    saved = {k: getattr(mod, name) for k, (mod, name) in sites.items()}

    def timed(key):
        fn = saved[key]

        def wrapper(*args, **kw):
            if key == "calc_prob":
                moves.append([])
                del moves[:-keep]
            elif key == "products":
                moves[-1].append((args[0], args[1]))
            elif key == "products_inc":
                moves[-1].append((args[0], args[3]))
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for key, (mod, name) in sites.items():
        setattr(mod, name, timed(key))

    def undo():
        for key, (mod, name) in sites.items():
            setattr(mod, name, saved[key])
    return undo


def paired_flag(device, d, flag, iterations, want, timeout,
                second_iterations, window, keep):
    """One paired flag on the aureus world in ``d``: a run through
    ``python -m gaml_tpu_torch.cli`` (its anneal wall gives ms per move)
    and a second in this process, of ``second_iterations``, under the
    profiler over ``window`` (cli_in_process: the device's busy share),
    with each move's wall (ms per warm move: moves 2 to n of this run and
    of ``want``'s in-process run, n the shorter; the first move's scoring
    calls align every start walk's windows), the host scoring's share and the bucket products of its last ``keep`` scoring
    calls (timed after it with CUDA events, call by call).  The second
    trace equals the first over its length, and the first equals
    ``want``'s (the host scorer's) or lies within traces_agree's 1e-9,
    with equal .walks.  With ``iterations`` None only the second run is
    made, held to ``want`` itself (phase 12's run of its config at world
    2 is then the run it must equal)."""
    name = flag[2:].replace("-", "_")

    def walks(tag):
        with open(os.path.join(d, f"{tag}.walks"), "rb") as f:
            return f.read()

    if iterations is not None:
        tag_a = name + "_a"
        text_a, wall_a = run_cli("gaml_tpu_torch.cli",
                                 write_config(d, tag_a, iterations),
                                 ["--device", str(device), flag], timeout)
        sum_a = summary_of(text_a)
    spent, moves = {}, []
    undo = scoring_probes(spent, moves, keep)
    try:
        text_b, sum_b, _wall, busy, span, move_s = cli_in_process(
            device, d, write_config(d, name + "_b", second_iterations),
            [flag], env={"GAML_DEV_MIN_BASES": "0"}, window=window)
    finally:
        undo()
    if iterations is None:
        tag_a, text_a, wall_a, sum_a = name + "_b", text_b, _wall, sum_b
        iterations = second_iterations
    tr_a, tr_b = trace(text_a), trace(text_b)
    check(len(tr_a) >= iterations, f"{flag}: {len(tr_a)} itnum lines")
    check(tr_a[:len(tr_b)] == tr_b,
          f"{flag}: two runs differ: {first_difference(tr_a, tr_b)}")
    how = traces_agree(tr_a, want["trace"])
    check(how is not None, f"{flag}: trace against the host scorer's: "
          f"{first_difference(tr_a, want['trace'])}")
    check(walks(tag_a) == want["walks"],
          f"{flag}: .walks differ from the host scorer's")
    check(device.type != "cuda" or sum_a["launches"]["extend_exact"] > 0,
          f"{flag}: no extension launch: {sum_a}")
    per_move = []
    for mv in moves:
        if mv:
            n = max(int(np.max(b["rid"])) for _sc, bs in mv for b in bs) + 1
            per_move.append(timer(device, lambda: [
                sc.read_totals(bs, n, MPB, MPS) for sc, bs in mv], 3))
    anneal_b = sum_b["anneal_s"]
    warm = min(len(move_s), len(want["move_s"]))
    res = {"iterations": iterations, "wall_s": wall_a,
           "second_iterations": second_iterations,
           "ms_per_move": sum_a["anneal_s"] / iterations * 1e3,
           "host_ms_per_move": want["anneal_s"] / want["iterations"] * 1e3,
           "first_move_ms": move_s[0] * 1e3,
           "host_first_move_ms": want["move_s"][0] * 1e3,
           "warm_moves": [2, warm],
           "warm_ms_per_move": float(np.mean(move_s[1:warm])) * 1e3,
           "host_warm_ms_per_move": float(np.mean(
               want["move_s"][1:warm])) * 1e3,
           "vs_host_trace": how, "second_run": f"identical over "
           f"{len(tr_b)} itnum lines" if text_a is not text_b
           else "phase 12's, at world 2",
           "profiled_ms_per_move": anneal_b / second_iterations * 1e3,
           "scoring_share": spent["calc_prob"] / anneal_b,
           "host_staging_share": (spent.get("staging", 0.0)
                                  + spent.get("host_pairs", 0.0)) / anneal_b,
           "profiled_moves": window or [0, second_iterations],
           "device_busy_ms": busy,
           "device_busy_share": None if busy is None else busy / 1e3 / span,
           "bucket_products_ms_per_call": float(np.median(per_move))
           if per_move else None,
           "bucket_products_calls_timed": len(per_move),
           "buckets_per_call": float(np.median([
               sum(len(bs) for _sc, bs in m) for m in moves if m]))
           if per_move else 0,
           "launches": {k: sum_b["launches"][k] + (
               sum_a["launches"][k] if text_a is not text_b else 0)
               for k in ("extend_exact", "extend_exact_staged",
                         "candgen_runs", "query_plain")}}
    print(f"  {flag} " + json.dumps(res), flush=True)
    # the second run's trace and .walks, for phase 12's world of two
    res["ref"] = {"trace": tr_b, "walks": walks(name + "_b"),
                  "window": window}
    return res


def single_end_world(device, world=(2_800_000, 300_000)):
    """Phase 9's single-end world when phase 9 did not run: host
    candidates on phase 3's world and SingleEndModel's score of them."""
    from gaml_tpu_torch.models import SingleEndModel
    from gaml_tpu_torch.ops.extend import stage_candidates

    genome_len, n_reads = world
    genome, reads = make_world(genome_len, n_reads)
    cands = host_candidates(make_bundle(reads), reads, genome)
    score, zeros, _ = SingleEndModel(
        MATCH, MISMATCH, MPB, MPS, device=device).score_candidates(
        genome, cands, n_reads, [READ_LEN] * n_reads, genome_len)
    rmax = stage_candidates(genome, [c.genome_pos for c, _ in cands],
                            [c.read_pos for c, _ in cands],
                            [r for _, r in cands], device="cpu")["rmax"]
    return {"genome": genome, "cands": cands, "rmax": rmax,
            "n_reads": n_reads, "score": score, "zero_reads": zeros}


def phase_device_scorers(device, d, d_pb, pb_genome, anneal=None, pb=None,
                         models=None, iterations=200, second_iterations=130,
                         window=(20, 100), full_iterations=None,
                         full_second_iterations=13, full_window=(1, 10),
                         pb_iterations=400, timeout=450):
    """The JAX CLI's four device scorers through the port's CLI on
    ``device``.  On the aureus world in ``d``: --paired-device-inc and
    --device-state over phase 4's iterations, their second runs over
    ``second_iterations`` profiled over ``window``; --paired-device
    (every walk restaged on every scoring call) over ``full_iterations``
    (None: no such run), its second run over ``full_second_iterations``
    profiled over ``full_window``; each flag in two runs (paired_flag;
    --paired-device's second run is phase 12's at world 2) held to the
    port's default run (the host incremental scorer: phase 4's, and one
    of --paired-device's length here, in this process, whose moves'
    walls give the host's ms per warm move).  On the
    PacBio world in ``d_pb``: --pacbio-device, every forward cell on K5
    ("mesh"), held to phase 7's native route by assembly_bound.  Then
    sharded_single_end_score on phase 9's candidates against
    SingleEndModel's score (within 1e-12, zero reads equal).  Without the
    earlier phases' results their reference runs are made here."""
    from gaml_tpu_torch.core import dna
    from gaml_tpu_torch.parallel import sharded

    def default_run(name, its):
        text, _ = run_cli("gaml_tpu_torch.cli", write_config(d, name, its),
                          ["--device", str(device)], timeout)
        with open(os.path.join(d, f"{name}.walks"), "rb") as f:
            walks = f.read()
        return {"trace": trace(text), "iterations": its, "walks": walks,
                "anneal_s": summary_of(text)["anneal_s"]}

    if anneal is None:
        ref = default_run("dev", iterations)
    else:
        iterations = anneal["iterations"]
        with open(os.path.join(d, "dev.walks"), "rb") as f:
            ref = {"trace": anneal["trace"], "iterations": iterations,
                   "walks": f.read(), "anneal_s": anneal["dev_anneal_s"]}
    short = full_iterations or full_second_iterations
    text, summary, _wall, _busy, _span, move_s = cli_in_process(
        device, d, write_config(d, "dev_short", short), [],
        env={"GAML_DEV_MIN_BASES": "0"})
    with open(os.path.join(d, "dev_short.walks"), "rb") as f:
        ref_short = {"trace": trace(text), "iterations": short,
                     "walks": f.read(), "anneal_s": summary["anneal_s"],
                     "move_s": move_s}
    check(ref_short["trace"] == ref["trace"][:len(ref_short["trace"])],
          "the default run's trace is not a prefix of the longer run's")
    ref["move_s"] = move_s
    res = {"host_ms_per_move": ref["anneal_s"] / iterations * 1e3}
    launches = {"extend_exact": 0, "extend_exact_staged": 0,
                "banded_forward": 0, "candgen_runs": 0, "query_plain": 0}
    for flag, its, want, its_b, win, keep in (
            ("--paired-device-inc", iterations, ref, second_iterations,
             window, 100),
            ("--device-state", iterations, ref, second_iterations, window,
             100),
            ("--paired-device", full_iterations, ref_short,
             full_second_iterations, full_window, 12)):
        res[flag] = paired_flag(device, d, flag, its, want, timeout, its_b,
                                win, keep)
        for k, v in res[flag]["launches"].items():
            launches[k] += v

    truth = dna.decode_seq(pb_genome)
    if pb is None:
        nat_tr, _ = native_pacbio_run(d_pb, pb_iterations, timeout)
        pb = {"nat_best_prob": float(nat_tr[-1].split()[9]),
              "nat_quality": quality(truth, os.path.join(d_pb, "nat.fasta"))}
    text, summary, wall, busy, _span, _moves = cli_in_process(
        device, d_pb, write_pacbio_config(d_pb, "mesh", pb_iterations),
        ["--pacbio-device"])
    cells = summary["pacbio_cells"]
    pb_launches = summary["launches"]["banded_forward"]
    check(set(cells) == {"mesh"} and cells["mesh"] > 0,
          f"--pacbio-device: forward cells {cells}")
    check(device.type != "cuda" or pb_launches > 0,
          f"--pacbio-device: K5 was not launched: {summary}")
    tr = trace(text)
    check(len(tr) >= pb_iterations, f"--pacbio-device: {len(tr)} lines")
    best = float(tr[-1].split()[9])
    q = assembly_bound(d_pb, truth, "mesh", best,
                       {"best_prob": pb["nat_best_prob"],
                        "quality": pb["nat_quality"]})
    launches["banded_forward"] += pb_launches
    res["--pacbio-device"] = {
        "iterations": pb_iterations, "wall_s": wall,
        "ms_per_move": summary["anneal_s"] / pb_iterations * 1e3,
        "best_prob": best, "nat_best_prob": pb["nat_best_prob"],
        "quality": q, "pacbio_cells": cells, "launches": pb_launches,
        "device_busy_ms": busy,
        "device_busy_share": None if busy is None
        else busy / 1e3 / summary["anneal_s"]}
    print("  --pacbio-device " + json.dumps(res["--pacbio-device"]),
          flush=True)
    res["--pacbio-device"]["ref"] = {"trace": tr, "nat": pb}

    w = models["world"] if models is not None else single_end_world(device)
    n_reads = w["n_reads"]
    shard = [[(c.read_id, c.genome_pos, c.read_pos, r) for c, r in w["cands"]]]
    args = (float(np.log(MATCH)), float(np.log(MISMATCH)), len(w["genome"]),
            MPB, MPS, w["rmax"])
    counts = reset_launches()
    t0 = time.perf_counter()
    staged, lens_mask, n_local = sharded.stage_sharded(
        w["genome"], shard, w["rmax"], [np.full(n_reads, READ_LEN)],
        device=device)
    sync(device)
    stage_s = time.perf_counter() - t0
    score, zeros = (x.item() for x in sharded.sharded_single_end_score(
        staged, lens_mask, *args, n_local, n_reads))
    staged_launches = counts["extend_exact_staged"]
    check(int(zeros) == w["zero_reads"] and close(score, w["score"], 1e-12),
          f"sharded_single_end_score ({score}, {zeros}) vs the model "
          f"({w['score']}, {w['zero_reads']})")
    check(device.type != "cuda" or (staged_launches == 1 and
                                    counts["extend_exact"] == 0),
          f"sharded_single_end_score launches {counts}")
    launches["extend_exact_staged"] += staged_launches
    res["single_end"] = {
        "candidates": len(w["cands"]), "score": score, "zero_reads":
        int(zeros), "rel_vs_model": abs(score - w["score"]) / abs(w["score"]),
        "staging_s": stage_s, "ms": timer(device, lambda: float(
            sharded.sharded_single_end_score(staged, lens_mask, *args,
                                             n_local, n_reads)[0]),
            5, host_clock=True),
        "launches": staged_launches}
    print("  single_end " + json.dumps(res["single_end"]), flush=True)
    check(device.type != "cuda" or launches["query_plain"] == 0,
          f"phase 11 ran query_plain on the card: {launches}")
    res["launches"] = launches
    return res


# ----------------------------------------------------------------- phase 12
def foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "gaml_tpu"))


def run_ranks(specs, timeout):
    """This script in rank mode (``--rank``, rank_main), one process per
    spec, all started together as one process group (gloo: the ranks
    share the card); returns their reports in rank order.  Every rank is
    killed when one fails or outlives ``timeout``."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    world = len(specs)
    with tempfile.TemporaryDirectory(prefix="gaml_ranks_") as tmp:
        outs, procs = [], []
        for r, spec in enumerate(specs):
            outs.append(os.path.join(tmp, f"rank{r}.json"))
            path = os.path.join(tmp, f"spec{r}.json")
            with open(path, "w") as f:
                json.dump(dict(spec, out=outs[r]), f)
            # each rank gets its share of the host's cores for its
            # OpenMP and torch threads, as torchrun's ranks do
            env = dict(os.environ, GAML_COORD=f"127.0.0.1:{port}",
                       GAML_NPROC=str(world), GAML_PROC_ID=str(r),
                       GAML_DIST_BACKEND="gloo", GAML_DEV_MIN_BASES="0",
                       OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1)
                                               // world)))
            env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH",
                                                            "")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", path],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r, (proc, log) in enumerate(zip(procs, logs)):
            check(proc.returncode == 0, f"rank {r} of {world} exited "
                  f"{proc.returncode}:\n{log[-4000:]}")
        reports = []
        for out in outs:
            with open(out) as f:
                reports.append(json.load(f))
    for r, rep in enumerate(reports):
        check(not rep["foreign_modules"], f"rank {r} holds modules of jax or "
              f"the JAX package: {rep['foreign_modules']}")
    return reports


def rank_main(spec_path):
    """One rank of phase 12 (run_ranks), on the spec's device.  ``cli``: the port's
    CLI in this process as cli_in_process runs it (its process group from
    the GAML_* environment; the scoring steps timed by scoring_probes);
    ``single_end``: sharded_single_end_score on this rank's shard of
    phase 9's candidates.  Writes its report to the spec's ``out``."""
    import torch

    with open(spec_path) as f:
        spec = json.load(f)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if spec["task"] == "cli":
        spent, moves = {}, []
        undo = scoring_probes(spent, moves, 1)
        try:
            text, summary, wall, busy, span, move_s = cli_in_process(
                device, spec["d"], spec["cfg"], spec["extra"],
                window=spec["window"])
        finally:
            undo()
        out = {"trace": trace(text), "summary": summary, "wall_s": wall,
               "busy_ms": busy, "span_s": span, "move_s": move_s,
               "spent": spent}
    else:
        out = single_end_rank(device, spec)
    out["foreign_modules"] = foreign_modules()
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def single_end_rank(device, spec):
    """sharded_single_end_score of this rank's reads shard (the npz at
    ``spec["shard"]``: local read ids, positions and read rows) at world
    (2, 1); its staging seconds, score, launches and warm ms."""
    from gaml_tpu_torch.parallel import distributed, sharded

    rank, world = distributed.initialize(
        os.environ["GAML_COORD"], int(os.environ["GAML_NPROC"]),
        int(os.environ["GAML_PROC_ID"]), backend="gloo", device=device)
    try:
        z = np.load(spec["shard"])
        n_local = int(z["n_local"])
        cands = list(zip(z["rid"].tolist(), z["gpos"].tolist(),
                         z["rpos"].tolist(), list(z["reads"])))
        counts = reset_launches()
        t0 = time.perf_counter()
        staged, lens_mask, n_pad = sharded.stage_sharded(
            z["genome"], [cands], spec["rmax"],
            [np.full(n_local, READ_LEN)], world=(world, 1), device=device)
        sync(device)
        stage_s = time.perf_counter() - t0
        args = (staged, lens_mask, float(np.log(MATCH)),
                float(np.log(MISMATCH)), len(z["genome"]), MPB, MPS,
                spec["rmax"], n_pad, spec["n_reads"])
        score, zeros = (x.item() for x in
                        sharded.sharded_single_end_score(*args))
        launches = dict(counts)
        ms = timer(device, lambda: float(
            sharded.sharded_single_end_score(*args)[0]), 5, host_clock=True)
    finally:
        distributed.shutdown()
    return {"rank": rank, "candidates": len(cands), "reads": n_local,
            "score": score, "zero_reads": int(zeros), "staging_s": stage_s,
            "ms": ms, "launches": launches}


def flag_world_two(device, d, flag, cfg, its, window, ref, timeout):
    """One device-scorer flag at world 2 (two ranks over gloo on one
    card, through the CLI): each rank's trace equal to the other's and to
    ``ref``'s, the world-1 run of the same config (phase 11's), itnum line
    for line.  Returns the per-rank readings."""
    reps = run_ranks([{"task": "cli", "device": str(device), "d": d,
                       "cfg": cfg, "extra": [flag], "window": window}] * 2,
                     timeout)
    for r, rep in enumerate(reps):
        check(len(rep["trace"]) >= its, f"{flag} rank {r}: "
              f"{len(rep['trace'])} itnum lines")
        check(rep["trace"] == ref, f"{flag} rank {r} against world 1: "
              f"{first_difference(rep['trace'], ref)}")
        check((rep["summary"]["rank"], rep["summary"]["world"]) == (r, 2),
              f"{flag} rank {r}: {rep['summary']}")
    out = {"iterations": its, "ranks": []}
    for rep in reps:
        anneal = rep["summary"]["anneal_s"]
        sp = rep["spent"]
        out["ranks"].append({
            "ms_per_move": anneal / its * 1e3,
            "scoring_share": sp["calc_prob"] / anneal,
            "host_staging_share": (sp.get("staging", 0.0)
                                   + sp.get("host_pairs", 0.0)
                                   + sp.get("pb_staging", 0.0)) / anneal,
            "device_busy_ms": rep["busy_ms"],
            "device_busy_share": None if rep["busy_ms"] is None
            else rep["busy_ms"] / 1e3 / rep["span_s"],
            "profiled_moves": window or [0, its],
            "launches": rep["summary"]["launches"],
            "pacbio_cells": rep["summary"]["pacbio_cells"]})
    busy = [r["device_busy_ms"] for r in out["ranks"]]
    out["card_busy_share"] = None if None in busy else \
        sum(busy) / 1e3 / max(rep["span_s"] for rep in reps)
    return out, reps


def phase_distributed(device, d, d_pb, pb_genome, scorers, models,
                      timeout=300):
    """Multi-process scoring on the card (parallel/distributed.py).  The
    dry run (tools/dryrun_distributed.py) at world 2 over gloo, both
    ranks on this card, against one rank over NCCL: every merged result
    bit-equal but the single-end score (index_add_'s float64 atomics,
    rel 1e-12).  Then the four device-scorer flags through the CLI at
    world 2 over gloo, each rank's trace equal to phase 11's world-1
    run of the same config (--paired-device-inc, --device-state: its
    second runs, profiled over the same moves; --paired-device: its
    second run; --pacbio-device: its whole run, held to phase 7's
    assembly bound too), rank 0's .walks equal; and
    sharded_single_end_score at world (2, 1) on phase 9's candidates
    against SingleEndModel's score."""
    from gaml_tpu_torch.core import dna
    from gaml_tpu_torch.parallel.distributed import reads_for_process
    from gaml_tpu_torch.tools import dryrun_distributed as dryrun

    launches = {"extend_exact": 0, "extend_exact_staged": 0,
                "banded_forward": 0, "candgen_runs": 0, "query_plain": 0}

    def count(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    res = {}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(dryrun.launch, w, backend=b, device=str(device),
                            timeout=timeout)
                for w, b in ((2, "gloo"), (1, "nccl"))]
        two, one = (r.result() for r in runs)
    # partials: sums of each rank's reads, added in rank order (another
    # association at another world)
    merged = [{k: v for k, v in rep.items() if k not in dryrun.LOCAL_KEYS
               + ("world", "backend", "partials")}
              for rep in (one[0], two[0])]
    se = [m.pop("single_end") for m in merged]
    check(merged[0] == merged[1] and se[0][1] == se[1][1]
          and close(se[0][0], se[1][0], 1e-12),
          f"the dry run at world 2 (gloo) against world 1 (nccl): "
          f"{merged[1]} {se[1]} vs {merged[0]} {se[0]}")
    for rep in two + one:
        check(device.type != "cuda" or (
              rep["launches"].get("extend_exact_staged", 0) > 0 and
              rep["launches"].get("banded_forward", 0) > 0),
              f"dry run rank {rep['rank']} of {rep['world']}: launches "
              f"{rep['launches']}")
        count(rep["launches"])
    res["dryrun"] = {
        "s": time.perf_counter() - t0, "backends": ["gloo x 2", "nccl x 1"],
        "single_end_rel": abs(se[1][0] - se[0][0]) / abs(se[0][0]),
        "fwd_max_err": max(r["fwd_max_err"] for r in two + one),
        "launches": {f"{r['backend']} rank {r['rank']}": r["launches"]
                     for r in two + one}}
    print("  dryrun " + json.dumps(res["dryrun"]), flush=True)

    for flag in ("--paired-device-inc", "--device-state", "--paired-device"):
        p11 = scorers[flag]
        name = flag[2:].replace("-", "_") + "_w2"
        its = p11["second_iterations"]
        t0 = time.perf_counter()
        out, _reps = flag_world_two(
            device, d, flag, write_config(d, name, its), its,
            p11["ref"]["window"], p11["ref"]["trace"], timeout)
        with open(os.path.join(d, f"{name}.walks"), "rb") as f:
            check(f.read() == p11["ref"]["walks"],
                  f"{flag}: world 2's .walks differ from world 1's")
        out.update(wall_s=time.perf_counter() - t0,
                   world1_ms_per_move=p11["profiled_ms_per_move"],
                   world1_host_staging_share=p11["host_staging_share"],
                   world1_device_busy_share=p11["device_busy_share"])
        for r in out["ranks"]:
            count(r["launches"])
        res[flag] = out
        print(f"  {flag} world 2 " + json.dumps(out), flush=True)

    p11 = scorers["--pacbio-device"]
    its = p11["iterations"]
    t0 = time.perf_counter()
    out, reps = flag_world_two(device, d_pb, "--pacbio-device",
                               write_pacbio_config(d_pb, "mesh_w2", its),
                               its, None, p11["ref"]["trace"], timeout)
    for r in out["ranks"]:
        check(set(r["pacbio_cells"]) == {"mesh"} and (
              device.type != "cuda" or
              r["launches"].get("banded_forward", 0) > 0),
              f"--pacbio-device world 2: cells {r['pacbio_cells']}, "
              f"launches {r['launches']}")
        count(r["launches"])
    nat = p11["ref"]["nat"]
    q = assembly_bound(d_pb, dna.decode_seq(pb_genome), "mesh_w2",
                       float(reps[0]["trace"][-1].split()[9]),
                       {"best_prob": nat["nat_best_prob"],
                        "quality": nat["nat_quality"]})
    out.update(wall_s=time.perf_counter() - t0, quality=q,
               world1_ms_per_move=p11["ms_per_move"],
               world1_device_busy_share=p11["device_busy_share"])
    res["--pacbio-device"] = out
    print("  --pacbio-device world 2 " + json.dumps(out), flush=True)

    w = models["world"] if models is not None else single_end_world(device)
    n_reads = w["n_reads"]
    rid = np.array([c.read_id for c, _ in w["cands"]], np.int64)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gaml_shards_") as tmp:
        specs = []
        for r in range(2):
            got = reads_for_process(n_reads, r, 2)
            lo, hi = got[0], got[-1] + 1
            sel = np.flatnonzero((rid >= lo) & (rid < hi))
            path = os.path.join(tmp, f"shard{r}.npz")
            np.savez(path, genome=w["genome"], rid=rid[sel] - lo,
                     gpos=np.array([w["cands"][i][0].genome_pos
                                    for i in sel], np.int64),
                     rpos=np.array([w["cands"][i][0].read_pos
                                    for i in sel], np.int64),
                     reads=np.stack([np.asarray(w["cands"][i][1], np.uint8)
                                     for i in sel]),
                     n_local=hi - lo)
            specs.append({"task": "single_end", "device": str(device),
                          "shard": path,
                          "rmax": int(w["rmax"]), "n_reads": n_reads})
        ranks = run_ranks(specs, timeout)
    for rep in ranks:
        check(rep["zero_reads"] == w["zero_reads"] and
              close(rep["score"], w["score"], 1e-12) and
              rep["score"] == ranks[0]["score"],
              f"sharded_single_end_score rank {rep['rank']} "
              f"({rep['score']}, {rep['zero_reads']}) vs the model "
              f"({w['score']}, {w['zero_reads']})")
        check(device.type != "cuda" or (
              rep["launches"].get("extend_exact_staged", 0) == 1 and
              rep["launches"].get("extend_exact", 0) == 0),
              f"sharded_single_end_score rank {rep['rank']} launches "
              f"{rep['launches']}")
        count(rep["launches"])
    res["single_end"] = {
        "s": time.perf_counter() - t0, "world": [2, 1],
        "rel_vs_model": abs(ranks[0]["score"] - w["score"]) / abs(
            w["score"]),
        "world1_ms": scorers["single_end"]["ms"],
        "ranks": [{k: rep[k] for k in ("candidates", "reads", "staging_s",
                                       "ms", "launches")} for rep in ranks]}
    print("  single_end world (2, 1) " + json.dumps(res["single_end"]),
          flush=True)
    check(device.type != "cuda" or launches["query_plain"] == 0,
          f"phase 12 ran query_plain on the card: {launches}")
    res["launches"] = launches
    return res


def kernels_line(card, kern, anneal, fwd, pb, exact, models, mixed,
                 scorers, dist, bench, aureus):
    """{"kernels": [...]}: one entry per TPU kernel with the numbers of
    the phases that measured it.  K1-K4 are all served by one kernel,
    the exact two-direction extension.  Launches come from the runs of
    the main paths (counts reset just before each): K1/K2/K3 the
    resident loader's (K1 + K2's function, and K3's, the JAX package's
    route under GAML_SWAR_BACKWARD=0): phase 4's anneal (uniform read
    sets), phase 10's (ragged read sets and the advice library's uniform
    one) and phase 11's paired-flag anneals; K4a/K4b the staged
    loader's: the models of phase 9 plus phase 11's
    sharded_single_end_score; K5 phase 7
    plus phase 11's --pacbio-device anneal, K6 its tool, and phase 12's
    launches summed over its ranks (each entry keeps phase 11's and
    phase 12's shares as ``launches_phase11`` and ``launches_phase12``).  The K1/K2 entries carry
    the resident loader's phase-1 numbers on the rescore's world and,
    beside them, the staged route it replaced on the same candidates.
    K3's entry is the resident loader on phase 8's ragged draw, K4b's the
    staged loader on that draw at rmax 96 (n % 1024 == 0, K4b's route on
    the TPU), K4a's its staged loader at phase 9's model forward, each
    with its bound counted both ways (the share uses the algorithm's
    count) and the single-direction stacked launch the port made before
    beside it.  No PyTorch call computes a banded min-plus or log-space
    forward DP, so library_ms is null throughout.
    ``card`` gives each band kernel's registers, spills and DPX
    instruction count, and K5's registers, spills and MUFU count per
    width (phase 0).  K5's max_abs_err is against the float32 plain
    version; the float64 one, the twin's and the adversarial batch's
    stand beside it, the largest over both widths.  The candgen entry
    (no TPU kernel: the JAX package's XLA graph) is the kernel route on
    phase 2's world from the uploaded codes against query_plain, with
    phase 3's numbers beside it; its launches are its queries (runs-pass
    launches) on the main paths: phases 2-3's rescores and jobs, the
    anneals of phases 4 and 10, phase 11's and phase 12's; no PyTorch
    call computes a max-hash window query, so library_ms is null, and
    its sort stage stands beside torch.sort on the same keys under
    "sort"."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    more = ("share", "rows", "lane_ops", "bytes", "bound_ms_stacked_count")
    res = kern["extend_exact"]
    p11, p12 = scorers["launches"], dist["launches"]
    p10 = mixed["launches"]["extend_exact"]
    resident = anneal["launches"]["extend_exact"] + p10 \
        + p11["extend_exact"] + p12["extend_exact"]
    k1k2 = dict({k: res[k] for k in keys + more},
                staged_route_ms=res["staged_route_ms"],
                stage_views_ms=res["stage_views_ms"], launches=resident,
                launches_phase10=p10, launches_phase11=p11["extend_exact"],
                launches_phase12=p12["extend_exact"], loader="resident")
    k4 = models["K4a"]["launches"] + p11["extend_exact_staged"] \
        + p12["extend_exact_staged"]

    def exact_entry(res, launches, **extra):
        return dict({k: res[k] for k in keys + more}, launches=launches,
                    **extra)

    k4a = models["K4a"]
    kern = {"K1": dict(k1k2, staged_entry_ms=res["staged_k1_ms"],
                       staged_entry_launches=anneal["launches"]["swar_cost"]),
            "K2": dict(k1k2, staged_entry_ms=res["staged_k2_ms"],
                       staged_entry_launches=anneal["launches"][
                           "swar_cost_accept"]),
            "K3": exact_entry(
                exact["exact_resident"], resident, launches_phase10=p10,
                launches_phase11=p11["extend_exact"],
                launches_phase12=p12["extend_exact"],
                loader="resident", read_lens=exact["exact_resident"][
                    "read_lens"], dp_rows_exact_ms=exact["dp_rows_exact"][
                    "ms"]),
            "K4a": exact_entry(
                k4a, k4, launches_phase11=p11["extend_exact_staged"],
                launches_phase12=p12["extend_exact_staged"],
                loader="staged", stacked_ms=k4a["stacked"]["ms"],
                stacked_bound_ms=k4a["stacked"]["bound_ms"],
                resident_ms=k4a["resident"]["ms"],
                resident_bound_ms=k4a["resident"]["bound_ms"]),
            "K4b": exact_entry(
                exact["exact_staged"], k4,
                launches_phase11=p11["extend_exact_staged"],
                launches_phase12=p12["extend_exact_staged"], loader="staged",
                stacked_ms=exact["dp_rows_exact_stacked"]["ms"]),
            "K6": exact["K6"]}
    kern["K5"] = {
        k: (fwd[64][k] if k != "max_abs_err" else
            max(fwd[64][k], fwd[128][k])) for k in keys}
    for tpu, entry in (("K1", "extend_exact"), ("K2", "extend_exact"),
                       ("K3", "extend_exact"), ("K4a", "extend_exact_staged"),
                       ("K4b", "extend_exact_staged"), ("K6", "swar_cost")):
        kern[tpu] = dict(kern[tpu], compiled=card[entry])
    for k in ("max_abs_err_f64", "max_abs_err_twin",
              "adversarial_max_abs_err", "adversarial_max_abs_err_f64",
              "adversarial_max_abs_err_twin"):
        kern["K5"][k] = max(fwd[64][k], fwd[128][k])
    kern["K5"].update(width=64, ms_w128=fwd[128]["ms"],
                      plain_ms_w128=fwd[128]["plain_ms"],
                      bound_ms_w128=fwd[128]["bound_ms"],
                      bound_term=fwd[64]["bound_term"],
                      mufu_bound_ms=fwd[64]["mufu_bound_ms"],
                      mufu_bound_ms_w128=fwd[128]["mufu_bound_ms"],
                      compiled=card["banded_forward_w64"],
                      compiled_w128=card["banded_forward_w128"],
                      launches=pb["launches"] + p11["banded_forward"]
                      + p12["banded_forward"],
                      launches_phase11=p11["banded_forward"],
                      launches_phase12=p12["banded_forward"])
    candgen = candgen_entry(card, bench["candgen"], aureus["candgen"],
                            (anneal["launches"], mixed["launches"], p11,
                             p12))
    return {"kernels": [
        dict({k: kern[tpu][k] for k in keys}, name=name, tpu_kernel=tpu,
             route="cuda", source=source, replaces=replaces,
             launches=kern[tpu]["launches"], library_ms=None,
             **{k: v for k, v in kern[tpu].items()
                if k not in keys and k != "launches"})
        for tpu, name, source, replaces in KERNELS] + [candgen]}


def candgen_entry(card, cg, cg3, runs):
    """The kernels line's candgen entry from phase 2's (``cg``) and phase
    3's (``cg3``) numbers, phase 0's compiler output and the launch
    counts of the main-path runs ``runs`` (phase 4's and 10's CLI
    summaries, phase 11's and 12's sums)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    main = dict(zip(("phase_4", "phase_10", "phase_11", "phase_12"),
                    (r["candgen_runs"] for r in runs)),
                phases_2_3=cg["launches"] + cg3["launches"])
    by_kernel = {k: runs[0].get(k, 0) + runs[1].get(k, 0)
                 for k in ("candgen_runs", "candgen_block", "candgen_expand",
                           "candgen_hist", "candgen_scatter")}
    return dict(
        {k: cg[k] for k in keys}, name=CANDGEN[0], tpu_kernel=None,
        route="cuda", source=CANDGEN[1], replaces=CANDGEN[2],
        launches=sum(main.values()), library_ms=None, launches_by_phase=main,
        launches_by_kernel_phases_4_10=by_kernel,
        query_plain_calls_on_main_paths=sum(r["query_plain"] for r in runs),
        world=f"400 kb, {cg['candidates']} candidates", share=cg["share"],
        int32_ops=cg["int32_ops"], bytes=cg["bytes"], runs=cg["runs"],
        split=cg["split"], sort=cg["sort"],
        launches_of_a_query=cg["launches_of_a_query"],
        aureus={k: cg3[k] for k in keys + (
            "share", "candidates", "split", "sort", "launches_of_a_query")},
        fuzz=cg3["fuzz"], compiled={k: card.get(k) for k in CANDGEN_KERNELS})


def run_phase(name, fn, *args, **kw):
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def main():
    if not os.path.isdir(os.path.join(ROOT, "gaml_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--candgen-split"]:
        return candgen_split_main(sys.argv[2:] or ("plain", "kernel"))
    if sys.argv[1:2] == ["--seeds"]:
        return seeds_main()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = run_phase("0 card", phase_card)
    kern = run_phase("1 kernels", phase_kernels, device)
    rescore_launches = {}
    bench = run_phase("2 rescore 400 kb", phase_rescore, device, 400_000,
                      100_000, launches=rescore_launches, jobs=4)
    aureus = run_phase("3 rescore 2.8 Mb", phase_rescore, device, 2_800_000,
                       300_000, fuzz=200)
    with tempfile.TemporaryDirectory(prefix="gaml_smoke_") as d_aureus, \
            tempfile.TemporaryDirectory(prefix="gaml_smoke_pb_") as d_pb:
        t0 = time.perf_counter()
        world = write_anneal_world(d_aureus)
        world += (time.perf_counter() - t0,)
        anneal = run_phase("4 anneal", phase_anneal, device, d_aureus, world)
        fwd = run_phase("5 K5", phase_forward_kernel, device)
        genome = write_pacbio_world(d_pb)
        run_phase("6 pacbio scoring", phase_pacbio_scoring, device, d_pb)
        run_phase("6b seed lookup", phase_seeds, device)
        pb = run_phase("7 pacbio anneal", phase_pacbio_anneal, device, d_pb,
                       genome)
        exact = run_phase("8 exact DP", phase_exact, device)
        models = run_phase("9 device models", phase_models, device,
                           d_aureus)
        mixed = run_phase("10 mixed-length anneal", phase_mixed_anneal,
                          device, d_aureus)
        scorers = run_phase("11 device scorers", phase_device_scorers,
                            device, d_aureus, d_pb, genome, anneal, pb,
                            models)
        dist = run_phase("12 distributed", phase_distributed, device,
                         d_aureus, d_pb, genome, scorers, models)
    foreign = foreign_modules()
    check(not foreign, f"modules of jax or the JAX package were imported: "
          f"{foreign}")
    print(json.dumps(kernels_line(card, kern, anneal, fwd, pb, exact, models,
                                  mixed, scorers, dist, bench, aureus)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   the SASS of the band kernels, K5's MUFU instructions);
1. the fused extension kernel against its plain version on a resident
   world of 131072 candidates (reads of 100 bp), timed beside the staged
   route it replaces (stage_views + K1 + K2) on the same candidates; the
   staged K1/K2 entries against their plain versions at the band shape
   (131072 candidates, rmax 96);
2. candidate generation and the full rescore at bench.py's world (400 kb
   genome, 100k reads of 100 bp) against the native C++ query and the
   port's own CPU engine (which runs the plain versions), with warm
   timings, the stage split (candgen, extension, dedup + reduction) and
   the fused kernel against its plain version on the rescore's own
   candidates;
3. the same at S. aureus scale (2.8 Mb, 300k reads of 100 bp);
4. an anneal through ``python -m gaml_tpu_torch.cli --device cuda`` on the
   2.8 Mb paired world of examples/aureus_like_run.py, held against a
   ``--device cpu`` run of the same config and reported against the
   port's ``--backend bfs``;
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
7. a PacBio anneal through the port's CLI (``--device cuda``, in this
   process, under the profiler) against the port's CLI on the native host
   route, held to the assembly-level bound of
   tests/test_pacbio.py::test_f32_route_anneal_quality_bound;
8. the exact band DP (dp_rows_exact, the counterpart of K3/K4a/K4b)
   against its plain version at phase 1's band inputs, one launch and the
   stacked two-direction launch; the K6 tool
   (gaml_tpu_torch.tools.swar_kernel_proto); and the phase-2 rescore on
   the K3 route (GAML_SWAR_BACKWARD=0) against the default route;
9. the device likelihood models at S. aureus scale: SingleEndModel on
   phase 3's world (host candidates) against the model on the CPU and
   DeviceRescorer.rescore, and PairedEndModel on the phase-4 world's
   frag library against the host paired scorer over the start walks;
10. a mixed-length anneal: phase 4's world with 20 % of each frag mate
   file's reads quality-trimmed (no native bundle, so its windows run
   through the exact kernel while the advice library stays on the fused
   kernel), ``--device cuda`` against ``--device cpu``, reported against
   ``--backend bfs``.

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
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MATCH, MISMATCH = 0.96, 0.01
MPB, MPS = -0.7, -10.0
READ_LEN = 100
BAND_DP = "gaml_tpu_torch/csrc/band_dp.cu"
KERNELS = (  # (TPU kernel, entry name, source, the pallas_call it replaces)
    ("K1", "extend_fused", BAND_DP, "gaml_tpu/ops/extend_pallas.py:467"),
    ("K2", "extend_fused", BAND_DP, "gaml_tpu/ops/extend_pallas.py:600"),
    ("K3", "dp_rows_exact:K3", BAND_DP, "gaml_tpu/ops/extend_pallas.py:710"),
    ("K4a", "dp_rows_exact:K4a", BAND_DP,
     "gaml_tpu/ops/extend_pallas.py:287"),
    ("K4b", "dp_rows_exact:K4b", BAND_DP,
     "gaml_tpu/ops/extend_pallas.py:231"),
    ("K5", "banded_forward", "gaml_tpu_torch/csrc/banded_forward.cu",
     "gaml_tpu/ops/forward_pallas.py:134"),
    ("K6", "swar_cost:K6", BAND_DP, "tools/swar_kernel_proto.py:127"),
)
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
                "extend_fused_kernel": "extend_fused"}


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


def fused_bound(args, rmax):
    """The bound of the fused extension on its inputs (codes, buf, base,
    glen, g0, r0, row): the backward rows (cost and offset), the forward
    rows (cost), the read rows the candidates name, the window buffer,
    five int32 and three outputs (9 bytes) per candidate."""
    import torch

    from gaml_tpu_torch.ops.extend import K

    codes, buf, _base, _glen, g0, r0, row = args
    L = codes.shape[1]
    rows_b = torch.where(g0 > 0, r0.clamp(max=rmax), 0)
    rows_f = (L - r0 - K).clamp(0, rmax)
    n = g0.shape[0]
    nbytes = torch.unique(row).numel() * L + buf.numel() + 29 * n
    return band_bound(int(rows_f.sum()), int(rows_b.sum()), nbytes)


def resident_world(device, n=None, genome_len=400_000, n_reads=100_000):
    """Phase 2's world made resident as the rescore holds it: both
    orientations' read codes (DeviceExtender), the genome as the window
    buffer, and the device candgen's candidates over it.  With ``n``,
    random candidates (any row, any seed offset, anywhere in the genome)
    fill the batch up to n.  Returns the extend_fused arguments (int32
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
    args = (ext.codes, c.codes, i32(torch.zeros(m, device=device)),
            i32(torch.full((m,), genome_len, device=device)), i32(g0),
            i32(r0), i32(row))
    return args, ext.rmax, c.n_total


def fused_against_plain(device, args, rmax, reps):
    """The fused extension against its plain version: ok equal
    everywhere, errs and begin equal wherever ok (integers: the tolerance
    is exact); its times and bound."""
    from gaml_tpu_torch.ops import extend_cuda as kc

    want = kc.extend_fused_ref(*args, rmax)
    ok = want[0]
    got = kc.extend_fused(*args, rmax)
    sync(device)
    check(bool((got[0] == ok).all()), "fused: ok differs from its plain "
          "version")
    err = max(int((g[ok] - w[ok]).abs().max()) if ok.any() else 0
              for g, w in zip(got[1:], want[1:]))
    check(err == 0, f"fused: errs/begin differ from the plain version by "
          f"{err} where ok")
    res = {"n": int(ok.numel()), "ok": int(ok.sum()), "max_abs_err": err,
           "equal_everywhere": all(bool((g == w).all())
                                   for g, w in zip(got, want))}
    res["ms"] = timer(device, lambda: kc.extend_fused(*args, rmax), reps)
    res["plain_ms"] = timer(device, lambda: kc.extend_fused_ref(*args, rmax),
                            3)
    res.update(fused_bound(args, rmax))
    return res


def phase_kernels(device, n=131072, rmax=96, reps=20):
    """The fused extension against its plain version on a resident world
    of n candidates, timed beside the staged route it replaces on the
    same candidates (stage_views, K1, K2, the epilogue, and each of those
    alone).  Then each staged entry against its plain version on band
    inputs.  The outputs are integers, so the tolerance is exact
    equality: K1's cost everywhere, K2's cost everywhere and its offset
    wherever the exact cost is <= 6 (the contract of the TPU kernels)."""
    import torch

    from gaml_tpu_torch.ops import extend_cuda as kc
    from gaml_tpu_torch.ops.extend import stage_views
    from gaml_tpu_torch.ops.extend_device import extend_candidates

    fargs, frmax, n_cands = resident_world(device, n)
    fused = fused_against_plain(device, fargs, frmax, reps)
    fused["candgen_candidates"] = n_cands
    codes, buf, *meta = fargs
    i64 = [x.to(torch.int64) for x in meta]
    read_len = torch.full_like(i64[0], codes.shape[1])
    staged = extend_candidates(codes, read_len, buf, *i64, frmax)
    got = kc.extend_fused(*fargs, frmax)
    ok = got[0]
    check(bool((staged[0] == ok).all()) and all(
        bool((s[ok] == g[ok]).all()) for s, g in zip(staged[1:], got[1:])),
        "the staged route and the fused kernel differ where ok")
    fwd, bwd = stage_views(codes, read_len, buf, *i64, frmax)
    fused["staged_route_ms"] = timer(device, lambda: extend_candidates(
        codes, read_len, buf, *i64, frmax), reps)
    fused["stage_views_ms"] = timer(device, lambda: stage_views(
        codes, read_len, buf, *i64, frmax), reps)
    fused["staged_k1_ms"] = timer(device, lambda: kc.swar_cost(*fwd), reps)
    fused["staged_k2_ms"] = timer(device, lambda: kc.swar_cost_accept(*bwd),
                                  reps)
    print(f"  fused n={n} L={codes.shape[1]}: " + json.dumps(fused),
          flush=True)

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
    out = {"extend_fused": fused}
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


def phase_rescore(device, genome_len, n_reads, reps=10, launches=None):
    """Candgen and rescore on ``device`` against the native query and the
    port's CPU engine; score tolerance 2e-6 relative (float32 sums taken
    in another order).  Then the stage split and the fused kernel against
    its plain version on the rescore's own candidates."""
    import torch

    from gaml_tpu_torch.native import query_windows_batch
    from gaml_tpu_torch.ops import extend_cuda
    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

    t0 = time.perf_counter()
    genome, reads = make_world(genome_len, n_reads)
    bundle = make_bundle(reads)
    t_world = time.perf_counter() - t0
    want = query_windows_batch(bundle, [genome])[0]
    got = DeviceCandGen(bundle, device).query_host([genome])[0]
    for name, a, b in zip(("rid", "g0", "r0", "orient"), got, want):
        check(np.array_equal(a, b), f"candgen {name} differs from native")
    cap = len(want[0])
    args = dict(log_match=float(np.log(MATCH)),
                log_mismatch=float(np.log(MISMATCH)), total_len=genome_len,
                min_prob_per_base=MPB, min_prob_start=MPS)
    ref = DeviceRescorer(bundle, device="cpu").rescore([genome], cap, **args)
    dev = DeviceRescorer(bundle, device=device)
    if launches is not None:
        for k in extend_cuda.LAUNCHES:
            extend_cuda.LAUNCHES[k] = 0
    score, zeros, n_tot = dev.rescore([genome], cap, **args)
    if launches is not None:
        launches.update(extend_cuda.LAUNCHES)
        check(device.type != "cuda" or (
            launches["extend_fused"] == 1 and launches["swar_cost"] ==
            launches["swar_cost_accept"] == 0),
            f"the rescore did not make one fused launch: {launches}")
    ms = timer(device, lambda: dev.rescore([genome], cap, **args), reps,
               host_clock=True)

    # the stage split: candgen (ending in its count's synchronisation),
    # the extension (CUDA events) and dedup + reduction (ending in the
    # score's); then the fused kernel on these candidates
    def candgen():
        out = dev.gen.query([genome], cap)
        sync(device)
        return out

    c = candgen()
    ext = dev._extend(c)
    split = {"candgen_ms": timer(device, candgen, reps, host_clock=True),
             "extend_ms": timer(device, lambda: dev._extend(c), reps),
             "dedup_reduce_ms": timer(device, lambda: dev.score(
                 c, ext, **args), reps, host_clock=True)}
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    fargs = (dev.ext.codes, c.codes, i32(c.seg_base[c.seg]),
             i32(c.seg_len[c.seg]), i32(c.g0), i32(c.r0),
             i32(dev.gen.row_of[c.rid] + c.orient * dev.ext.n_rows))
    fused = fused_against_plain(device, fargs, dev.ext.rmax, reps)
    check(n_tot == ref[2] == cap, f"n_total {n_tot} vs cpu {ref[2]} "
          f"vs native {cap}")
    check(zeros == ref[1], f"zero_reads {zeros} vs cpu {ref[1]}")
    rel = abs(score - ref[0]) / abs(ref[0])
    check(np.isfinite(score) and rel <= 2e-6,
          f"score {score} vs cpu {ref[0]} (rel {rel:.3g})")
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
    print("  fused on these candidates: " + json.dumps(fused), flush=True)
    return res


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
    native host route (reported), on the world in ``d``; outputs and caches are named
    <tag>dev, <tag>bfs, <tag>cpu.  Every kernel named in ``launched``
    must have been launched by the ``device`` run."""
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
    summary = json.loads(dev_out.strip().splitlines()[-1]
                         .split("device work: ", 1)[1])
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
           "best_prob": best, "batches": summary["batches"],
           "candidates": summary["candidates"],
           "launches": summary["launches"],
           "vs_bfs_trace": "identical" if diff is None else
           f"first difference at line {diff[0]}",
           "vs_bfs_files": files}
    return res, diff


def phase_anneal(device, d, world, iterations=1000, check_iterations=200,
                 timeout=450):
    """The anneal on the aureus world written to ``d`` (``world``: its
    genome length, node count and seconds to write)."""
    res, diff = anneal_against_cpu_and_bfs(
        device, d, iterations, check_iterations, timeout, ("extend_fused",))
    res = dict(zip(("genome", "nodes", "world_s"), world), **res)
    print("  " + json.dumps(res), flush=True)
    if diff is not None:
        print(f"  {device}: {diff[1]}\n  bfs:  {diff[2]}", flush=True)
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


def phase_pacbio_anneal(device, d, genome, iterations=400, timeout=600):
    """The port's CLI on ``device`` (in this process, under the profiler)
    against the port's CLI on the native host route, both from the same
    world and config seed: best score within 0.05, k-mer recall within
    0.005, junk no higher than native + 0.001, NG50 ratio in
    [0.95, 1.06] (tests/test_pacbio.py::test_f32_route_anneal_quality_
    bound, PARITY.md)."""
    import contextlib
    import io

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from asm_quality import assembly_quality
    from gaml_tpu_torch.core import dna
    from gaml_tpu_torch import cli
    from gaml_tpu_torch.ops import forward_cuda

    truth = dna.decode_seq(genome)
    env = dict(os.environ, GAML_PB_DEVICE_MIN_CELLS=str(NATIVE))
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gaml_tpu_torch.cli",
         write_pacbio_config(d, "nat", iterations), "--device", "cpu"],
        cwd=d, env=env, capture_output=True, text=True, timeout=timeout)
    nat_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the native route exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    nat_tr = trace(proc.stdout)

    cfg = write_pacbio_config(d, "dev", iterations)
    buf = io.StringIO()
    forward_cuda.LAUNCHES["banded_forward"] = 0
    acts = [torch.profiler.ProfilerActivity.CUDA
            if device.type == "cuda" else torch.profiler.ProfilerActivity.CPU]
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with torch.profiler.profile(activities=acts) as prof, \
                contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            rc = cli.main([cfg, "--device", str(device)])
            sync(device)
            dev_wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = forward_cuda.LAUNCHES["banded_forward"]
    out = buf.getvalue()
    check(rc == 0, f"gaml_tpu_torch.cli exited {rc}")
    dev_tr = trace(out)
    summary = json.loads(out.strip().splitlines()[-1]
                         .split("device work: ", 1)[1])
    check(len(dev_tr) >= iterations and len(nat_tr) >= iterations,
          f"short traces: {len(dev_tr)} / {len(nat_tr)} itnum lines")
    check(summary["launches"]["banded_forward"] == launches and
          (device.type != "cuda" or launches > 0),
          f"K5 was not launched by the anneal: {summary}")
    check(summary["pacbio_cells"].get(route(device), 0) > 0,
          f"no forward-DP cell on {device}: {summary}")
    best_dev, best_nat = float(dev_tr[-1].split()[9]), \
        float(nat_tr[-1].split()[9])
    q_dev = assembly_quality(truth, os.path.join(d, "dev.fasta"))
    q_nat = assembly_quality(truth, os.path.join(d, "nat.fasta"))
    check(abs(best_dev - best_nat) < 0.05,
          f"best prob {best_dev} vs native {best_nat}")
    check(abs(q_dev["kmer_recall"] - q_nat["kmer_recall"]) <= 0.005,
          f"k-mer recall {q_dev} vs native {q_nat}")
    check(q_dev["kmer_junk"] <= q_nat["kmer_junk"] + 0.001,
          f"k-mer junk {q_dev} vs native {q_nat}")
    check(q_nat["ng50"] == 0 or 0.95 <= q_dev["ng50"] / q_nat["ng50"] <= 1.06,
          f"NG50 {q_dev} vs native {q_nat}")
    busy = device_busy_ms(prof)
    diff = first_difference(dev_tr, nat_tr)
    res = {"iterations": iterations, "dev_wall_s": dev_wall,
           "nat_wall_s": nat_wall, "dev_moves_per_s": iterations / dev_wall,
           "nat_moves_per_s": iterations / nat_wall,
           "best_prob": best_dev, "nat_best_prob": best_nat,
           "quality": q_dev, "nat_quality": q_nat,
           "pacbio_cells": summary["pacbio_cells"], "launches": launches,
           "device_busy_ms": busy,
           "device_busy_share": None if busy is None
           else busy / 1e3 / dev_wall,
           "vs_native_trace": "identical" if diff is None else
           f"first difference at line {diff[0]}"}
    print("  " + json.dumps(res), flush=True)
    return res


# ------------------------------------------------------------------ phase 8
def reset_launches():
    from gaml_tpu_torch.ops import extend_cuda

    for k in extend_cuda.LAUNCHES:
        extend_cuda.LAUNCHES[k] = 0
    return extend_cuda.LAUNCHES


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


def phase_exact(device, n=131072, rmax=96, rescore_world=(400_000, 100_000),
                reps=20):
    """The exact kernel at phase 1's inputs (one launch, K3's shape) and
    stacked with a second draw (2n, the two-direction launch of K4b's
    static path); the K6 tool, also held against the plain version; and
    the phase-2 rescore on the K3 route (GAML_SWAR_BACKWARD=0), whose
    score and zero_reads must equal the default route's."""
    import torch

    from gaml_tpu_torch.ops import extend_cuda as kc
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer
    from gaml_tpu_torch.tools import swar_kernel_proto

    args = band_inputs(0, n, rmax, device)
    stacked = tuple(torch.cat([x, y], dim=-1).contiguous() for x, y in
                    zip(args, band_inputs(1, n, rmax, device)))
    out = {"K3": exact_against_plain(device, args, reps),
           "K4b": exact_against_plain(device, stacked, reps)}
    check(out["K3"]["above_saturation"] > n // 8,
          f"too few costs above K1/K2's saturation: {out['K3']}")

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

    genome, reads = make_world(*rescore_world)
    dev = DeviceRescorer(make_bundle(reads), device=device)
    kw = dict(log_match=float(np.log(MATCH)),
              log_mismatch=float(np.log(MISMATCH)),
              total_len=len(genome), min_prob_per_base=MPB,
              min_prob_start=MPS)
    cap = len(genome)
    default = dev.rescore([genome], cap, **kw)
    default_ms = timer(device, lambda: dev.rescore([genome], cap, **kw),
                       reps // 2, host_clock=True)
    os.environ["GAML_SWAR_BACKWARD"] = "0"
    try:
        launches = reset_launches()
        k3 = dev.rescore([genome], cap, **kw)
        out["K3"]["launches"] = launches["dp_rows_exact"]
        check(launches["swar_cost_accept"] == launches["extend_fused"] == 0
              and (device.type != "cuda" or (launches["dp_rows_exact"] > 0
                                             and launches["swar_cost"] > 0)),
              f"the K3 route did not run K1 + dp_rows_exact: {launches}")
        k3_ms = timer(device, lambda: dev.rescore([genome], cap, **kw),
                      reps // 2, host_clock=True)
    finally:
        del os.environ["GAML_SWAR_BACKWARD"]
    check(k3[:2] == default[:2] and np.isfinite(k3[0]),
          f"K3 route (score, zero_reads, n) {k3} vs default {default}")
    out["rescore"] = {"candidates": k3[2], "score": k3[0],
                      "zero_reads": k3[1], "k3_route_ms": k3_ms,
                      "default_ms": default_ms}
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


def phase_models(device, d, world=(2_800_000, 300_000), reps=5):
    """SingleEndModel on ``device`` over host candidates of phase 3's
    world, against the model on the CPU and DeviceRescorer.rescore on the
    same window (score rel 2e-6, zero_reads equal); PairedEndModel on the
    frag library of the world in ``d`` over the start walks, against the
    float64 host paired scorer (rel 1e-5, zero_reads equal)."""
    import torch

    from gaml_tpu_torch.cli import starting_paths_from_config
    from gaml_tpu_torch.core.io import load_lastgraph
    from gaml_tpu_torch.optimize.settings import AssemblySettings
    from gaml_tpu_torch.scoring.paired import calc_score_for_paths_paired
    from gaml_tpu_torch.scoring.readset import ReadSet
    from gaml_tpu_torch.models import PairedEndModel, SingleEndModel
    from gaml_tpu_torch.ops.extend import stage_candidates
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

    genome_len, n_reads = world
    genome, reads = make_world(genome_len, n_reads)
    bundle = make_bundle(reads)
    t0 = time.perf_counter()
    cands = host_candidates(bundle, reads, genome)
    t_cands = time.perf_counter() - t0
    lens = [READ_LEN] * n_reads
    model = SingleEndModel(MATCH, MISMATCH, MPB, MPS, device=device)
    launches = reset_launches()
    score, zeros, _ = model.score_candidates(genome, cands, n_reads, lens,
                                             genome_len)
    model_launches = launches["dp_rows_exact"]
    check(device.type != "cuda" or model_launches > 0,
          f"the model did not launch dp_rows_exact: {launches}")
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
    st = stage_candidates(
        genome, [c.genome_pos for c, _ in cands],
        [c.read_pos for c, _ in cands], [r for _, r in cands],
        read_ids=[c.read_id for c, _ in cands], device=device)
    lens_t = torch.full((n_reads,), READ_LEN, dtype=torch.int32,
                        device=device)
    fwd_ms = timer(device, lambda: float(model(st, lens_t, genome_len,
                                               n_reads)[0]),
                   reps, host_clock=True)
    # the forward's stacked launch, alone, at this shape (K4a's entry)
    views = [torch.cat([st[f"{k}_f"].t(), st[f"{k}_b"].t()], dim=-1)
             .contiguous() for k in ("read", "gwin")]
    views += [torch.cat([st[f"{k}_f"], st[f"{k}_b"]]) for k in
              ("rlen", "glen")]
    k4a = exact_against_plain(device, views, reps)
    k4a["launches"] = model_launches
    single = {"genome": genome_len, "reads": n_reads,
              "candidates": len(cands), "host_candgen_s": t_cands,
              "score": score, "zero_reads": zeros,
              "rel_vs_cpu": abs(score - cpu[0]) / abs(cpu[0]),
              "rel_vs_rescore": abs(score - resc[0]) / abs(resc[0]),
              "forward_ms": fwd_ms, "launches": model_launches}
    print("  single " + json.dumps(single), flush=True)

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
    return {"single": single, "paired": paired, "K4a": k4a}


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


def phase_mixed_anneal(device, d, iterations=200, check_iterations=50,
                       timeout=450):
    """The phase-4 world with its frag library quality-trimmed: 20 % of
    each mate file's reads cut to 60-99 bp (own generator, seed 29).  The
    frag read sets get no native bundle, so their windows run through
    batch_extend_multi and the exact kernel; the advice library keeps the
    fused kernel.  --device cuda against --device cpu (equal traces over
    the cpu run), reported against --backend bfs."""
    rng = np.random.default_rng(29)
    trimmed = [trim_fastq(os.path.join(d, f"f{k}.fq"),
                          os.path.join(d, f"t{k}.fq"), rng) for k in (1, 2)]
    res, diff = anneal_against_cpu_and_bfs(
        device, d, iterations, check_iterations, timeout,
        ("extend_fused", "dp_rows_exact"), frag="t",
        tag="mixed_")
    res["trimmed_reads"] = trimmed
    print("  " + json.dumps(res), flush=True)
    if diff is not None:
        print(f"  {device}: {diff[1]}\n  bfs:  {diff[2]}", flush=True)
    return res


def kernels_line(card, kern, anneal, fwd, pb, exact, models, mixed):
    """{"kernels": [...]}: one entry per TPU kernel with the numbers of
    the phases that measured it.  Launches come from the runs of the main
    paths (counts reset just before each): K1/K2 (both served by the
    fused extension) phase 4's anneal, K3 the K3-route rescore of phase
    8, K4a/K4b the models of phase 9 plus phase 10's anneal (one kernel
    serves both), K5 phase 7, K6 its tool.  The K1/K2 entries carry the
    fused kernel's phase-1 numbers and, beside them, the staged route it
    replaced on the same candidates.  No PyTorch call computes a banded
    min-plus or log-space forward DP, so library_ms is null throughout.
    ``card`` gives each band kernel's registers, spills and DPX
    instruction count, and K5's registers, spills and MUFU count per
    width (phase 0).  K5's max_abs_err is against the float32 plain
    version; the float64 one, the twin's and the adversarial batch's
    stand beside it, the largest over both widths."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    fused = kern["extend_fused"]
    k1k2 = dict({k: fused[k] for k in keys},
                staged_route_ms=fused["staged_route_ms"],
                stage_views_ms=fused["stage_views_ms"],
                launches=anneal["launches"]["extend_fused"])
    k4 = mixed["launches"]["dp_rows_exact"] + models["K4a"]["launches"]
    kern = {"K1": dict(k1k2, staged_entry_ms=fused["staged_k1_ms"],
                       staged_entry_launches=anneal["launches"]["swar_cost"]),
            "K2": dict(k1k2, staged_entry_ms=fused["staged_k2_ms"],
                       staged_entry_launches=anneal["launches"][
                           "swar_cost_accept"]),
            "K3": exact["K3"],
            "K4a": dict(models["K4a"], launches=k4),
            "K4b": dict(exact["K4b"], launches=k4),
            "K6": exact["K6"]}
    kern["K5"] = {
        k: (fwd[64][k] if k != "max_abs_err" else
            max(fwd[64][k], fwd[128][k])) for k in keys}
    for tpu, entry in (("K1", "extend_fused"), ("K2", "extend_fused"),
                       ("K3", "dp_rows_exact"), ("K4a", "dp_rows_exact"),
                       ("K4b", "dp_rows_exact"), ("K6", "swar_cost")):
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
                      launches=pb["launches"])
    return {"kernels": [
        dict({k: kern[tpu][k] for k in keys}, name=name, tpu_kernel=tpu,
             route="cuda", source=source, replaces=replaces,
             launches=kern[tpu]["launches"], library_ms=None,
             **{k: v for k, v in kern[tpu].items()
                if k not in keys and k != "launches"})
        for tpu, name, source, replaces in KERNELS]}


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
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = run_phase("0 card", phase_card)
    kern = run_phase("1 kernels", phase_kernels, device)
    rescore_launches = {}
    run_phase("2 rescore 400 kb", phase_rescore, device, 400_000, 100_000,
              launches=rescore_launches)
    run_phase("3 rescore 2.8 Mb", phase_rescore, device, 2_800_000, 300_000)
    with tempfile.TemporaryDirectory(prefix="gaml_smoke_") as d_aureus:
        t0 = time.perf_counter()
        world = write_anneal_world(d_aureus)
        world += (time.perf_counter() - t0,)
        anneal = run_phase("4 anneal", phase_anneal, device, d_aureus, world)
        fwd = run_phase("5 K5", phase_forward_kernel, device)
        with tempfile.TemporaryDirectory(prefix="gaml_smoke_pb_") as d:
            genome = write_pacbio_world(d)
            run_phase("6 pacbio scoring", phase_pacbio_scoring, device, d)
            pb = run_phase("7 pacbio anneal", phase_pacbio_anneal, device,
                           d, genome)
        exact = run_phase("8 exact DP", phase_exact, device)
        models = run_phase("9 device models", phase_models, device,
                           d_aureus)
        mixed = run_phase("10 mixed-length anneal", phase_mixed_anneal,
                          device, d_aureus)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "gaml_tpu"))
    check(not foreign, f"modules of jax or the JAX package were imported: "
          f"{foreign}")
    print(json.dumps(kernels_line(card, kern, anneal, fwd, pb, exact, models,
                                  mixed)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

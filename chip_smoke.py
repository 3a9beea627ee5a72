#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from gaml_tpu_torch/csrc, then drives the port's
short-read rescore path and its long-read scoring path phase by phase,
each phase printing its results and seconds:

0. the card (nvidia-smi name and power limit), torch and CUDA versions,
   the kernel build;
1. kernels K1/K2 against their plain torch versions on the card at the
   main path's shape (131072 candidates, rmax 96), with timings;
2. candidate generation and the full rescore at bench.py's world (400 kb
   genome, 100k reads of 100 bp) against the native C++ query and the
   port's own CPU engine (which runs the plain versions), with warm
   timings;
3. the same at S. aureus scale (2.8 Mb, 300k reads of 100 bp);
4. an anneal through ``python -m gaml_tpu_torch.cli --device cuda`` on the
   2.8 Mb paired world of examples/aureus_like_run.py, held against a
   ``--device cpu`` run of the same config and reported against
   ``python -m gaml_tpu.cli --backend bfs``;
5. kernel K5 (the PacBio banded forward DP) against its plain torch
   version on the card at widths 64 and 128, at an S. aureus-sized batch
   (2.8 Mb walk buffer, 2048 jobs, reads up to 5 kb);
6. long-read scoring at the repo's pinned scale (the examples/pacbio_run.py
   world: 1 Mb, 500 reads of 3 kb, 10 % errors, seed 5): the port's read
   set against the native host route, and the native-vs-card crossover
   in DP cells;
7. a PacBio anneal through the port's CLI (``--device cuda``, in this
   process, under the profiler) against ``python -m gaml_tpu.cli`` on the
   native host route, held to the assembly-level bound of
   tests/test_pacbio.py::test_f32_route_anneal_quality_bound;
8. the exact band DP (dp_rows_exact, the counterpart of K3/K4a/K4b)
   against its plain version at phase 1's inputs, one launch and the
   stacked two-direction launch; the K6 tool
   (gaml_tpu_torch.tools.swar_kernel_proto); and the phase-2 rescore on
   the K3 route (GAML_SWAR_BACKWARD=0) against the default route;
9. the device likelihood models at S. aureus scale: SingleEndModel on
   phase 3's world (host candidates) against the model on the CPU and
   DeviceRescorer.rescore, and PairedEndModel on the phase-4 world's
   frag library against the host paired scorer over the start walks;
10. a mixed-length anneal: phase 4's world with 20 % of each frag mate
   file's reads quality-trimmed (no native bundle, so its windows run
   through the exact kernel while the advice library stays on K1/K2),
   ``--device cuda`` against ``--device cpu``, reported against
   ``gaml_tpu.cli --backend bfs``.

Any failed check raises and exits non-zero.  The last two lines are a
JSON object describing each kernel and {"ok": true, "device": {...}}.
Without a CUDA device, or without the repository beside it, the script
exits non-zero before any phase.
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
    ("K1", "swar_cost", BAND_DP, "gaml_tpu/ops/extend_pallas.py:467"),
    ("K2", "swar_cost_accept", BAND_DP, "gaml_tpu/ops/extend_pallas.py:600"),
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
def phase_card():
    import torch

    from gaml_tpu_torch.native import load_native
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
    check(load_native() is not None, "the native C++ library did not build")
    build.load()
    print(f"kernel build {build.build_info['seconds']:.2f} s -> "
          f"{os.path.relpath(build.build_info['path'], ROOT)}", flush=True)
    for line in build.build_info["log"].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("  ptxas: " + line.split(":", 1)[-1].strip(), flush=True)
    return smi


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


def phase_kernels(device, n=131072, rmax=96, reps=20):
    """Each kernel against its plain version on the same inputs.  The
    outputs are integers, so the tolerance is exact equality: K1's cost
    everywhere, K2's cost everywhere and its offset wherever the exact
    cost is <= 6 (the contract of the TPU kernels)."""
    from gaml_tpu_torch.ops import extend_cuda as kc

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
    out = {}
    for name, err in (("swar_cost", err1), ("swar_cost_accept", err2)):
        out[name] = {
            "max_abs_err": err,
            "ms": timer(device, lambda: getattr(kc, name)(*args), reps),
            "plain_ms": timer(device, lambda: getattr(kc, name + "_ref")(
                *args), 3)}
    print(f"  n={n} rmax={rmax}: " + ", ".join(
        f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f} ms)"
        for k, v in out.items()), flush=True)
    return out


# -------------------------------------------------------------- phases 2-3
def make_world(genome_len, n_reads, read_len=READ_LEN, err_rate=0.01,
               seed=7):
    """bench.py's world: a random genome and reads sampled from it with
    substitution errors, half of them reverse-complemented."""
    from gaml_tpu.core import dna

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
    from gaml_tpu.core.dna import _COMP_LUT
    from gaml_tpu.index.maxhash import K_INDEX_KMER
    from gaml_tpu.native import NativeAlignBundle, read_index_build

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
    from gaml_tpu.native import align_window

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
    in another order)."""
    import torch

    from gaml_tpu.native import query_windows_batch
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
    ms = timer(device, lambda: dev.rescore([genome], cap, **args), reps,
               host_clock=True)
    if launches is not None:
        launches.update(extend_cuda.LAUNCHES)
        check(device.type != "cuda" or all(
            launches[k] > 0 for k in ("swar_cost", "swar_cost_accept")),
            f"a kernel was not launched by the rescore: {launches}")
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
           "world_s": t_world}
    if device.type == "cuda":
        res["peak_mem_mb"] = torch.cuda.max_memory_allocated() / 2**20
    print("  " + json.dumps(res), flush=True)
    return res


# ------------------------------------------------------------------ phase 4
def write_anneal_world(d, genome_mb=2.8, n_frag=150_000, n_adv=30_000):
    """examples/aureus_like_run.py's world (seed 13) as LastGraph + FASTQ:
    long nodes 1200-6000 bp alternating with 60-300 bp ones in a chain,
    90 bp side branches, a frag library 180+-20 and an advice library
    3700+-350 of 100 bp innie pairs with 0.5 % substitutions."""
    from gaml_tpu.core import dna

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
    the cpu run's iterations) and against gaml_tpu.cli --backend bfs
    (reported), on the world in ``d``; outputs and caches are named
    <tag>dev, <tag>bfs, <tag>cpu.  Every kernel named in ``launched``
    must have been launched by the ``device`` run."""
    dev, bfs, cpu = (tag + x for x in ("dev", "bfs", "cpu"))
    dev_out, dev_wall = run_cli(
        "gaml_tpu_torch.cli", write_config(d, dev, iterations, frag),
        ["--device", str(device)], timeout)
    bfs_out, bfs_wall = run_cli(
        "gaml_tpu.cli", write_config(d, bfs, iterations, frag),
        ["--backend", "bfs"], timeout)
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
        device, d, iterations, check_iterations, timeout,
        ("swar_cost", "swar_cost_accept"))
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


def forward_inputs(seed, device, n_jobs=2048, rmax=5120,
                   seq_len=2_800_000, err=0.1):
    """K5 inputs of an S. aureus-sized long-read batch: a random walk
    buffer; each job's read follows its guide path (steps from
    {0,1,1,1,2}) with 10 % substitutions; ragged read lengths up to rmax;
    random targets, some of which end inside the read's span."""
    import torch

    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, seq_len).astype(np.uint8)
    rlen = rng.integers(rmax // 8, rmax + 1, n_jobs).astype(np.int32)
    steps = rng.choice(np.array([0, 1, 1, 1, 2], np.uint8), (n_jobs, rmax))
    c0 = rng.integers(256, seq_len - 2 * rmax - 256, n_jobs)
    pos = c0[:, None] + np.cumsum(steps, axis=1, dtype=np.int64)
    reads = seq[pos - 1]
    sub = rng.random(reads.shape) < err
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    gstart = c0 - rng.integers(0, 300, n_jobs)
    span = pos[np.arange(n_jobs), rlen - 1] - gstart
    glen = (span * rng.uniform(0.7, 1.3, n_jobs)).astype(np.int64)
    t = lambda x, dt: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, dtype=dt)).to(device)
    return (t(reads, np.uint8), torch.arange(n_jobs, dtype=torch.int32,
                                             device=device),
            t(seq, np.uint8), t(steps, np.uint8), t(c0, np.int32),
            t(gstart, np.int32), t(glen, np.int32), t(rlen, np.int32))


def phase_forward_kernel(device, reps=10, **shape):
    """K5 against its plain version at both band widths.  Both are
    float32 with different exp/log1p implementations and a different
    order of the gap-chain scan, so the tolerance per job is
    |kernel - plain| <= 1e-4 |plain| + 1e-3."""
    import torch

    from gaml_tpu_torch.ops import build, forward_cuda as fc

    args = forward_inputs(0, device, **shape)
    lm, lmm = float(np.log(PB_MATCH)), float(np.log(PB_MISMATCH))
    cells_per_lane = int(args[7].sum())
    out = {}
    for width in (64, 128):
        got = fc.banded_forward(*args, lm, lmm, width)
        sync(device)
        t0 = time.perf_counter()
        want = fc.banded_forward_ref(*args, lm, lmm, width)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = (got - want).abs()
        bad = int((diff > 1e-4 * want.abs() + 1e-3).sum())
        check(bool(torch.isfinite(got).all()), f"K5 W={width}: non-finite")
        check(bad == 0, f"K5 W={width}: {bad} jobs outside the tolerance "
              f"(max abs err {float(diff.max()):.3g})")
        ms = timer(device, lambda: fc.banded_forward(*args, lm, lmm, width),
                   reps)
        out[width] = {
            "max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.abs()).max()),
            "ms": ms, "plain_ms": plain_ms,
            "cells_per_s": cells_per_lane * width / (ms / 1e3),
            "ptxas": ptxas_usage(build.build_info["log"],
                                 f"banded_forward_kernelILi{width}E")}
        print(f"  W={width} jobs={len(args[7])} rmax={args[3].shape[1]} "
              f"cells={cells_per_lane * width}: " + json.dumps(out[width]),
              flush=True)
    return out


# -------------------------------------------------------------- phases 6-7
def write_pacbio_world(d, genome_kb=1000, n_reads=500, read_len=3000):
    """examples/pacbio_run.py's world (seed 5) as LastGraph + FASTQ: a
    chain of long nodes (2-8 kb) alternating with short ones (80-400 bp),
    and long reads with 10 % errors (4 % substitutions, 3 % insertions,
    3 % deletions), half of them reverse-complemented.  Returns the truth
    genome's codes."""
    from gaml_tpu.core import dna

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


def pacbio_readsets(d, graph):
    """A native-route PacbioReadSet and a copy adopted into the port
    (same reads and anchors, separate alignment caches)."""
    from gaml_tpu.scoring.pacbio import PacbioReadSet

    sets = []
    for name in ("nat", "dev"):
        rs = PacbioReadSet(os.path.join(d, f"pb_{name}"),
                           os.path.join(d, "pb.fq"), PB_MATCH, PB_MISMATCH)
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
    from gaml_tpu.core.io import load_lastgraph
    from gaml_tpu_torch.scoring.pacbio import adopt_pacbio_readset

    t0 = time.perf_counter()
    graph = load_lastgraph(os.path.join(d, "LastGraph"))
    nat, dev = pacbio_readsets(d, graph)
    t_setup = time.perf_counter() - t0
    walks = [[i] for i in range(0, graph.num_nodes, 2)
             if graph.node_len(i) > 500]
    adopt_pacbio_readset(dev, device)
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
    against gaml_tpu.cli on the native host route, both from the same
    world and config seed: best score within 0.05, k-mer recall within
    0.005, junk no higher than native + 0.001, NG50 ratio in
    [0.95, 1.06] (tests/test_pacbio.py::test_f32_route_anneal_quality_
    bound, PARITY.md)."""
    import contextlib
    import io

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from asm_quality import assembly_quality
    from gaml_tpu.core import dna
    from gaml_tpu_torch import cli
    from gaml_tpu_torch.ops import forward_cuda

    truth = dna.decode_seq(genome)
    env = dict(os.environ, GAML_PB_DEVICE_MIN_CELLS=str(NATIVE))
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gaml_tpu.cli",
         write_pacbio_config(d, "nat", iterations)],
        cwd=d, env=env, capture_output=True, text=True, timeout=timeout)
    nat_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"gaml_tpu.cli exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
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
                              3)}


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
                 "launches": k6_launches, "exact_ms": k6["exact_ms"]}
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
        check(launches["swar_cost_accept"] == 0 and
              (device.type != "cuda" or (launches["dp_rows_exact"] > 0 and
                                         launches["swar_cost"] > 0)),
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
    from gaml_tpu.align.aligner import _ReadCache, gen_candidates
    from gaml_tpu.index.maxhash import K_INDEX_KMER, ReadIndexMaxHash
    from gaml_tpu.native import read_index_build

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

    from gaml_tpu.cli import starting_paths_from_config
    from gaml_tpu.core.io import load_lastgraph
    from gaml_tpu.optimize.settings import AssemblySettings
    from gaml_tpu.scoring.paired import calc_score_for_paths_paired
    from gaml_tpu.scoring.readset import ReadSet
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
    cpu = SingleEndModel(MATCH, MISMATCH, MPB, MPS).score_candidates(
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
    batch_extend_multi and the exact kernel; the advice library keeps K1/
    K2.  --device cuda against --device cpu (equal traces over the cpu
    run), reported against gaml_tpu.cli --backend bfs."""
    rng = np.random.default_rng(29)
    trimmed = [trim_fastq(os.path.join(d, f"f{k}.fq"),
                          os.path.join(d, f"t{k}.fq"), rng) for k in (1, 2)]
    res, diff = anneal_against_cpu_and_bfs(
        device, d, iterations, check_iterations, timeout,
        ("swar_cost", "swar_cost_accept", "dp_rows_exact"), frag="t",
        tag="mixed_")
    res["trimmed_reads"] = trimmed
    print("  " + json.dumps(res), flush=True)
    if diff is not None:
        print(f"  {device}: {diff[1]}\n  bfs:  {diff[2]}", flush=True)
    return res


def kernels_line(kern, anneal, fwd, pb, exact, models, mixed):
    """{"kernels": [...]}: one entry per TPU kernel with the numbers of
    the phases that measured it.  Launches come from the runs of the main
    paths (counts reset just before each): K1/K2 phase 4's anneal, K3 the
    K3-route rescore of phase 8, K4a/K4b the models of phase 9 plus phase
    10's anneal (one kernel serves both), K5 phase 7, K6 its tool."""
    k4 = mixed["launches"]["dp_rows_exact"] + models["K4a"]["launches"]
    kern = {"K1": dict(kern["swar_cost"],
                       launches=anneal["launches"]["swar_cost"]),
            "K2": dict(kern["swar_cost_accept"],
                       launches=anneal["launches"]["swar_cost_accept"]),
            "K3": exact["K3"],
            "K4a": dict(models["K4a"], launches=k4),
            "K4b": dict(exact["K4b"], launches=k4),
            "K6": exact["K6"]}
    kern["K5"] = {
        k: (fwd[64][k] if k != "max_abs_err" else
            max(fwd[64][k], fwd[128][k]))
        for k in ("max_abs_err", "ms", "plain_ms")}
    kern["K5"].update(width=64, ms_w128=fwd[128]["ms"],
                      plain_ms_w128=fwd[128]["plain_ms"],
                      launches=pb["launches"])
    return {"kernels": [
        dict(name=name, tpu_kernel=tpu, route="cuda", source=source,
             replaces=replaces, **kern[tpu])
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
    run_phase("0 card", phase_card)
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
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps(kernels_line(kern, anneal, fwd, pb, exact, models,
                                  mixed)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from gaml_tpu_torch/csrc, then drives the port's
short-read rescore path phase by phase, each phase printing one line with
its result and seconds:

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
   ``python -m gaml_tpu.cli --backend bfs``.

Any failed check raises and exits non-zero.  The last two lines are a
JSON object describing each kernel and {"ok": true, "device": {...}}.
Without a CUDA device, or without the repository beside it, the script
exits non-zero before any phase.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MATCH, MISMATCH = 0.96, 0.01
MPB, MPS = -0.7, -10.0
READ_LEN = 100
KERNELS = {
    "swar_cost": "gaml_tpu/ops/extend_pallas.py:467",
    "swar_cost_accept": "gaml_tpu/ops/extend_pallas.py:600",
}
SOURCE = "gaml_tpu_torch/csrc/band_dp.cu"


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

    from gaml_tpu.native import get_lib
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
        check(device.type != "cuda" or all(v > 0 for v in launches.values()),
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


def write_config(d, name, iterations):
    cfg = os.path.join(d, f"{name}.cfg")
    libs = (("frag", "f", 180, 20, 0.00007, 30, False),
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


def phase_anneal(device, iterations=1000, check_iterations=200,
                 world=None, timeout=450):
    """The port's CLI on ``device`` against --device cpu (must agree) and
    against gaml_tpu.cli --backend bfs (reported)."""
    with tempfile.TemporaryDirectory(prefix="gaml_smoke_") as d:
        t0 = time.perf_counter()
        g_len, n_nodes = write_anneal_world(d, **(world or {}))
        t_world = time.perf_counter() - t0
        dev_out, dev_wall = run_cli(
            "gaml_tpu_torch.cli", write_config(d, "dev", iterations),
            ["--device", str(device)], timeout)
        bfs_out, bfs_wall = run_cli(
            "gaml_tpu.cli", write_config(d, "bfs", iterations),
            ["--backend", "bfs"], timeout)
        cpu_out, cpu_wall = run_cli(
            "gaml_tpu_torch.cli", write_config(d, "cpu", check_iterations),
            ["--device", "cpu"], timeout)
        dev_tr, bfs_tr, cpu_tr = trace(dev_out), trace(bfs_out), \
            trace(cpu_out)
        summary = json.loads(dev_out.strip().splitlines()[-1]
                             .split("device work: ", 1)[1])
        check(len(dev_tr) >= iterations and len(cpu_tr) >= check_iterations,
              f"short traces: {len(dev_tr)} / {len(cpu_tr)} itnum lines")
        check(dev_tr[:len(cpu_tr)] == cpu_tr,
              f"{device} and cpu traces differ: "
              f"{first_difference(dev_tr, cpu_tr)}")
        check(summary["batches"] > 0 and summary["candidates"] > 0,
              f"no window batch reached the device: {summary}")
        check(device.type != "cuda" or
              all(v > 0 for v in summary["launches"].values()),
              f"a kernel was not launched by the anneal: {summary}")
        best = float(dev_tr[-1].split()[9])
        check(np.isfinite(best), f"best prob {best}")
        files = {}
        for ext in ("walks", "fasta"):
            with open(os.path.join(d, f"dev.{ext}"), "rb") as f:
                a = f.read()
            with open(os.path.join(d, f"bfs.{ext}"), "rb") as f:
                b = f.read()
            check(len(a) > 0, f"empty dev.{ext}")
            files[ext] = "identical" if a == b else "differ"
        diff = first_difference(dev_tr, bfs_tr)
    res = {"genome": g_len, "nodes": n_nodes, "iterations": iterations,
           "dev_wall_s": dev_wall, "bfs_wall_s": bfs_wall,
           "cpu_wall_s": cpu_wall, "cpu_iterations": check_iterations,
           "world_s": t_world, "best_prob": best,
           "batches": summary["batches"],
           "candidates": summary["candidates"],
           "launches": summary["launches"],
           "vs_bfs_trace": "identical" if diff is None else
           f"first difference at line {diff[0]}",
           "vs_bfs_files": files}
    print("  " + json.dumps(res), flush=True)
    if diff is not None:
        print(f"  {device}: {diff[1]}\n  bfs:  {diff[2]}", flush=True)
    return res


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
    anneal = run_phase("4 anneal", phase_anneal, device)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
             launches=anneal["launches"][name], **kern[name])
        for name, replaces in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

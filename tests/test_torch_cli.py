"""The port's CLI (gaml_tpu_torch.cli) end to end on the CPU: the same
anneal trace and output files as gaml_tpu.cli on both backends (device
and bfs), and no jax anywhere in the port's process."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import lastgraph_text, random_seq, write_fastq
from test_scoring import make_pairs
from test_torch_kernels import port_native_lib


@pytest.fixture(autouse=True)
def native_library():
    if port_native_lib() is None:
        pytest.skip("native library unavailable")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def with_errors(rng, reads, rate):
    out = []
    for r in reads:
        r = list(r)
        for i in np.nonzero(rng.random(len(r)) < rate)[0].tolist():
            r[i] = "ACGT"[("ACGT".index(r[i]) + int(rng.integers(1, 4))) % 4]
        out.append("".join(r))
    return out


def write_world(tmp_path, iterations=25, trimmed=False):
    """The test_config_cli end-to-end world with 2 % substitution errors;
    returns a function making a config whose outputs and caches live
    under their own prefix.  ``trimmed`` cuts 20 % of each mate file's
    reads at the 3' end to 20-29 bp (a quality-trimmed library: mixed
    read lengths, so no native bundle)."""
    rng = np.random.default_rng(0)
    node_seqs = [random_seq(rng, 600), random_seq(rng, 80),
                 random_seq(rng, 700)]
    (tmp_path / "LastGraph").write_text(
        lastgraph_text(node_seqs, [(1, 2), (2, 3)]))
    m1, m2 = make_pairs(rng, "".join(node_seqs), 25, 30, 250, 25)
    m1, m2 = with_errors(rng, m1, 0.02), with_errors(rng, m2, 0.02)
    if trimmed:
        from test_torch_mixed import trim_reads

        m1, m2 = (trim_reads(m, seed, lo=20, hi=29)
                  for m, seed in ((m1, 1), (m2, 2)))
    write_fastq(str(tmp_path / "m1.fq"), m1)
    write_fastq(str(tmp_path / "m2.fq"), m2)

    def config(name):
        cfg = tmp_path / f"{name}.cfg"
        cfg.write_text(f"""graph={tmp_path}/LastGraph
max_iterations={iterations}
t0=0.01
output_prefix={tmp_path}/{name}
seed=3

[lib1]
type=paired
filename1={tmp_path}/m1.fq
filename2={tmp_path}/m2.fq
insert_mean=250
insert_std=25
cache_prefix={tmp_path}/{name}_lib1
""")
        return str(cfg)

    return config


def itnum_lines(text):
    """Anneal trace with the timestamp field stripped."""
    out = []
    for line in text.splitlines():
        if line.startswith("itnum"):
            f = line.split()
            del f[5]
            out.append(" ".join(f))
    return out


def port_against_jax(tmp_path, monkeypatch, capsys, trimmed):
    """The port's CLI (--device cpu) against gaml_tpu.cli --backend
    device: identical itnum traces and .walks/.fasta files.  Returns the
    port's device-work summary."""
    from gaml_tpu.cli import main as jax_main
    from gaml_tpu_torch.cli import main as port_main

    config = write_world(tmp_path, trimmed=trimmed)
    monkeypatch.setenv("GAML_DEV_MIN_BASES", "0")
    monkeypatch.setenv("GAML_DEV_EAGER", "1")
    monkeypatch.chdir(tmp_path)
    assert jax_main([config("jax"), "--backend", "device"]) == 0
    jax_out = capsys.readouterr().out
    assert port_main([config("port"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    trace = itnum_lines(port_out)
    assert len(trace) >= 25
    assert trace == itnum_lines(jax_out)
    summary = json.loads(port_out.splitlines()[-1].split(
        "device work: ", 1)[1])
    assert summary["batches"] > 0 and summary["candidates"] > 0
    for ext in ("walks", "fasta"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    return summary


def test_trace_and_outputs_match_jax_device_backend(tmp_path, monkeypatch,
                                                    capsys):
    port_against_jax(tmp_path, monkeypatch, capsys, trimmed=False)


@pytest.mark.parametrize("trimmed", [False, True])
def test_bfs_backend_matches_jax_bfs_backend(tmp_path, monkeypatch, capsys,
                                            trimmed):
    """--backend bfs is the port's own copy of the host route: the same
    itnum trace and .walks/.fasta as gaml_tpu.cli --backend bfs, on
    uniform and on quality-trimmed reads, with no window batch sent to
    the device."""
    from gaml_tpu.cli import main as jax_main
    from gaml_tpu_torch.cli import main as port_main

    config = write_world(tmp_path, trimmed=trimmed)
    monkeypatch.chdir(tmp_path)
    assert jax_main([config("jax"), "--backend", "bfs"]) == 0
    jax_out = capsys.readouterr().out
    assert port_main([config("port"), "--backend", "bfs",
                      "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    trace = itnum_lines(port_out)
    assert len(trace) >= 25
    assert trace == itnum_lines(jax_out)
    summary = json.loads(port_out.splitlines()[-1].split(
        "device work: ", 1)[1])
    assert summary["backend"] == "bfs" and summary["batches"] == 0
    for ext in ("walks", "fasta"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()


def test_mixed_length_trace_matches_jax_device_backend(tmp_path,
                                                       monkeypatch, capsys):
    """A quality-trimmed library (no native bundle): every window batch
    is one candgen query over the max-hash index's CSR (query_plain on
    the CPU) and one DeviceExtender.extend call on the read set's
    resident ragged codes (one launch of the exact extension), counted in
    the summary line; the host candidate pass never runs."""
    from gaml_tpu_torch.ops import extend_device
    from gaml_tpu_torch.utils.metrics import LAUNCHES

    calls = []
    real = extend_device.DeviceExtender.extend
    monkeypatch.setattr(extend_device.DeviceExtender, "extend",
                        lambda self, *a, **kw: calls.append(len(a[3]))
                        or real(self, *a, **kw))
    # the counts are the process's: earlier tests may have added to them
    before = {k: LAUNCHES[k] for k in ("query_plain", "gen_candidates")}
    summary = port_against_jax(tmp_path, monkeypatch, capsys, trimmed=True)
    assert summary["batches"] == len(calls) > 0
    assert summary["candidates"] == sum(calls)
    ran = {k: summary["launches"].get(k, 0) - v for k, v in before.items()}
    assert ran == {"query_plain": len(calls), "gen_candidates": 0}


def test_port_process_never_imports_jax(tmp_path):
    config = write_world(tmp_path, iterations=3)("nojax")
    code = (
        "import sys\n"
        "import gaml_tpu_torch\n"
        "import gaml_tpu_torch.ops.build, gaml_tpu_torch.ops.extend_cuda\n"
        "import gaml_tpu_torch.models, gaml_tpu_torch.ops.pair\n"
        "import gaml_tpu_torch.tools.swar_kernel_proto\n"
        "from gaml_tpu_torch.cli import main\n"
        f"rc = main([{config!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, GAML_DEV_MIN_BASES="0")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout
    assert '"batches": 0' not in proc.stdout  # the device path ran


def test_cli_refuses_missing_cuda_and_unported_options(tmp_path,
                                                       monkeypatch):
    from gaml_tpu_torch.cli import main as port_main

    config = write_world(tmp_path, iterations=1)("refuse")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main([config, "--device", "cuda"]) != 0
    assert port_main([config, "--device", "cuda", "--paired-device"]) != 0
    # --distributed is ported: without its process count and id it exits
    # 1, as gaml_tpu.cli does
    monkeypatch.delenv("GAML_NPROC", raising=False)
    monkeypatch.delenv("GAML_PROC_ID", raising=False)
    assert port_main([config, "--device", "cpu",
                      "--distributed", "localhost:1234"]) == 1


def write_pacbio_world(tmp_path, iterations=8):
    """A three-node chain and 16 long reads (8 % errors, both strands) as
    LastGraph + FASTQ, with a config of one pacbio advice library."""
    from gaml_tpu.core import dna

    from test_forward_kernel import noisy_copy

    rng = np.random.default_rng(2)
    node_seqs = [random_seq(rng, 900), random_seq(rng, 120),
                 random_seq(rng, 1200)]
    (tmp_path / "LastGraph").write_text(
        lastgraph_text(node_seqs, [(1, 2), (2, 3)]))
    genome = dna.encode_seq("".join(node_seqs))
    reads = []
    for _ in range(16):
        p = int(rng.integers(0, len(genome) - 400))
        r = noisy_copy(rng, genome[p:p + 400], err=0.08)
        reads.append(dna.decode_seq(dna.revcomp(r) if rng.random() < 0.5
                                    else r))
    write_fastq(str(tmp_path / "pb.fq"), reads, prefix="pb")
    cfg = tmp_path / "pb.cfg"
    cfg.write_text(f"""graph={tmp_path}/LastGraph
max_iterations={iterations}
output_prefix={tmp_path}/pbout
seed=3

[pb]
type=pacbio
filename={tmp_path}/pb.fq
mismatch_prob=0.0375
penalty_constant=0.0001
penalty_step=100
advice=1
cache_prefix={tmp_path}/pbcache
""")
    return str(cfg)


def test_pacbio_config_runs_on_port_without_jax(tmp_path):
    """A pacbio library on the port's CLI: its forward-DP batches reach
    the engine (the plain K5 on the CPU), jax never loads, and the
    summary line reports the seed kernels' counts from the one launch
    store (set here, since no card runs them)."""
    config = write_pacbio_world(tmp_path)
    code = (
        "import sys\n"
        "from gaml_tpu_torch.cli import main\n"
        "from gaml_tpu_torch.utils.metrics import LAUNCHES\n"
        "LAUNCHES['seeds_count'] += 7\n"
        f"rc = main([{config!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, GAML_PB_DEVICE_MIN_CELLS="0")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "NOJAX-OK"
    summary = json.loads(lines[-2].split("device work: ", 1)[1])
    assert summary["pacbio_cells"].get("torch", 0) > 0
    # no card: no launch
    assert summary["launches"].get("banded_forward", 0) == 0
    assert summary["launches"]["seeds_count"] == 7
    assert len(itnum_lines(proc.stdout)) >= 8
    assert (tmp_path / "pbout.fasta").stat().st_size > 0

"""The port's copies of the exact PacBio band model and the diagnostics
(gaml_tpu_torch/scoring/pacbio_exact.py, diagnostics/{exact_pacbio,
fake_blasr,testrep}.py) against gaml_tpu's, in the uses of
tests/test_pacbio.py and tests/test_assembly_import.py: the same outputs
on seeded inputs."""
import numpy as np
import pytest

from gaml_tpu.core import dna as jdna
from gaml_tpu.diagnostics import fake_blasr as jblasr
from gaml_tpu.diagnostics import testrep as jtestrep
from gaml_tpu.diagnostics.exact_pacbio import ExactPacbioReadSet as JExact
from gaml_tpu.scoring import pacbio_exact as jexact
from gaml_tpu.scoring.pacbio_score import calc_score_for_pacbio as jcalc
from gaml_tpu_torch.core import dna
from gaml_tpu_torch.diagnostics import fake_blasr, testrep
from gaml_tpu_torch.diagnostics.exact_pacbio import ExactPacbioReadSet
from gaml_tpu_torch.scoring import pacbio_exact
from gaml_tpu_torch.scoring.pacbio import PacbioReadSet
from gaml_tpu_torch.scoring.pacbio_score import calc_score_for_pacbio

from fixtures import make_linear_graph, random_seq, write_fastq
from test_forward_kernel import noisy_copy
from test_torch_kernels import port_linear_graph

PB_MATCH = 0.85


def long_reads(rng, genome, n_reads=10, rlen=400, err=0.08):
    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, max(1, len(genome) - rlen)))
        r = noisy_copy(rng, jdna.encode_seq(genome[p:p + rlen]), err=err)
        if rng.random() < 0.5:
            r = jdna.revcomp(r)
        reads.append(jdna.decode_seq(r))
    return reads


@pytest.fixture
def world(tmp_path):
    """tests/test_pacbio.py's band world: a 900-120-1200 chain (JAX graph
    and the port's), 10 reads of 400 bp at 8 % errors in pbe.fq."""
    rng = np.random.default_rng(11)
    jgr, seqs = make_linear_graph(rng, [900, 120, 1200])
    reads = long_reads(rng, "".join(seqs))
    write_fastq(str(tmp_path / "pbe.fq"), reads, prefix="pb")
    return jgr, port_linear_graph(seqs), seqs, reads


def test_exact_read_set_scores_equal_jax(tmp_path, world):
    """tests/test_pacbio.py::test_production_band_vs_exact_reference_band
    on the port: the exact read set's walk score, zero reads and length
    equal gaml_tpu's, and the production band stays within 2 % of it."""
    jgr, gr, _seqs, _reads = world
    fq = str(tmp_path / "pbe.fq")
    got, want = [], []
    for cls, graph, calc, out, name in (
            (ExactPacbioReadSet, gr, calc_score_for_pacbio, got, "p"),
            (JExact, jgr, jcalc, want, "j")):
        rs = cls(str(tmp_path / f"pbe_x{name}"), fq, PB_MATCH, 0.05)
        rs.preprocess_reads()
        rs.compute_anchors(graph, persist=False)
        out.append(calc(graph, [[0, 2, 4]], rs))
        out.append({k: sorted(v) for k, v in rs.anchors_cache.items()})
    assert got == want
    prod = PacbioReadSet(str(tmp_path / "pbe_prod"), fq, PB_MATCH, 0.05,
                         device="cpu")
    prod.preprocess_reads()
    prod.compute_anchors(gr, persist=False)
    sp, _zp, tlp = calc_score_for_pacbio(gr, [[0, 2, 4]], prod)
    assert tlp == got[0][2]
    assert sp == pytest.approx(got[0][0], rel=0.02)


def test_fake_blasr_and_band_model_equal_jax(world):
    """The shim's anchor and SAM lines, each SAM line parsed, and its
    alignment probability over the doubled target equal gaml_tpu's."""
    jgr, _gr, seqs, reads = world
    named = [(f"pb{i}", dna.encode_seq(r)) for i, r in enumerate(reads)]
    nodes = [(i, dna.encode_seq(s)) for i, s in zip((0, 2, 4), seqs)]
    assert fake_blasr.anchor_lines(named, nodes) == \
        jblasr.anchor_lines(named, nodes)
    target = dna.encode_seq("".join(seqs))
    lines = fake_blasr.sam_lines(named, target)
    assert lines and lines == jblasr.sam_lines(named, target)
    t = "".join(seqs)
    seqall = t + "\n" + dna.revcomp_str(t)
    lm, lmm = float(np.log(PB_MATCH)), float(np.log(0.05))
    for line in lines:
        a = pacbio_exact.parse_alignment_line(line, len(seqall))
        assert tuple(a) == tuple(jexact.parse_alignment_line(
            line, len(seqall)))
        read = reads[int(a.name.split("/")[0][2:])]
        assert pacbio_exact.aligment_probability(seqall, read, a, lm, lmm) \
            == jexact.aligment_probability(seqall, read, a, lm, lmm)


def test_fake_blasr_cli_equals_jax(tmp_path, world, capsys):
    """The shim's command line (anchors mode and -sam mode) prints what
    gaml_tpu's prints."""
    _jgr, _gr, seqs, _reads = world
    fq = str(tmp_path / "pbe.fq")
    nodes = tmp_path / "nodes.fa"
    nodes.write_text("".join(f">{i}\n{s}\n" for i, s in zip((0, 2, 4),
                                                            seqs)))
    walk = tmp_path / "walk.fa"
    walk.write_text(f">tmp\n{''.join(seqs)}\n")
    for argv in ([fq, str(nodes), "-bestn", "10"],
                 [fq, str(walk), "-sam", "-nproc", "1"]):
        outs = []
        for mod in (fake_blasr, jblasr):
            assert mod.main(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0].count("\n") > 1


def test_testrep_finds_the_same_duplicates(tmp_path, capsys):
    """tests/test_assembly_import.py::test_testrep_finds_duplicates on
    the port: the same report as gaml_tpu's, repeats found."""
    rng = np.random.default_rng(6)
    rep = random_seq(rng, 600)
    fa = tmp_path / "scf.fasta"
    fa.write_text(f">a\n{rep + random_seq(rng, 100) + rep}\n"
                  f">b\n{random_seq(rng, 300) + rep[:200]}\n")
    outs = []
    for mod in (testrep, jtestrep):
        assert mod.main([str(fa)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "repeat x" in outs[0]
    assert testrep.main([]) == 1
    assert testrep.find_repeats({"a": "ACGT" * 40}, 21) == \
        jtestrep.find_repeats({"a": "ACGT" * 40}, 21)


def test_parse_cigar_and_bands_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        ops = "".join(f"{int(rng.integers(1, 30))}{'MID'[int(rng.integers(3))]}"
                      for _ in range(int(rng.integers(1, 8))))
        cig = pacbio_exact.parse_cigar(ops)
        assert cig == jexact.parse_cigar(ops)
        flat = pacbio_exact.expand_cigar(cig)
        assert flat == jexact.expand_cigar(cig)
        assert pacbio_exact.get_cigar_ends(flat) == jexact.get_cigar_ends(flat)
        for band in (2, 7):
            assert pacbio_exact.band_cells(flat, band) == \
                jexact.band_cells(flat, band)

"""The ``pacbio.rescore`` cell on the CPU at a small size, with its own
small-cell helper: a sound run comes out correct; the control (the
reference in float32 in the program's place), a perturbed log-probability
and a dropped cache window come out not correct; and K5's roofline share
reads the bound of the reference's jobs."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from harness import bounds, common

CELL = "pacbio.rescore"


def small_cell():
    """The cell with its world cut to 40 kb and 24 reads of 0.5-3 kb, its
    chain in 2 walks and its misassemblies' runs of 1-3 nodes."""
    cell = common.Cell(CELL)
    cell.config["world"].update(genome_bp=40_000, reads=24,
                                read_bp=[500, 3000])
    cell.traffic.update(walks=2, run_nodes=[1, 3])
    return cell


def run_small(seed=4294967311, trace=0, **kw):
    """(exit code, result dict) of one CPU run of the small cell."""
    import run as bench_run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_run.main(["--workload", CELL, "--seed", str(seed),
                             "--seconds", "1", "--trace", str(trace)],
                            device="cpu", cell=small_cell(), **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_sound_run_is_correct():
    rc, res = run_small()
    assert rc == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(common.Cell(CELL).traffic["limits"])


def test_control_is_not_correct():
    rc, res = run_small(control=np.float32)
    assert rc == 0 and not res["correct"], res["checks"]
    assert res["checks"]["logprob_gap"]["value"] > \
        res["checks"]["logprob_gap"]["limit"]


def perturb_one_logprob():
    """The forward batch's first log-probability raised by one nat."""
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    forward = PacbioReadSet._forward_batch

    def perturbed(self, *a, **kw):
        out = forward(self, *a, **kw)
        return [out[0] + 1.0] + out[1:] if out else out

    PacbioReadSet._forward_batch = perturbed
    return lambda: setattr(PacbioReadSet, "_forward_batch", forward)


def drop_one_window():
    """Each fill's first window that holds a hit taken out of the cache."""
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    apply = PacbioReadSet._slow_apply

    def dropped(self, prep, logprobs):
        out = apply(self, prep, logprobs)
        for key in prep["subpath_starts"]:
            if self.aligment_cache.get(key):
                del self.aligment_cache[key]
                break
        return out

    PacbioReadSet._slow_apply = dropped
    return lambda: setattr(PacbioReadSet, "_slow_apply", apply)


@pytest.mark.parametrize("fault", [perturb_one_logprob, drop_one_window])
def test_broken_timed_path_is_not_correct(fault):
    undo = []
    try:
        rc, res = run_small(faults=lambda: undo.append(fault()))
    finally:
        for u in undo:
            u()
    assert rc == 0 and not res["correct"], res["checks"]


def test_k5_roofline_reads_the_references_jobs(monkeypatch):
    """The share's bound is forward_bound on the reference's jobs of each
    traced request: their read lengths, band 64, the walk buffer."""
    from reference import pacbio as R

    driver = common.load_module("drivers", "pacbio_rescore")
    seen = []
    check = driver.check
    monkeypatch.setattr(driver, "check",
                        lambda ctx: (check(ctx), seen.append(ctx)))
    rc, res = run_small()
    assert rc == 0 and res["correct"]
    ctx, = seen
    lib = ctx.cell.config["cli"]["libraries"]["pb"]
    ref = R.Reference(ctx.world.nodes, ctx.world.reads,
                      float(lib["mismatch_prob"]))
    want = 0.0
    for k in ctx.layer["traced_calls"]:
        plan = ref.plan(ctx.pool[k])
        rlen = [len(j.guide) - 1 for j in plan.jobs]
        assert rlen and all(r == len(ctx.world.reads[j.rid])
                            for r, j in zip(rlen, plan.jobs))
        want += bounds.forward_bound(
            rlen, 64, sum(len(f.target) for f in plan.fills))["bound_ms"]

    class Trace:
        @staticmethod
        def op_seconds(match):
            assert match("void banded_forward_kernel<64>(unsigned char")
            assert not match("extend_kernel")
            return 2e-3

    ctx.tracer.trace = Trace()
    got = common.load_metric_reader("k5_roofline_pct.pacbio")(ctx)
    assert got == pytest.approx(100.0 * want / 1e3 / 2e-3, rel=1e-12)

"""The ``pacbio.anneal`` cell on the CPU at a small size: a sound run comes
out correct, and each fault of the timed path comes out not correct: a
dropped long-read window, a shifted hit position, the forward's results
rounded to float16, and a paired state off by one term.  Every long-read
batch runs on the native kernel (float64), the CPU's quick route."""
import io
import json
from contextlib import redirect_stdout

import pytest

from harness import common

CELL = "pacbio.anneal"


def small_cell():
    """The cell with its world cut to 60 kb, 2,000 frag pairs and 40 long
    reads of 0.5-4 kb, its sample to 6 of the first 20 calls."""
    cell = common.Cell(CELL)
    w = cell.config["world"]
    w.update(genome_bp=60_000, reads=40, long_read_bp=[500, 4000])
    w["libraries"]["rs1"]["pairs"] = 2_000
    cell.traffic.update(sample_span=20, sampled_calls=6)
    return cell


@pytest.fixture(autouse=True)
def native_route(monkeypatch):
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))


def run_small(seed=4294967311, **kw):
    """(exit code, result dict) of one 2 s CPU run of the small cell."""
    import run as bench_run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_run.main(["--workload", CELL, "--seed", str(seed),
                             "--seconds", "2", "--trace", "0"],
                            device="cpu", cell=small_cell(), **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_sound_run_is_correct():
    rc, res = run_small()
    assert rc == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(common.Cell(CELL).traffic["limits"]) <= set(res["checks"])


def after_apply(change):
    """``change(cache, prep)`` run after every ``_slow_apply``."""
    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    apply = PacbioReadSet._slow_apply

    def changed(self, prep, logprobs):
        out = apply(self, prep, logprobs)
        change(self.aligment_cache, prep)
        return out

    PacbioReadSet._slow_apply = changed
    return lambda: setattr(PacbioReadSet, "_slow_apply", apply)


def drop_one_window():
    """Each fill's first window that holds a hit taken out of the cache."""
    def drop(cache, prep):
        for key in prep["subpath_starts"]:
            if cache.get(key):
                del cache[key]
                return

    return after_apply(drop)


def shift_one_hit():
    """Each fill's first hit one base further right."""
    def shift(cache, prep):
        for key in prep["subpath_starts"]:
            hits = cache.get(key)
            if hits:
                hits[0] = hits[0]._replace(position=hits[0].position + 1)
                return

    return after_apply(shift)


def forward_in_float16():
    """Every forward batch's log-probabilities rounded to float16."""
    import numpy as np

    from gaml_tpu_torch.scoring.pacbio import PacbioReadSet

    forward = PacbioReadSet._forward_batch

    def rounded(self, *a, **kw):
        return [float(np.float16(x)) for x in forward(self, *a, **kw)]

    PacbioReadSet._forward_batch = rounded
    return lambda: setattr(PacbioReadSet, "_forward_batch", forward)


def paired_state_off_by_one_term():
    """From the second scoring call on, the first read with a total in
    the paired state counts its total twice."""
    from gaml_tpu_torch.scoring import calculator

    score = calculator.calc_score_for_paths_incremental
    calls = []

    def off(graph, paths, rs1, rs2, im, istd, state, *a, **kw):
        out = score(graph, paths, rs1, rs2, im, istd, state, *a, **kw)
        calls.append(1)
        if len(calls) > 1:
            i = int((state.probs > 0).argmax())
            state.probs[i] *= 2
        return out

    calculator.calc_score_for_paths_incremental = off
    return lambda: setattr(calculator, "calc_score_for_paths_incremental",
                           score)


@pytest.mark.parametrize("fault,check", [
    (drop_one_window, "windows_gap"), (shift_one_hit, "positions_gap"),
    (forward_in_float16, "logprob_gap"),
    (paired_state_off_by_one_term, "state_rel_gap")])
def test_broken_timed_path_is_not_correct(fault, check):
    undo = []
    try:
        rc, res = run_small(faults=lambda: undo.append(fault()))
    finally:
        for u in undo:
            u()
    assert rc == 0 and not res["correct"], res["checks"]
    assert res["checks"][check]["value"] > res["checks"][check]["limit"]

"""Whole runs of each cell on the CPU at a small size: sound runs come out
correct; the control (the reference in float32 in the program's place)
and the timed path broken underneath come out not correct."""
import numpy as np
import pytest

from conftest import run_small, small_cell

CELLS = ["aureus.rescore", "aureus.anneal"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rc, res = run_small(cell)
    assert rc == 0 and res["correct"], res
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    rc, res = run_small(cell, control=np.float32)
    assert rc == 0 and not res["correct"], res
    assert res["checks"]["score_rel_gap"]["value"] > \
        res["checks"]["score_rel_gap"]["limit"]


def drop_half_of_the_reads():
    """DeviceRescorer.score over the even reads only: half of the batch
    left out, the mean taken over the rest."""
    from gaml_tpu_torch.ops.rescore_device import DeviceRescorer

    score = DeviceRescorer.score

    def half(self, c, ext, *a, **kw):
        if ext is not None:
            ok, errs, begin = ext
            ext = (ok & (c.rid % 2 == 0), errs, begin)
        return score(self, c, ext, *a, **kw)

    DeviceRescorer.score = half
    return lambda: setattr(DeviceRescorer, "score", score)


def alter_one_alignment():
    """The extension's answer for one candidate of every batch altered
    where it is produced (one more error)."""
    from gaml_tpu_torch.ops import extend_device

    extend = extend_device.DeviceExtender.extend

    def altered(self, *a, **kw):
        ok, errs, begin = extend(self, *a, **kw)
        errs = errs.clone()
        errs[:1] += 1
        return ok, errs, begin

    extend_device.DeviceExtender.extend = altered
    return lambda: setattr(extend_device.DeviceExtender, "extend", extend)


def alter_one_native_window():
    """The native aligner's answer for the first window of every batch
    altered where it is produced (one more error on its first
    alignment)."""
    from gaml_tpu_torch import native

    batch = native.align_windows_batch

    def altered(*a, **kw):
        out = batch(*a, **kw)
        for res in out[:1]:
            if len(res[1]):
                res[1][0] += 1
        return out

    native.align_windows_batch = altered
    return lambda: setattr(native, "align_windows_batch", batch)


def keep_the_state():
    """The paired scorer returns the state it started from: every call
    answers what the first call of its library answered."""
    from gaml_tpu_torch.scoring import calculator

    inc = calculator.calc_score_for_paths_incremental
    first = {}

    def unchanged(graph, paths, rs1, *a, **kw):
        out = inc(graph, paths, rs1, *a, **kw)
        return first.setdefault(id(rs1), out)

    calculator.calc_score_for_paths_incremental = unchanged
    return lambda: setattr(calculator, "calc_score_for_paths_incremental",
                           inc)


def store_one_update_wrong():
    """The paired scorer stores one call's update wrong (the first call
    after the start scoring halves its largest per-read total) and
    answers that call right: only the totals that later calls start from
    carry the fault."""
    from gaml_tpu_torch.scoring import calculator

    inc = calculator.calc_score_for_paths_incremental
    calls = []

    def wrong(graph, paths, rs1, rs2, mean, std, state, *a, **kw):
        out = inc(graph, paths, rs1, rs2, mean, std, state, *a, **kw)
        calls.append(id(rs1))
        if calls.count(id(rs1)) == 2:
            state.probs[int(np.argmax(state.probs))] *= 0.5
        return out

    calculator.calc_score_for_paths_incremental = wrong
    return lambda: setattr(calculator, "calc_score_for_paths_incremental",
                           inc)


@pytest.mark.parametrize("cell,fault", [
    ("aureus.rescore", drop_half_of_the_reads),
    ("aureus.rescore", alter_one_alignment),
    ("aureus.anneal", keep_the_state),
    ("aureus.anneal", alter_one_native_window),
    ("aureus.anneal", store_one_update_wrong),
])
def test_broken_timed_path_is_not_correct(cell, fault):
    undo = []
    try:
        rc, res = run_small(cell, faults=lambda: undo.append(fault()))
    finally:
        for u in undo:
            u()
    assert rc == 0 and not res["correct"], res["checks"]


def test_jobs_in_one_call_are_judged_each():
    """A rescore mix of two assemblies a call (independent jobs) runs
    correct, and the control in its place does not."""
    cell = small_cell("aureus.rescore", jobs_per_call=2)
    rc, res = run_small("aureus.rescore", cell=cell)
    assert rc == 0 and res["correct"], res
    cell = small_cell("aureus.rescore", jobs_per_call=2)
    rc, res = run_small("aureus.rescore", cell=cell, control=np.float32)
    assert rc == 0 and not res["correct"], res["checks"]

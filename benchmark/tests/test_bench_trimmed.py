"""The ``aureus_trimmed.anneal`` cell on the CPU at a small size: a sound
run comes out correct; the float32 control and the timed path broken
underneath (an alignment of the device route altered where it is
produced, a candidate dropped from every candgen query, a paired update
stored wrong) come out not correct."""
import numpy as np
import pytest

from conftest import run_small
from test_bench_faults import alter_one_alignment, store_one_update_wrong

CELL = "aureus_trimmed.anneal"


def test_sound_run_is_correct():
    rc, res = run_small(CELL, seconds=4.0)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0


def test_control_is_not_correct():
    rc, res = run_small(CELL, seconds=4.0, control=np.float32)
    assert rc == 0 and not res["correct"], res
    for name in ("score_rel_gap", "state_rel_gap"):
        assert res["checks"][name]["value"] > res["checks"][name]["limit"]


def drop_one_candidate():
    """Every candgen query of the ragged route loses its last candidate."""
    from gaml_tpu_torch.ops.candgen_device import DeviceCandGen

    query = DeviceCandGen.query

    def dropped(self, *a, **kw):
        c = query(self, *a, **kw)
        if c.overflow or not c.n_total:
            return c
        return c._replace(n_total=c.n_total - 1, **{
            k: getattr(c, k)[:-1] for k in ("rid", "g0", "r0", "orient",
                                            "seg")})

    DeviceCandGen.query = dropped
    return lambda: setattr(DeviceCandGen, "query", query)


@pytest.mark.parametrize("fault", [alter_one_alignment, drop_one_candidate,
                                   store_one_update_wrong])
def test_broken_timed_path_is_not_correct(fault):
    undo = []
    try:
        rc, res = run_small(CELL, seconds=4.0,
                            faults=lambda: undo.append(fault()))
    finally:
        for u in undo:
            u()
    assert rc == 0 and not res["correct"], res["checks"]

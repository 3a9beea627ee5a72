"""The per-layer metrics read from the program's own spans and counters
(harness/program_trace.py): a traced CPU run of each cell reports each of
them with a positive value, and an untraced run reports none."""
import pytest

from conftest import run_small

READ = {"aureus.anneal": ["propose_self_ms.anneal", "score_align_ms.anneal",
                          "score_pairs_ms.anneal", "score_reduce_ms.anneal",
                          "native_batches_per_move"],
        "aureus.rescore": ["launch_host_ms.rescore", "sync_wait_ms.rescore"]}


@pytest.mark.parametrize("cell", sorted(READ))
def test_traced_run_reports_the_program_span_metrics(cell):
    from gaml_tpu_torch.utils.metrics import TRACE

    TRACE.reset()
    rc, res = run_small(cell, trace=1)
    assert rc == 0 and res["correct"], res
    for name in READ[cell]:
        assert res["metrics"][name]["value"] > 0, name
    if cell == "aureus.rescore":
        # launch and sync share out the program's rescore span
        calls, total, _own = TRACE.span_stats("rescore")
        parts = sum(res["metrics"][n]["value"] for n in READ[cell])
        assert abs(parts - 1e3 * total / calls) < 1e-9 * parts
    TRACE.reset()
    rc, res = run_small(cell, trace=0)
    assert rc == 0 and res["correct"], res
    assert not set(READ[cell]) & set(res["metrics"])
    assert not TRACE.spans and not TRACE.counters

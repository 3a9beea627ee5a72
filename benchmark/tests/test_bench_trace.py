"""The reduction of a profiler trace (harness/trace.py) on a made-up one:
busy time, idle share, device time by kernel and by launching span, and
idle time shared out by the innermost host span."""
import json

from harness.trace import Trace


def made_up(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench.move",
           "ts": 0, "dur": 40},
          {"ph": "X", "cat": "user_annotation", "name": "bench.move",
           "ts": 45, "dur": 55},
          {"ph": "X", "cat": "user_annotation", "name": "bench.score",
           "ts": 5, "dur": 25},
          {"ph": "X", "cat": "user_annotation", "name": "bench.score",
           "ts": 60, "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "bench.align",
           "ts": 8, "dur": 4},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 9, "dur": 1, "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 41, "dur": 1, "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name":
           "void (anonymous namespace)::extend_kernel<Load>(int)",
           "ts": 10, "dur": 10, "args": {"correlation": 1}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned)",
           "ts": 50, "dur": 5, "args": {"correlation": 2}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def test_reduction(tmp_path):
    tr = made_up(tmp_path)
    assert tr.window_s() == 100e-6
    assert abs(tr.busy_s() - 15e-6) < 1e-12
    assert abs(tr.idle_pct() - 85.0) < 1e-9
    assert abs(tr.op_seconds(lambda n: "extend_kernel" in n) - 10e-6) < 1e-12
    assert abs(tr.op_seconds_in("score") - 10e-6) < 1e-12
    assert tr.op_seconds_in("move") == 10e-6
    b = tr.breakdown()
    assert b["device_ops"][0] == ["extend_kernel", 10e-6]
    idle = {n: round(v * 1e6, 6) for n, v in b["idle_gaps"]}
    assert idle == {"score": 43.0, "move": 35.0, "outside": 5.0,
                    "align": 2.0}

"""The metric arithmetic: the window rate, the percentile, the spread, the
roofline, the readers, and the reduction of a profiler trace."""

import json
import statistics

import pytest

from portbench import harness, measure, spread


def test_window_rate_and_percentile():
    assert measure.window_rate(12.0, 240) == 0.05
    times = [0.01 * (i + 1) for i in range(100)]
    assert measure.percentile(times, 95) == pytest.approx(0.9505)
    assert measure.percentile([0.3], 95) == 0.3


def test_spread_uses_statistics_quartiles(tmp_path):
    values = [1.0, 1.1, 0.9, 1.05, 0.95, 1.2]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert measure.spread(values) == pytest.approx((q3 - q1) / med)
    files = []
    for i, v in enumerate(values):
        f = tmp_path / f"run{i}.out"
        f.write_text('{"portbench": {}}\n' + json.dumps(
            {"metrics": {"solve_s": {"value": v, "unit": "s"},
                         "peak_mem_gib": {"value": 5.0, "unit": "GiB"}}}) + "\n")
        files.append(str(f))
    got = spread.spreads([json.loads(open(f).read().splitlines()[-1]) for f in files])
    assert got == {"solve_s": pytest.approx((q3 - q1) / med), "peak_mem_gib": 0.0}


@pytest.mark.parametrize("nbytes, flops, kind, by", [
    (3.35e9, 1e9, "f32", "bytes"),          # 1 ms of bytes, 0.015 ms of operations
    (3.35e6, 6.7e10, "f32", "operations"),  # 0.001 ms of bytes, 1 ms of operations
])
def test_bound_and_roofline(nbytes, flops, kind, by):
    ms, which = measure.bound(nbytes, flops, kind)
    assert which == by and ms == pytest.approx(1.0)
    assert measure.roofline_percent(nbytes, flops, kind, 4.0) == pytest.approx(25.0)


def trace_event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic_trace():
    ann = harness.ANNOTATION
    return [
        trace_event("kernel", "spin_kernel", 0, 50),            # padding, outside
        trace_event("user_annotation", ann, 100, 1000),
        trace_event("cpu_op", "aten::mm", 110, 30),
        trace_event("cuda_runtime", "cudaLaunchKernel", 115, 5),
        trace_event("kernel", "gemm", 150, 100),
        trace_event("cpu_op", "aten::_local_scalar_dense", 300, 400),
        trace_event("cuda_runtime", "cudaLaunchKernel", 310, 5),
        trace_event("cuda_driver", "cuLaunchKernel", 320, 5),
        trace_event("kernel", "k6", 400, 200),
        trace_event("kernel", "k6", 500, 200),                 # overlaps the first
        trace_event("gpu_memcpy", "Memcpy HtoD", 800, 100),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 400},
    ]


def test_reduce_trace():
    s = measure.reduce_trace(synthetic_trace(), harness.ANNOTATION)
    assert s["window_s"] == pytest.approx(1000e-6)
    # gemm 100 + k6 union 300 + memcpy 100
    assert s["busy_s"] == pytest.approx(500e-6)
    assert s["kernels"] == 3 and s["launch_calls"] == 3
    assert s["device_ops"][0] == ["k6", pytest.approx(400e-6)]
    names = dict(s["idle_gaps"])
    # the gap 100-150: its midpoint lies in aten::mm (110-140)
    assert names["aten::mm"] == pytest.approx(50e-6)
    # 250-400: mid 325 under cuLaunchKernel (320-325); 700-800 and 900-1100
    # under nothing
    assert names["cuLaunchKernel"] == pytest.approx(150e-6)
    assert names["host between operations"] == pytest.approx(100e-6 + 200e-6)


def test_reduce_trace_without_window():
    assert measure.reduce_trace([trace_event("kernel", "k", 0, 1)], "none") is None


def test_readers():
    run = {"attempted": 4, "window_s": 2.0, "solve_times": [0.5, 0.5, 0.4, 0.6],
           "iterations": [3, 3, 4, 3], "memory_peak_bytes": 2 ** 31, "setup_s": 9.0,
           "first_solve_s": 1.5,
           "trace": {"launch_calls": 300, "iterations": 15, "window_s": 0.2, "busy_s": 0.15},
           "action": {"ms": 2.0, "bytes": 3.35e9, "ops": 1.0, "peak": "f32"}}
    read = {m: harness.plugin("metrics", m).read(run) for m in (
        "solve_s", "solve_p95_s", "peak_mem_gib", "setup_s", "first_solve_s", "iterations",
        "launches_per_iter", "action_roofline", "idle_share")}
    assert read == pytest.approx({
        "solve_s": 0.5, "solve_p95_s": 0.585, "peak_mem_gib": 2.0, "setup_s": 9.0,
        "first_solve_s": 1.5, "iterations": 3.25, "launches_per_iter": 20.0,
        "action_roofline": 50.0, "idle_share": 25.0})


def test_readers_find_nothing_in_an_untraced_run():
    run = {"attempted": 1, "window_s": 1.0, "solve_times": [1.0], "iterations": [3],
           "memory_peak_bytes": None}
    for m in ("launches_per_iter", "action_roofline", "idle_share", "peak_mem_gib"):
        assert harness.plugin("metrics", m).read(run) is None

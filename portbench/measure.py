"""The yardstick's arithmetic: peaks, bounds, CUDA-event timing, window
statistics and the reduction of a profiler trace.

``time_ms``, ``pad_events``, ``bound`` and the peaks are frozen copies of
the port's smoke script's helpers (``chip_smoke.py``), kept here so that no
change to the program moves the yardstick. The trace is read from the
profiler's chrome trace (``reduce_trace``), which carries each event's
interval, where the smoke script summed key averages.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import numpy as np

# H100 SXM data-sheet peaks (dense): memory 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; int8 tensor cores 1979 TOP/s; float32 outside the tensor
# cores 67 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}

# the host's CUDA launch calls; a graph launch counts once
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")

# host operations searched back from an idle gap for the one under it
LOOKBACK = 256


def time_ms(fn, device, reps: int = 20) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def pad_events(device, kernels: int = 16) -> None:
    """A few short spin kernels, launched at both ends of a profiled
    window: the profiler can miss the first device events of a session
    (on an H100 it once recorded 5 of 10 K6 calls), so these take that place.
    ``reduce_trace`` leaves them out."""
    import torch

    torch.cuda.synchronize(device)
    for _ in range(kernels):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)


def bound(nbytes: float, flops: float, kind: str):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory peak and the operations over ``kind``'s peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_percent(nbytes: float, flops: float, kind: str, ms: float) -> float:
    """The bound's share of a measured time, in percent."""
    return 100.0 * bound(nbytes, flops, kind)[0] / ms


def window_rate(window_s: float, completed: int) -> float:
    """Seconds per completed solve over the whole window."""
    return window_s / completed


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, interpolated linearly between
    the closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median, the quartiles as ``statistics.quantiles(values, n=4)``
    gives them."""
    import statistics

    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


# ---------------------------------------------------------------------------
# the profiler trace


def export_events(prof) -> list:
    """The trace events of a finished ``torch.profiler.profile``, read back
    from its chrome trace (written to, and removed from, the temporary
    directory)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _kind(ev: dict):
    cat = str(ev.get("cat", "")).lower()
    if ev.get("ph") != "X" or "dur" not in ev:
        return None
    if cat in ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"):
        return "device"
    if cat in ("cuda_runtime", "cuda_driver", "runtime", "driver"):
        return "api"
    if cat in ("cpu_op", "operator", "user_annotation"):
        return "host"
    return None


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list, annotation: str, top: int = 10) -> dict:
    """What one traced window holds, inside the host annotation named
    ``annotation``: its length, the union of its device intervals (kernels,
    copies, sets), the device operations and the host's launch calls
    counted, the device time by operation name, and the idle gaps named by
    the innermost host operation under each gap's midpoint. Times in
    seconds; an empty window gives ``None``."""
    ann = [ev for ev in events if ev.get("name") == annotation and _kind(ev) == "host"]
    if not ann:
        return None
    w0 = float(ann[0]["ts"])
    w1 = w0 + float(ann[0]["dur"])
    device, host, by_op = [], [], {}
    launches = kernels = 0
    for ev in events:
        kind = _kind(ev)
        if kind is None:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if e < w0 or s > w1:
            continue
        if kind == "device":
            if "spin_kernel" in ev.get("name", ""):
                continue
            device.append((max(s, w0), min(e, w1)))
            by_op[ev["name"]] = by_op.get(ev["name"], 0.0) + (e - s)
            if str(ev.get("cat", "")).lower() == "kernel":
                kernels += 1
        else:
            if kind == "api" and ev.get("name") in LAUNCH_CALLS:
                launches += 1
            if ev is not ann[0]:
                host.append((s, e, ev["name"]))
    busy = merged(device)
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    # innermost host operation at a time: the latest-starting one that
    # covers it, looked for among the last LOOKBACK to start
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = "host between operations"
        k = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, k - LOOKBACK):k]):
            if h[1] >= mid:
                name = h[2]
                break
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps_named = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": kernels,
        "launch_calls": launches,
        "device_ops": [[name[:120], us * 1e-6] for name, us in ops],
        "idle_gaps": [[name[:120], s] for name, s in gaps_named],
    }

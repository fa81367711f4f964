"""The program's own spans and counters, as the per-layer metrics read
them: ``iterative_solver_torch.utils.profiler.snapshot()`` after the run.

The program records only while a ``torch.profiler`` session records, and
the harness records only in its traced solves, so the registry holds those
solves: every window the segment took, retakes included. Each metric
divides a span's total by a span's count (per solve: ``davidson.solve``;
per iteration: ``davidson.iteration``), so a retaken window does not skew
it. A run without a trace, or a program without the registry or without
the solve's spans, gives ``None``.
"""

from __future__ import annotations

SOLVE = "davidson.solve"
ITERATION = "davidson.iteration"


def registry(run: dict):
    """The program's registry after the run's traced solves, or ``None``."""
    if not run.get("trace"):
        return None
    try:
        from iterative_solver_torch.utils import profiler
    except ImportError:
        return None
    snapshot = getattr(profiler, "snapshot", None)
    if snapshot is None:
        return None
    reg = snapshot()
    if not reg["spans"].get(SOLVE, {}).get("count"):
        return None
    return reg


def ms_per(run: dict, name: str, field: str, divisor: str):
    """Milliseconds of span ``name``'s summed ``field`` (``host_s`` or
    ``device_s``) per count of span ``divisor``, or ``None``."""
    reg = registry(run)
    if reg is None:
        return None
    spans = reg["spans"]
    if name not in spans or not spans.get(divisor, {}).get("count"):
        return None
    return 1e3 * spans[name][field] / spans[divisor]["count"]

"""The spans and counters of the program's ``FusedPPCG`` solve, as the
``ppcg_*`` per-layer metrics read them: ``spans.py``'s reading, keyed on
``ppcg.solve`` (per solve) and ``ppcg.iteration`` (per iteration) where
``spans.py`` keys on Davidson's spans.

A run without a trace, or a program without the registry or without the
PPCG solve's spans, gives ``None``.
"""

from __future__ import annotations

SOLVE = "ppcg.solve"
ITERATION = "ppcg.iteration"


def registry(run: dict):
    """The program's registry after the run's traced solves, or ``None``
    where it holds no ``ppcg.solve``."""
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

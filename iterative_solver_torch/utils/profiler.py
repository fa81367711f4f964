"""Hierarchical named-region profiler (port of
iterative_solver_tpu/utils/profiler.py), and the spans and counters of
the solve.

The counterpart of molpro::Profiler (SURVEY.md §5): a wall-clock region
tree on the host, with each region also opened as a
``torch.profiler.record_function`` range while a ``torch.profiler`` session
records, so that it shows in the trace of the card beside the kernels it
launched (the JAX package opens a ``jax.profiler.TraceAnnotation``
instead). Regions nest via the ``push()`` context manager; ``report()``
renders the tree with cumulative times and call counts.

``span(name)`` and ``count(name, n)`` instrument the solve itself. Both
record only while a ``torch.profiler`` session records; otherwise each is
one flag read. A span opens a ``record_function`` range (a
``user_annotation`` in the profiler's chrome trace, on the kernels' clock),
takes its host duration, and with CUDA in use records a start and an end
event on the current stream: their interval is the span's device extent,
from the device reaching the span's first work to its finishing the last,
idle inside included. Where CUDA is not in use the host does the work
inside the span, and the extent is the host duration. Extents are resolved
without a synchronisation of their own: ``settle()``, called after the
solve's blocking reads, adds those whose end event has completed, and
``snapshot()`` waits for the rest. Totals live in one registry per process
(a solve runs on one host thread): per span name the count, the summed host
seconds and the summed device seconds, and per counter its sum.
``snapshot()`` returns them and ``reset()`` clears them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

# True while a torch.profiler session records: the one gate of every
# instrument here
_recording = torch._C._autograd._profiler_enabled
# what span() returns with the gate off: a shared context that does nothing
_OFF = contextlib.nullcontext()

# span name -> [count, host seconds, device seconds]
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, float] = {}
# (record, start event, end event, their pool) of spans whose extent is not
# yet added, in the order their end events were recorded
_PENDING: List[tuple] = []
# device index -> timing events whose interval has been read, for reuse
_FREE: Dict[int, list] = {}


class _Span:
    __slots__ = ("name", "range", "stream", "free", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        # with CUDA in use, the extent is read on the stream current at entry
        self.stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        if self.stream is not None:
            self.free = _FREE.setdefault(self.stream.device_index, [])
            self.start = self._event()
        self.t0 = time.perf_counter()
        return self

    def _event(self):
        ev = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        rec = _SPANS.setdefault(self.name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += host
        if self.stream is None:
            rec[2] += host
        else:
            _PENDING.append((rec, self.start, self._event(), self.free))
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the region ``name`` while a
    ``torch.profiler`` session records, and does nothing otherwise."""
    return _Span(name) if _recording() else _OFF


def count(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` while a ``torch.profiler`` session
    records."""
    if _recording():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def settle() -> None:
    """Add the device extents of the spans whose end event has completed,
    oldest first, up to the first that has not; waits for nothing."""
    done = 0
    for rec, start, end, free in _PENDING:
        if not end.query():
            break
        rec[2] += start.elapsed_time(end) * 1e-3
        free += (start, end)
        done += 1
    del _PENDING[:done]


def snapshot() -> dict:
    """The registry: ``{"spans": {name: {"count", "host_s", "device_s"}},
    "counters": {name: total}}``. Waits for the device to finish the spans
    recorded so far."""
    for _, _, end, _ in _PENDING:
        end.synchronize()
    settle()
    return {"spans": {name: {"count": c, "host_s": h, "device_s": d}
                      for name, (c, h, d) in _SPANS.items()},
            "counters": dict(_COUNTERS)}


def reset() -> None:
    """Clear the registry."""
    _SPANS.clear()
    _COUNTERS.clear()
    _PENDING.clear()
    _FREE.clear()


class _Node:
    __slots__ = ("name", "children", "total", "calls", "flops")

    def __init__(self, name: str):
        self.name = name
        self.children: Dict[str, _Node] = {}
        self.total = 0.0
        self.calls = 0
        self.flops = 0.0


class Profiler:
    """Hierarchical timer. ``max_depth=0`` disables all accounting."""

    def __init__(self, name: str = "iterative-solver", max_depth: int = 1 << 30):
        self.root = _Node(name)
        self._stack = [self.root]
        self.max_depth = max_depth

    @contextlib.contextmanager
    def push(self, name: str, flops: float = 0.0):
        if self.max_depth <= 0 or len(self._stack) > self.max_depth:
            yield self
            return
        parent = self._stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = parent.children[name] = _Node(name)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            with record_function(name) if _recording() else _OFF:
                yield self
        finally:
            node.total += time.perf_counter() - t0
            node.calls += 1
            node.flops += flops
            self._stack.pop()

    def report(self) -> str:
        lines = []

        def walk(node: _Node, depth: int):
            rate = f", {node.flops / node.total / 1e9:.2f} GF/s" if node.flops and node.total else ""
            lines.append(f"{'  ' * depth}{node.name}: {node.total:.4f}s x{node.calls}{rate}")
            for child in sorted(node.children.values(), key=lambda n: -n.total):
                walk(child, depth + 1)

        for child in sorted(self.root.children.values(), key=lambda n: -n.total):
            walk(child, 0)
        return "\n".join(lines)

    def dotgraph(self, threshold: float = 0.01) -> str:
        """Graphviz rendering of the region tree (the reference's
        PROFILER_DOTGRAPH output, IterativeSolverTemplate.h:485-501):
        nodes below ``threshold`` fraction of total wall time are pruned,
        hotter nodes are filled redder."""
        total = sum(c.total for c in self.root.children.values()) or 1.0
        lines = ["digraph profile {", '  node [shape=box, style=filled];']
        counter = [0]

        def walk(node: _Node, parent_id):
            frac = node.total / total
            if frac < threshold:
                return
            nid = f"n{counter[0]}"
            counter[0] += 1
            heat = int(255 * min(1.0, frac))
            color = f"#ff{255 - heat:02x}{255 - heat:02x}"
            lines.append(
                f'  {nid} [label="{node.name}\\n{node.total:.4f}s x{node.calls}",'
                f' fillcolor="{color}"];'
            )
            if parent_id is not None:
                lines.append(f"  {parent_id} -> {nid};")
            for child in sorted(node.children.values(), key=lambda n: -n.total):
                walk(child, nid)

        for child in sorted(self.root.children.values(), key=lambda n: -n.total):
            walk(child, None)
        lines.append("}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.report()


def null_profiler() -> Profiler:
    """A profiler that records nothing (``max_depth=0``)."""
    return Profiler(max_depth=0)

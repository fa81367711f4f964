"""Hierarchical named-region profiler (port of
iterative_solver_tpu/utils/profiler.py).

The counterpart of molpro::Profiler (SURVEY.md §5): a wall-clock region
tree on the host, with each region also opened as a
``torch.profiler.record_function`` range, so that it shows in a
``torch.profiler`` trace of the card beside the kernels it launched (the
JAX package opens a ``jax.profiler.TraceAnnotation`` instead). Regions nest
via the ``push()`` context manager; ``report()`` renders the tree with
cumulative times and call counts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

from torch.profiler import record_function


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
            with record_function(name):
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

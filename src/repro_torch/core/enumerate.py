"""Exhaustive enumeration of the implementation space.

Enumerates every (topological traversal x stream assignment) of a program
DAG, pruning stream-bijection-equivalent implementations by only emitting
canonical stream labelings (streams first used in increasing order,
paper §III-C2). Used for the paper's "2036 implementations" style
exhaustive baselines (Fig. 1) and for Table V generalization accuracy.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch.core.dag import BoundOp, Graph, OpKind, Schedule


def enumerate_schedules(graph: Graph, n_streams: int) -> Iterator[Schedule]:
    """Yield every canonical implementation of ``graph``.

    Canonical form: when a GPU op is bound, it may use any stream already in
    use, or the lowest-numbered unused stream (if any remain). This emits
    exactly one representative per stream-bijection equivalence class.
    """
    items: list[BoundOp] = []
    scheduled: set[str] = set()

    def rec() -> Iterator[Schedule]:
        if len(scheduled) == len(graph.ops):
            yield Schedule(tuple(items))
            return
        for name in graph.eligible(scheduled):
            op = graph.ops[name]
            if op.kind is OpKind.GPU:
                used = {i.stream for i in items if i.stream is not None}
                options = sorted(used)
                if len(used) < n_streams:
                    options.append(len(used))  # first unused stream
                for s in options:
                    items.append(BoundOp(name, s))
                    scheduled.add(name)
                    yield from rec()
                    scheduled.remove(name)
                    items.pop()
            else:
                items.append(BoundOp(name))
                scheduled.add(name)
                yield from rec()
                scheduled.remove(name)
                items.pop()

    yield from rec()


def count_schedules(graph: Graph, n_streams: int) -> int:
    return sum(1 for _ in enumerate_schedules(graph, n_streams))

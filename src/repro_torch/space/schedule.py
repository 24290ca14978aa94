"""Canonical identity and move generation for the paper's
(traversal order x stream binding) space (§III-C).

:func:`canonical_key` is the transposition key under stream
relabeling, :func:`eligible_items` the stream-bijection-pruned move
set shared by MCTS expansion and rollouts, and :func:`random_schedule`
the uniform rollout policy.
"""
from __future__ import annotations

import random

from repro_torch.core.dag import BoundOp, Graph, OpKind, Schedule


def canonical_key(schedule: Schedule) -> tuple:
    """Hashable identity under stream relabeling (transposition key).

    Inlines :func:`~repro_torch.core.dag.canonicalize_streams`' first-use
    relabeling without building intermediate ``BoundOp`` objects.
    """
    mapping: dict[int, int] = {}
    out = []
    for it in schedule.items:
        s = it.stream
        if s is None:
            out.append((it.name, None))
        else:
            c = mapping.get(s)
            if c is None:
                c = mapping[s] = len(mapping)
            out.append((it.name, c))
    return tuple(out)


def eligible_items(graph: Graph, prefix: list[BoundOp],
                   n_streams: int) -> list[BoundOp]:
    """Eligible next items from a prefix, stream-bijection pruned.

    GPU ops may bind to any stream already in use, or the lowest-numbered
    unused stream — the canonical first-use labeling of §III-C2, so every
    complete schedule built through this helper is canonical by
    construction. Shared by MCTS expansion and random rollouts.
    """
    scheduled = {b.name for b in prefix}
    used = sorted({b.stream for b in prefix if b.stream is not None})
    options: list[BoundOp] = []
    for name in graph.eligible(scheduled):
        if graph.ops[name].kind is OpKind.GPU:
            for s in used:
                options.append(BoundOp(name, s))
            if len(used) < n_streams:
                options.append(BoundOp(name, len(used)))
        else:
            options.append(BoundOp(name))
    return options


def random_schedule(graph: Graph, n_streams: int,
                    rng: random.Random) -> Schedule:
    """Uniform random canonical schedule (the MCTS rollout policy)."""
    prefix: list[BoundOp] = []
    while True:
        options = eligible_items(graph, prefix, n_streams)
        if not options:
            return Schedule(tuple(prefix))
        prefix.append(rng.choice(options))

"""The paper's (traversal order x stream binding) spaces (§III-C) as a
:class:`~repro_torch.space.base.DesignSpace`.

:func:`canonical_key` is the transposition key under stream
relabeling, :func:`tie_key` its total order, :func:`eligible_items` the
stream-bijection-pruned move
set shared by MCTS expansion and rollouts, :func:`random_schedule`
the uniform rollout policy, and :class:`ScheduleSpace` the protocol
over them: the JAX package's ``repro/space/schedule.py``, so cache keys,
store addresses, features, trajectories and analytic costs are the
reference's.
"""
from __future__ import annotations

import random
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.costmodel import op_durations, simulate
from repro_torch.core.dag import BoundOp, Graph, OpKind, Schedule
from repro_torch.core.enumerate import enumerate_schedules
from repro_torch.core.features import (FeatureBasis, FeatureMatrix,
                                       FeatureUniverse, apply_features,
                                       featurize)
from repro_torch.space.base import DesignSpace


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


def tie_key(schedule: Schedule) -> tuple:
    """Total order on canonical encodings: the canonical item sequence
    with ``None`` streams as -1, so tuples compare without type errors
    (CPU ops sort first)."""
    return tuple((name, -1 if s is None else s)
                 for name, s in canonical_key(schedule))


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


class ScheduleSpace(DesignSpace):
    """Schedules of ``graph`` over ``n_streams`` streams (§III-C)."""

    def __init__(self, graph: Graph, n_streams: int = 2,
                 name: str | None = None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.graph = graph
        self.n_streams = n_streams
        self.name = name if name is not None else \
            f"schedule:{graph.n_vertices()}ops:{n_streams}streams"
        self._op_id = {n: i for i, n in enumerate(graph.ops)}

    # -- identity ----------------------------------------------------------
    def encode_batch(self, schedules: Sequence[Schedule]
                     ) -> tuple[list[bytes], np.ndarray]:
        """(keys, encoding) for a batch of complete schedules.

        The encoding is ``(B, 2, N)`` int32: ``enc[b, 0]`` the op id
        per position, ``enc[b, 1]`` the *canonical* (first-use-
        relabeled, §III-C2) stream per position, -1 for CPU ops; each
        row's bytes are the schedule's cache key — the same identity
        :func:`canonical_key` computes, for a whole batch at once. The
        first-use relabel is itself
        vectorized (first-occurrence position per stream,
        stable-argsorted into ranks) over the *distinct* stream ids
        present in the batch — never ``max(id) + 1`` slots — so sparse
        ids (stream ``10**6``) cost what dense ids cost instead of
        allocating gigabytes.
        """
        op_id = self._op_id
        n = len(op_id)
        b_n = len(schedules)
        ids: list[int] = []
        sts: list[int] = []
        ext_i, ext_s = ids.extend, sts.extend
        for sched in schedules:
            items = sched.items
            if len(items) != n:
                raise ValueError(
                    f"evaluators require complete schedules: got "
                    f"{len(items)} items for a {n}-op graph")
            ext_i([op_id[i.name] for i in items])
            ext_s([-1 if i.stream is None else i.stream for i in items])
        enc = np.empty((b_n, 2, n), dtype=np.int32)
        enc[:, 0, :] = np.fromiter(ids, np.int32,
                                   count=b_n * n).reshape(b_n, n)
        enc[:, 1, :] = np.fromiter(sts, np.int32,
                                   count=b_n * n).reshape(b_n, n)
        streams = enc[:, 1, :]
        uniq = np.unique(streams)
        uniq = uniq[uniq >= 0]               # distinct real ids, sorted
        if uniq.size:
            d = uniq.size
            pos = np.arange(n, dtype=np.int32)
            first = np.where(
                streams[:, :, None] == uniq[None, None, :],
                pos[None, :, None], n).min(axis=1)      # (B, D)
            # Ids absent from a row have first == n and stable-sort
            # last, so present ids get ranks 0..p-1 in first-use order
            # (same labels the dense 0..max relabel assigned) and the
            # padding ranks are never looked up.
            by_first = np.argsort(first, axis=1, kind="stable")
            label = np.empty_like(by_first)
            np.put_along_axis(
                label, by_first,
                np.arange(d)[None, :], axis=1)
            col = np.searchsorted(
                uniq, np.where(streams < 0, uniq[0], streams))
            row_base = (np.arange(b_n) * d)[:, None]
            enc[:, 1, :] = np.where(
                streams >= 0,
                label.ravel()[row_base + col],
                -1)
        return [row.tobytes() for row in enc], enc

    def decode_batch(self, enc: np.ndarray) -> list[Schedule]:
        """Schedules back from ``encode_batch`` rows.

        Accepts ``(B, 2, N)`` or per-row flattened ``(B, 2*N)`` int32
        (the cache-key bytes reinterpreted). Streams come back exactly
        as encoded — the canonical first-use labels — so the result is
        each row's canonical representative schedule: identical cache
        key, identical expanded sequence and feature vector (sync
        insertion depends only on same-stream relations, never on
        stream *ids*).
        """
        enc = np.asarray(enc, dtype=np.int32)
        names = list(self._op_id)
        n = len(names)
        enc = enc.reshape(-1, 2, n)
        out: list[Schedule] = []
        for row in enc:
            out.append(Schedule(tuple(
                BoundOp(names[int(o)], None if s < 0 else int(s))
                for o, s in zip(row[0], row[1]))))
        return out

    def candidate_key(self, schedule: Schedule) -> tuple:
        return canonical_key(schedule)

    def tie_key(self, schedule: Schedule) -> tuple:
        return tie_key(schedule)

    def describe(self, schedule: Schedule) -> str:
        return " ".join(str(i) for i in schedule.items)

    # -- moves -------------------------------------------------------------
    def moves(self, prefix: list[BoundOp]) -> list[BoundOp]:
        return eligible_items(self.graph, prefix, self.n_streams)

    def move_key(self, move: BoundOp) -> tuple:
        return (move.name, move.stream)

    def finalize(self, prefix: list[BoundOp]) -> Schedule:
        return Schedule(tuple(prefix))

    def candidate_moves(self, schedule: Schedule) -> Sequence[BoundOp]:
        return schedule.items

    def enumerate_candidates(self) -> Iterator[Schedule]:
        return enumerate_schedules(self.graph, self.n_streams)

    # -- featurization (§IV-B order/stream pairs) --------------------------
    def feature_basis(self) -> FeatureBasis:
        return FeatureBasis(self.graph)

    def featurize(self, schedules: Sequence[Schedule]) -> FeatureMatrix:
        return featurize(self.graph, list(schedules))

    def apply_features(self, schedules: Sequence[Schedule],
                       features: list) -> np.ndarray:
        return apply_features(self.graph, list(schedules), features)

    # -- evaluation support ------------------------------------------------
    def feature_universe(self) -> FeatureUniverse:
        return FeatureUniverse(self.graph)

    def durations(self, machine) -> dict:
        return op_durations(self.graph, machine)

    def fingerprint(self, machine, durations: dict,
                    objective: str) -> bytes:
        # Runtime import: the engine package imports this module.
        from repro_torch.engine.store import store_fingerprint
        return store_fingerprint(self.graph, machine, durations,
                                 objective)

    def analytic_cost(self, schedule: Schedule, machine,
                      durations: dict) -> float:
        return simulate(self.graph, schedule, machine,
                        durations=durations).makespan

"""The evaluator contract: a memo cache over canonical schedules.

Every backend subclasses :class:`EvaluatorBase` and implements one hook,
``_measure_batch(schedules) -> list[float]``, called only with
canonical-unique cache misses in first-appearance order. The base class
keys its cache on :func:`repro_torch.space.schedule.canonical_key`
(stream-bijection normal form, §III-C2), so each distinct
implementation is measured once, and counts ``cache_hits`` and
``cache_misses``.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.dag import Graph, Schedule
from repro_torch.space.schedule import canonical_key


class EvaluatorBase:
    """Batched, memoized schedule evaluation."""

    backend = "abstract"

    def __init__(self, graph: Graph):
        self.graph = graph
        self._cache: dict[tuple, float] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    def __len__(self) -> int:
        return len(self._cache)

    def _measure_batch(self, schedules: Sequence[Schedule]) -> list[float]:
        """One time per (distinct, uncached) schedule, in order."""
        raise NotImplementedError

    def evaluate_keyed(self, schedules: Sequence[Schedule]
                       ) -> list[tuple[tuple, float]]:
        """(canonical key, time) per schedule, in order; one measurement
        per distinct canonical schedule across the evaluator's life."""
        keys = [canonical_key(s) for s in schedules]
        pending: set[tuple] = set()
        misses: list[Schedule] = []
        miss_keys: list[tuple] = []
        for s, key in zip(schedules, keys):
            if key in self._cache or key in pending:
                continue
            pending.add(key)
            misses.append(s)
            miss_keys.append(key)
        if misses:
            measured = self._measure_batch(misses)
            if len(measured) != len(misses):
                raise RuntimeError(
                    f"{type(self).__name__}._measure_batch returned "
                    f"{len(measured)} results for {len(misses)} schedules")
            for key, t in zip(miss_keys, measured):
                self._cache[key] = float(t)
        out = []
        for key in keys:
            if key in pending:       # first occurrence of a fresh miss
                pending.discard(key)
                self.cache_misses += 1
            else:
                self.cache_hits += 1
            out.append((key, self._cache[key]))
        return out

    def evaluate(self, schedules: Sequence[Schedule]) -> list[float]:
        """Time per schedule, in order (see :meth:`evaluate_keyed`)."""
        return [t for _, t in self.evaluate_keyed(schedules)]

"""Straggler detection: per-rank step-time accounting + slow-rank report.

On a real pod every host records its step wall-time (the bulk-
synchronous step makes per-host timing meaningful: a straggler drags the
collective). The monitor flags ranks persistently slower than
``threshold`` x median and recommends mitigation (evict + elastic
re-mesh, see repro.ft.elastic). Tests feed synthetic timings.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics


@dataclasses.dataclass
class StragglerReport:
    step: int
    median_s: float
    slow_ranks: dict[int, float]  # rank -> seconds


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, window: int = 20,
                 min_observations: int = 5):
        self.threshold = threshold
        self.window = window
        self.min_obs = min_observations
        self._times: dict[int, collections.deque] = {}
        self._last_step = 0

    def record(self, rank: int, step: int, seconds: float) -> None:
        self._times.setdefault(
            rank, collections.deque(maxlen=self.window)).append(seconds)
        self._last_step = max(self._last_step, step)

    def report(self) -> StragglerReport | None:
        means = {r: statistics.fmean(t) for r, t in self._times.items()
                 if len(t) >= self.min_obs}
        if len(means) < 2:
            return None
        med = statistics.median(means.values())
        slow = {r: m for r, m in means.items()
                if m > self.threshold * med}
        if not slow:
            return None
        return StragglerReport(self._last_step, med, slow)

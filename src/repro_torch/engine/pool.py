"""Process-pool evaluation backend: shard cache misses over workers.

Discrete-event simulations of distinct schedules are independent, so a
batch of canonical-unique cache misses shards cleanly over a
``multiprocessing`` pool. Everything stateful stays in the parent —
the memo cache, the ``cache_hits`` / ``cache_misses`` meters, and the (canonical key, draw index) noise
— so a pooled search is **bit-identical** to the serial backend: same
(features, labels, times), same budget accounting, any worker count
(tests/test_torch_analytic.py locks this).

Workers are initialized once with (graph, machine, durations) — the
same precomputed duration table the parent would use, so worker math is
the serial simulator's math — then receive contiguous shards of each
miss batch as compact ``(k, 2, N)`` int32 canonical encodings (the
base class computes them for the cache keys anyway): shipping arrays
instead of pickled ``Schedule`` object trees keeps IPC cost below the
simulation cost it parallelizes. Workers rebuild the schedules and run
the serial discrete-event simulator; the canonical stream relabel is a
bijection, under which the simulator is exactly invariant (columns of
per-stream state permute), so results stay bit-identical to evaluating
the original schedules. Shards are dispatched via ``imap_unordered``
with an index tag — a straggler shard never serializes collection of
the others — and reassembled by index into the first-appearance miss
order the base class expects.

The default start method is ``forkserver`` (falling back to ``spawn``
where unavailable): the parent may hold CUDA state and threads, which
make plain ``fork`` a documented hazard. A worker unpickles its
functions from this module, so it imports :mod:`repro_torch.engine`,
whose ``wallclock`` backend imports torch: each worker pays that
import once, at pool start-up (seconds, against the milliseconds
of a worker without torch), and simulates in plain Python after it. Pass ``start_method="fork"``
explicitly for single-threaded parents where inheriting the loaded
modules is safe and cheapest.

The workers run on the host and take no device. The JAX package's
``repro/engine/pool.py`` with its imports rewritten.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import Sequence

import numpy as np

from repro_torch.core.costmodel import Machine, simulate
from repro_torch.core.dag import BoundOp, Graph, Schedule
from repro_torch.engine.base import EvaluatorBase

_WORKER_STATE: tuple | None = None


def _init_worker(graph: Graph, machine: Machine,
                 durations: dict[str, float]) -> None:
    global _WORKER_STATE
    _WORKER_STATE = (graph, machine, durations, list(graph.ops))


def _simulate_shard(encoded: np.ndarray) -> list[float]:
    graph, machine, durations, names = _WORKER_STATE
    out = []
    for row in encoded:
        items = tuple(
            BoundOp(names[o], None if s < 0 else int(s))
            for o, s in zip(row[0], row[1]))
        out.append(simulate(graph, Schedule(items), machine,
                            durations=durations).makespan)
    return out


def _simulate_shard_indexed(task: tuple[int, np.ndarray]
                            ) -> tuple[int, list[float]]:
    """(shard index, encodings) -> (shard index, makespans).

    The index rides along so shards can be dispatched out of order
    (``imap_unordered``) and still be reassembled exactly.
    """
    idx, encoded = task
    return idx, _simulate_shard(encoded)


class PoolEvaluator(EvaluatorBase):
    """Evaluation backend fanning cache misses out to worker processes.

    ``n_workers=None`` uses the CPU count. Small miss batches (fewer
    than ``2 * min_shard`` schedules, i.e. not enough to give two
    shards a meaningful size) skip the pool entirely — IPC would cost
    more than the simulations. ``close()`` (or use as a context
    manager) tears the pool down; it is also re-created lazily after a
    close, so a closed evaluator still works.
    """

    backend = "pool"

    def __init__(self, graph: Graph, machine: Machine | None = None,
                 noise_sigma: float = 0.0, noise_seed: int = 0,
                 n_workers: int | None = None, min_shard: int = 8,
                 start_method: str | None = None, **base_kwargs):
        super().__init__(graph, machine, noise_sigma, noise_seed,
                         **base_kwargs)
        if self.graph is None:
            raise TypeError(
                "the pool backend shards schedule simulations of a "
                f"Graph; design space {self.space.name!r} has no graph "
                "(use backend='sim' for spaces with an analytic cost, "
                "or 'wallclock' for kernel runners)")
        self.n_workers = n_workers or (os.cpu_count() or 2)
        self.min_shard = max(1, min_shard)
        if start_method is None:
            methods = multiprocessing.get_all_start_methods()
            start_method = "forkserver" if "forkserver" in methods \
                else "spawn"
        self.start_method = start_method
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None:
            ctx = multiprocessing.get_context(self.start_method)
            self._pool = ctx.Pool(
                self.n_workers, initializer=_init_worker,
                initargs=(self.graph, self.machine, self._durations))
        return self._pool

    def _measure_batch(self, schedules: Sequence[Schedule],
                       encoded: np.ndarray | None = None) -> list[float]:
        n = len(schedules)
        if n < self.min_shard * 2 or self.n_workers < 2:
            return _serial_measure(self.graph, self.machine,
                                   self._durations, schedules)
        n_shards = min(self.n_workers, max(2, n // self.min_shard))
        bounds = [n * k // n_shards for k in range(n_shards + 1)]
        shards = [encoded[bounds[k]:bounds[k + 1]]
                  for k in range(n_shards)]
        # imap_unordered instead of the map() barrier: each shard is
        # tagged with its index and collected as it finishes, so one
        # straggler shard no longer serializes result collection —
        # while reassembly by index keeps the output order (and
        # therefore the whole search) bit-identical to serial.
        parts: dict[int, list[float]] = {}
        for idx, part in self._ensure_pool().imap_unordered(
                _simulate_shard_indexed, list(enumerate(shards))):
            parts[idx] = part
        out: list[float] = []
        for idx in range(n_shards):
            out.extend(parts[idx])
        return out

    def close(self) -> None:
        """Graceful teardown: let in-flight shards finish, then reap.

        ``Pool.close()`` + ``join()`` — never ``terminate()`` here,
        which would kill workers mid-shard and lose paid simulations.
        Idempotent; the pool is re-created lazily on next use.
        """
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
        super().close()

    def __del__(self):
        # Last-resort fallback only: at interpreter shutdown a graceful
        # close()+join() may deadlock on already-collected machinery,
        # so terminate() is correct *here* (and only here). Guard
        # everything — modules can be half torn down by the time
        # __del__ runs.
        try:
            pool = getattr(self, "_pool", None)
            if pool is not None:
                pool.terminate()
                pool.join()
                self._pool = None
        except Exception:
            pass


def _serial_measure(graph: Graph, machine: Machine,
                    durations: dict[str, float],
                    schedules: Sequence[Schedule]) -> list[float]:
    return [simulate(graph, s, machine, durations=durations).makespan
            for s in schedules]

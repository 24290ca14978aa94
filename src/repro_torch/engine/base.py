"""The evaluator contract: memo cache, persistent store, budget meters.

Every backend subclasses :class:`EvaluatorBase` and implements one hook,
``_measure_batch(candidates) -> list[float]``, called only with
canonical-unique cache misses in first-appearance order. Everything
search-visible lives in the base class:

  * the memo cache keyed on the space's canonical encoding
    (:meth:`~repro_torch.space.base.DesignSpace.encode_batch`: the
    stream-bijection normal form for schedules, §III-C2, value indices
    for parameter grids) — each distinct candidate is measured once;
  * the optional persistent store (``store=`` a shared
    :class:`~repro_torch.engine.store.EvalStore`, or ``store_path=`` a
    file the evaluator opens and owns): looked up between the memo
    cache and ``_measure_batch`` and written after every measurement,
    so a search against a warmed store replays without measuring;
  * ``cache_hits`` / ``store_hits`` / ``cache_misses`` accounting;
  * salvage: a backend whose batch fails part-way banks the
    measurements it already paid for (:meth:`_salvage_partial`).

The JAX package's ``repro/engine/base.py`` without the analytic
``Machine``, the measurement noise and the telemetry spans.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.core.dag import Graph
from repro_torch.engine.store import EvalStore
from repro_torch.space.base import DesignSpace, as_space


class EvaluatorBase:
    """Batched, memoized candidate evaluation (backend-agnostic layer)."""

    backend = "abstract"

    def __init__(self, graph: "Graph | DesignSpace",
                 store: EvalStore | None = None,
                 store_path: "str | None" = None):
        if store is not None and store_path is not None:
            raise ValueError(
                "pass store= (a shared EvalStore) or store_path= "
                "(a file the evaluator opens and owns), not both")
        self.space = as_space(graph)
        # Schedule spaces expose their graph; param spaces have none.
        self.graph = getattr(self.space, "graph", None)
        self._cache: dict[bytes, float] = {}
        self._salvaged: set[bytes] = set()
        self.cache_hits = 0
        self.store_hits = 0
        self.cache_misses = 0
        self._owns_store = store_path is not None
        self.store = EvalStore(store_path) if store_path is not None \
            else store
        self._fingerprint: bytes | None = None

    def __len__(self) -> int:
        return len(self._cache)

    # -- persistent store --------------------------------------------------
    def objective_key(self) -> str:
        """What quantity ``_measure_batch`` estimates, and on what
        hardware; measuring backends override it so their times never
        share a store address with another objective's."""
        return self.backend

    @property
    def store_fingerprint(self) -> bytes:
        """Content address of this evaluator's measurement semantics
        (the space's fingerprint over the objective key); lazy, so a
        subclass ``__init__`` can finish configuring the objective."""
        if self._fingerprint is None:
            self._fingerprint = self.space.fingerprint(self.objective_key())
        return self._fingerprint

    def fresh_evals(self) -> int:
        """First-time evaluations of distinct candidates: paid
        measurements plus store warm hits."""
        return self.cache_misses + self.store_hits

    def stats(self) -> dict:
        """Cache traffic: {backend, memory_hits, store_hits, misses,
        size, hit_rate}."""
        served = self.cache_hits + self.store_hits
        total = served + self.cache_misses
        return {
            "backend": self.backend,
            "memory_hits": self.cache_hits,
            "store_hits": self.store_hits,
            "misses": self.cache_misses,
            "size": len(self._cache),
            "hit_rate": served / total if total else 0.0,
        }

    # -- the backend hook --------------------------------------------------
    def _measure_batch(self, candidates: Sequence[Any]) -> list[float]:
        """One time per (distinct, uncached) candidate, in order."""
        raise NotImplementedError

    # -- the shared evaluation path ----------------------------------------
    def evaluate_keyed(self, candidates: Sequence[Any]
                       ) -> list[tuple[bytes, float]]:
        """(canonical key, time) per candidate, in order; one measurement
        per distinct canonical candidate across the evaluator's life."""
        if not candidates:
            return []
        keys, _ = self.space.encode_batch(candidates)
        miss_keys: list[bytes] = []
        miss_rows: list[int] = []
        pending: set[bytes] = set()
        warm: set[bytes] = set()     # served by the persistent store
        for b, key in enumerate(keys):
            if key in self._cache or key in pending:
                continue
            if self.store is not None:
                t = self.store.get(self.store_fingerprint, key)
                if t is not None:
                    self._cache[key] = t
                    warm.add(key)
                    continue
            pending.add(key)
            miss_keys.append(key)
            miss_rows.append(b)
        if miss_rows:
            misses = [candidates[b] for b in miss_rows]
            measured = self._measure_batch(misses)
            if len(measured) != len(misses):
                raise RuntimeError(
                    f"{type(self).__name__}._measure_batch returned "
                    f"{len(measured)} results for {len(misses)} "
                    "candidates")
            for key, t in zip(miss_keys, measured):
                self._cache[key] = float(t)
            if self.store is not None:
                self.store.put_many(
                    self.store_fingerprint,
                    [(key, self._cache[key]) for key in miss_keys])

        out: list[tuple[bytes, float]] = []
        for key in keys:
            if key in pending:       # first occurrence of a fresh miss
                pending.discard(key)
                self.cache_misses += 1
            elif key in warm:        # first occurrence of a store hit
                warm.discard(key)
                self.store_hits += 1
            elif key in self._salvaged:
                # A measurement salvaged from an aborted batch was paid
                # but never counted: its first later lookup is a miss.
                self._salvaged.discard(key)
                self.cache_misses += 1
            else:
                self.cache_hits += 1
            out.append((key, self._cache[key]))
        return out

    def evaluate(self, candidates: Sequence[Any]) -> list[float]:
        """Time per candidate, in order (see :meth:`evaluate_keyed`)."""
        return [t for _, t in self.evaluate_keyed(candidates)]

    def _salvage_partial(self, encoded: np.ndarray,
                         times: Sequence[float]) -> None:
        """Bank completed measurements of an aborted ``_measure_batch``.

        The finished ``(encoded row, time)`` pairs land in the memo
        cache — and the persistent store; they were paid for — so a
        retry does not re-measure them. The keys are remembered as
        salvaged so their first later lookup counts as a miss, never as
        a free hit.
        """
        items = []
        for row, t in zip(encoded, times):
            key = row.tobytes()
            self._cache[key] = float(t)
            self._salvaged.add(key)
            items.append((key, float(t)))
        if self.store is not None and items:
            self.store.put_many(self.store_fingerprint, items)

    def close(self) -> None:
        """Release an owned store; idempotent. A store opened by this
        evaluator (``store_path=``) is closed; a shared ``store=``
        stays the caller's."""
        if self._owns_store and self.store is not None:
            self.store.close()
            self.store = None
            self._owns_store = False

    def __enter__(self) -> "EvaluatorBase":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

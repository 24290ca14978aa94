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
    ``store_tag=`` names the program a backend measures (one graph can
    carry different impls and inputs) and goes into the fingerprint;
  * ``cache_hits`` / ``store_hits`` / ``cache_misses`` accounting;
  * measurement noise: with ``noise_sigma`` set, every evaluation draws
    multiplicative Gaussian jitter seeded per **(canonical key, draw
    index)** — *not* from one shared RNG stream — so noisy results are
    a function of what was evaluated, never of batch order, worker
    sharding, or vectorization, and equal the JAX package's draws for
    the same ``noise_seed``;
  * salvage: a backend whose batch fails part-way banks the
    measurements it already paid for (:meth:`_salvage_partial`).

The serial analytic backend (:class:`BatchEvaluator`, registry name
``"sim"``) lives here too: ``vectorized`` and ``pool`` are bit-locked
against it. The analytic backends run the
:mod:`repro_torch.core.costmodel` model under a
:class:`~repro_torch.core.costmodel.Machine` (the H100's by default) in
Python and numpy on the host; they take no device.

Every batch is an ``engine.batch`` telemetry span (:mod:`repro_torch.obs`)
with its memory hits, store hits and misses, and every call of the hook
an ``engine.measure`` span inside it; :meth:`EvaluatorBase.evaluate_batch`
packs a batch's results as the :class:`EvalBatch` record the search
driver streams to its sinks. The JAX package's ``repro/engine/base.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Any, Iterator, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import Machine
from repro_torch.core.dag import Graph
from repro_torch.engine.store import EvalStore
from repro_torch.space.base import DesignSpace, as_space


def _noise_gauss(noise_seed: int, key: bytes, draw: int) -> float:
    """A standard-normal draw seeded purely by what is being evaluated.

    ``repr`` of a canonical cache key (bytes) is deterministic, and
    blake2b is stable across processes and ``PYTHONHASHSEED`` values —
    so pooled, vectorized, and permuted evaluation all see the
    identical noise for the j-th draw of a given implementation.
    """
    payload = repr((noise_seed, key, draw)).encode()
    seed = int.from_bytes(
        hashlib.blake2b(payload, digest_size=8).digest(), "big")
    return random.Random(seed).gauss(0.0, 1.0)


@dataclasses.dataclass
class EvalBatch:
    """One evaluated proposal batch — the record streamed to sinks.

    Every round of the search driver (:mod:`repro_torch.driver`) yields
    one :class:`EvalBatch` with aligned ``schedules`` (candidates) /
    canonical ``keys`` / ``times``, exactly the ``(key, time)`` pairs
    :meth:`EvaluatorBase.evaluate_keyed` returns, in proposal order
    (duplicates included — run-level dedup is the consumer's choice,
    not the evaluator's). Iterating yields ``(candidate, key, time)``
    triples.
    """

    schedules: list[Any]
    keys: list[bytes]
    times: np.ndarray                    # float64, aligned

    def __len__(self) -> int:
        return len(self.schedules)

    def __iter__(self) -> Iterator[tuple[Any, bytes, float]]:
        return iter(zip(self.schedules, self.keys, self.times))


class EvaluatorBase:
    """Batched, memoized candidate evaluation (backend-agnostic layer)."""

    backend = "abstract"

    def __init__(self, graph: "Graph | DesignSpace",
                 machine: Machine | None = None,
                 noise_sigma: float = 0.0, noise_seed: int = 0,
                 store: EvalStore | None = None,
                 store_path: "str | None" = None,
                 store_tag: str = ""):
        if store is not None and store_path is not None:
            raise ValueError(
                "pass store= (a shared EvalStore) or store_path= "
                "(a file the evaluator opens and owns), not both")
        self.space = as_space(graph)
        # Schedule spaces expose their graph; param spaces have none.
        self.graph = getattr(self.space, "graph", None)
        self.machine = machine or Machine()
        self.noise_sigma = noise_sigma
        self.noise_seed = noise_seed
        self._noise_draws: dict[bytes, int] = {}
        self._durations = self.space.durations(self.machine)
        self._cache: dict[bytes, float] = {}
        self._salvaged: set[bytes] = set()
        self.cache_hits = 0
        self.store_hits = 0
        self.cache_misses = 0
        self._owns_store = store_path is not None
        self.store = EvalStore(store_path) if store_path is not None \
            else store
        self.store_tag = store_tag
        self._fingerprint: bytes | None = None

    def __len__(self) -> int:
        return len(self._cache)

    # -- persistent store --------------------------------------------------
    def objective_key(self) -> str:
        """What quantity ``_measure_batch`` estimates.

        The bit-identical analytic family (sim/vectorized/pool) shares
        ``"analytic"`` on purpose — their stored times are
        interchangeable, so they warm-start each other. Measuring
        backends override it (the quantity, the card, the protocol, the
        kernels' build) so their times never share a store address with
        another objective's.
        """
        return "analytic"

    @property
    def store_fingerprint(self) -> bytes:
        """Content address of this evaluator's measurement semantics
        (the space's fingerprint over the machine, the per-op durations,
        the objective key and the ``store_tag``, when one is set); lazy,
        so a subclass ``__init__`` can finish configuring the
        objective."""
        if self._fingerprint is None:
            objective = self.objective_key()
            if self.store_tag:
                objective += f":{self.store_tag}"
            self._fingerprint = self.space.fingerprint(
                self.machine, self._durations, objective)
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
    def _measure_batch(self, candidates: Sequence[Any],
                       encoded: np.ndarray | None = None) -> list[float]:
        """One time per (distinct, uncached) candidate, in order.

        ``encoded`` is the matching canonical encoding rows from the
        space's ``encode_batch`` (``(K, 2, N)`` int32 for schedule
        spaces, ``(K, D)`` value indices for parameter spaces) —
        backends that simulate in array form use it to skip
        re-encoding; others ignore it.
        """
        raise NotImplementedError

    # -- the shared evaluation path ----------------------------------------
    def _noisy(self, key: bytes, t: float) -> float:
        if not self.noise_sigma:
            return t
        draw = self._noise_draws.get(key, 0)
        self._noise_draws[key] = draw + 1
        g = _noise_gauss(self.noise_seed, key, draw)
        return t * max(0.1, 1.0 + self.noise_sigma * g)

    def evaluate_keyed(self, candidates: Sequence[Any]
                       ) -> list[tuple[bytes, float]]:
        """(canonical key, time) per candidate, in order; one measurement
        per distinct canonical candidate across the evaluator's life."""
        if not candidates:
            return []
        batch_span = obs.span("engine.batch", backend=self.backend,
                              n=len(candidates))
        batch_span.__enter__()
        hits0, store0 = self.cache_hits, self.store_hits
        misses0 = self.cache_misses
        try:
            out = self._evaluate_keyed(candidates)
        finally:
            batch_span.set(
                memory_hits=self.cache_hits - hits0,
                store_hits=self.store_hits - store0,
                misses=self.cache_misses - misses0,
                noise_draws=len(candidates) if self.noise_sigma else 0)
            batch_span.__exit__(None, None, None)
        return out

    def _evaluate_keyed(self, candidates: Sequence[Any]
                        ) -> list[tuple[bytes, float]]:
        keys, encoded = self.space.encode_batch(candidates)
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
            with obs.span("engine.measure", backend=self.backend,
                          n=len(misses)):
                measured = self._measure_batch(misses, encoded[miss_rows])
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
            out.append((key, self._noisy(key, self._cache[key])))
        return out

    def evaluate(self, candidates: Sequence[Any]) -> list[float]:
        """Time per candidate, in order (see :meth:`evaluate_keyed`)."""
        return [t for _, t in self.evaluate_keyed(candidates)]

    def evaluate_batch(self, candidates: Sequence[Any]) -> EvalBatch:
        """One :class:`EvalBatch` record for ``candidates``: the values,
        cache, meters and noise of :meth:`evaluate_keyed`, packed as the
        record the search driver hands to its sinks."""
        keyed = self.evaluate_keyed(candidates)
        return EvalBatch(
            schedules=list(candidates),
            keys=[k for k, _ in keyed],
            times=np.asarray([t for _, t in keyed], dtype=np.float64))

    def evaluate_one(self, candidate: Any) -> float:
        return self.evaluate([candidate])[0]

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
        """Release backend resources (worker pools, an owned store);
        idempotent. A store opened by this evaluator (``store_path=``)
        is closed; a shared ``store=`` stays the caller's."""
        if self._owns_store and self.store is not None:
            self.store.close()
            self.store = None
            self._owns_store = False

    def __enter__(self) -> "EvaluatorBase":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BatchEvaluator(EvaluatorBase):
    """The serial reference backend: one analytic-model evaluation per
    canonical-unique candidate (a discrete-event simulation for
    schedule spaces, the space's cost function otherwise), on the
    host."""

    backend = "sim"

    def _measure_batch(self, candidates: Sequence[Any],
                       encoded: np.ndarray | None = None) -> list[float]:
        return [self.space.analytic_cost(c, self.machine, self._durations)
                for c in candidates]

"""Streaming result sinks: consume evaluated batches as they land.

``SearchResult.dataset()`` re-featurizes the whole deduplicated
candidate list whenever the rules pipeline runs. Sinks fold it instead:
the :class:`~repro_torch.driver.driver.
SearchDriver` streams every evaluated :class:`~repro_torch.engine.base.
EvalBatch` (plus the run-level freshness mask) to each attached sink
*during* the search, so by the time the search returns, the dataset is
already folded.

``dataset`` — :class:`DatasetSink`
    Folds each batch's fresh (first-seen canonical) schedules into an
    incremental :class:`~repro_torch.core.features.FeatureBasis` (schedules
    are sync-expanded exactly once, never re-featurized) and an
    incremental time histogram. ``dataset()`` then emits the same
    ``(features, labels, times)`` triple ``SearchResult.dataset()``
    computes from scratch — byte-identical, locked by test — and
    ``distill()`` hands the streamed matrix straight to
    :func:`repro_torch.rules.distill` (``features=``), skipping the
    re-featurization pass entirely.

``histogram`` — :class:`HistogramSink`
    The out-of-core variant: stores only compact canonical encodings
    and folded count histograms — never a ``(rows x features)``
    matrix — and ``distill()`` trains the design-rule tree blockwise
    through :class:`repro_torch.rules.trees.HistogramGrower`, bit-identical
    to the in-memory path. Sinks from sharded hosts ``merge()``.

``trace`` — :class:`TraceSink`
    Records one row per driver round (canonical keys chosen, fresh
    count, running best) — the determinism probe used by the
    cross-backend acquisition tests and the benchmark race logs.

Sinks implement one method::

    consume(batch: EvalBatch, fresh: np.ndarray) -> None

where ``fresh[i]`` marks the first occurrence of ``batch.keys[i]``
within the driver run (the same dedup that builds
``SearchResult.schedules``). Registered factories are constructed as
``factory(graph, **kwargs)`` via :func:`make_sink`.

The JAX package's ``repro/driver/sinks.py`` with its imports rewritten;
on the card the batches hold measured times, so a sink folds what the
card measured.
"""
from __future__ import annotations

import math
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.dag import Graph, Schedule
from repro_torch.core.features import (DegenerateFeatureSpaceError,
                                       FeatureMatrix)
from repro_torch.engine.base import EvalBatch
from repro_torch.space.base import DesignSpace, as_space


@runtime_checkable
class Sink(Protocol):
    """Consumer of evaluated batches streamed by the search driver."""

    def consume(self, batch: EvalBatch, fresh: np.ndarray) -> None:
        """Fold one evaluated batch (with run-level freshness mask)."""
        ...


class StreamingHistogram:
    """Fixed-width counts over a range that doubles on overflow.

    The incremental form of ``np.histogram``: ``add`` folds a batch
    into ``2 * half_bins`` equal-width bins spanning ``[0, hi)``; when
    a value lands past ``hi`` the range doubles and adjacent bin pairs
    merge (counts are preserved exactly), so the memory footprint is
    constant no matter how many observations stream through. This is
    the label-histogram seed for out-of-core distillation: class
    boundaries can be estimated from the folded counts without holding
    every observation.

    ``hi`` is always a power of two (the smallest strictly above the
    largest value seen), so it is a pure function of that maximum —
    independent of batch order or sharding — and any two histograms'
    ranges nest by exact doublings. That is what makes :meth:`merge`
    associative, commutative, and bin-for-bin equal to single-stream
    ``add`` of the concatenated observations (hypothesis-locked in
    tests/test_torch_driver.py).
    """

    def __init__(self, half_bins: int = 128):
        if half_bins < 1:
            raise ValueError("half_bins must be >= 1")
        self.n_bins = 2 * half_bins
        self.counts = np.zeros(self.n_bins, dtype=np.int64)
        self.hi = 0.0                      # upper edge; 0 = no data yet

    def add(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return
        if np.any(v < 0.0):
            raise ValueError("times must be non-negative")
        vmax = float(v.max())
        if self.hi == 0.0:
            # Smallest power of two strictly above vmax (frexp gives
            # vmax = m * 2**e with m in [0.5, 1), so 2**e > vmax).
            self.hi = math.ldexp(1.0, math.frexp(vmax)[1]) \
                if vmax > 0.0 else 1.0
        while vmax >= self.hi:
            # Doubling merges adjacent bin pairs: counts are preserved
            # exactly, and because the doubled edges coincide with
            # every second old edge (scaling by 2 is exact in binary
            # floating point), the merged counts are exactly what
            # np.histogram would produce over the new edges.
            self.counts = (self.counts[0::2] + self.counts[1::2])
            self.counts = np.concatenate(
                [self.counts, np.zeros(self.n_bins // 2, np.int64)])
            self.hi *= 2.0
        idx = np.minimum((v / self.hi * self.n_bins).astype(np.int64),
                         self.n_bins - 1)
        # np.histogram's boundary correction: the scaled floor can land
        # one bin off when v sits within a rounding error of an edge;
        # nudge against the actual edges so counts match np.histogram
        # on edges() bin for bin.
        edges = self.edges()
        idx[v < edges[idx]] -= 1
        idx[(v >= edges[idx + 1]) & (idx != self.n_bins - 1)] += 1
        np.add.at(self.counts, idx, 1)

    @property
    def n(self) -> int:
        return int(self.counts.sum())

    def edges(self) -> np.ndarray:
        """Bin edges, ``np.histogram`` convention (n_bins + 1 values)."""
        return np.linspace(0.0, self.hi, self.n_bins + 1)

    def _rebin(self, counts: np.ndarray, hi: float,
               target: float) -> np.ndarray:
        """Counts rebinned to a larger power-of-two range (exact —
        each doubling merges adjacent pairs, see :meth:`add`)."""
        counts = counts.copy()
        while hi < target:
            counts = counts[0::2] + counts[1::2]
            counts = np.concatenate(
                [counts, np.zeros(self.n_bins // 2, np.int64)])
            hi *= 2.0
        if hi != target:
            raise ValueError(
                f"ranges do not nest: hi={hi} vs target={target}")
        return counts

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold another histogram in (sharded hosts; in place).

        Both ranges double up to the larger one and the counts add —
        exactly the histogram single-stream ``add`` of both hosts'
        observations would have produced, in any merge order, because
        ``hi`` is a power-of-two function of the maximum value seen.
        """
        if not isinstance(other, StreamingHistogram):
            raise TypeError(f"expected StreamingHistogram, got "
                            f"{type(other).__name__}")
        if other.n_bins != self.n_bins:
            raise ValueError(
                f"cannot merge {other.n_bins}-bin histogram into "
                f"{self.n_bins}-bin histogram")
        if other.hi == 0.0:
            return self
        if self.hi == 0.0:
            self.hi = other.hi
            self.counts = other.counts.copy()
            return self
        target = max(self.hi, other.hi)
        self.counts = (self._rebin(self.counts, self.hi, target)
                       + other._rebin(other.counts, other.hi, target))
        self.hi = target
        return self


class _CanonicalKeySet:
    """Vectorized sink-lifetime dedup over canonical cache keys.

    Keys are fixed-width byte strings (canonical encoding rows), so
    membership is numpy ``S``-dtype array work instead of a Python set
    probe per element: the seen set is one sorted array (searchsorted
    membership) plus small unsorted pending chunks (``np.isin``),
    compacted geometrically so the amortized cost per batch stays
    O(batch · log seen).
    """

    def __init__(self):
        self._sorted: np.ndarray | None = None     # sorted S-dtype keys
        self._pending: list[np.ndarray] = []       # recent, unsorted
        self._n_pending = 0

    def __len__(self) -> int:
        n = 0 if self._sorted is None else self._sorted.size
        return n + self._n_pending

    def _compact(self) -> None:
        parts = ([] if self._sorted is None else [self._sorted]) \
            + self._pending
        self._sorted = np.sort(np.concatenate(parts))
        self._pending = []
        self._n_pending = 0

    def filter_new(self, keys, fresh: np.ndarray) -> np.ndarray:
        """Indices of ``keys`` that are fresh, unseen, and first within
        the batch (first-appearance order), then marks them seen."""
        arr = np.asarray(keys, dtype=np.bytes_)
        if arr.size == 0:
            return np.zeros(0, dtype=np.int64)
        if self._sorted is not None \
                and arr.dtype.itemsize != self._sorted.dtype.itemsize:
            raise ValueError(
                f"canonical keys must be fixed-width: got "
                f"{arr.dtype} vs seen {self._sorted.dtype}")
        new = np.asarray(fresh, dtype=bool).copy()
        if self._sorted is not None and self._sorted.size:
            pos = np.searchsorted(self._sorted, arr)
            pos_c = np.minimum(pos, self._sorted.size - 1)
            new &= self._sorted[pos_c] != arr
        for chunk in self._pending:
            new &= ~np.isin(arr, chunk)
        # First occurrence within the batch: the driver's fresh mask
        # already dedups within a run, but a sink fed raw keys (merge)
        # must not admit an intra-batch duplicate twice.
        _, first = np.unique(arr, return_index=True)
        keep = np.zeros(arr.size, dtype=bool)
        keep[first] = True
        new &= keep
        idx = np.flatnonzero(new)
        if idx.size:
            self._pending.append(arr[idx])
            self._n_pending += idx.size
            n_sorted = 0 if self._sorted is None else self._sorted.size
            if self._n_pending * 4 >= max(n_sorted, 256):
                self._compact()
        return idx


class DatasetSink:
    """Incremental ``(features, labels, times)`` accumulator.

    Mirrors the ``SearchResult`` dedup contract — the first observation
    per canonical schedule, in first-appearance order — so
    :meth:`dataset` is byte-identical to ``SearchResult.dataset()``
    while featurizing each schedule exactly once, the round it arrives.
    """

    def __init__(self, graph: "Graph | DesignSpace",
                 half_bins: int = 128):
        self.space = as_space(graph)
        self.graph = getattr(self.space, "graph", None)
        self.basis = self.space.feature_basis()
        self.schedules: list[Schedule] = []
        self.times: list[float] = []
        self.histogram = StreamingHistogram(half_bins=half_bins)
        self.n_consumed = 0                # every evaluation, dups too
        self._seen = _CanonicalKeySet()    # sink-lifetime dedup
        self._matrix_cache: FeatureMatrix | None = None
        self._matrix_rows = -1

    def consume(self, batch: EvalBatch, fresh: np.ndarray) -> None:
        self.n_consumed += len(batch)
        # The fresh mask is *per driver run*; the sink keeps its own
        # canonical-key set so one sink fed by several runs (e.g. over
        # a shared memoized evaluator) still holds each implementation
        # exactly once.
        idx = self._seen.filter_new(batch.keys, fresh)
        if idx.size == 0:
            return
        self._matrix_cache = None
        new = [batch.schedules[i] for i in idx]
        self.basis.add(new)
        self.schedules.extend(new)
        t_new = np.asarray(batch.times)[idx]
        self.times.extend(float(t) for t in t_new)
        self.histogram.add(t_new)

    # -- the streamed corpus -------------------------------------------
    def times_array(self) -> np.ndarray:
        return np.asarray(self.times, dtype=np.float64)

    def matrix(self) -> FeatureMatrix:
        """Constant-pruned feature matrix of everything streamed so far.

        Same contract as :func:`repro_torch.core.features.featurize`
        (including :class:`DegenerateFeatureSpaceError` on a corpus
        with no discriminating features) — but the expansion work was
        already paid batch by batch, and the pruning pass is cached
        per corpus length (``distill()`` then ``dataset()`` on an
        unchanged corpus prunes once, not twice; ``consume``
        invalidates).
        """
        if self._matrix_cache is not None \
                and self._matrix_rows == len(self.schedules):
            return self._matrix_cache
        fm = self.basis.matrix()
        if not fm.features:
            raise DegenerateFeatureSpaceError(
                f"streamed corpus of {len(self.schedules)} schedule(s) "
                "has no discriminating features after constant-column "
                "pruning; at least 2 distinct schedules are required")
        self._matrix_cache = fm
        self._matrix_rows = len(self.schedules)
        return fm

    def dataset(self):
        """(features, labels, times) — ``SearchResult.dataset()`` shape."""
        from repro_torch.rules.labels import label_times
        times = self.times_array()
        return self.matrix(), label_times(times), times

    def distill(self, **kwargs):
        """:func:`repro_torch.rules.distill` on the streamed corpus.

        Passes the incrementally-built matrix via ``features=`` so the
        rules pipeline never re-featurizes the schedule list.
        """
        from repro_torch.rules.pipeline import distill
        return distill(self, features=self.matrix(), **kwargs)


class HistogramSink:
    """Out-of-core corpus accumulator: compact encodings + count
    histograms, never a ``(rows x features)`` matrix.

    Per fresh (first-seen canonical) evaluation the sink stores only
    the canonical int32 encoding row (the cache-key bytes
    reinterpreted — ``(2, N)`` order/stream form for schedule spaces,
    value indices for parameter grids), the observed time, and folds
    the time into the :class:`StreamingHistogram`; the item universe
    that names candidate features is tracked names-only through the
    space's ``feature_universe()``. Memory is O(rows x encoding) +
    O(features) — for the paper's spaces roughly 50x under the dense
    feature matrix — and :meth:`distill` runs the labels->tree pass
    blockwise in O(features x bins) extra memory via
    :class:`repro_torch.rules.trees.HistogramGrower`, producing the same
    report bit for bit.

    The sink doubles as the corpus handle ``repro_torch.rules.distill``
    consumes through its ``histograms=`` seam: ``n_rows`` /
    ``times`` / ``feature_list()`` / ``value_grids()`` / ``blocks()``.
    Blocks are decoded (``decode_batch``) and featurized
    (``apply_features``) on the fly, ``block_rows`` rows at a time —
    every tree level re-pays that featurization, which is the
    memory/CPU trade the out-of-core path makes. :meth:`merge` folds
    another host's sink in (sharded search), with the same
    first-appearance dedup the driver applies.
    """

    def __init__(self, graph: "Graph | DesignSpace",
                 half_bins: int = 128, block_rows: int = 4096):
        if block_rows < 1:
            raise ValueError("block_rows must be >= 1")
        self.space = as_space(graph)
        self.graph = getattr(self.space, "graph", None)
        self.universe = self.space.feature_universe()
        self.block_rows = int(block_rows)
        self.times: list[float] = []
        self.histogram = StreamingHistogram(half_bins=half_bins)
        self.n_consumed = 0
        self._seen = _CanonicalKeySet()
        self._rows: list[np.ndarray] = []  # flat int32 canonical rows
        self._pruned: tuple[list, list[np.ndarray]] | None = None
        self._pruned_rows = -1

    def consume(self, batch: EvalBatch, fresh: np.ndarray) -> None:
        self.n_consumed += len(batch)
        idx = self._seen.filter_new(batch.keys, fresh)
        if idx.size == 0:
            return
        enc = [np.frombuffer(batch.keys[i], dtype=np.int32)
               for i in idx]
        # Universe names come from the *decoded* canonical candidates,
        # so stored rows and candidate features stay consistent even if
        # a caller ever feeds non-canonical schedules.
        self.universe.add(self.space.decode_batch(np.stack(enc)))
        self._rows.extend(enc)
        t_new = np.asarray(batch.times)[idx]
        self.times.extend(float(t) for t in t_new)
        self.histogram.add(t_new)
        self._pruned = None

    # -- the streamed corpus (the ``histograms=`` protocol) ---------------
    @property
    def n_rows(self) -> int:
        return len(self._rows)

    def times_array(self) -> np.ndarray:
        return np.asarray(self.times, dtype=np.float64)

    def _encoded_blocks(self):
        for lo in range(0, len(self._rows), self.block_rows):
            yield np.stack(self._rows[lo:lo + self.block_rows])

    def _discover(self) -> tuple[list, list[np.ndarray]]:
        """(pruned features, per-feature value grids), cached per corpus
        length: one blockwise min/max fold over the candidate features
        replaces ``FeatureBasis.matrix()``'s in-memory pruning."""
        if self._pruned is not None \
                and self._pruned_rows == len(self._rows):
            return self._pruned
        cands = self.universe.candidate_features()
        lo = hi = None
        for enc in self._encoded_blocks():
            X = self.space.apply_features(
                self.space.decode_batch(enc), cands)
            if X.size and (X.min() < 0 or X.max() > 1):
                raise ValueError(
                    "histogram sinks require binary 0/1 features")
            bl, bh = X.min(axis=0), X.max(axis=0)
            lo = bl if lo is None else np.minimum(lo, bl)
            hi = bh if hi is None else np.maximum(hi, bh)
        keep = np.flatnonzero(lo != hi) if lo is not None \
            else np.zeros(0, dtype=np.int64)
        if keep.size == 0:
            raise DegenerateFeatureSpaceError(
                f"streamed corpus of {len(self._rows)} "
                "implementation(s) has no discriminating features "
                "after constant-column pruning; at least 2 distinct "
                "candidates are required")
        feats = [cands[j] for j in keep]
        grids = [np.array([0.0, 1.0]) for _ in feats]
        self._pruned = (feats, grids)
        self._pruned_rows = len(self._rows)
        return self._pruned

    def feature_list(self) -> list:
        """Pruned candidate features — matches what
        ``DatasetSink.matrix().features`` lists on an equal corpus."""
        return self._discover()[0]

    def value_grids(self) -> list[np.ndarray]:
        """Per-feature value grids for :class:`~repro_torch.rules.trees.
        ClassCountHistogram` (binary 0/1 indicators here)."""
        return self._discover()[1]

    def blocks(self):
        """Feature blocks (int8, ``block_rows`` rows each) over the
        pruned features — decoded and featurized on the fly."""
        feats, _ = self._discover()
        for enc in self._encoded_blocks():
            yield self.space.apply_features(
                self.space.decode_batch(enc), feats)

    def distill(self, **kwargs):
        """:func:`repro_torch.rules.distill` on the streamed corpus, through
        the out-of-core ``histograms=`` seam — the feature matrix is
        never materialized."""
        from repro_torch.rules.pipeline import distill
        return distill(self, histograms=self, **kwargs)

    def merge(self, other: "HistogramSink") -> "HistogramSink":
        """Fold another host's streamed corpus in (in place).

        First-appearance dedup against ``self``: only times of rows
        unseen here fold into the doubling histogram, so the merged
        sink equals one sink that consumed both hosts' batches in
        sequence. ``StreamingHistogram.merge`` stays for genuinely
        disjoint shards; here overlap must not double-count.
        """
        if not isinstance(other, HistogramSink):
            raise TypeError(f"expected HistogramSink, got "
                            f"{type(other).__name__}")
        if self.space.name != other.space.name:
            raise ValueError(
                f"cannot merge sink over {other.space.name!r} into "
                f"sink over {self.space.name!r}")
        self.n_consumed += other.n_consumed
        if not other._rows:
            return self
        keys = [r.tobytes() for r in other._rows]
        idx = self._seen.filter_new(keys,
                                    np.ones(len(keys), dtype=bool))
        if idx.size:
            enc = [other._rows[i] for i in idx]
            self.universe.add(self.space.decode_batch(np.stack(enc)))
            self._rows.extend(enc)
            t_new = np.asarray(other.times)[idx]
            self.times.extend(float(t) for t in t_new)
            self.histogram.add(t_new)
            self._pruned = None
        return self


class TraceSink:
    """Per-round trace: what was chosen, what was fresh, running best.

    ``rounds[i]`` is a dict with ``round`` (the 0-based round index —
    the driver calls each sink exactly once per round, so this is the
    same numbering the driver's ``driver.round`` telemetry spans
    carry), ``keys`` (canonical cache keys of the round's batch, in
    proposal order), ``n_fresh``, and ``best`` (the minimum time
    observed up to and including that round). Canonical keys make
    traces comparable across evaluation backends — the cross-backend
    determinism tests assert exact equality of the key streams.
    """

    def __init__(self, graph: "Graph | DesignSpace | None" = None):
        self.rounds: list[dict] = []
        self._best = float("inf")

    def consume(self, batch: EvalBatch, fresh: np.ndarray) -> None:
        if len(batch):
            self._best = min(self._best, float(np.min(batch.times)))
        self.rounds.append({
            "round": len(self.rounds),
            "keys": tuple(batch.keys),
            "n_fresh": int(np.count_nonzero(fresh)),
            "best": self._best,
        })

    def key_stream(self, rounds: bool = False) -> tuple:
        """All chosen canonical keys, round-concatenated (for equality).

        The default shape is unchanged (a flat tuple of keys);
        ``rounds=True`` pairs every key with its round index —
        ``((round, key), ...)`` — so consumers can line the choice
        stream up against round-indexed telemetry spans.
        """
        if rounds:
            return tuple((r["round"], k)
                         for r in self.rounds for k in r["keys"])
        return tuple(k for r in self.rounds for k in r["keys"])


class TelemetrySink:
    """The obs-backed sink: stream per-round markers into the active
    telemetry registry (:mod:`repro_torch.obs`).

    Emits one ``sink.round`` instant event per consumed batch (with
    the same 0-based round numbering as :class:`TraceSink` and the
    driver's ``driver.round`` spans — each sink sees exactly one
    ``consume`` per round), bumps the ``sink.consumed`` /
    ``sink.fresh`` counters, and tracks the running best as the
    ``sink.best`` gauge. Registered as ``"telemetry"`` in
    :data:`SINKS`, so ``SearchDriver(..., sinks=["telemetry"])`` puts
    round markers in a trace without any bespoke sink code. A no-op
    under the disabled default registry.
    """

    def __init__(self, graph: "Graph | DesignSpace | None" = None):
        self.n_rounds = 0
        self._best = float("inf")

    def consume(self, batch: EvalBatch, fresh: np.ndarray) -> None:
        from repro_torch import obs
        tel = obs.current()
        if tel.enabled:
            n_fresh = int(np.count_nonzero(fresh))
            if len(batch):
                self._best = min(self._best,
                                 float(np.min(batch.times)))
            tel.event("sink.round", round=self.n_rounds, n=len(batch),
                      n_fresh=n_fresh,
                      best=self._best if self._best < float("inf")
                      else None)
            tel.counter("sink.consumed").add(len(batch))
            tel.counter("sink.fresh").add(n_fresh)
            if self._best < float("inf"):
                tel.gauge("sink.best").set(self._best)
        self.n_rounds += 1


# -- the registry -------------------------------------------------------------

SINKS: dict[str, Callable[..., Sink]] = {}
"""Sink factories: name -> ``factory(graph, **kwargs) -> sink``."""


def register_sink(name: str, factory: Callable[..., Sink]) -> None:
    """Add a sink factory to the :data:`SINKS` registry."""
    SINKS[name] = factory


register_sink("dataset", DatasetSink)
register_sink("histogram", HistogramSink)
register_sink("trace", TraceSink)
register_sink("telemetry", TelemetrySink)


def make_sink(sink: str, graph: "Graph | DesignSpace",
              **kwargs) -> Sink:
    """Construct a sink by registry name."""
    try:
        factory = SINKS[sink]
    except KeyError:
        raise ValueError(
            f"unknown sink {sink!r}; registered: {sorted(SINKS)}"
        ) from None
    return factory(graph, **kwargs)

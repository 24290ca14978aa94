"""Sequence-to-vector feature transformation (paper §IV-B).

For a set of expanded schedules (original ops + inserted sync ops):

  * one *ordering* feature per ordered pair (u, v) of items:
      1 if u appears before v in the expanded sequence, else 0
    (only (u, v) with u < v lexicographically are kept; the reverse pair is
    its complement and adds no information);
  * one *stream* feature per unordered pair of GPU ops:
      1 if both are bound to the same stream, else 0.

Features that take the same value in every schedule (e.g. DAG-implied
orderings) are dropped — they have no discriminatory power.

The matrix fill is vectorized: per schedule we store only the positions
of its expanded items (one integer per item), and the full
(schedules × pairs) matrix is produced by numpy index operations over a
position matrix — no per-feature Python loop. :class:`FeatureBasis`
absorbs new schedules without re-expanding the corpus (the online
surrogates train on it), and :class:`FeatureUniverse` tracks the
candidate features by name only (the out-of-core histogram sink).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import Graph, Schedule
from repro_torch.core.sync import expanded_names


@dataclasses.dataclass(frozen=True)
class Feature:
    kind: str  # 'order' | 'stream'
    u: str
    v: str

    def describe(self, value: int) -> str:
        """Human-readable rule text for this feature taking ``value``."""
        if self.kind == "order":
            return (f"{self.u} before {self.v}" if value
                    else f"{self.v} before {self.u}")
        return (f"{self.u} same stream as {self.v}" if value
                else f"{self.u} different stream than {self.v}")


@dataclasses.dataclass
class FeatureMatrix:
    features: list[Feature]
    X: np.ndarray  # (n_schedules, n_features) int8

    def names(self) -> list[str]:
        return [f"{f.kind}:{f.u}<{f.v}" for f in self.features]


class DegenerateFeatureSpaceError(ValueError):
    """Raised when a corpus has no discriminating features.

    After constant-column pruning, a corpus of zero or one *distinct*
    schedules has an empty feature matrix; the downstream learning stack
    (``algorithm1``) cannot split on nothing, so the error is raised
    here, at the point where the cause is nameable.
    """


class FeatureBasis:
    """Incremental featurizer over a growing schedule corpus.

    ``add`` absorbs schedules by expanding them once (sync insertion,
    :func:`repro_torch.core.sync.expanded_names`) and caching only their item
    positions and stream bindings; ``matrix`` then materializes the
    pruned :class:`FeatureMatrix` for everything absorbed so far with
    vectorized index ops. Absorbing more schedules never re-expands the
    existing corpus — items first seen in later schedules are simply
    absent (feature value 0) in earlier rows, exactly as the pairwise
    definition above prescribes.
    """

    # Position sentinel for "item absent from this schedule": larger
    # than any real position, so ``absent < anything`` is never true.
    _ABSENT = np.int32(2 ** 30)

    def __init__(self, graph: Graph):
        self.graph = graph
        self.gpu = sorted(graph.gpu_ops())
        self._gpu_col = {n: i for i, n in enumerate(self.gpu)}
        self._universe: dict[str, int] = {}  # item name -> column id
        # Per absorbed schedule: universe column ids in sequence order
        # (the position of an item IS its index in that array) and the
        # stream binding per GPU op (row into the stream matrix).
        self._rows: list[np.ndarray] = []
        self._streams: list[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._rows)

    def add(self, schedules: list[Schedule]) -> "FeatureBasis":
        uni = self._universe
        for s in schedules:
            names = expanded_names(self.graph, s)
            self._rows.append(np.asarray(
                [uni.setdefault(n, len(uni)) for n in names],
                dtype=np.int32))
            srow = np.full(len(self.gpu), -1, dtype=np.int32)
            for it in s.items:
                if it.stream is not None:
                    j = self._gpu_col.get(it.name)
                    if j is not None:
                        srow[j] = it.stream
            self._streams.append(srow)
        return self

    # -- vectorized matrix construction -----------------------------------
    def _position_matrix(self) -> tuple[list[str], np.ndarray]:
        """(sorted universe, (n_schedules, |universe|) position matrix).

        Entry [i, u] is the position of item u in schedule i's expanded
        sequence, or the ``_ABSENT`` sentinel if it does not occur.
        """
        names = sorted(self._universe)
        remap = np.empty(len(self._universe), dtype=np.int64)
        for sorted_col, n in enumerate(names):
            remap[self._universe[n]] = sorted_col
        P = np.full((len(self._rows), len(names)), self._ABSENT,
                    dtype=np.int32)
        for i, cols in enumerate(self._rows):
            P[i, remap[cols]] = np.arange(cols.size, dtype=np.int32)
        return names, P

    def _raw(self) -> tuple[list[Feature], np.ndarray]:
        """All candidate features (order pairs, then stream pairs) and
        their unpruned value matrix."""
        names, P = self._position_matrix()
        n_sched = len(self._rows)
        iu, iv = np.triu_indices(len(names), k=1)
        # A[i, a, b] = "a before b in schedule i, both present": the
        # absent sentinel is never < anything (so an absent a never
        # fires), and absent b columns are masked off. One contiguous
        # (n, U, U) broadcast beats two (n, pairs) int32 gathers.
        A = P[:, :, None] < P[:, None, :]
        A &= (P != self._ABSENT)[:, None, :]
        X_order = A[:, iu, iv]

        S = (np.vstack(self._streams) if self._streams
             else np.empty((0, len(self.gpu)), dtype=np.int32))
        gu, gv = np.triu_indices(len(self.gpu), k=1)
        X_stream = S[:, gu] == S[:, gv]

        feats = [Feature("order", names[a], names[b])
                 for a, b in zip(iu, iv)]
        feats += [Feature("stream", self.gpu[a], self.gpu[b])
                  for a, b in zip(gu, gv)]
        X = np.concatenate([X_order, X_stream], axis=1) if feats else \
            np.zeros((n_sched, 0), dtype=bool)
        return feats, X

    def matrix(self) -> FeatureMatrix:
        """Constant-pruned feature matrix for the absorbed corpus."""
        feats, X = self._raw()
        if X.shape[0]:
            keep = np.flatnonzero(X.min(axis=0) != X.max(axis=0))
        else:
            keep = np.array([], dtype=np.int64)
        # bool and int8 share layout with values 0/1: the view is free
        # and keeps the public int8 contract.
        return FeatureMatrix([feats[j] for j in keep],
                             np.ascontiguousarray(X[:, keep])
                             .view(np.int8))


class FeatureUniverse:
    """Names-only candidate-feature tracker for out-of-core corpora.

    The O(|items|) companion of :class:`FeatureBasis`: ``add`` absorbs
    schedules by recording *which* expanded items occur — never their
    positions — so memory stays independent of corpus size.
    ``candidate_features()`` lists the same candidate features, in the
    same order, as ``FeatureBasis._raw()`` over an equal corpus
    (sorted-universe order pairs, then sorted-GPU stream pairs), which
    is what lets a histogram sink prune constant columns blockwise
    with :func:`apply_features` and still match the in-memory basis
    feature for feature. ``merge`` unions two hosts' universes.
    """

    def __init__(self, graph: Graph):
        self.graph = graph
        self.gpu = sorted(graph.gpu_ops())
        self._names: set[str] = set()

    def __len__(self) -> int:
        return len(self._names)

    def add(self, schedules: list[Schedule]) -> "FeatureUniverse":
        for s in schedules:
            self._names.update(expanded_names(self.graph, s))
        return self

    def merge(self, other: "FeatureUniverse") -> "FeatureUniverse":
        """Absorb another universe (sharded hosts); in place."""
        self._names |= other._names
        return self

    def candidate_features(self) -> list[Feature]:
        """Unpruned candidate features in ``FeatureBasis._raw()`` order."""
        names = sorted(self._names)
        iu, iv = np.triu_indices(len(names), k=1)
        feats = [Feature("order", names[a], names[b])
                 for a, b in zip(iu, iv)]
        gu, gv = np.triu_indices(len(self.gpu), k=1)
        feats += [Feature("stream", self.gpu[a], self.gpu[b])
                  for a, b in zip(gu, gv)]
        return feats


def featurize(graph: Graph, schedules: list[Schedule]) -> FeatureMatrix:
    """Build the (pruned) feature matrix for ``schedules``.

    Raises :class:`DegenerateFeatureSpaceError` when the corpus has no
    discriminating features (zero or one distinct schedules): every
    column would be pruned as constant and the downstream tree fit
    (``algorithm1``) would silently consume a 0-feature matrix.
    """
    fm = FeatureBasis(graph).add(schedules).matrix()
    if not fm.features:
        raise DegenerateFeatureSpaceError(
            f"corpus of {len(schedules)} schedule(s) has no "
            "discriminating features after constant-column pruning "
            "(all schedules are identical, or the corpus is empty); "
            "at least 2 distinct schedules are required")
    return fm


def apply_features(graph: Graph, schedules: list[Schedule],
                   features: list[Feature]) -> np.ndarray:
    """Evaluate an explicit feature list on ``schedules`` (vectorized).

    The basis is fixed by ``features``: items unseen there contribute
    nothing, items absent from a schedule give 0 on their order pairs.
    """
    order_cols = [j for j, f in enumerate(features) if f.kind == "order"]
    stream_cols = [j for j, f in enumerate(features) if f.kind == "stream"]
    X = np.zeros((len(schedules), len(features)), dtype=np.int8)
    if not schedules or not features:
        return X

    if order_cols:
        names = sorted({n for j in order_cols
                        for n in (features[j].u, features[j].v)})
        col = {n: i for i, n in enumerate(names)}
        P = np.full((len(schedules), len(names)), -1, dtype=np.int64)
        for i, s in enumerate(schedules):
            for pos, n in enumerate(expanded_names(graph, s)):
                c = col.get(n)
                if c is not None:
                    P[i, c] = pos
        iu = np.array([col[features[j].u] for j in order_cols])
        iv = np.array([col[features[j].v] for j in order_cols])
        Pu, Pv = P[:, iu], P[:, iv]
        X[:, order_cols] = ((Pu >= 0) & (Pv >= 0) & (Pu < Pv)) \
            .astype(np.int8)

    if stream_cols:
        gpu = sorted({n for j in stream_cols
                      for n in (features[j].u, features[j].v)})
        gcol = {n: i for i, n in enumerate(gpu)}
        S = np.full((len(schedules), len(gpu)), -1, dtype=np.int64)
        for i, s in enumerate(schedules):
            for n, stream in s.streams().items():
                c = gcol.get(n)
                if c is not None:
                    S[i, c] = stream
        gu = np.array([gcol[features[j].u] for j in stream_cols])
        gv = np.array([gcol[features[j].v] for j in stream_cols])
        X[:, stream_cols] = (S[:, gu] == S[:, gv]).astype(np.int8)

    return X


def featurize_like(graph: Graph, schedules: list[Schedule],
                   reference: FeatureMatrix) -> np.ndarray:
    """Feature values for new schedules in an existing feature basis.

    Table V's evaluation: classify the whole space with a tree trained
    on an MCTS subset, whose feature pruning defined the basis.
    """
    return apply_features(graph, schedules, reference.features)

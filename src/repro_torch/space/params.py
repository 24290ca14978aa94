"""Parameter-grid design spaces: tunable knobs behind the protocol.

A :class:`ParamSpace` is an ordered list of named dimensions, each
with a finite value set — block sizes, tile widths, unroll factors.
Candidates are value tuples (one value per dimension, in dimension
order); the canonical encoding is the int32 vector of value *indices*,
so cache keys and store addresses are stable as long as the dimension
definition is (the definition itself is hashed into the store
fingerprint — change the grid and old entries stop matching, exactly
as they must).

Sequential construction assigns dimensions in order (``moves`` of a
length-``k`` prefix are dimension ``k``'s values), which gives MCTS,
rollouts, and elite mutation over parameter grids for free via the
:class:`~repro_torch.space.base.DesignSpace` defaults.

Featurization emits *threshold* features — ``block_q >= 64`` — for
numerically ordered dimensions (a binary tree over thresholds can
express any interval rule, which is what block-size design rules are)
and one-hot equality features for unordered ones. The rules pipeline
then renders reports like ``block_k >= 128`` next to the paper's
``Pack before yL`` — same tree, same Algorithm 1, new vocabulary.

:class:`KernelRunner` is the wallclock hook: how the param-space
``wallclock`` evaluator (:class:`repro_torch.engine.params.
KernelWallclockEvaluator`) builds a runnable from a candidate and what
reference output gates its correctness. :func:`demo_param_space` is a
dependency-free analytic grid for tests and smoke runs.

The JAX package's ``repro/space/params.py``, with its imports rewritten.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from repro_torch.core.features import (DegenerateFeatureSpaceError,
                                       FeatureMatrix)
from repro_torch.space.base import DesignSpace


@dataclasses.dataclass(frozen=True)
class ParamFeature:
    """A binary feature over one parameter dimension.

    Same field layout as :class:`repro_torch.core.features.Feature` (kind /
    u / v), so rulesets, trees, and reports consume it unchanged;
    ``v`` holds the raw threshold (``param_ge``) or value
    (``param_eq``), not a string, so evaluation never round-trips
    through repr.
    """

    kind: str   # 'param_ge' | 'param_eq'
    u: str      # dimension name
    v: Any      # threshold / value

    def describe(self, value: int) -> str:
        """Human-readable rule text for this feature taking ``value``."""
        if self.kind == "param_ge":
            return (f"{self.u} >= {self.v}" if value
                    else f"{self.u} < {self.v}")
        return (f"{self.u} = {self.v}" if value
                else f"{self.u} != {self.v}")


@dataclasses.dataclass
class KernelRunner:
    """How a :class:`ParamSpace` candidate becomes a measurable program.

    ``build(params)`` maps a candidate's ``{name: value}`` dict to a
    zero-argument callable returning the kernel's outputs on a fixed
    problem instance (inputs are closed over — the instance is part of
    the space, hashed via the space ``signature``). ``reference()``
    returns the ground-truth outputs every candidate must reproduce
    (the wallclock value-correctness gate).
    """

    build: Callable[[dict], Callable[[], Any]]
    reference: Callable[[], Any]


class _ParamBasis:
    """Incremental corpus for :meth:`ParamSpace.featurize` (the
    ``feature_basis`` protocol: ``add`` absorbs, ``matrix`` emits)."""

    def __init__(self, space: "ParamSpace"):
        self.space = space
        self._cands: list[tuple] = []

    def __len__(self) -> int:
        return len(self._cands)

    def add(self, candidates: Sequence) -> "_ParamBasis":
        self._cands.extend(tuple(c) for c in candidates)
        return self

    def matrix(self) -> FeatureMatrix:
        feats = self.space.all_features()
        X = self.space.apply_features(self._cands, feats)
        if X.shape[0]:
            keep = np.flatnonzero(X.min(axis=0) != X.max(axis=0))
        else:
            keep = np.array([], dtype=np.int64)
        return FeatureMatrix([feats[j] for j in keep],
                             np.ascontiguousarray(X[:, keep]))


class _ParamUniverse:
    """Feature universe of a parameter grid (the ``feature_universe``
    protocol): the candidate features are closed-form over the grid
    (``all_features``), so absorbing candidates is a no-op and merging
    two hosts' universes over the same grid is trivially exact."""

    def __init__(self, space: "ParamSpace"):
        self.space = space

    def __len__(self) -> int:
        return len(self.space.all_features())

    def add(self, candidates: Sequence) -> "_ParamUniverse":
        return self

    def merge(self, other: "_ParamUniverse") -> "_ParamUniverse":
        return self

    def candidate_features(self) -> list[ParamFeature]:
        return self.space.all_features()


class ParamSpace(DesignSpace):
    """A finite grid of named parameter dimensions.

    ``dims`` is an ordered ``[(name, values), ...]``; candidates are
    value tuples in that order. ``runner`` attaches wallclock
    measurement (see :class:`KernelRunner`), ``analytic_cost_fn`` an
    analytic objective (``fn(params_dict) -> float``) for the ``sim``
    backend, and
    ``signature`` names the fixed problem instance
    (shapes, dtypes, flags) so store fingerprints of the same grid on
    different instances never collide.
    """

    def __init__(self, name: str,
                 dims: Sequence[tuple[str, Sequence]], *,
                 runner: KernelRunner | None = None,
                 signature: str = "",
                 analytic_cost_fn: Callable[[dict], float] | None = None):
        if not dims:
            raise ValueError("a ParamSpace needs at least one dimension")
        self.name = name
        self.dims: list[tuple[str, tuple]] = []
        seen: set[str] = set()
        for dim_name, values in dims:
            dim_name = str(dim_name)
            values = tuple(values)
            if not values:
                raise ValueError(f"dimension {dim_name!r} has no values")
            if len(set(values)) != len(values):
                raise ValueError(
                    f"dimension {dim_name!r} has duplicate values")
            if dim_name in seen:
                raise ValueError(f"duplicate dimension {dim_name!r}")
            seen.add(dim_name)
            self.dims.append((dim_name, values))
        self._index = [{v: i for i, v in enumerate(vs)}
                       for _, vs in self.dims]
        self._dim_of = {n: i for i, (n, _) in enumerate(self.dims)}
        self.runner = runner
        self.signature = signature
        self.analytic_cost_fn = analytic_cost_fn

    # -- candidate helpers -------------------------------------------------
    def candidate(self, **params) -> tuple:
        """Build a candidate tuple from keyword values."""
        unknown = set(params) - set(self._dim_of)
        if unknown or len(params) != len(self.dims):
            raise ValueError(
                f"candidate needs exactly {sorted(self._dim_of)}, "
                f"got {sorted(params)}")
        return tuple(params[n] for n, _ in self.dims)

    def as_dict(self, candidate: Sequence) -> dict:
        """``{name: value}`` view of a candidate tuple."""
        return {n: v for (n, _), v in zip(self.dims, candidate)}

    def _indices(self, candidate: Sequence) -> list[int]:
        cand = tuple(candidate)
        if len(cand) != len(self.dims):
            raise ValueError(
                f"candidate {cand!r} has {len(cand)} values for "
                f"{len(self.dims)} dimensions")
        out = []
        for (name, _), idx, v in zip(self.dims, self._index, cand):
            i = idx.get(v)
            if i is None:
                raise ValueError(
                    f"{v!r} is not a value of dimension {name!r}")
            out.append(i)
        return out

    # -- identity ----------------------------------------------------------
    def encode_batch(self, candidates: Sequence
                     ) -> tuple[list[bytes], np.ndarray]:
        enc = np.asarray([self._indices(c) for c in candidates],
                         dtype=np.int32).reshape(len(candidates),
                                                 len(self.dims))
        return [row.tobytes() for row in enc], enc

    def decode_batch(self, enc: np.ndarray) -> list[tuple]:
        """Candidate tuples back from ``encode_batch`` index rows."""
        enc = np.asarray(enc, dtype=np.int32).reshape(-1, len(self.dims))
        out: list[tuple] = []
        for row in enc:
            cand = []
            for (name, vs), i in zip(self.dims, row):
                if not 0 <= i < len(vs):
                    raise ValueError(
                        f"index {int(i)} out of range for dimension "
                        f"{name!r}")
                cand.append(vs[int(i)])
            out.append(tuple(cand))
        return out

    def candidate_key(self, candidate: Sequence) -> tuple:
        return tuple(candidate)

    def tie_key(self, candidate: Sequence) -> tuple:
        return tuple(self._indices(candidate))

    def describe(self, candidate: Sequence) -> str:
        return ", ".join(f"{n}={v}" for (n, _), v
                         in zip(self.dims, candidate))

    # -- moves: assign dimensions in order ---------------------------------
    def moves(self, prefix: list) -> list:
        if len(prefix) >= len(self.dims):
            return []
        return list(self.dims[len(prefix)][1])

    def move_key(self, move):
        return move

    def finalize(self, prefix: list) -> tuple:
        if len(prefix) != len(self.dims):
            raise ValueError(
                f"incomplete candidate: {len(prefix)} of "
                f"{len(self.dims)} dimensions assigned")
        return tuple(prefix)

    def candidate_moves(self, candidate: Sequence) -> Sequence:
        return tuple(candidate)

    def enumerate_candidates(self) -> Iterator[tuple]:
        return itertools.product(*(vs for _, vs in self.dims))

    def n_candidates(self) -> int:
        out = 1
        for _, vs in self.dims:
            out *= len(vs)
        return out

    # -- featurization -----------------------------------------------------
    def all_features(self) -> list[ParamFeature]:
        """Unpruned feature list: thresholds for ordered dimensions,
        one-hot equality for unordered ones."""
        feats: list[ParamFeature] = []
        for name, values in self.dims:
            try:
                ordered = sorted(values)
            except TypeError:
                ordered = None
            if ordered is not None:
                feats.extend(ParamFeature("param_ge", name, v)
                             for v in ordered[1:])
            else:
                feats.extend(ParamFeature("param_eq", name, v)
                             for v in values)
        return feats

    def feature_basis(self) -> _ParamBasis:
        return _ParamBasis(self)

    def feature_universe(self) -> "_ParamUniverse":
        return _ParamUniverse(self)

    def featurize(self, candidates: Sequence) -> FeatureMatrix:
        fm = self.feature_basis().add(candidates).matrix()
        if not fm.features:
            raise DegenerateFeatureSpaceError(
                f"corpus of {len(candidates)} candidate(s) in "
                f"{self.name!r} has no discriminating features after "
                "constant-column pruning (all candidates are "
                "identical, or the corpus is empty); at least 2 "
                "distinct candidates are required")
        return fm

    def apply_features(self, candidates: Sequence,
                       features: list) -> np.ndarray:
        X = np.zeros((len(candidates), len(features)), dtype=np.int8)
        if not len(candidates) or not features:
            return X
        for j, f in enumerate(features):
            d = self._dim_of.get(f.u)
            if d is None:
                continue          # feature from another basis: all 0
            col = [c[d] for c in (tuple(c) for c in candidates)]
            if f.kind == "param_ge":
                X[:, j] = [1 if v >= f.v else 0 for v in col]
            else:
                X[:, j] = [1 if v == f.v else 0 for v in col]
        return X

    # -- evaluation support ------------------------------------------------
    def fingerprint(self, machine, durations: dict,
                    objective: str) -> bytes:
        from repro_torch.engine.store import FINGERPRINT_SIZE
        h = hashlib.blake2b(digest_size=FINGERPRINT_SIZE)
        h.update(b"objective=" + objective.encode() + b"\n")
        h.update(b"param-space=" + self.name.encode() + b"\n")
        h.update(b"signature=" + self.signature.encode() + b"\n")
        h.update(repr(machine).encode() + b"\n")
        for name, values in self.dims:
            h.update(repr((name, values)).encode() + b"\n")
        return h.digest()

    def analytic_cost(self, candidate: Sequence, machine,
                      durations: dict) -> float:
        if self.analytic_cost_fn is None:
            return super().analytic_cost(candidate, machine, durations)
        return float(self.analytic_cost_fn(self.as_dict(candidate)))


def demo_param_space(name: str = "demo") -> ParamSpace:
    """A tiny analytic parameter grid (no device needed).

    A smooth cost bowl over (tile, unroll, prefetch) with the optimum
    at ``tile=32, unroll=2, prefetch=1`` — enough structure for
    strategies, labeling, and rules to find and express, cheap enough
    for unit tests and smoke runs on any container.
    """
    import math

    def cost(p: dict) -> float:
        tile = (math.log2(p["tile"]) - 5.0) ** 2        # min at 32
        unroll = (math.log2(p["unroll"]) - 1.0) ** 2    # min at 2
        pf = 0.25 * (1 - p["prefetch"])                 # prefer on
        return 1.0 + 0.5 * tile + 0.25 * unroll + pf

    return ParamSpace(
        name,
        [("tile", (8, 16, 32, 64, 128)),
         ("unroll", (1, 2, 4)),
         ("prefetch", (0, 1))],
        signature="analytic-demo-bowl-v1",
        analytic_cost_fn=cost)
